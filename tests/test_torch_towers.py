"""Each ported tower against its JAX counterpart (TINY widths, float32, CPU).

Parameters come from the JAX module's own parameter tree: every leaf is
drawn from a seeded numpy generator (none left at a zero init, which would
make a comparison vacuous: the deform-attn offset and weight kernels, the
UNet out_conv/proj_out and the captioner gates start at zero), then carried
into the port with ``load_flax_params``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_torch.model_zoo.from_jax import load_flax_params  # noqa: E402


def perturbed_params(shapes, seed=0):
    """Seeded values for every leaf of a flax parameter tree of shapes:
    kernels at 1/sqrt(fan_in), norm scales near 1, everything else (biases,
    embeddings, gates, raw parameters) at 0.2 standard deviation."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        z = np.asarray(rng.randn(*s.shape), np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1 + np.float32(0.1) * z
        return np.float32(0.2) * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_and_port(jmodule, port_module, *init_args, method=None, seed=0, **init_kw):
    """Perturbed params for ``jmodule`` (shapes from eval_shape of init),
    loaded into ``port_module``. Returns (params, jitted JAX apply)."""
    shapes = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), *init_args, method=method, **init_kw))
    params = perturbed_params(shapes, seed)
    load_flax_params(port_module, params)
    port_module.eval()
    return params, jax.jit(lambda p, *a: jmodule.apply(p, *a, method=method, **init_kw))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol)


def test_vae_taps_match_jax():
    """Encode/decode taps, latent and rgb; 1e-4: float32 convs over ~30
    layers, values of unit scale."""
    from odise_tpu.models.sd.vae import AutoencoderKL as J
    from odise_torch.models.sd.vae import AutoencoderKL as P

    x = np.random.RandomState(1).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    port = P(ch=8, encoder_tap_indices=(5, 7), decoder_tap_indices=(2, 5))
    params, fn = jax_and_port(J(ch=8, encoder_tap_indices=(5, 7),
                                decoder_tap_indices=(2, 5)), port, jnp.asarray(x))
    rgb, z, enc, dec = fn(params, jnp.asarray(x))
    with torch.no_grad():
        p_rgb, p_z, p_enc, p_dec = port(nchw(x))
        _, p_dec_only = port.decode(p_z, taps_only=True)
    close(to_nhwc(p_z), z, 1e-4)
    close(to_nhwc(p_rgb), rgb, 1e-4)
    for a, b in zip(p_enc + p_dec, list(enc) + list(dec)):
        close(to_nhwc(a), b, 1e-4)
    for a, b in zip(p_dec_only, p_dec):
        assert torch.equal(a, b)


def test_unet_taps_match_jax():
    """Output-block taps and eps with a time-embedding delta; 1e-4."""
    from odise_tpu.models.sd.unet import UNetModel as J
    from odise_torch.models.sd.unet import UNetModel as P

    rng = np.random.RandomState(2)
    x = rng.randn(1, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(1, 7, 16).astype(np.float32)
    cond = rng.randn(1, 32).astype(np.float32)
    t = np.array([3], np.int32)
    port = P(model_channels=8, num_heads=2, context_dim=16)
    params, fn = jax_and_port(J(model_channels=8, num_heads=2, context_dim=16),
                              port, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx), jnp.asarray(cond))
    eps, taps = fn(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                   jnp.asarray(cond))
    with torch.no_grad():
        p_eps, p_taps = port(nchw(x), torch.from_numpy(t).long(),
                             torch.from_numpy(ctx), torch.from_numpy(cond))
    assert len(p_taps) == len(taps) == 4
    close(to_nhwc(p_eps), eps, 1e-4)
    for a, b in zip(p_taps, taps):
        close(to_nhwc(a), b, 1e-4)


def test_clip_text_matches_jax():
    """Pooled embed at argmax(tokens) and the ln_final encodings; 1e-5."""
    from odise_tpu.models.clip.model import TextTransformer as J
    from odise_torch.models.clip.model import TextTransformer as P
    from odise_torch.models.clip.tokenizer import tokenize

    tokens = tokenize(["a photo of a cat", "dog", ""])
    assert tokens[2, :3].tolist() == [49406, 49407, 0]
    port = P(width=16, layers=2, heads=2, embed_dim=16)
    params, fn = jax_and_port(J(width=16, layers=2, heads=2, embed_dim=16),
                              port, jnp.asarray(tokens))
    emb, enc = fn(params, jnp.asarray(tokens))
    with torch.no_grad():
        p_emb, p_enc = port(torch.from_numpy(tokens).long())
    close(p_emb, emb, 1e-5)
    close(p_enc, enc, 1e-5)


def test_clip_vision_plain_and_reader_match_jax():
    """Plain forward and the MaskCLIP reader path with the reader mask
    built by each package from the same logits (masks must be equal)."""
    from odise_tpu.models.clip.adapter import build_mask_reader_mask as jmask
    from odise_tpu.models.clip.adapter import clip_preprocess as jprep
    from odise_tpu.models.clip.model import VisionTransformer as J
    from odise_torch.models.clip.adapter import build_mask_reader_mask, clip_preprocess
    from odise_torch.models.clip.model import VisionTransformer as P

    rng = np.random.RandomState(3)
    img = rng.rand(2, 40, 48, 3).astype(np.float32)
    logits = (rng.randn(2, 3, 32, 32) * 2).astype(np.float32)
    j_img = jprep(jnp.asarray(img), 32)
    p_img = clip_preprocess(nchw(img), 32)
    close(to_nhwc(p_img), j_img, 1e-5)

    cfg = dict(image_size=32, patch_size=8, width=16, layers=2, heads=2, embed_dim=16)
    port = P(**cfg)
    params, fn = jax_and_port(J(**cfg), port, j_img)
    emb, enc = fn(params, j_img)

    j_rm = jmask(jnp.asarray(logits), 8, 16)
    p_rm = build_mask_reader_mask(torch.from_numpy(logits), 8, 16)
    assert np.array_equal(p_rm.numpy(), np.asarray(j_rm))
    assert not p_rm[:, :, 0].any()  # the class column is never masked
    reader = jax.jit(lambda p, x, m: J(**cfg).apply(p, x, mask_tokens=3, reader_mask=m))(
        params, j_img, j_rm)
    with torch.no_grad():
        p_emb, p_enc = port(p_img)
        p_reader = port(p_img, mask_tokens=3, reader_mask=p_rm)
    close(p_emb, emb, 1e-5)
    close(p_enc, enc, 1e-5)
    close(p_reader, reader, 1e-5)


def _pyramid(rng, sizes, ch=32):
    return {k: rng.randn(1, s, s, ch).astype(np.float32) for k, s in sizes.items()}


INPUT_SHAPE = {f"s{i}": {"channels": 32, "stride": 2 ** i} for i in (2, 3, 4, 5)}


def test_pixel_decoder_matches_jax(monkeypatch):
    """MSDeformAttnPixelDecoder with s3 at 40x40 = 1600 rows, above the JAX
    package's 1024-row matmul cutoff, so its hybrid op runs both its gather
    and its matmul branch; 1e-4 over 2 encoder layers."""
    from odise_tpu.models.decoder.pixel_decoder import MSDeformAttnPixelDecoder as J
    from odise_torch.models.decoder.pixel_decoder import MSDeformAttnPixelDecoder as P

    for var in ("ODISE_TPU_DEFORM_IMPL", "ODISE_TPU_DEFORM_MATMUL_ROWS",
                "ODISE_TPU_DEFORM_SPLIT_GATHER"):
        monkeypatch.delenv(var, raising=False)
    feats = _pyramid(np.random.RandomState(4), {"s2": 80, "s3": 40, "s4": 20, "s5": 10})
    kw = dict(conv_dim=32, mask_dim=32, transformer_nheads=4,
              transformer_dim_feedforward=64, transformer_enc_layers=2)
    port = P(INPUT_SHAPE, **kw)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    params, fn = jax_and_port(J(input_shape=INPUT_SHAPE, **kw), port, jf)
    mf, ms = fn(params, jf)
    with torch.no_grad():
        p_mf, p_ms = port({k: nchw(v) for k, v in feats.items()})
    close(to_nhwc(p_mf), mf, 1e-4)
    for a, b in zip(p_ms, ms):
        close(to_nhwc(a), b, 1e-4)


def test_transformer_decoder_fast_path_matches_jax():
    """The inference path (training=False): masked cross-attention with the
    thresholded masks, then PooledMaskEmbed; 1e-4."""
    from odise_tpu.models.decoder import transformer_decoder as J
    from odise_torch.models.decoder import transformer_decoder as P

    rng = np.random.RandomState(5)
    x = [rng.randn(2, s, s, 32).astype(np.float32) for s in (4, 8, 16)]
    mf = rng.randn(2, 32, 32, 32).astype(np.float32)
    kw = dict(hidden_dim=32, num_queries=10, nheads=4, dim_feedforward=64,
              dec_layers=3, mask_dim=32, num_classes=3, in_channels=32)
    jdec = J.ODISEMultiScaleMaskedTransformerDecoder(
        class_embed=J.PseudoClassEmbed(num_classes=3),
        post_mask_embed=J.PooledMaskEmbed(hidden_dim=32, mask_dim=32, projection_dim=32),
        **kw)
    port = P.ODISEMultiScaleMaskedTransformerDecoder(
        class_embed=P.PseudoClassEmbed(3),
        post_mask_embed=P.PooledMaskEmbed(32, 32, 32), **kw)
    jx = [jnp.asarray(a) for a in x]
    params, fn = jax_and_port(jdec, port, jx, jnp.asarray(mf), training=False)
    out = fn(params, jx, jnp.asarray(mf))
    with torch.no_grad():
        p_out = port([nchw(a) for a in x], nchw(mf))
    assert p_out["aux_outputs"] == [] and out["aux_outputs"] == []
    for k in ("pred_logits", "pred_masks", "mask_embed", "mask_pooled_features",
              "logit_scale"):
        close(p_out[k], out[k], 1e-4)
