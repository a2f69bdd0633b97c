"""The reference's checkpoints into the port (``odise_torch/model_zoo``),
against the JAX package's converters, at TINY on the CPU and at FULL on
the card.

``reference_state_dicts(scale, seed)`` builds three state dicts in the
reference's own key layout: Stable Diffusion v1.3 (CompVis
``model.diffusion_model.*``, ``first_stage_model.*`` and the text encoder
under ``cond_stage_model.transformer.``, in the OpenAI layout the JAX
converter reads or in the Hugging Face layout CompVis checkpoints hold),
OpenAI CLIP ViT-L/14 (``visual.*``, the text tower, ``logit_scale``) and a
released ODISE checkpoint's trainable set. Key names and shapes follow the
reference architectures (the trainable set extends
``tests/test_convert_structure.py``'s builders to FULL); every tensor is
drawn from a generator seeded with ``(seed, crc32(key))``: convolutions and
linears at std ``1/sqrt(fan_in)``, norm scales near 1, biases and raw
parameters near 0.

The cases here, at TINY unless named FULL:
* each port map gives JAX's tree leaf by leaf, exactly;
* at FULL key sets (zero-stride arrays, no memory) each map fills every
  tensor of its towers in the FULL port model built on the meta device,
  at the right shapes, the three checkpoints together the whole model,
  and the CLIP head refuses the 224-px CLIP state;
* the Hugging Face SD text layout gives JAX's OpenAI-layout tree, while
  JAX's ``install_sd_weights`` raises ``KeyError`` on it;
* a port model built by the port's ``build_with_weights`` from the dicts
  gives the activations of a JAX model built by JAX's from the same dicts
  (the JAX side stored, as below);
* the partial loader and the installers raise on a leaf with no tensor,
  on a misfit shape and on a tower left unfilled.

The comparison with JAX's forward: this module run as a script,

    JAX_PLATFORMS=cpu python -m tests.test_torch_convert [tiny] [full]

builds the dicts, runs JAX's ``tools/capture_activations.py``
(``build_with_weights`` in-process on these dicts, then
``capture_activations``) on the ramp image in float32, adds the eval
forward's ``mask_cls`` and panoptic map, and writes
``tests/data/torch_{tiny,full}_reference.npz``: for every stage its
shape, sum, sum of |x|, max |x| and a strided sample of ``SAMPLES``
values, with a sha256 of every generated tensor and the jax, flax and
numpy versions (on an 8-core CPU about 2 minutes for TINY, 5 for FULL and
some 15 GB of memory: a JAX model initialises eagerly, so even TINY is too
slow for the tests). ``port_parity`` holds the port to it: at TINY here,
at FULL on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 11).
"""

import hashlib
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from odise_torch.model_zoo import convert as pconv  # noqa: E402
from odise_torch.model_zoo.from_jax import (load_flax_subtree,  # noqa: E402
                                            match_flax_tree)
from odise_torch.models.backbone.feature_extractor import ldm_feature_dims_strides  # noqa: E402
from .torch_threads import one_thread  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
SEED = 0
SAMPLES = 4096

# the reference architectures' widths at the JAX package's two scales
ARCH = {
    "tiny": dict(mc=8, vae_ch=8, ctx=16, sd_text_layers=1,
                 vision=(32, 8, 16, 1), head_vision=(32, 8, 16, 1), clip_embed=16,
                 text=(16, 1), hid=32, proj=32, queries=10, enc_layers=2,
                 enc_ffn=64, dec_layers=3, dec_ffn=64, nheads=4),
    "full": dict(mc=320, vae_ch=128, ctx=768, sd_text_layers=12,
                 vision=(224, 14, 1024, 24), head_vision=(336, 14, 1024, 24),
                 clip_embed=768, text=(768, 12), hid=256, proj=512, queries=100,
                 enc_layers=6, enc_ffn=1024, dec_layers=9, dec_ffn=2048, nheads=8),
}
VOCAB_SIZE, CONTEXT = 49408, 77
LEVELS, POINTS = 3, 4

# ---------------------------------------------------------------------------
# key specs: name -> (shape, mean, std), in the reference's layout
# ---------------------------------------------------------------------------


def _lin(sp, name, cin, cout, bias=True):
    sp[f"{name}.weight"] = ((cout, cin), 0.0, cin ** -0.5)
    if bias:
        sp[f"{name}.bias"] = ((cout,), 0.0, 0.1)


def _conv(sp, name, cin, cout, k=3, bias=True):
    sp[f"{name}.weight"] = ((cout, cin, k, k), 0.0, (cin * k * k) ** -0.5)
    if bias:
        sp[f"{name}.bias"] = ((cout,), 0.0, 0.1)


def _norm(sp, name, c):
    sp[f"{name}.weight"] = ((c,), 1.0, 0.1)
    sp[f"{name}.bias"] = ((c,), 0.0, 0.1)


def _raw(sp, name, shape, std=0.1, mean=0.0):
    sp[name] = (tuple(shape), mean, std)


def _vae_resblock(sp, name, cin, cout):
    _norm(sp, f"{name}.norm1", cin)
    _conv(sp, f"{name}.conv1", cin, cout)
    _norm(sp, f"{name}.norm2", cout)
    _conv(sp, f"{name}.conv2", cout, cout)
    if cin != cout:
        _conv(sp, f"{name}.nin_shortcut", cin, cout, k=1)


def _vae_attn(sp, name, c):
    _norm(sp, f"{name}.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        _conv(sp, f"{name}.{n}", c, c, k=1)


def _vae(sp, ch, mult=(1, 2, 4, 4), nrb=2, z=4):
    p = "first_stage_model."
    _conv(sp, p + "encoder.conv_in", 3, ch)
    cin = ch
    for i, m in enumerate(mult):
        for j in range(nrb):
            _vae_resblock(sp, p + f"encoder.down.{i}.block.{j}", cin, ch * m)
            cin = ch * m
        if i != len(mult) - 1:
            _conv(sp, p + f"encoder.down.{i}.downsample.conv", cin, cin)
    _vae_resblock(sp, p + "encoder.mid.block_1", cin, cin)
    _vae_attn(sp, p + "encoder.mid.attn_1", cin)
    _vae_resblock(sp, p + "encoder.mid.block_2", cin, cin)
    _norm(sp, p + "encoder.norm_out", cin)
    _conv(sp, p + "encoder.conv_out", cin, 2 * z)
    top = ch * mult[-1]
    _conv(sp, p + "decoder.conv_in", z, top)
    _vae_resblock(sp, p + "decoder.mid.block_1", top, top)
    _vae_attn(sp, p + "decoder.mid.attn_1", top)
    _vae_resblock(sp, p + "decoder.mid.block_2", top, top)
    cin = top
    for i in reversed(range(len(mult))):
        for j in range(nrb + 1):
            _vae_resblock(sp, p + f"decoder.up.{i}.block.{j}", cin, ch * mult[i])
            cin = ch * mult[i]
        if i != 0:
            _conv(sp, p + f"decoder.up.{i}.upsample.conv", cin, cin)
    _norm(sp, p + "decoder.norm_out", cin)
    _conv(sp, p + "decoder.conv_out", cin, 3)
    _conv(sp, p + "quant_conv", 2 * z, 2 * z, k=1)
    _conv(sp, p + "post_quant_conv", z, z, k=1)


def _unet_resblock(sp, name, cin, cout, temb):
    _norm(sp, f"{name}.in_layers.0", cin)
    _conv(sp, f"{name}.in_layers.2", cin, cout)
    _lin(sp, f"{name}.emb_layers.1", temb, cout)
    _norm(sp, f"{name}.out_layers.0", cout)
    _conv(sp, f"{name}.out_layers.3", cout, cout)
    if cin != cout:
        _conv(sp, f"{name}.skip_connection", cin, cout, k=1)


def _unet_attn(sp, name, c, ctx):
    _norm(sp, f"{name}.norm", c)
    _conv(sp, f"{name}.proj_in", c, c, k=1)
    b = f"{name}.transformer_blocks.0"
    for attn, kv in (("attn1", c), ("attn2", ctx)):
        _lin(sp, f"{b}.{attn}.to_q", c, c, bias=False)
        _lin(sp, f"{b}.{attn}.to_k", kv, c, bias=False)
        _lin(sp, f"{b}.{attn}.to_v", kv, c, bias=False)
        _lin(sp, f"{b}.{attn}.to_out.0", c, c)
    _lin(sp, f"{b}.ff.net.0.proj", c, c * 8)  # GEGLU: value and gate
    _lin(sp, f"{b}.ff.net.2", c * 4, c)
    for n in ("norm1", "norm2", "norm3"):
        _norm(sp, f"{b}.{n}", c)
    _conv(sp, f"{name}.proj_out", c, c, k=1)


def _unet(sp, mc, ctx, mult=(1, 2, 4, 4), nrb=2, attn_ds=(1, 2, 4)):
    p = "model.diffusion_model."
    temb = mc * 4
    _lin(sp, p + "time_embed.0", mc, temb)
    _lin(sp, p + "time_embed.2", temb, temb)
    _conv(sp, p + "input_blocks.0.0", 4, mc)
    ds, k, cin, chans = 1, 0, mc, [mc]
    for i, m in enumerate(mult):
        for _ in range(nrb):
            k += 1
            _unet_resblock(sp, p + f"input_blocks.{k}.0", cin, mc * m, temb)
            cin = mc * m
            if ds in attn_ds:
                _unet_attn(sp, p + f"input_blocks.{k}.1", cin, ctx)
            chans.append(cin)
        if i != len(mult) - 1:
            k += 1
            _conv(sp, p + f"input_blocks.{k}.0.op", cin, cin)
            chans.append(cin)
            ds *= 2
    _unet_resblock(sp, p + "middle_block.0", cin, cin, temb)
    _unet_attn(sp, p + "middle_block.1", cin, ctx)
    _unet_resblock(sp, p + "middle_block.2", cin, cin, temb)
    oi = 0
    for i in reversed(range(len(mult))):
        for j in range(nrb + 1):
            _unet_resblock(sp, p + f"output_blocks.{oi}.0", cin + chans.pop(),
                           mc * mult[i], temb)
            cin = mc * mult[i]
            mod = 1
            if ds in attn_ds:
                _unet_attn(sp, p + f"output_blocks.{oi}.{mod}", cin, ctx)
                mod += 1
            if i != 0 and j == nrb:
                _conv(sp, p + f"output_blocks.{oi}.{mod}.conv", cin, cin)
                ds //= 2
            oi += 1
    _norm(sp, p + "out.0", cin)
    _conv(sp, p + "out.2", cin, 4)


def _openai_resblocks(sp, prefix, width, layers):
    for i in range(layers):
        b = f"{prefix}transformer.resblocks.{i}"
        sp[f"{b}.attn.in_proj_weight"] = ((3 * width, width), 0.0, width ** -0.5)
        sp[f"{b}.attn.in_proj_bias"] = ((3 * width,), 0.0, 0.1)
        _lin(sp, f"{b}.attn.out_proj", width, width)
        _norm(sp, f"{b}.ln_1", width)
        _norm(sp, f"{b}.ln_2", width)
        _lin(sp, f"{b}.mlp.c_fc", width, 4 * width)
        _lin(sp, f"{b}.mlp.c_proj", 4 * width, width)


def _openai_text(sp, prefix, width, layers, embed):
    _raw(sp, f"{prefix}token_embedding.weight", (VOCAB_SIZE, width), std=0.02)
    _raw(sp, f"{prefix}positional_embedding", (CONTEXT, width), std=0.01)
    _openai_resblocks(sp, prefix, width, layers)
    _norm(sp, f"{prefix}ln_final", width)
    _raw(sp, f"{prefix}text_projection", (width, embed), std=width ** -0.5)


def _hf_text(sp, prefix, width, layers):
    """Hugging Face ``CLIPTextModel``, as CompVis SD v1 checkpoints hold the
    text encoder (no text projection; ``position_ids`` a buffer)."""
    e = f"{prefix}text_model.embeddings"
    _raw(sp, f"{e}.token_embedding.weight", (VOCAB_SIZE, width), std=0.02)
    _raw(sp, f"{e}.position_embedding.weight", (CONTEXT, width), std=0.01)
    sp[f"{e}.position_ids"] = ((1, CONTEXT), "arange", None)
    for i in range(layers):
        b = f"{prefix}text_model.encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            _lin(sp, f"{b}.self_attn.{n}_proj", width, width)
        _norm(sp, f"{b}.layer_norm1", width)
        _lin(sp, f"{b}.mlp.fc1", width, 4 * width)
        _lin(sp, f"{b}.mlp.fc2", 4 * width, width)
        _norm(sp, f"{b}.layer_norm2", width)
    _norm(sp, f"{prefix}text_model.final_layer_norm", width)


def sd_spec(scale: str, text_layout: str = "openai") -> dict:
    """Stable Diffusion v1.3 (CompVis ``LatentDiffusion``): UNet, VAE and
    the text encoder in ``text_layout`` ("openai", "hf" or None)."""
    a = ARCH[scale]
    sp: dict = {}
    _unet(sp, a["mc"], a["ctx"])
    _vae(sp, a["vae_ch"])
    prefix = "cond_stage_model.transformer."
    if text_layout == "openai":
        _openai_text(sp, prefix, a["ctx"], a["sd_text_layers"], a["ctx"])
    elif text_layout == "hf":
        _hf_text(sp, prefix, a["ctx"], a["sd_text_layers"])
    return sp


def clip_spec(scale: str, head: bool = False, text: bool = True) -> dict:
    """OpenAI CLIP: ViT-L/14 at 224 px (``head``: at 336 px, the CLIP
    head's) with ``visual.*``, the text tower and ``logit_scale``."""
    a = ARCH[scale]
    size, patch, width, layers = a["head_vision" if head else "vision"]
    sp: dict = {}
    _conv(sp, "visual.conv1", 3, width, k=patch, bias=False)
    _raw(sp, "visual.class_embedding", (width,), std=width ** -0.5)
    _raw(sp, "visual.positional_embedding", ((size // patch) ** 2 + 1, width),
         std=width ** -0.5)
    _norm(sp, "visual.ln_pre", width)
    _openai_resblocks(sp, "visual.", width, layers)
    _norm(sp, "visual.ln_post", width)
    _raw(sp, "visual.proj", (width, a["clip_embed"]), std=width ** -0.5)
    if text:
        _openai_text(sp, "", a["text"][0], a["text"][1], a["clip_embed"])
    _raw(sp, "logit_scale", (), std=0.05, mean=float(np.log(1 / 0.07)))
    return sp


def _d2_conv_gn(sp, name, cin, cout, k):
    _conv(sp, name, cin, cout, k=k, bias=False)
    _norm(sp, f"{name}.norm", cout)


def _mha(sp, name, c):
    sp[f"{name}.in_proj_weight"] = ((3 * c, c), 0.0, c ** -0.5)
    sp[f"{name}.in_proj_bias"] = ((3 * c,), 0.0, 0.1)
    _lin(sp, f"{name}.out_proj", c, c)


def odise_spec(scale: str) -> dict:
    """A released CategoryODISE checkpoint's trainable set: the backbone's
    feature projections (d2 BottleneckBlock with GN), the implicit
    captioner's projections, the MSDeformAttn pixel decoder, the masked
    transformer decoder with PooledMaskEmbed, and the category head.

    ``mask_features`` is the 3x3 convolution both packages build; the
    Mask2Former pixel decoder the reference imports builds it 1x1
    (ROADMAP C25)."""
    a = ARCH[scale]
    hid, proj, clip_dim, ctx = a["hid"], a["proj"], a["clip_embed"], a["ctx"]
    temb = a["mc"] * 4
    sp: dict = {}
    dims, _ = ldm_feature_dims_strides(a["mc"], a["vae_ch"])
    for i, cin in enumerate(dims):
        b = f"backbone.feature_projections.{i}.0"
        if cin != proj:
            _d2_conv_gn(sp, f"{b}.shortcut", cin, proj, k=1)
        _d2_conv_gn(sp, f"{b}.conv1", cin, proj // 4, k=1)
        _d2_conv_gn(sp, f"{b}.conv2", proj // 4, proj // 4, k=3)
        _d2_conv_gn(sp, f"{b}.conv3", proj // 4, proj, k=1)
    fx = "backbone.feature_extractor"
    _lin(sp, f"{fx}.clip_project.linear", clip_dim, ctx)
    _raw(sp, f"{fx}.clip_project.positional_embedding", (1, CONTEXT, ctx), std=0.02)
    _raw(sp, f"{fx}.alpha_cond", (1, CONTEXT, ctx))  # zeros_like(uncond_inputs)
    _lin(sp, f"{fx}.time_embed_project.linear", clip_dim, temb)
    _raw(sp, f"{fx}.time_embed_project.positional_embedding", (1, 1, temb), std=0.02)
    _raw(sp, f"{fx}.alpha_cond_time_embed", (temb,))  # 1-D in the reference
    pd = "sem_seg_head.pixel_decoder"
    for i in range(LEVELS):
        _conv(sp, f"{pd}.input_proj.{i}.0", proj, hid, k=1)
        _norm(sp, f"{pd}.input_proj.{i}.1", hid)
    _raw(sp, f"{pd}.transformer.level_embed", (LEVELS, hid), std=1.0)
    heads = a["nheads"]
    for i in range(a["enc_layers"]):
        e = f"{pd}.transformer.encoder.layers.{i}"
        _lin(sp, f"{e}.self_attn.sampling_offsets", hid, heads * LEVELS * POINTS * 2)
        _lin(sp, f"{e}.self_attn.attention_weights", hid, heads * LEVELS * POINTS)
        _lin(sp, f"{e}.self_attn.value_proj", hid, hid)
        _lin(sp, f"{e}.self_attn.output_proj", hid, hid)
        _lin(sp, f"{e}.linear1", hid, a["enc_ffn"])
        _lin(sp, f"{e}.linear2", a["enc_ffn"], hid)
        _norm(sp, f"{e}.norm1", hid)
        _norm(sp, f"{e}.norm2", hid)
    _d2_conv_gn(sp, f"{pd}.lateral_convs.0", proj, hid, k=1)
    _d2_conv_gn(sp, f"{pd}.output_convs.0", hid, hid, k=3)
    _conv(sp, f"{pd}.mask_features", hid, hid, k=3)
    pr = "sem_seg_head.predictor"
    for n in ("query_feat", "query_embed"):
        _raw(sp, f"{pr}.{n}.weight", (a["queries"], hid), std=1.0)
    _raw(sp, f"{pr}.level_embed.weight", (LEVELS, hid), std=1.0)
    for i in range(a["dec_layers"]):
        _mha(sp, f"{pr}.transformer_cross_attention_layers.{i}.multihead_attn", hid)
        _norm(sp, f"{pr}.transformer_cross_attention_layers.{i}.norm", hid)
        _mha(sp, f"{pr}.transformer_self_attention_layers.{i}.self_attn", hid)
        _norm(sp, f"{pr}.transformer_self_attention_layers.{i}.norm", hid)
        _lin(sp, f"{pr}.transformer_ffn_layers.{i}.linear1", hid, a["dec_ffn"])
        _lin(sp, f"{pr}.transformer_ffn_layers.{i}.linear2", a["dec_ffn"], hid)
        _norm(sp, f"{pr}.transformer_ffn_layers.{i}.norm", hid)
    _norm(sp, f"{pr}.decoder_norm", hid)
    for i in range(3):
        _lin(sp, f"{pr}.mask_embed.layers.{i}", hid, hid)
    pme = f"{pr}.post_mask_embed"
    _norm(sp, f"{pme}.pool_proj.0", hid)
    _lin(sp, f"{pme}.pool_proj.1", hid, hid)
    _norm(sp, f"{pme}.mask_embed.0", hid)
    for i in range(3):
        _lin(sp, f"{pme}.mask_embed.1.layers.{i}", hid, hid)
    _raw(sp, f"{pme}.logit_scale", (), std=0.05, mean=float(np.log(1 / 0.07)))
    _lin(sp, "category_head.text_proj", clip_dim, hid)
    _raw(sp, "category_head.null_embed", (1, clip_dim), std=0.02)
    return sp


def fill(spec: dict, seed: int = SEED):
    """(state dict of numpy arrays, name -> sha256 of its bytes): each
    tensor drawn from a generator seeded with (seed, crc32(name))."""
    state, shas = {}, {}
    for name, (shape, mean, std) in spec.items():
        if mean == "arange":
            v = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
        else:
            rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
            v = np.asarray(rng.standard_normal(shape, dtype=np.float32))
            v *= np.float32(std)
            v += np.float32(mean)
        state[name] = v
        shas[name] = hashlib.sha256(v.data).hexdigest()
    return state, shas


def zero_stride(spec: dict) -> dict:
    """The spec's key set as zero-stride arrays: shapes without memory."""
    return {name: np.broadcast_to(np.zeros((), np.float32), shape)
            for name, (shape, _, _) in spec.items()}


def reference_specs(scale: str, text_layout: str = "openai") -> dict:
    return {"sd": sd_spec(scale, text_layout), "clip": clip_spec(scale),
            "odise": odise_spec(scale)}


def reference_state_dicts(scale: str, seed: int = SEED, text_layout: str = "openai"):
    """({"sd", "clip", "odise"} -> state dict, name -> sha256 of every
    tensor) in the reference's layout."""
    dicts, shas = {}, {}
    for kind, spec in reference_specs(scale, text_layout).items():
        dicts[kind], s = fill(spec, seed)
        shas.update({f"{kind}/{k}": v for k, v in s.items()})
    return dicts, shas


# ---------------------------------------------------------------------------
# the JAX side (imported lazily: the card's machine has no JAX)
# ---------------------------------------------------------------------------


class jax_converters:
    """The JAX package's convert module, with its FULL layer counts set to
    TINY's for ``scale="tiny"`` (its installers and ``build_with_weights``
    pass none), restored on exit."""

    def __init__(self, scale: str, states: dict = None):
        import odise_tpu.model_zoo.convert as jconv

        self.jconv, self.scale, self.states = jconv, scale, states
        self.saved = {}

    def _patch(self, name, fn):
        self.saved[name] = getattr(self.jconv, name)
        setattr(self.jconv, name, fn)

    def __enter__(self):
        if self.states is not None:  # in-memory "files"
            self._patch("load_torch_state_dict", self.states.pop)
        if self.scale == "tiny":
            a = ARCH["tiny"]
            for name, kw in (("convert_clip_vision", dict(layers=a["vision"][3])),
                             ("convert_clip_text", dict(layers=a["text"][1])),
                             ("convert_odise_trainable", dict(
                                 enc_layers=a["enc_layers"], dec_layers=a["dec_layers"]))):
                orig = getattr(self.jconv, name)
                self._patch(name, lambda *args, _f=orig, _kw=kw, **k: _f(*args, **{**k, **_kw}))
        return self.jconv

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.jconv, name, fn)


def jax_tools():
    """JAX's ``tools/capture_activations.py`` module."""
    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import capture_activations

    return capture_activations


def jax_build_with_weights(scale: str, dicts: dict, **kw):
    """JAX's ``build_with_weights`` on in-memory state dicts (consumed)."""
    with jax_converters(scale, dicts):
        return jax_tools().build_with_weights(
            scale, sd_ckpt="sd", clip_ckpt="clip", odise_ckpt="odise", **kw)


def jax_eval_mask_cls(model, variables, img):
    """JAX's counterpart of ``odise_torch.verify_parity.eval_mask_cls``
    (``tools/verify_parity.py::panoptic_map``'s forward)."""
    import jax.numpy as jnp

    K = len(model.train_labels)
    clip_dim = model.category_head.clip_dim
    text = np.linspace(-1, 1, K * clip_dim).reshape(K, clip_dim).astype(np.float32)
    return model.apply(variables, jnp.asarray(img[None]), jnp.asarray(text),
                       model.train_labels, None, None, None,
                       method=type(model).forward_eval)


def summarize(x: np.ndarray) -> dict:
    """Shape, sum, sum |x|, max |x| and ``SAMPLES`` values at fixed strides
    (all of them in a smaller array)."""
    x = np.asarray(x, np.float32)
    flat = x.ravel()
    idx = np.unique(np.linspace(0, flat.size - 1, SAMPLES).astype(np.int64))
    return {"shape": np.asarray(x.shape, np.int64),
            "sum": np.float64(flat.sum(dtype=np.float64)),
            "abs_sum": np.float64(np.abs(flat).sum(dtype=np.float64)),
            "abs_max": np.float64(np.abs(flat).max()), "sample": flat[idx]}


def jax_versions() -> str:
    import flax
    import jax

    return f"jax {jax.__version__}, flax {flax.__version__}, numpy {np.__version__}"


def write_reference(scale: str) -> None:
    """Run the JAX package at ``scale`` on the CPU (float32)
    and write ``PARITY[scale]["file"]``."""
    import functools

    import jax.numpy as jnp

    import odise_tpu.model_zoo.factory as jfactory
    from odise_tpu.models.inference import panoptic_inference

    cfg = PARITY[scale]
    if cfg["backbone_in_size"] is not None:  # build_with_weights takes none
        jfactory.build_category_odise = functools.partial(
            jfactory.build_category_odise, backbone_in_size=cfg["backbone_in_size"])
    dicts, shas = reference_state_dicts(scale)
    model, variables = jax_build_with_weights(scale, dicts,
                                              with_clip_head=cfg["with_clip_head"])
    img = jax_tools().ramp_image(cfg["image_size"])
    captures = jax_tools().capture_activations(model, variables, img)
    mask_cls, mask_pred = jax_eval_mask_cls(model, variables, img)
    pan = panoptic_inference(mask_cls[0], mask_pred[0],
                             jnp.ones((len(model.train_labels),), bool),
                             object_mask_threshold=0.0, overlap_threshold=0.8)
    captures["eval_mask_cls"] = np.asarray(mask_cls, np.float32)
    captures["eval_mask_pred"] = np.asarray(mask_pred, np.float32)
    out = {"meta/versions": np.asarray(jax_versions()),
           "mask_cls": captures["eval_mask_cls"], "panoptic": np.asarray(pan.panoptic_seg)}
    for key, value in captures.items():
        for field, v in summarize(value).items():
            out[f"stage/{key}/{field}"] = v
    for key, sha in shas.items():
        out[f"sha256/{key}"] = np.asarray(sha)
    cfg["file"].parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(cfg["file"], **out)
    print(f"wrote {cfg['file']}: {len(captures)} stages, {len(shas)} tensors")


# ---------------------------------------------------------------------------
# the port against the stored JAX side: TINY on the CPU, FULL on the card
# ---------------------------------------------------------------------------

# per stage, the largest relative error (max|port - jax| / max|jax| over the
# stored sample) allowed; float32 on both sides, TF32 off on the card. At
# TINY the JAX side runs with a 128-px backbone: at its 64 px the UNet's
# last level is 1x1 and the projections' GroupNorm sees single-value groups
# (ROADMAP C6). The CLIP head runs only at TINY: at FULL the JAX installer
# puts the 224-px CLIP state into the 336-px head (ROADMAP C24).
PARITY = {
    "tiny": dict(file=Path(__file__).with_name("data") / "torch_tiny_reference.npz",
                 image_size=128, backbone_in_size=(128, 128), with_clip_head=True,
                 tolerances=[("tap_", 1e-4), ("backbone_", 1e-4), ("head_", 1e-3),
                             ("clip_", 1e-3), ("eval_", 1e-3)]),
    "full": dict(file=Path(__file__).with_name("data") / "torch_full_reference.npz",
                 image_size=512, backbone_in_size=None, with_clip_head=False,
                 tolerances=[("tap_", 1e-4), ("backbone_", 1e-4), ("head_", 1e-3),
                             ("eval_", 1e-3)]),
}


def load_reference(scale: str, shas: dict) -> dict:
    """The stored JAX side at ``scale``, after checking that it was made
    from exactly the tensors ``reference_state_dicts`` made here."""
    path = PARITY[scale]["file"]
    ref = dict(np.load(path))
    stored = {k[len("sha256/"):]: str(v) for k, v in ref.items() if k.startswith("sha256/")}
    if stored != shas:
        bad = sorted(k for k in set(stored) | set(shas) if stored.get(k) != shas.get(k))
        raise AssertionError(f"{path.name} was made from other tensors ({len(bad)} differ, "
                             f"e.g. {bad[:3]}); rerun python -m tests.test_torch_convert")
    return ref


def stage_errors(captures: dict, ref: dict, tolerances) -> dict:
    """stage -> (relative error over the stored sample, relative error of
    the sum of |x|, tolerance), for every stage the reference stored."""
    out = {}
    for key in sorted({k.split("/")[1] for k in ref if k.startswith("stage/")}):
        r = {f: ref[f"stage/{key}/{f}"] for f in ("shape", "abs_sum", "abs_max", "sample")}
        mine = summarize(captures[key])
        if tuple(mine["shape"]) != tuple(r["shape"]):
            raise AssertionError(f"{key}: shape {tuple(mine['shape'])}, JAX {tuple(r['shape'])}")
        tol = next(t for p, t in tolerances if key.startswith(p))
        err = float(np.abs(mine["sample"] - r["sample"]).max() / r["abs_max"])
        sum_err = float(abs(mine["abs_sum"] - r["abs_sum"]) / r["abs_sum"])
        out[key] = (err, sum_err, tol)
    return out


def port_parity(scale: str, device="cuda", made=None, hook=None):
    """The port at ``scale`` in float32, loaded through its converters from
    the reference dicts (``made``: ``reference_state_dicts(scale)``'s
    result, consumed; made here if None), captured on the ramp image as the
    JAX side was; ``hook(model)`` runs before the capture. Returns (stage
    -> (error, sum error, tolerance), the panoptic map's agreement with
    JAX's, the model)."""
    from odise_torch.capture_activations import (build_with_weights, capture_activations,
                                                 ramp_image)
    from odise_torch.verify_parity import eval_mask_cls, fuse_panoptic, panoptic_agreement

    cfg = PARITY[scale]
    dicts, shas = made if made is not None else reference_state_dicts(scale)
    ref = load_reference(scale, shas)
    model = build_with_weights(scale, sd_ckpt=dicts.pop("sd"), clip_ckpt=dicts.pop("clip"),
                               odise_ckpt=dicts.pop("odise"),
                               with_clip_head=cfg["with_clip_head"],
                               backbone_in_size=cfg["backbone_in_size"], device=device)
    if hook is not None:
        hook(model)
    img = ramp_image(cfg["image_size"])
    captures = capture_activations(model, img)
    mask_cls, mask_pred = eval_mask_cls(model, img)
    captures["eval_mask_cls"] = mask_cls.cpu().numpy()
    captures["eval_mask_pred"] = mask_pred.cpu().numpy()
    errors = stage_errors(captures, ref, cfg["tolerances"])
    agreement = panoptic_agreement(fuse_panoptic(mask_cls, mask_pred), ref["panoptic"])
    return errors, agreement, model


# ---------------------------------------------------------------------------
# CPU tests at TINY
# ---------------------------------------------------------------------------


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_same_tree(mine, theirs):
    a, b = _flat(mine), _flat(theirs)
    assert sorted(a) == sorted(b), (sorted(set(a) ^ set(b)))[:6]
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), "/".join(k)


@pytest.fixture(scope="module")
def tiny_dicts():
    return reference_state_dicts("tiny")[0]


MAPS = {
    "sd_vae": lambda c, d: c.convert_sd_vae(d["sd"]),
    "sd_unet": lambda c, d: c.convert_sd_unet(d["sd"]),
    "sd_text": lambda c, d: c.convert_clip_text(
        {k[len("cond_stage_model.transformer."):]: v for k, v in d["sd"].items()
         if k.startswith("cond_stage_model.transformer.")}, layers=1),
    "clip_vision": lambda c, d: c.convert_clip_vision(d["clip"], layers=1),
    "clip_text": lambda c, d: c.convert_clip_text(d["clip"], layers=1),
    "odise_trainable": lambda c, d: c.convert_odise_trainable(d["odise"], enc_layers=2,
                                                              dec_layers=3),
}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_map_equals_jax_exactly(name, tiny_dicts):
    """Each port map gives the JAX map's tree from the same numpy state
    dict: the same scope paths, dtypes and values (np.array_equal)."""
    pytest.importorskip("jax")
    import odise_tpu.model_zoo.convert as jconv

    _assert_same_tree(MAPS[name](pconv, tiny_dicts), MAPS[name](jconv, tiny_dicts))


@pytest.fixture(scope="module")
def full_meta_model():
    from odise_torch.model_zoo.factory import build_category_odise

    return build_category_odise("full", device="meta", dtype=torch.bfloat16)


def _tower_names(model, what):
    return {n for n in model.state_dict() if n not in what.may_leave
            and any(n == t or n.startswith(t + ".") for t in what.towers)}


FULL_INSTALLS = {
    "sd": lambda m: pconv.sd_install(m, zero_stride(sd_spec("full"))),
    "sd_hf": lambda m: pconv.sd_install(m, zero_stride(sd_spec("full", "hf"))),
    "clip": lambda m: pconv.clip_install(
        m, zero_stride(clip_spec("full")),
        clip_head_state=zero_stride(clip_spec("full", head=True, text=False))),
    "odise": lambda m: pconv.odise_install(m, zero_stride(odise_spec("full"))),
}


@pytest.mark.parametrize("name", sorted(FULL_INSTALLS))
def test_full_key_sets_fill_their_towers(name, full_meta_model):
    """At FULL key sets and shapes (zero-stride arrays), each converter's
    paths are exactly the FULL port model's tensors of its towers, at their
    shapes: every tensor filled, no leaf left over (in the Hugging Face SD
    text layout, all but the text projection it does not have)."""
    what = FULL_INSTALLS[name](full_meta_model)
    matched, _ = match_flax_tree(full_meta_model, what.tree)
    names = {n for n, _ in matched}
    want = _tower_names(full_meta_model, what)
    assert names == want, (sorted(want - names)[:5], sorted(names - want)[:5])
    n = sum(int(np.prod(v.shape)) for _, v in matched)
    assert n > {"sd": 1_000_000_000, "sd_hf": 1_000_000_000, "clip": 700_000_000,
                "odise": 28_000_000}[name]
    assert name != "sd_hf" or what.may_leave == (
        "backbone.feature_extractor.ldm_extractor.sd_text.text_projection",)


def test_full_checkpoints_fill_the_whole_model(full_meta_model):
    """SD v1.3, CLIP ViT-L/14 (with the head's 336-px state) and the ODISE
    trainable set together fill every tensor of FULL CategoryODISE with
    the CLIP head, each once."""
    names = []
    for name in ("sd", "clip", "odise"):
        matched, _ = match_flax_tree(full_meta_model, FULL_INSTALLS[name](full_meta_model).tree)
        names += [n for n, _ in matched]
    assert len(names) == len(set(names))
    assert set(names) == set(full_meta_model.state_dict())


def test_clip_head_refuses_the_224px_state(full_meta_model):
    """Reference fault 2 (ROADMAP C24): the JAX installer writes the one
    CLIP state into the 224-px captioner and the 336-px CLIP head, and
    ``merge_params`` checks no shape. The port raises at the head's
    positional embedding (257 positions for 577) and writes nothing; with
    the head's own state it fills every tower."""
    state = zero_stride(clip_spec("full"))
    with pytest.raises(ValueError, match=r"clip_head.*positional_embedding.*577"):
        pconv.install_clip_weights(full_meta_model, state)
    head = zero_stride(clip_spec("full", head=True, text=False))
    tree = {"clip_head": {"clip_visual": pconv.convert_clip_vision(head)}}
    _, unfilled = match_flax_tree(full_meta_model, tree)
    assert not [n for n in unfilled if n.startswith("clip_head.clip_visual.")]


def test_sd_text_hugging_face_layout(tiny_dicts):
    """Reference fault 1 (ROADMAP C23): CompVis SD v1 checkpoints hold the
    text encoder as Hugging Face ``CLIPTextModel`` names, which JAX's
    ``install_sd_weights`` cannot read (``KeyError``). The port repacks
    them: the tree equals JAX's ``convert_clip_text`` of the same weights
    packed by hand into the OpenAI layout, less ``text_projection``, which
    the layout does not have (and the SD tower never applies)."""
    pytest.importorskip("jax")
    import odise_tpu.model_zoo.convert as jconv

    hf, _ = fill(sd_spec("tiny", "hf"))
    p = "cond_stage_model.transformer."
    text = {k[len(p):]: v for k, v in hf.items() if k.startswith(p)}
    openai = {"token_embedding.weight": text["text_model.embeddings.token_embedding.weight"],
              "positional_embedding": text["text_model.embeddings.position_embedding.weight"],
              "ln_final.weight": text["text_model.final_layer_norm.weight"],
              "ln_final.bias": text["text_model.final_layer_norm.bias"],
              "text_projection": np.zeros((16, 16), np.float32)}
    b, o = "text_model.encoder.layers.0", "transformer.resblocks.0"
    for kind in ("weight", "bias"):
        openai[f"{o}.attn.in_proj_{kind}"] = np.concatenate(
            [text[f"{b}.self_attn.q_proj.{kind}"], text[f"{b}.self_attn.k_proj.{kind}"],
             text[f"{b}.self_attn.v_proj.{kind}"]])
        openai[f"{o}.attn.out_proj.{kind}"] = text[f"{b}.self_attn.out_proj.{kind}"]
        openai[f"{o}.ln_1.{kind}"] = text[f"{b}.layer_norm1.{kind}"]
        openai[f"{o}.ln_2.{kind}"] = text[f"{b}.layer_norm2.{kind}"]
        openai[f"{o}.mlp.c_fc.{kind}"] = text[f"{b}.mlp.fc1.{kind}"]
        openai[f"{o}.mlp.c_proj.{kind}"] = text[f"{b}.mlp.fc2.{kind}"]
    want = jconv.convert_clip_text(openai, layers=1)
    del want["text_projection"]
    _assert_same_tree(pconv.convert_clip_text(pconv.hf_clip_text_to_openai(text, 1), 1), want)

    from odise_torch.model_zoo.factory import build_category_odise

    model = build_category_odise("tiny", device="cpu")
    sd_text = model.backbone.feature_extractor.ldm_extractor.sd_text
    proj = sd_text.text_projection.detach().clone()
    pconv.install_sd_weights(model, hf)
    assert torch.equal(sd_text.text_projection, proj)
    assert torch.equal(sd_text.token_embedding.weight,
                       torch.from_numpy(text["text_model.embeddings.token_embedding.weight"]))

    with pytest.raises(KeyError, match="token_embedding"):
        jconv.install_sd_weights({}, hf)


def test_build_with_weights_equals_jax():
    """A TINY port model with the CLIP head built by the port's
    ``build_with_weights`` from the reference-layout dicts gives JAX's
    ``build_with_weights`` model's activations, eval logits and panoptic
    map on the ramp image, stage by stage within ``PARITY["tiny"]``'s
    tolerances (the JAX side stored in ``tests/data/torch_tiny_reference
    .npz``: a JAX TINY model initialises for over a minute on a CPU)."""
    errors, agreement, _ = port_parity("tiny", device="cpu")
    assert "clip_mask_cls" in errors and "tap_7" in errors and "eval_mask_cls" in errors
    missed = {k: v for k, v in errors.items() if not v[0] <= v[2]}
    assert not missed, missed
    assert agreement == 1.0


def test_partial_loader_raises_before_writing():
    """``load_flax_subtree`` raises ``KeyError`` on a leaf that names no
    tensor and ``ValueError`` on a shape that does not fit, and writes
    nothing in either case; it returns the tensors it left unfilled."""
    from odise_torch.model_zoo.factory import build_category_odise

    model = build_category_odise("tiny", device="cpu")
    head = model.category_head
    before = {k: v.clone() for k, v in model.state_dict().items()}
    good = {"category_head": {"text_proj": {"kernel": np.ones((16, 32), np.float32),
                                            "bias": np.ones(32, np.float32)}}}
    with pytest.raises(KeyError, match="category_head/no_such"):
        load_flax_subtree(model, {"category_head": {**good["category_head"],
                                                    "no_such": np.ones(3, np.float32)}})
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_subtree(model, {"category_head": {**good["category_head"],
                                                    "null_embed": np.ones((2, 16), np.float32)}})
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    unfilled = load_flax_subtree(model, good)
    assert torch.equal(head.text_proj.weight, torch.ones(32, 16))
    assert "category_head.null_embed" in unfilled
    assert "category_head.text_proj.weight" not in unfilled


def test_installers_refuse_a_partial_tower(tiny_dicts):
    """An installer raises when its checkpoint leaves a tensor of its tower
    unfilled; the reference's 1x1 ``mask_features`` (ROADMAP C25) does not
    fit the 3x3 convolution both packages build."""
    from odise_torch.model_zoo.factory import build_category_odise

    model = build_category_odise("tiny", device="cpu")
    sd = {k: v for k, v in tiny_dicts["sd"].items() if "out_layers.3" not in k}
    with pytest.raises(KeyError):  # the map itself misses the key
        pconv.install_sd_weights(model, sd)
    odise = dict(tiny_dicts["odise"])
    del odise["category_head.text_proj.weight"]
    with pytest.raises(KeyError, match="category_head.null_embed|category_head.text_proj"):
        pconv.install_odise_trainable(model, odise)
    odise = dict(tiny_dicts["odise"])
    odise["sem_seg_head.pixel_decoder.mask_features.weight"] = np.zeros((32, 32, 1, 1),
                                                                        np.float32)
    with pytest.raises(ValueError, match="mask_features"):
        pconv.install_odise_trainable(model, odise)


if __name__ == "__main__":
    for scale in sys.argv[1:] or ("tiny", "full"):
        write_reference(scale)
