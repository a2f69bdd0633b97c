"""The port's demo (``odise_torch/demo.py``) against ``demo/demo.py``, and
the rest of the demo's slice: the CLIP adapter's functions and
``CLIPOpenClassEmbed`` against the JAX package (CPU, float32, TINY).

* ``segment`` against JAX's demo steps (``demo/demo.py:194-224``: cv2
  resize of the short side, zero padding to 64, ``OpenPanopticInference``,
  ``panoptic_inference``, crop) on one image, with the same weights (JAX's
  outputs stored by ``tests/torch_stored.py``; its ``panoptic_inference``
  rerun live on them);
* ``python -m odise_torch.demo`` end to end on the TINY synthetic config on
  the CPU: a PNG in, an overlay out, its segments printed;
* the vocabulary merge and the checkpoint-kind rule of ``--init-from``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_torch.model_zoo.from_jax import load_flax_params  # noqa: E402

from .test_torch_towers import nchw, perturbed_params  # noqa: E402
from .torch_threads import one_thread  # noqa: F401,E402

LABELS = (("cat", "feline"), ("dog",), ("grass",))
SIZE = 64


IMAGE_SEED = 5


def _jax_model():
    from odise_tpu.model_zoo.factory import build_category_odise as jax_build

    return jax_build("tiny", train_labels=LABELS, backbone_in_size=(128, 128))


def _padded(img):
    """The demo's steps before the model (``demo/demo.py:194-224``): the
    short side resized to ``SIZE`` by the port (cv2's rule), zero padding to
    a multiple of 64."""
    from odise_torch.data.transforms import resize_image

    scale = SIZE / min(img.shape[:2])
    nh, nw = int(img.shape[0] * scale + 0.5), int(img.shape[1] * scale + 0.5)
    h64, w64 = -(-nh // 64) * 64, -(-nw // 64) * 64
    padded = np.zeros((1, h64, w64, 3), np.float32)
    padded[0, :nh, :nw] = resize_image(torch.from_numpy(img), nh, nw).numpy() / 255.0
    return padded


def jax_shapes():
    from odise_tpu.models.odise import CategoryODISE as JCategoryODISE

    jm = _jax_model()
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((4, 16)),
        method=JCategoryODISE.init_full))


def stored_inputs(shapes):
    """TINY CategoryODISE's perturbed parameters on the JAX model's shapes,
    a 128-px backbone (well-conditioned GroupNorm, ROADMAP C6), the logit
    scales at their start (1/0.07) so that queries classify as labels
    rather than null; a 50x70 uint8 image, resized and padded as the demo
    does."""
    params = perturbed_params(shapes, seed=11)
    p = params["params"]
    # logit scales as the modules start them (exp = 1/0.07), not near 0
    for scope in (p["sem_seg_head"]["transformer_predictor"]["post_mask_embed"],
                  p["clip_head"]):
        scope["logit_scale"] = np.full((), np.log(1 / 0.07), np.float32)
    img = (np.random.RandomState(IMAGE_SEED).rand(50, 70, 3) * 255).astype(np.uint8)
    return dict(params=params, image=img, padded=_padded(img))


def _jax_panoptic(mask_cls, mask_pred):
    from odise_tpu.models.inference import panoptic_inference as jax_panoptic

    return jax_panoptic(jnp.asarray(mask_cls)[0], jnp.asarray(mask_pred)[0],
                        jnp.ones(len(LABELS), bool), object_mask_threshold=0.0,
                        overlap_threshold=0.0)


def jax_outputs(inputs):
    """JAX's demo steps after the padding: ``OpenPanopticInference`` over
    the vocabulary (every label a thing) and ``panoptic_inference``
    (``tests/torch_stored.py`` keeps their outputs)."""
    from odise_tpu.models.wrapper import (OpenPanopticInference as JInfer,
                                          build_open_vocabulary as jax_vocab)

    jm = _jax_model()
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    jvocab = jax_vocab(jm, params, [list(l) for l in LABELS],
                       thing_mask=np.ones(len(LABELS), bool), with_clip_head=True)
    mask_cls, mask_pred = JInfer(jm, params, jvocab)(jnp.asarray(inputs["padded"]))
    pan = _jax_panoptic(mask_cls, mask_pred)
    return {"mask_cls": np.asarray(mask_cls), "mask_pred": np.asarray(mask_pred),
            "panoptic_seg": np.asarray(pan.panoptic_seg),
            "segment_category": np.asarray(pan.segment_category),
            "num_segments": np.asarray(pan.num_segments)}


@pytest.fixture(scope="module")
def demo_models():
    """The stored JAX side's inputs and outputs (``tests/torch_stored.py``),
    and the port model with the same parameters."""
    from odise_torch.model_zoo.factory import build_category_odise

    from . import torch_stored

    inputs = stored_inputs(torch_stored.shapes("demo"))
    stored = torch_stored.load("demo", inputs)
    pm = build_category_odise("tiny", train_labels=LABELS, backbone_in_size=(128, 128),
                              device="cpu")
    load_flax_params(pm, inputs["params"])
    return inputs, stored, pm


def test_stored_jax_side_is_jax(demo_models):
    """The stored JAX side (``tests/data/torch_stored_demo.npz``) is the
    JAX package's: its ``panoptic_inference``, run live on the stored
    mask_cls and mask_pred, gives the stored panoptic map, categories and
    segment count exactly."""
    _, stored, _ = demo_models
    pan = _jax_panoptic(stored["mask_cls"], stored["mask_pred"])
    assert np.array_equal(np.asarray(pan.panoptic_seg), stored["panoptic_seg"])
    assert np.array_equal(np.asarray(pan.segment_category), stored["segment_category"])
    assert int(pan.num_segments) == int(stored["num_segments"])


def test_segment_matches_jax_demo(demo_models):
    """One 50x70 uint8 image at ``--image-size`` 64 (resized to 64x90,
    padded to 64x128). The port's resize is cv2's to one level (cv2 weighs
    uint8 pixels in fixed point). From the image the port resized, JAX's
    demo steps (stored) give the same segment count and categories, and
    panoptic maps that agree on at least 99.5% of the pixels (segment ids
    up to a permutation; a random TINY model's query masks are near ties,
    ROADMAP C12). Every label is a thing here: the random queries all pick
    one label, which as stuff would merge into a single segment."""
    import cv2

    from odise_torch.demo import segment
    from odise_torch.models.wrapper import build_open_vocabulary
    from odise_torch.verify_parity import panoptic_agreement

    inputs, stored, pm = demo_models
    img = inputs["image"]
    things = np.ones(len(LABELS), bool)
    vocab = build_open_vocabulary(pm, LABELS, thing_mask=things, with_clip_head=True)
    out = segment(pm, vocab, img, image_size=SIZE, overlap_threshold=0.0)

    # demo/demo.py:194-224, as it runs them
    scale = SIZE / min(img.shape[:2])
    nh, nw = int(img.shape[0] * scale + 0.5), int(img.shape[1] * scale + 0.5)
    resized = cv2.resize(img, (nw, nh))
    assert out.image.shape == (nh, nw, 3) and out.panoptic_seg.shape == (nh, nw)
    assert int(np.abs(out.image.numpy().astype(int) - resized.astype(int)).max()) <= 1
    # the stored JAX side ran on the port's resized image, padded
    assert np.array_equal(_padded(img)[0, :nh, :nw], out.image.numpy() / np.float32(255.0))
    jseg = stored["panoptic_seg"][:nh, :nw]
    jn = int(stored["num_segments"])
    assert jn >= 2 and out.num_segments == jn
    assert np.array_equal(out.segment_category.numpy(), stored["segment_category"])
    assert panoptic_agreement(out.panoptic_seg.numpy(), jseg) >= 0.995


def test_demo_cli_on_the_cpu(tmp_path, capsys):
    """``python -m odise_torch.demo`` on the TINY synthetic config with
    ``train.device=cpu``: reads a PNG (PIL), writes an overlay of the
    resized size, prints the vocabulary and the segments."""
    from PIL import Image

    from odise_torch import demo

    src = tmp_path / "in.png"
    Image.fromarray((np.random.RandomState(1).rand(48, 80, 3) * 255).astype(np.uint8)
                    ).save(src)
    demo.main(["--config-file", "odise_torch/configs/Panoptic/odise_label_tiny_synth.py",
               "--input", str(src), "--output", str(tmp_path / "out"), "--image-size", "64",
               "--vocab", "black pickup truck, pickup truck; sky", "train.device=cpu"])
    printed = capsys.readouterr().out
    assert "Vocabulary: 135 categories" in printed
    assert f"{src}: " in printed and " segments -> " in printed
    written = np.asarray(Image.open(tmp_path / "out" / "in.png"))
    assert written.shape == (64, 107, 3) and written.dtype == np.uint8


def test_build_demo_vocab_merges_as_jax():
    """``build_demo_vocab`` gives ``demo/demo.py``'s merged vocabulary and
    thing flags for ``--vocab``, ``--caption`` and every builtin label
    set."""
    import argparse
    import importlib.util
    from pathlib import Path

    from odise_torch.demo import build_demo_vocab, parse_args

    # by its path: "demo" is also the name of the repository's demo/ directory
    path = Path(__file__).resolve().parent.parent / "demo" / "demo.py"
    spec = importlib.util.spec_from_file_location("_jax_demo", path)
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    args = parse_args(["--vocab", "black pickup truck, pickup truck; sky",
                       "--caption", "a dog on grass", "--label", "COCO", "ADE", "LVIS"])
    jargs = argparse.Namespace(vocab=args.vocab, caption=args.caption, label=args.label)
    labels, things = build_demo_vocab(args)
    jlabels, jthings = jax_demo.build_demo_vocab(jargs)
    assert labels == jlabels and np.array_equal(things, jthings)
    assert labels[:2] == [["black pickup truck", "pickup truck"], ["sky"]]
    assert len(labels) == 2 + len(jlabels) - 2 and things.dtype == bool


def test_init_from_decides_by_keys(tmp_path):
    """``--init-from``: a released ODISE state (``sem_seg_head.*``) goes
    through the converter, a port checkpoint through ``Checkpointer``, and
    any other file raises (the JAX demo falls back on ``except
    Exception``)."""
    from odise_torch.demo import load_init
    from odise_torch.engine.checkpoint import Checkpointer
    from odise_torch.model_zoo.factory import build_category_odise

    from .test_torch_convert import fill, odise_spec

    model = build_category_odise("tiny", device="cpu")
    state, _ = fill(odise_spec("tiny"))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               tmp_path / "odise.pth")
    assert load_init(model, str(tmp_path / "odise.pth")) == "reference"
    assert torch.equal(model.category_head.null_embed,
                       torch.from_numpy(state["category_head.null_embed"]))

    other = build_category_odise("tiny", device="cpu")
    path = Checkpointer(str(tmp_path / "ck")).save("model_final", dict(model.named_parameters()))
    assert load_init(other, path) == "port"
    assert torch.equal(other.category_head.null_embed, model.category_head.null_embed)

    torch.save({"weights": torch.zeros(3)}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="neither"):
        load_init(other, str(tmp_path / "other.pth"))


def test_adapter_matches_jax():
    """``embed_image``, ``embed_text``, ``build_text_embed``,
    ``build_mask_attn_mask`` and ``MaskCLIP`` against the JAX adapter on a
    TINY ViT and text tower with the same perturbed parameters (1e-5; the
    masks exactly)."""
    from odise_tpu.models.clip import adapter as jad
    from odise_tpu.models.clip.model import TextTransformer as JText
    from odise_tpu.models.clip.model import VisionTransformer as JViT

    from odise_torch.models.clip import adapter as pad
    from odise_torch.models.clip.model import TextTransformer, VisionTransformer
    from odise_torch.models.clip.tokenizer import tokenize

    vit_kw = dict(image_size=32, patch_size=8, width=16, layers=1, heads=2, embed_dim=16)
    jvit = JViT(**vit_kw)
    vparams = perturbed_params(jax.eval_shape(lambda: jvit.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))), seed=2)
    pvit = VisionTransformer(**vit_kw)
    load_flax_params(pvit, vparams)
    text_kw = dict(width=16, layers=1, heads=2, embed_dim=16)
    jtext = JText(**text_kw)
    tparams = perturbed_params(jax.eval_shape(lambda: jtext.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 77), jnp.int32))), seed=3)
    ptext = TextTransformer(**text_kw)
    load_flax_params(ptext, tparams)

    rng = np.random.RandomState(4)
    img = rng.rand(2, 40, 48, 3).astype(np.float32)
    j = jad.embed_image(lambda x: jvit.apply(vparams, x), jnp.asarray(img), 32)
    with torch.no_grad():
        p = pad.embed_image(pvit, nchw(img), 32)
    for a, b in zip(p, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    tokens = tokenize(["a cat", "a photo of a dog", "grass"])
    j = jad.embed_text(lambda t: jtext.apply(tparams, t), jnp.asarray(tokens))
    with torch.no_grad():
        p = pad.embed_text(ptext, torch.from_numpy(tokens).long())
    for a, b in zip(p, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    labels = [["cat", "feline"], ["dog"], ["grass"]]
    j = jad.build_text_embed(lambda t: jtext.apply(tparams, t), labels, batch_size=2,
                             normalize=True)
    with torch.no_grad():
        p = pad.build_text_embed(ptext, labels, batch_size=2, normalize=True)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)

    logits = (rng.randn(2, 3, 32, 32) * 3).astype(np.float32)
    j = jad.build_mask_attn_mask(jnp.asarray(logits), 8, 16)
    p = pad.build_mask_attn_mask(torch.from_numpy(logits), 8, 16)
    assert p.shape == (2, 3 + 1 + 16, 3 + 1 + 16)
    assert np.array_equal(p.numpy(), np.asarray(j)) and 0 < int(p.sum()) < p.numel()

    masks = (rng.randn(2, 3, 16, 16) * 3).astype(np.float32)
    jclip = jad.MaskCLIP(jvit, image_size=32, patch_size=8)
    pclip = pad.MaskCLIP(pvit, image_size=32, patch_size=8)
    j = jclip.get_mask_embed(vparams, jnp.asarray(img), jnp.asarray(masks))
    with torch.no_grad():
        p = pclip.get_mask_embed(nchw(img), torch.from_numpy(masks))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    text = rng.randn(4, 16).astype(np.float32)
    grouped = (("a", "b"), ("c",), ("d",))
    np.testing.assert_allclose(
        pad.MaskCLIP.pred_logits(p, torch.from_numpy(text), grouped).numpy(),
        np.asarray(jad.MaskCLIP.pred_logits(j, jnp.asarray(text), grouped)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("modality,null", [("text", True), ("text", False),
                                           ("image", True), ("image", False)])
@pytest.mark.parametrize("ensemble", ["max", "mean"])
def test_clip_open_class_embed_matches_jax(modality, null, ensemble):
    """``CLIPOpenClassEmbed`` against the JAX module, both projection
    modalities, with and without the null embedding, both ensembles: the
    same parameter names and shapes, logits within 1e-5."""
    from odise_tpu.models.odise import CLIPOpenClassEmbed as JEmbed

    from odise_torch.models.odise import CLIPOpenClassEmbed

    labels = (("a", "b"), ("c",), ("d", "e", "f"))
    kw = dict(labels=labels, hidden_dim=12, projection_modality=modality,
              with_null_embed=null, ensemble_method=ensemble, clip_dim=8)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 12).astype(np.float32)
    text = rng.randn(6, 8).astype(np.float32)
    jm = JEmbed(**kw)
    params = perturbed_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(text))), seed=7)
    pm = CLIPOpenClassEmbed(**kw)
    load_flax_params(pm, params)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(text)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(text)).numpy()
    assert got.shape == (2, 5, 3 + int(null)) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
