"""The port's whole eval slice against the JAX package, and its structure.

* TINY CategoryODISE with the CLIP head in both packages, the same
  perturbed parameters: forward_eval_trunk, forward_eval_head,
  semantic_inference, and panoptic_inference on identical inputs. The JAX
  model's outputs are stored (``tests/torch_stored.py``; its jitted slice
  compiles for tens of seconds), and ``test_stored_jax_side_is_jax`` runs
  its head live on them.
* The FULL model built on the meta device against the shapes of the JAX
  FULL eval model (odise_tpu/model_zoo/bench_manifest.json.gz).
* The port imports no JAX, and the stored SD noise is JAX's.
"""

import gzip
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_tpu.model_zoo.factory import build_category_odise as jax_build  # noqa: E402
from odise_tpu.models import inference as jinf  # noqa: E402
from odise_tpu.models.odise import CategoryODISE as JCategoryODISE  # noqa: E402
from odise_torch.model_zoo.factory import build_category_odise  # noqa: E402
from odise_torch.model_zoo.from_jax import flax_leaf_to_torch, flax_to_torch_name  # noqa: E402
from odise_torch.models import inference  # noqa: E402
from odise_torch.models.clip.tokenizer import tokenize  # noqa: E402

from . import torch_stored  # noqa: E402
from .test_torch_towers import perturbed_params  # noqa: E402
from .torch_threads import one_thread  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
# 128-px backbone input: at TINY's default 64 px the UNet's last level is
# 1x1 with one channel per GroupNorm group, a normalisation of a single
# value that amplifies rounding noise by ~300x in both packages
SIZE = 128
VOCAB = (("cat", "feline"), ("dog",), ("grass",))
THING = np.array([True, True, False])


def _jax_model():
    return jax_build("tiny", dtype=jnp.float32, backbone_in_size=(SIZE, SIZE))


def jax_shapes():
    jm = _jax_model()
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((3, 16)),
        method=JCategoryODISE.init_full))


def stored_inputs(shapes):
    """The JAX side's inputs: perturbed parameters on the JAX model's
    shapes, the image, the vocabulary's token ids with and without the
    prompt, and the category overlap."""
    rng = np.random.RandomState(8)
    return dict(params=perturbed_params(shapes, seed=7),
                img=rng.rand(1, SIZE, SIZE, 3).astype(np.float32),
                tokens=tokenize([s for syns in VOCAB for s in syns]),
                prompted=tokenize([f"a photo of a {syns[0]}" for syns in VOCAB]),
                overlap=np.array([1, 0, 1], np.int32))


CLIP_LABELS = tuple((s[0],) for s in VOCAB)


def _jax_head(jm, p, trunk, tok, ptok, ovl):
    text = jm.apply(p, tok, method=JCategoryODISE.encode_vocab)
    clip_text = jm.apply(p, ptok, method=JCategoryODISE.encode_vocab)
    head_in = {k: v for k, v in trunk.items() if k != "mask_pred"}
    return text, jm.apply(p, head_in, text, VOCAB, clip_text, CLIP_LABELS, ovl,
                          method=JCategoryODISE.forward_eval_head)


def jax_outputs(inputs):
    """The JAX eval slice, jitted: the trunk, the vocabulary's text
    embeddings and mask_cls (``tests/torch_stored.py`` keeps them)."""
    jm = _jax_model()

    def j_eval(p, x, tok, ptok, ovl):
        trunk = jm.apply(p, x, method=JCategoryODISE.forward_eval_trunk)
        return (trunk,) + _jax_head(jm, p, trunk, tok, ptok, ovl)

    trunk, text, cls = jax.jit(j_eval)(*(jax.tree_util.tree_map(jnp.asarray, inputs[k]) for k in (
        "params", "img", "tokens", "prompted", "overlap")))
    out = {f"trunk/{k}": np.asarray(v) for k, v in trunk.items()}
    out.update(text=np.asarray(text), cls=np.asarray(cls))
    return out


@pytest.fixture(scope="module")
def slice_outputs():
    from odise_torch.model_zoo.from_jax import load_flax_params

    inputs = stored_inputs(torch_stored.shapes("model"))
    stored = torch_stored.load("model", inputs)
    pm = build_category_odise("tiny", device="cpu", backbone_in_size=(SIZE, SIZE))
    load_flax_params(pm, inputs["params"])
    img, tokens, prompted, overlap = (inputs[k] for k in ("img", "tokens", "prompted",
                                                          "overlap"))
    with torch.no_grad():
        p_trunk = pm.forward_eval_trunk(torch.from_numpy(img))
        p_text = pm.encode_vocab(torch.from_numpy(tokens).long())
        p_clip_text = pm.encode_vocab(torch.from_numpy(prompted).long())
        p_cls = pm.forward_eval_head(p_trunk, p_text, VOCAB, p_clip_text,
                                     CLIP_LABELS, torch.from_numpy(overlap))
    return dict(j_trunk={k[len("trunk/"):]: v for k, v in stored.items()
                         if k.startswith("trunk/")},
                j_text=stored["text"], j_cls=stored["cls"], inputs=inputs,
                p_trunk=p_trunk, p_text=p_text, p_cls=p_cls.numpy())


def test_stored_jax_side_is_jax(slice_outputs):
    """The stored JAX side (``tests/data/torch_stored_model.npz``) is the
    JAX package's: its ``encode_vocab`` and ``forward_eval_head``, run live
    on the stored trunk outputs, give the stored text embeddings and
    mask_cls within 1e-5 (the same float32 ops, jitted apart from the
    trunk)."""
    inputs = slice_outputs["inputs"]
    jm = _jax_model()
    text, cls = jax.jit(lambda p, t, *a: _jax_head(jm, p, t, *a))(
        *(jax.tree_util.tree_map(jnp.asarray, x) for x in (
            inputs["params"], slice_outputs["j_trunk"], inputs["tokens"], inputs["prompted"],
            inputs["overlap"])))
    np.testing.assert_allclose(np.asarray(text), slice_outputs["j_text"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(cls), slice_outputs["j_cls"], rtol=1e-5, atol=1e-5)


def test_trunk_matches_jax(slice_outputs):
    """Trunk dict at 1e-4: float32 through SD, the deformable encoder and
    the masked decoder (measured gap ~4e-5 on mask logits of magnitude ~10)."""
    j, p = slice_outputs["j_trunk"], slice_outputs["p_trunk"]
    assert set(j) == set(p)
    assert p["mask_pred"].shape == (1, 10, SIZE, SIZE)
    for k in j:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_head_matches_jax(slice_outputs):
    """encode_vocab at 1e-5 and mask_cls [1, Q, K+1] at 1e-4."""
    np.testing.assert_allclose(slice_outputs["p_text"].numpy(),
                               np.asarray(slice_outputs["j_text"]), rtol=1e-5, atol=1e-5)
    assert slice_outputs["p_cls"].shape == (1, 10, len(VOCAB) + 1)
    np.testing.assert_allclose(slice_outputs["p_cls"], slice_outputs["j_cls"],
                               rtol=1e-4, atol=1e-4)


def test_semantic_inference_matches_jax(slice_outputs):
    mask_cls = slice_outputs["j_cls"][0]
    mask_pred = np.asarray(slice_outputs["j_trunk"]["mask_pred"])[0]
    ref = jinf.semantic_inference(jnp.asarray(mask_cls), jnp.asarray(mask_pred))
    out = inference.semantic_inference(torch.tensor(mask_cls),
                                       torch.tensor(mask_pred))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _panoptic_case(case, slice_outputs):
    if case == "model":
        return (np.array(slice_outputs["j_cls"][0]),
                np.array(slice_outputs["j_trunk"]["mask_pred"])[0])
    # many segments: query q owns block q of a 3x4 grid (plus noise), two
    # queries of the stuff class 2 merge into one segment, query 7 is null,
    # query 10 is swallowed by query 11 (fails the overlap threshold)
    rng = np.random.RandomState(9)
    Q = 12
    mask_cls = rng.randn(Q, 4).astype(np.float32)
    mask_cls[np.arange(Q), rng.randint(0, 3, Q)] += 8.0
    mask_cls[3, 2] = mask_cls[5, 2] = 20.0
    mask_cls[7, 3] = 30.0
    mask_pred = rng.randn(Q, 48, 48).astype(np.float32) - 6.0
    for q in range(Q):
        r, c = divmod(q, 4)
        mask_pred[q, r * 16:(r + 1) * 16, c * 12:(c + 1) * 12] += 12.0
    mask_pred[11, 32:48, 24:48] += 12.0
    return mask_cls, mask_pred


@pytest.mark.parametrize("case", ["model", "synthetic"])
def test_panoptic_inference_agrees_exactly(case, slice_outputs):
    mask_cls, mask_pred = _panoptic_case(case, slice_outputs)
    ref = jinf.panoptic_inference(jnp.asarray(mask_cls), jnp.asarray(mask_pred),
                                  jnp.asarray(THING), object_mask_threshold=0.0,
                                  overlap_threshold=0.8)
    out = inference.panoptic_inference(torch.from_numpy(mask_cls),
                                       torch.from_numpy(mask_pred),
                                       torch.from_numpy(THING),
                                       object_mask_threshold=0.0,
                                       overlap_threshold=0.8)
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if case == "synthetic":
        assert int(out.num_segments) >= 3


def test_full_structure_matches_jax_manifest():
    """The FULL port model on the meta device has one tensor for each leaf
    of the JAX FULL eval model, of the same shape after the layout map
    (the vocabulary text tower, absent from the manifest, aside)."""
    with gzip.open(REPO / "odise_tpu/model_zoo/bench_manifest.json.gz", "rt") as f:
        manifest = json.load(f)
    labels = tuple((f"category {i}",) for i in range(133))
    model = build_category_odise("full", train_labels=labels, device="meta",
                                 dtype=torch.bfloat16)
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.startswith("text_encoder.")}
    mapped = {}
    for key, (shape, _) in manifest.items():
        path = tuple(key.split("/")[1:])
        mapped[flax_to_torch_name(path)] = tuple(
            flax_leaf_to_torch(path, np.empty(shape, np.uint8)).shape)
    assert len(manifest) == 2146
    assert port == mapped
    n = sum(v.numel() for k, v in model.state_dict().items())
    assert n > 1_500_000_000  # SD + two ViT-L + text towers


def test_entry_point_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_train_loader
    from odise_torch.data.synthetic import make_shapes_records
    from odise_torch.model_zoo.factory import build_caption_odise

    with pytest.raises(RuntimeError, match="CUDA"):
        build_category_odise("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_category_odise("tiny", use_checkpoint=True, slide_training=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_caption_odise("tiny", with_clip_head=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        COCOPanopticDatasetMapper(image_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):  # its default mapper needs the card
        next(build_train_loader(make_shapes_records(1, size=32), lambda r, rng: (
            COCOPanopticDatasetMapper(image_size=32)(r, rng)), 1))
    cpu = COCOPanopticDatasetMapper(image_size=32, device="cpu")
    batch = next(build_train_loader(make_shapes_records(1, size=32), cpu, 1))
    assert batch["image"].device.type == "cpu"
    # FULL trains on COCO panoptic's prompt-engineered labels by default, as
    # the JAX factory does
    from odise_tpu.data.build import get_openseg_labels

    model = build_category_odise("full", device="meta", dtype=torch.bfloat16)
    assert model.train_labels == tuple(
        tuple(l) for l in get_openseg_labels("coco_panoptic", True))
    assert model.train_labels == jax_build("full").train_labels


def test_port_imports_no_jax():
    """With jax, flax, odise_tpu, PIL and cv2 unimportable (the card's
    machine has neither image library): import every odise_torch module,
    build TINY CategoryODISE on the CPU and run forward_eval, evaluate it on
    one in-memory synthetic record (prefetched) and count PQ's pixel pairs
    with the host C++ op, build TINY CaptionODISE, take one TINY
    CategoryODISE train step (mapper, loader, partition, optimizer,
    Trainer), load every file of the port's config tree and run the train
    and eval CLI for one step; the launcher and the collectives' helpers
    at world size 1; register a dataset of PNG files, map one
    record and evaluate one image from its files; and a JPEG read on the
    CPU fails naming PIL. chip_smoke.py must not import them either, and
    phase 11 (e)'s loader of the stored JAX train step, run first with JAX
    importable, imports none of jax, jaxlib, flax, optax and odise_tpu."""
    script = textwrap.dedent("""
        import sys
        from tests import test_torch_full_train as full_train
        dicts, shas = full_train.train_inputs("tiny")
        assert "category/relu/keys" in full_train.load_reference("tiny", shas)
        del dicts
        assert not [k for k in sys.modules
                    if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "odise_tpu")]
        for name in ("jax", "jaxlib", "flax", "optax", "odise_tpu", "PIL", "cv2"):
            sys.modules[name] = None
        import importlib, pkgutil
        import torch
        import odise_torch
        for m in pkgutil.walk_packages(odise_torch.__path__, "odise_torch."):
            importlib.import_module(m.name)
        from odise_torch.engine.launch import launch
        from odise_torch.parallel import gather_pickled, get_world_size
        assert launch(gather_pickled, 1, args=("x",), device="cpu") == ["x"]
        assert get_world_size() == 1
        from odise_torch.model_zoo.factory import build_category_odise
        from odise_torch.models.clip.tokenizer import tokenize
        model = build_category_odise("tiny", device="cpu")
        with torch.no_grad():
            text = model.encode_vocab(torch.from_numpy(tokenize(["a", "b", "c"])).long())
            cls, pred = model.forward_eval(torch.rand(1, 64, 64, 3), text,
                                           (("a",), ("b",), ("c",)))
        assert cls.shape == (1, 10, 4) and pred.shape == (1, 10, 64, 64)
        assert bool(torch.isfinite(cls).all()) and bool(torch.isfinite(pred).all())
        from odise_torch.data.synthetic import SYNTH_LABELS, SYNTH_THING, make_shapes_records
        from odise_torch.evaluation.run import evaluate_open_vocab
        from odise_torch.model_zoo.factory import build_caption_odise
        from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary
        infer = OpenPanopticInference(model, build_open_vocabulary(
            model, SYNTH_LABELS, thing_mask=SYNTH_THING))
        r = evaluate_open_vocab(infer, make_shapes_records(1, size=48), labels=SYNTH_LABELS,
                                thing_mask=SYNTH_THING, short_side=64, max_size=160)
        assert r["images"] == 1 and r["host_fallback_images"] == 0
        from odise_torch.utils import host_ops
        assert [a.tolist() for a in host_ops.pq_intersections([[1, 2]], [[1, 1]])] == [
            [1, 2], [1, 1], [1, 1]]
        caption = build_caption_odise("tiny", device="cpu")
        assert type(caption).__name__ == "CaptionODISE"
        from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
        from odise_torch.data.loader import build_train_loader
        from odise_torch.engine import (Trainer, make_category_train_step, make_optimizer,
                                        partition_params)
        from odise_torch.losses import CriterionConfig
        trainable, _ = partition_params(model)
        step = make_category_train_step(model, make_optimizer(trainable),
                                        CriterionConfig(num_classes=3, num_points=16),
                                        text, (("a",), ("b",), ("c",)))
        mapper = COCOPanopticDatasetMapper(image_size=64, max_instances=3, device="cpu")
        trainer = Trainer(step, build_train_loader(make_shapes_records(2, size=48), mapper, 1),
                          torch.Generator().manual_seed(0))
        trainer.train(0, 1)
        assert trainer.metrics_history[0]["grad_norm"] > 0
        import glob, tempfile
        from odise_torch import train_net
        from odise_torch.config import load_config
        configs = sorted(glob.glob("odise_torch/configs/**/*.py", recursive=True))
        assert len(configs) == 13, configs
        for path in configs:
            load_config(path)
        with tempfile.TemporaryDirectory() as out:
            run = train_net.main(["--config-file",
                                  "odise_torch/configs/Panoptic/odise_label_tiny_synth.py",
                                  "--output", out, "--max-eval-images", "1", "train.device=cpu",
                                  "train.max_iter=1", "train.eval_period=1"])
        assert run.history[0]["grad_norm"] > 0 and run.eval_results["main"]["images"] == 1
        from odise_torch.data.catalog import DatasetCatalog, MetadataCatalog
        from odise_torch.data.image_io import read_image
        from odise_torch.data.synthetic import synth_categories, write_shapes_dataset
        with tempfile.TemporaryDirectory() as d:
            files = write_shapes_dataset(d, 1, size=48)
            DatasetCatalog.register("_png_files", lambda: files)
            MetadataCatalog.get("_png_files").set(ignore_label=255,
                                                  categories=synth_categories())
            rec = DatasetCatalog.get("_png_files")[0]
            assert "image" not in rec and mapper(rec)["gt_valid"].any()
            r = evaluate_open_vocab(infer, DatasetCatalog.get("_png_files"), labels=SYNTH_LABELS,
                                    thing_mask=SYNTH_THING, short_side=64, max_size=160)
            assert r["images"] == 1 and r["host_fallback_images"] == 0
            jpeg = d + "/a.jpg"
            with open(jpeg, "wb") as f:
                f.write(bytes([0xFF, 0xD8, 0xFF, 0xE0]) + bytes(16))
            try:
                read_image(jpeg, "cpu")
                raise AssertionError("a JPEG was decoded on the CPU without PIL")
            except ImportError as err:
                assert "PIL" in str(err), err
        assert not any(k.split(".")[0] in ("jax", "flax", "odise_tpu", "PIL", "cv2")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    # one intra-op thread: the suite's parallel processes share the cores
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr

    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert "odise_torch" in imported
    assert not imported & {"jax", "jaxlib", "flax", "optax", "odise_tpu", "PIL", "cv2"}


def test_shared_noise_is_jax_prng_key_42():
    stored = np.load(REPO / "odise_torch/models/backbone/shared_noise_seed42.npy")
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (1, 64, 64, 4),
                                       jnp.float32))
    assert stored.dtype == np.float32 and stored.shape == (1, 64, 64, 4)
    assert np.array_equal(stored.view(np.uint32), ref.view(np.uint32))
