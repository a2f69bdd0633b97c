"""The port's tools against the JAX package's, on the CPU: the parameter
counts (``odise_torch/utils/parameter_count.py``, ``analyze_model.py``),
the app's inference functions (``odise_torch/app.py``), the semantic-PQ
tool (``evaluate_pq_for_semantic_segmentation.py``) and
``models/preprocess.py``.
"""

import ast
import importlib.util
import io
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odise_torch.utils.parameter_count import parameter_count, parameter_count_table
from .torch_threads import one_thread  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
K = 133
LABELS = tuple((f"c{i}",) for i in range(K))
TINY_CONFIG = str(REPO / "odise_torch" / "configs" / "Panoptic" / "odise_label_tiny_synth.py")


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def counted():
    """(JAX's tree of tools/analyze_model.py (forward_eval's init), JAX's
    tree of every submodule (init_full), the port's model) at TINY with
    the CLIP head and 133 labels."""
    from odise_tpu.model_zoo.factory import build_category_odise as jax_build

    from odise_torch.model_zoo.factory import build_category_odise

    model = jax_build("tiny", train_labels=LABELS, with_clip_head=True, use_checkpoint=False,
                      slide_training=False)
    d = model.category_head.clip_dim
    rng, img = jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))
    tool = jax.eval_shape(lambda: model.init(
        rng, img, jnp.zeros((K, d)), LABELS, jnp.zeros((K, d)), LABELS,
        jnp.zeros((K,), jnp.int32), method=type(model).forward_eval))["params"]
    full = jax.eval_shape(lambda: model.init(rng, img, jnp.zeros((K, d)),
                                             method=type(model).init_full))["params"]
    port = build_category_odise("tiny", train_labels=LABELS, with_clip_head=True,
                                use_checkpoint=False, slide_training=False, device="cpu")
    return tool, full, port


def test_parameter_count_equals_jax(counted):
    """Per dotted prefix, the port's counts equal JAX's ``parameter_count``
    of the tree of every submodule (the leaves' own names differ: a
    kernel is a weight), totals and trainable totals too; the JAX tool's
    tree lacks only the vocabulary text encoder (ROADMAP C31)."""
    from odise_tpu.utils.parameter_count import parameter_count as jax_count

    _, full, port = counted
    for trainable_only in (False, True):
        j = jax_count(full, trainable_only=trainable_only)
        p = parameter_count(port, trainable_only=trainable_only)
        common = set(j) & set(p)
        assert len(common) > (200 if trainable_only else 1000)
        assert all(j[k] == p[k] for k in common), [k for k in common if j[k] != p[k]][:5]
        leaves = ("kernel", "scale", "embedding", "weight")
        assert all(k.rsplit(".", 1)[-1] in leaves for k in set(j) ^ set(p))
    assert parameter_count(port, trainable_only=True)[""] == 110_945


def test_parameter_tables_equal_jax(counted):
    from odise_tpu.utils.parameter_count import parameter_count_table as jax_table

    tool, full, port = counted
    for trainable_only in (False, True):
        assert parameter_count_table(port, 2, trainable_only) == jax_table(full, 2, trainable_only)
    assert parameter_count_table(port, 2, True) == jax_table(tool, 2, True)


def test_analyze_model_tiny(counted):
    """``python -m odise_torch.analyze_model --scale tiny``: both tables and
    the totals, the JAX tool's text kept with the exact counts beside it."""
    from odise_torch.analyze_model import main

    _, full, port = counted
    out = io.StringIO()
    with redirect_stdout(out):
        counts = main(["--scale", "tiny", "--device", "cpu"])
    text = out.getvalue()
    assert counts == {"total": parameter_count(port)[""],
                      "trainable": parameter_count(port, trainable_only=True)[""]}
    assert "=== all parameters ===" in text and "=== trainable parameters ===" in text
    assert parameter_count_table(port, 2) in text
    assert (f"(reference: 28.1M trainable)  exact: {counts['total']:,} total, "
            f"{counts['trainable']:,} trainable") in text
    if not torch.cuda.is_available():  # the card by default, never the CPU quietly
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--scale", "tiny"])


# ------------------------------------------------------------- the app


@pytest.fixture(scope="module")
def apps():
    from odise_torch import app

    return app, load_file(REPO / "demo" / "app.py", "jax_demo_app")


def test_app_examples_and_checkboxes_equal_jax(apps):
    app, jax_app = apps
    mine, theirs = app.list_examples(), jax_app.list_examples()
    assert len(mine) == 3
    assert [[os.path.realpath(r[0])] + r[1:] for r in mine] == \
        [[os.path.realpath(r[0])] + r[1:] for r in theirs]
    for cats in (None, [], ["ADE (150 categories)"], app.CATEGORY_CHOICES,
                 ["LVIS (1203 categories)", "COCO (133 categories)"]):
        assert app.checkbox_to_label_args(cats) == jax_app.checkbox_to_label_args(cats)
    assert app.CATEGORY_CHOICES == jax_app.CATEGORY_CHOICES
    assert app.EXAMPLE_PRESETS == jax_app.EXAMPLE_PRESETS
    assert list(app.MODEL_CONFIGS) == list(jax_app.MODEL_CONFIGS)
    assert all(os.path.isfile(p) for p in app.MODEL_CONFIGS.values())


def test_app_run_inference_equals_demo_segment(apps, monkeypatch):
    """``run_inference`` on TINY (the tiny config as a dropdown choice,
    ``train.device=cpu``, short side 64): the overlay equals the
    visualizer's over ``demo.segment`` of the same model, vocabulary and
    image at the JAX app's thresholds; the model is built once and cached."""
    from odise_torch.demo import build_demo_vocab, segment
    from odise_torch.models.wrapper import build_open_vocabulary
    from odise_torch.utils.visualizer import Visualizer

    app, _ = apps
    monkeypatch.setitem(app.MODEL_CONFIGS, "tiny", TINY_CONFIG)
    monkeypatch.setattr(app, "IMAGE_SIZE", 64)
    opts = ("train.device=cpu",)
    app.build_inference.cache_clear()
    image = (np.random.RandomState(0).rand(48, 80, 3) * 255).astype(np.uint8)
    overlay = app.run_inference(image, "red car, car; sky", ["ADE (150 categories)"],
                                "tiny", opts=opts)
    model = app.build_inference("tiny", opts)
    assert app.build_inference.cache_info().hits >= 1
    import argparse

    labels, things = build_demo_vocab(argparse.Namespace(vocab="red car, car; sky",
                                                         caption="", label=["ADE"]))
    vocab = build_open_vocabulary(model, labels, thing_mask=things, with_clip_head=False)
    out = segment(model, vocab, image, 64, 0.8)
    want = Visualizer(out.image.numpy(), class_names=[l[0] for l in labels]).draw_panoptic_seg(
        out.panoptic_seg.numpy(), out.segment_category.numpy(), out.num_segments)
    assert overlay.shape == (64, 107, 3) and overlay.dtype == np.uint8
    assert np.array_equal(overlay, want)
    app.build_inference.cache_clear()


def test_app_alpha_beta_reach_the_clip_head(apps, monkeypatch):
    """``alpha`` and ``beta`` set the cached model's CLIP head."""
    app, _ = apps
    monkeypatch.setitem(app.MODEL_CONFIGS, "tiny", TINY_CONFIG)
    monkeypatch.setattr(app, "IMAGE_SIZE", 64)
    app.build_inference.cache_clear()
    opts = ("train.device=cpu", "model.with_clip_head=True")
    model = app.build_inference("tiny", opts)
    assert model.clip_head is not None
    image = np.zeros((64, 64, 3), np.uint8)
    app.run_inference(image, "", None, "tiny", alpha=0.1, beta=0.9, opts=opts)
    assert (model.clip_head.alpha, model.clip_head.beta) == (0.1, 0.9)
    assert model.sem_seg_head is app.build_inference("tiny", opts).sem_seg_head
    app.build_inference.cache_clear()


def test_app_main_without_gradio(apps, monkeypatch, capsys):
    """Without gradio both apps say so and return."""
    app, jax_app = apps
    monkeypatch.setitem(sys.modules, "gradio", None)
    assert app.main([]) is None
    assert jax_app.main() is None
    out = capsys.readouterr().out.splitlines()
    assert out == ["gradio is not installed; use python -m odise_torch.demo for CLI inference.",
                   "gradio is not installed; use demo/demo.py for CLI inference."]


# ------------------------------------------------------------- semantic PQ


def _semantic_pngs(root, seed=0):
    from odise_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    for d in ("pred", "gt"):
        os.makedirs(os.path.join(root, d))
    for i in range(3):
        gt = np.full((40, 56), 255, np.uint8)
        gt[:20] = 0
        gt[20:] = 1 + i % 2
        gt[5:15, 10:30] = 3
        gt[25:35, 30:50] = 4
        pred = gt.copy()
        pred[rng.rand(*gt.shape) < 0.05] = 2
        pred[30:, :10] = 255
        if i == 2:
            pred[5:15, 10:30] = 1  # a class missed, another over-predicted
        write_png(os.path.join(root, "gt", f"{i}.png"), gt)
        write_png(os.path.join(root, "pred", f"{i}.png"), pred)


def test_semantic_pq_equals_jax_tool(tmp_path, monkeypatch, capsys):
    from odise_torch.evaluate_pq_for_semantic_segmentation import main, seg_from_semantic

    jax_tool = load_file(REPO / "tools" / "evaluate_pq_for_semantic_segmentation.py",
                         "jax_semantic_pq")
    _semantic_pngs(str(tmp_path))
    sem = np.asarray([[0, 3, 255], [3, 7, 0]], np.uint8)
    for a, b in zip(seg_from_semantic(sem, 255), jax_tool.seg_from_semantic(sem, 255)):
        assert np.array_equal(np.asarray(a), np.asarray(b)) if isinstance(a, np.ndarray) \
            else a == b
    argv = ["--pred-dir", str(tmp_path / "pred"), "--gt-dir", str(tmp_path / "gt"),
            "--num-classes", "5"]
    mine = main(argv)
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    capsys.readouterr()
    jax_tool.main()
    theirs = ast.literal_eval(capsys.readouterr().out.strip().replace("np.float64", ""))
    assert sorted(mine) == sorted(theirs) and 0 < mine["PQ"] < 100
    for k in mine:
        assert abs(mine[k] - theirs[k]) <= 1e-9, k
    self_pq = main(argv[:2] + ["--gt-dir", str(tmp_path / "pred"), "--num-classes", "5"])
    assert self_pq["PQ"] == 100.0


# ------------------------------------------------------------- preprocess


def test_batched_input_to_device():
    from odise_torch.models.preprocess import batched_input_to_device

    batch = {"image": np.ones((2, 3), np.float32), "meta": [{"id": 3, "t": torch.ones(2)}],
             "pair": (np.zeros(1, np.int64), "name")}
    assert batched_input_to_device(batch) is batch
    out = batched_input_to_device(batch, "cpu")
    assert isinstance(out["image"], torch.Tensor) and out["image"].shape == (2, 3)
    assert out["meta"][0]["id"] == 3 and torch.equal(out["meta"][0]["t"], torch.ones(2))
    assert isinstance(out["pair"], tuple) and out["pair"][1] == "name"
    assert out["pair"][0].dtype == torch.int64
