"""The port's layer spans and backward brackets (``odise_torch/utils/tracing.py``),
CPU, TINY, float32: the eval call and one caption and one category train
step.

* With no profiler, no span site calls ``record_function`` and no bracket
  makes an autograd node (both replaced by functions that raise), and the
  gate allocates nothing.
* Outputs and gradients are bitwise the same with a CPU profiler recording
  and without, and the only ops the ranges add are views and the ranges'
  own (no kernel: a gradient that never comes is not made zeros).
* Under the profiler every span appears where the layer runs, nested in
  ``odise.infer`` or ``odise.step``; each ``.bwd`` range is closed and
  comes after its forward range; the training image is cut into two serial
  crops, so ``odise.backbone.crop`` appears twice in the forward and twice
  again in the checkpoint's recompute, inside ``odise.backbone.bwd``.
  (``odise.ms_deform_attn.bwd`` is the CUDA kernel's backward: on the CPU
  autograd differentiates the plain op.)
"""

import collections
import contextlib
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from odise_torch.engine import (Trainer, make_caption_train_step,  # noqa: E402
                                make_category_train_step, make_optimizer, partition_params)
from odise_torch.losses import CriterionConfig  # noqa: E402
from odise_torch.model_zoo.factory import (TINY_TRAIN_LABELS, build_caption_odise,  # noqa: E402
                                           build_category_odise)
from odise_torch.models.clip.tokenizer import tokenize  # noqa: E402
from odise_torch.models.inference import panoptic_inference, semantic_inference  # noqa: E402
from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary  # noqa: E402
from odise_torch.utils import tracing  # noqa: E402
from .torch_threads import one_thread  # noqa: F401,E402

CASES = ("eval", "caption_step", "category_step")
# two 64-px serial crops of the TINY backbone
H, W, B, T, WORDS = 64, 128, 2, 3, 2


def _batch(caption: bool):
    rng = np.random.RandomState(5)
    batch = {"image": torch.from_numpy(rng.rand(B, H, W, 3).astype(np.float32)),
             "gt_labels": torch.from_numpy(rng.randint(0, 3, (B, T))),
             "gt_masks": torch.zeros((B, T, H, W), dtype=torch.bool),
             "gt_valid": torch.ones((B, T), dtype=torch.bool)}
    for b in range(B):
        for t in range(T):
            y, x = rng.randint(0, H - 24), rng.randint(0, W - 24)
            batch["gt_masks"][b, t, y:y + 24, x:x + 24] = True
    if caption:
        words = ["a red thing", "a blue stuff", "sky", "grass"]
        toks = tokenize([words[(b + k) % 4] for b in range(B) for k in range(WORDS)])
        batch["word_tokens"] = torch.from_numpy(toks).long().reshape(B, WORDS, -1)
        batch["word_valid"] = torch.ones((B, WORDS), dtype=torch.bool)
    return batch


class _Case:
    """One model and a function that runs the case once and returns what
    it computed (outputs, or the gradients and parameters after the step)."""

    def __init__(self, case: str):
        torch.manual_seed(0)
        self.case = case
        build = build_caption_odise if case == "caption_step" else build_category_odise
        self.model = build("tiny", device="cpu")
        if case == "eval":
            vocab = build_open_vocabulary(self.model, TINY_TRAIN_LABELS,
                                          thing_mask=np.array([1, 1, 0], bool))
            self.infer = OpenPanopticInference(self.model, vocab)
            self.thing = vocab.thing_mask
            self.images = torch.from_numpy(
                np.random.RandomState(3).rand(1, H, H, 3).astype(np.float32))
            return
        self.trainable, _ = partition_params(self.model)
        self.start = {n: p.detach().clone() for n, p in self.trainable.items()}
        self.batch = _batch(case == "caption_step")

    def __call__(self):
        if self.case == "eval":
            mask_cls, mask_pred = self.infer(self.images)
            sem = semantic_inference(mask_cls[0], mask_pred[0])
            pan = panoptic_inference(mask_cls[0], mask_pred[0], self.thing,
                                     object_mask_threshold=0.0)
            return [mask_cls, mask_pred, sem, pan.panoptic_seg]
        with torch.no_grad():
            for n, p in self.trainable.items():
                p.copy_(self.start[n])
        opt = make_optimizer(self.trainable, lr=1e-3, weight_decay=0.05)
        crit = CriterionConfig(num_classes=1 if self.case == "caption_step" else 3,
                               num_points=64)
        if self.case == "caption_step":
            step = make_caption_train_step(self.model, opt, crit)
        else:
            with torch.no_grad():
                text = self.model.encode_vocab(torch.from_numpy(
                    tokenize([t for g in TINY_TRAIN_LABELS for t in g])).long())
            step = make_category_train_step(self.model, opt, crit, text, TINY_TRAIN_LABELS)
        trainer = Trainer(step, iter([self.batch]), torch.Generator().manual_seed(7))
        trainer.train(0, 1)
        grads = [p.grad.clone() for p in self.trainable.values() if p.grad is not None]
        return grads + [p.detach().clone() for p in self.trainable.values()]


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name):
    if name not in cases:
        cases[name] = _Case(name)
    return cases[name]


def _raise(*args, **kwargs):
    raise AssertionError("a tracing hook ran with no profiler recording")


@pytest.mark.parametrize("case", CASES)
def test_off_calls_nothing(cases, case, monkeypatch):
    run = _case(cases, case)
    monkeypatch.setattr(tracing, "record_function", _raise)
    monkeypatch.setattr(tracing._Open, "apply", _raise)
    monkeypatch.setattr(tracing._Close, "apply", _raise)
    monkeypatch.setattr(tracing.Range, "open", _raise)
    assert all(torch.isfinite(t.float()).all() for t in run())
    # the gate itself: one shared null context, the arguments as given
    x = torch.ones(3, requires_grad=True)
    assert tracing.span("odise.x") is tracing.span("odise.y")
    got, bwd = tracing.bracket("odise.x", {"x": x})
    assert got["x"] is x and bwd(x) is x

    def hits(n):
        for _ in range(n):
            with tracing.span("odise.x"):
                pass
            got, bwd = tracing.bracket("odise.x", x)
            bwd(got)

    tracemalloc.start()
    try:
        hits(1)
        before = tracemalloc.get_traced_memory()[0]
        hits(1000)
        assert tracemalloc.get_traced_memory()[0] == before
    finally:
        tracemalloc.stop()


class _Ops(TorchDispatchMode):
    """Counts the ops dispatched, by name."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _profiled(run, ops=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ops or contextlib.nullcontext():
            out = run()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("odise.")]
    return out, sorted(ranges, key=lambda r: r[1])


@pytest.mark.parametrize("case", CASES)
def test_profiler_leaves_values_bitwise(cases, case):
    run = _case(cases, case)
    ops_off, ops_on = _Ops(), _Ops()
    with ops_off:
        off = run()
    on, ranges = _profiled(run, ops_on)
    assert ranges
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    added = ops_on.count - ops_off.count
    assert not ops_off.count - ops_on.count
    assert set(added) <= {"aten.view.default", "profiler._record_function_enter_new.default",
                          "profiler._record_function_exit._RecordFunction"}, added


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_by_layer(cases, case):
    _, ranges = _profiled(_case(cases, case))
    names = {r[0] for r in ranges}
    for r in ranges:
        assert r[2] >= r[1], r
    if case == "eval":
        (root,) = _named(ranges, "odise.infer")
        assert {"odise.backbone", "odise.sem_seg_head", "odise.pixel_decoder",
                "odise.ms_deform_attn", "odise.mask_decoder", "odise.clip_head",
                "odise.mask_upsample", "odise.vocab_head", "odise.fusion"} <= names
        fusion = _named(ranges, "odise.fusion")
        assert len(fusion) == 2 and not any(_inside(f, root) for f in fusion)
        for r in ranges:
            if r[0] != "odise.fusion":
                assert _inside(r, root), r
        (head,) = _named(ranges, "odise.sem_seg_head")
        (pixel,) = _named(ranges, "odise.pixel_decoder")
        assert _inside(pixel, head) and _inside(_named(ranges, "odise.mask_decoder")[0], head)
        deform = _named(ranges, "odise.ms_deform_attn")
        assert len(deform) == 2 and all(_inside(d, pixel) for d in deform)
        (vocab,) = _named(ranges, "odise.vocab_head")
        clip = _named(ranges, "odise.clip_head")
        assert len(clip) == 2 and sum(_inside(c, vocab) for c in clip) == 1
        return

    (step,) = _named(ranges, "odise.step")
    assert all(_inside(r, step) for r in ranges)
    assert _named(ranges, "odise.data_wait")
    want = {"odise.backbone", "odise.backbone.crop", "odise.sem_seg_head",
            "odise.pixel_decoder", "odise.ms_deform_attn", "odise.mask_decoder",
            "odise.criterion", "odise.matcher", "odise.optimizer",
            "odise.backbone.bwd", "odise.sem_seg_head.bwd", "odise.criterion.bwd"}
    caption = {"odise.text_tower", "odise.grounding", "odise.grounding.bwd"}
    assert want <= names
    assert (caption <= names) == (case == "caption_step")
    assert not (caption & names) or case == "caption_step"
    (matcher,) = _named(ranges, "odise.matcher")
    assert _inside(matcher, _named(ranges, "odise.criterion")[0])
    for bwd in (r for r in ranges if r[0].endswith(".bwd")):
        (fwd,) = _named(ranges, bwd[0][:-len(".bwd")])
        assert bwd[1] >= fwd[2], (bwd, fwd)
    (backbone,) = _named(ranges, "odise.backbone")
    (backbone_bwd,) = _named(ranges, "odise.backbone.bwd")
    crops = _named(ranges, "odise.backbone.crop")
    assert sum(_inside(c, backbone) for c in crops) == 2
    assert sum(_inside(c, backbone_bwd) for c in crops) == 2
    assert len(crops) == 4
    # the optimizer runs after the backward; the backbone's backward, last
    (opt,) = _named(ranges, "odise.optimizer")
    assert all(r[2] <= opt[1] for r in ranges if r[0].endswith(".bwd"))
    assert all(r[1] <= backbone_bwd[1] for r in ranges if r[0].endswith(".bwd"))
