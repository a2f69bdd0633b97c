"""The host side of the port's data path against the JAX package's, on the
CPU: ``prefetch_iter`` against ``odise_tpu.utils.prefetch``, the eval loop
prefetching the next record while the model runs the current one (the same
metrics at every depth), ``build_grain_train_loader``'s worker processes
(the serial loader's batches bitwise, the JAX loaders' as
``tests/test_torch_data.py`` holds them, a bounded read-ahead, a worker's
error at its own batch), and the host C++ ops against their numpy forms and
``odise_tpu.native``.

The JAX modules are imported inside the tests: the loader's worker
processes import this module to unpickle ``_MarkingMapper``."""

import dataclasses
import os
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
from odise_torch.data.image_io import write_png
from odise_torch.data.loader import (build_grain_train_loader, build_train_loader,
                                     read_ahead)
from odise_torch.data.transforms import id2rgb
from odise_torch.utils import host_ops
from odise_torch.utils.prefetch import prefetch_iter
from .torch_threads import one_thread  # noqa: F401

# ---------------------------------------------------------------- prefetch


class _Boom(Exception):
    pass


def _square_or_raise(bad):
    def fn(x):
        if x == bad:
            raise _Boom(f"item {x}")
        return x * x

    return fn


def _drain(gen):
    """What a consumer sees: the results, then the exception that ended it."""
    got = []
    try:
        for y in gen:
            got.append(y)
    except _Boom as err:
        return got, str(err)
    return got, None


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
@pytest.mark.parametrize("bad", [None, 0, 4, 9])
def test_prefetch_iter_matches_jax(depth, bad):
    """The same results in order and the same exception at the same item as
    the JAX package's ``prefetch_iter``, at every depth (0: inline)."""
    from odise_tpu.utils.prefetch import prefetch_iter as jax_prefetch_iter

    got = _drain(prefetch_iter(range(10), _square_or_raise(bad), depth=depth))
    want = _drain(jax_prefetch_iter(range(10), _square_or_raise(bad), depth=depth))
    assert got == want
    assert got[0] == [x * x for x in range(10 if bad is None else bad)]


def test_prefetch_iter_stops_its_thread_when_closed():
    """A consumer that stops early leaves no prefetch thread running: the
    items not started are cancelled and the running one is waited for."""
    started, release = [], threading.Event()

    def slow(x):
        started.append(x)
        release.wait(10)
        return x

    gen = prefetch_iter(range(100), slow, depth=3)
    release.set()
    assert next(gen) == 0
    gen.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("prefetch")]
    assert len(started) <= 4  # the one yielded, at most the 3 queued behind it


# ---------------------------------------------------------------- eval


SYNTH = dict(size=48, seed=3)


@pytest.fixture(scope="module")
def tiny_infer():
    from odise_torch.data.synthetic import SYNTH_LABELS, SYNTH_THING
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary

    torch.manual_seed(0)
    model = build_category_odise("tiny", device="cpu")
    return OpenPanopticInference(model, build_open_vocabulary(model, SYNTH_LABELS,
                                                              thing_mask=SYNTH_THING))


def _eval_kw():
    from odise_torch.data.synthetic import SYNTH_LABELS, SYNTH_THING

    return dict(labels=SYNTH_LABELS, thing_mask=SYNTH_THING, short_side=64, max_size=160)


def test_eval_prepares_the_next_record_while_the_model_runs(tiny_infer, tmp_path,
                                                            monkeypatch):
    """At depth 2 the next record's preparation starts while the model runs
    on the current one: each call of ``infer`` but the last waits (10 s at
    most) for it."""
    from odise_torch.data.synthetic import write_shapes_dataset
    from odise_torch.evaluation import run

    records = write_shapes_dataset(str(tmp_path), 3, **SYNTH)
    started = [threading.Event() for _ in records]
    prep_thread = []
    real_prep = run.prep_record

    def prep(rec, **kw):
        i = records.index(rec)
        prep_thread.append(threading.current_thread().name)
        started[i].set()
        return real_prep(rec, **kw)

    class Infer:
        model, device = tiny_infer.model, tiny_infer.device
        calls = 0
        waited = []

        def __call__(self, images):
            i = Infer.calls
            Infer.calls += 1
            if i + 1 < len(records):
                Infer.waited.append(started[i + 1].wait(10))
            return tiny_infer(images)

    monkeypatch.setattr(run, "prep_record", prep)
    r = run.evaluate_open_vocab(Infer(), records, prefetch=2, **_eval_kw())
    assert r["images"] == 3 and Infer.waited == [True, True]
    assert all(name.startswith("prefetch") for name in prep_thread)


def test_eval_metrics_equal_with_and_without_prefetch(tiny_infer, tmp_path):
    """``evaluate_open_vocab`` on records that name their files gives every
    metric bitwise equal at prefetch depths 0 and 2."""
    from odise_torch.data.synthetic import write_shapes_dataset
    from odise_torch.evaluation.run import evaluate_open_vocab

    records = write_shapes_dataset(str(tmp_path), 2, **SYNTH)
    serial = evaluate_open_vocab(tiny_infer, records, prefetch=0, **_eval_kw())
    ahead = evaluate_open_vocab(tiny_infer, records, prefetch=2, **_eval_kw())
    assert serial.pop("s_per_img") > 0 and ahead.pop("s_per_img") > 0
    assert ahead == serial and serial["images"] == 2 and "PQ" in serial


# ---------------------------------------------------------------- train loader

LOADER_KW = dict(image_size=64, max_instances=4, with_captions=True, num_words=3,
                 word_dropout=0.3)


def _file_records(root, n=5, size=(40, 56), seed=6):
    """``n`` records of seeded PNG images and panoptic PNGs (two things, a
    crowd and a stuff segment each) with captions, as the COCO registration
    gives them."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    h, w = size
    records = []
    for i in range(n):
        ids = np.full((h, w), 5, np.uint32)
        y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
        ids[y:y + h // 3, x:x + w // 3] = 3
        ids[h // 2:, w // 2:] = 4
        ids[2:10, w - 14:w - 2] = 6
        image = os.path.join(root, f"{i:04d}.jpg")  # a PNG under COCO's name
        pan = os.path.join(root, f"{i:04d}_pan.png")
        write_png(image, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        write_png(pan, id2rgb(ids))
        records.append({
            "file_name": image, "pan_seg_file_name": pan, "image_id": i,
            "captions": [f"a person and a dog {i}", "a wall"],
            "segments_info": [{"id": 3, "category_id": 0, "iscrowd": 0},
                              {"id": 4, "category_id": 1, "iscrowd": 1},
                              {"id": 5, "category_id": 2, "iscrowd": 0},
                              {"id": 6, "category_id": 3, "iscrowd": 0}]})
    return records


def _take(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def test_worker_loader_equals_the_serial_and_jax_loaders(tmp_path, monkeypatch):
    """``build_grain_train_loader`` at 0, 1 and 4 workers yields
    ``build_train_loader``'s batches bitwise; and they equal the JAX
    package's ``build_train_loader`` and its ``build_grain_train_loader(
    worker_count=4)`` where grain is absent (as on the card's machine) as
    ``tests/test_torch_data.py`` holds the mapper from files: targets and
    words exactly, images within one uint8 level (cv2 resizes uint8 in fixed
    point)."""
    from odise_tpu.data import dataset_mapper as jdm
    from odise_tpu.data import loader as jl

    records = _file_records(str(tmp_path))
    mapper = COCOPanopticDatasetMapper(device="cpu", **LOADER_KW)
    serial = _take(build_train_loader(records, mapper, 2, seed=5), 4)
    for workers in (0, 1, 4):
        got = _take(build_grain_train_loader(records, mapper, 2, seed=5,
                                             worker_count=workers), 4)
        for g, s in zip(got, serial):
            assert sorted(g) == sorted(s)
            assert all(torch.equal(g[k], s[k]) for k in s), workers
    # grain is installed in some environments, where JAX's grain path draws
    # grain's shuffle and per-record seeds (ROADMAP C37); the port holds
    # the path that runs where grain is absent
    monkeypatch.setitem(sys.modules, "grain", None)
    monkeypatch.setitem(sys.modules, "grain.python", None)
    jmapper = jdm.COCOPanopticDatasetMapper(**LOADER_KW)
    for jax_loader in (jl.build_train_loader(records, jmapper, 2, seed=5),
                       jl.build_grain_train_loader(records, jmapper, 2, seed=5,
                                                   worker_count=4)):
        for g, want in zip(serial, _take(jax_loader, 4)):
            assert sorted(g) == sorted(want)
            for k in ("gt_labels", "gt_masks", "gt_valid", "word_tokens", "word_valid"):
                assert np.array_equal(g[k].numpy(), want[k]), k
            assert float(np.abs(g["image"].numpy() - want["image"]).max()) <= 1 / 255 + 1e-6
    assert any(b["gt_valid"].any() and b["word_valid"].any() for b in serial)


@dataclasses.dataclass
class _MarkingMapper(COCOPanopticDatasetMapper):
    """A mapper whose every ``read`` leaves a file in ``marks``."""

    marks: str = ""

    def read(self, record):
        out = super().read(record)
        open(os.path.join(self.marks, uuid.uuid4().hex), "w").close()
        return out


def _reads_settle(marks, want, timeout=10.0):
    t_end = time.monotonic() + timeout
    while len(os.listdir(marks)) < want and time.monotonic() < t_end:
        time.sleep(0.02)
    time.sleep(0.3)  # a loader past its bound would read on meanwhile
    return len(os.listdir(marks))


def test_worker_loader_reads_ahead_within_its_bound(tmp_path):
    """While the consumer holds a batch the workers read ahead of it, up to
    ``read_ahead`` records beyond the batches yielded, and no further."""
    records = _file_records(str(tmp_path / "data"))
    marks = str(tmp_path / "marks")
    os.makedirs(marks)
    mapper = _MarkingMapper(device="cpu", marks=marks, **LOADER_KW)
    per_host, workers = 2, 1
    bound = read_ahead(per_host, workers)
    assert bound == 4
    loader = build_grain_train_loader(records, mapper, per_host, seed=5,
                                      worker_count=workers)
    try:
        for taken in (1, 2):
            next(loader)
            assert _reads_settle(marks, taken * per_host + bound) == taken * per_host + bound
    finally:
        loader.close()


def test_worker_loader_raises_a_read_error_at_its_batch(tmp_path):
    """A record whose file is missing: the batches before its own come as
    the serial loader gives them, and its batch raises the worker's
    ``FileNotFoundError``, as the serial loader raises it."""
    records = _file_records(str(tmp_path))
    os.unlink(records[3]["pan_seg_file_name"])
    mapper = COCOPanopticDatasetMapper(device="cpu", **LOADER_KW)

    def until_error(loader):
        batches = []
        try:
            while len(batches) < 10:
                batches.append(next(loader))
        except FileNotFoundError as err:
            return batches, err
        finally:
            loader.close()
        raise AssertionError("no batch read the missing file")

    serial, serial_err = until_error(build_train_loader(records, mapper, 2, seed=5))
    ahead, err = until_error(build_grain_train_loader(records, mapper, 2, seed=5,
                                                      worker_count=2))
    assert len(ahead) == len(serial) and err.filename == serial_err.filename
    for a, s in zip(ahead, serial):
        assert all(torch.equal(a[k], s[k]) for k in s)


# ---------------------------------------------------------------- host ops


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """``odise_tpu.native`` built into a directory of this test's own (not
    beside its source, which other tests build at the same time), and
    checked to be the C++ library, not its numpy fallback."""
    from odise_tpu import native

    saved = native._SO, native._LIB, native._TRIED
    native._SO = str(tmp_path_factory.mktemp("native") / "libhostops.so")
    native._LIB, native._TRIED = None, False
    try:
        assert native._lib() is not None
        yield native
    finally:
        native._SO, native._LIB, native._TRIED = saved


def _pairs(g, p, c):
    return {(int(a), int(b)): int(n) for a, b, n in zip(g, p, c)}


def test_host_rgb2id_matches_numpy_and_jax(jax_native):
    rng = np.random.RandomState(0)
    for shape in ((17, 23, 3), (0, 5, 3)):
        rgb = rng.randint(0, 256, shape).astype(np.uint8)
        got = host_ops.rgb2id(rgb)
        assert got.dtype == np.uint32 and got.shape == shape[:2]
        assert np.array_equal(got, host_ops.rgb2id_plain(rgb))
        assert np.array_equal(got, jax_native.rgb2id(rgb))


@pytest.mark.parametrize("case", ["small", "past_the_cap", "empty"])
def test_host_pq_intersections_matches_numpy_and_jax(jax_native, case):
    """The pairs in ascending order, as numpy's; as a set equal to JAX's
    (whose C++ counter gives them in hash order). ``past_the_cap`` has more
    than the first call's 4096 pairs, which takes the second call."""
    rng = np.random.RandomState(1)
    shape, n_gt, n_pred = {"small": ((32, 32), 5, 4), "past_the_cap": ((128, 128), 100, 60),
                           "empty": ((0, 7), 1, 1)}[case]
    gt = rng.randint(0, n_gt, shape).astype(np.uint32) * 70001  # ids past 2**16
    pred = rng.randint(0, n_pred, shape).astype(np.uint32)
    got = host_ops.pq_intersections(gt, pred)
    want = host_ops.pq_intersections_plain(gt, pred)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
    assert _pairs(*got) == _pairs(*jax_native.pq_intersections(gt, pred))
    assert (len(got[0]) > host_ops.PAIRS_CAP) == (case == "past_the_cap")
    assert int(got[2].sum()) == gt.size


def test_host_mask_iou_matches_numpy_and_jax(jax_native):
    rng = np.random.RandomState(2)
    a, b = rng.rand(2, 31, 29) > 0.6
    empty = np.zeros((31, 29), bool)
    for x, y in ((a, b), (a, a), (a, empty), (empty, empty)):
        got = host_ops.mask_iou(x, y)
        assert got == host_ops.mask_iou_plain(x, y) == jax_native.mask_iou(x, y)
    assert host_ops.mask_iou(empty, empty) == 0.0


def test_host_bincount_matches_numpy_and_jax(jax_native):
    import ctypes

    rng = np.random.RandomState(3)
    for ids, num_ids in ((rng.randint(0, 40, (19, 21)).astype(np.uint32), 32),
                         (np.zeros((0,), np.uint32), 8)):
        got = host_ops.bincount_u32(ids, num_ids)
        assert np.array_equal(got, host_ops.bincount_u32_plain(ids, num_ids))
        want = np.empty(num_ids, np.uint64)
        ids_c = np.ascontiguousarray(ids)
        jax_native._lib().bincount_u32(ids_c.ctypes.data, ctypes.c_int64(ids_c.size),
                                       want.ctypes.data, ctypes.c_int64(num_ids))
        assert np.array_equal(got, want) and got.dtype == np.uint64


def test_host_ops_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails makes the build raise with its name."""
    from odise_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed for host_ops.cpp"):
        _build.build(["host_ops"])
    assert not list(tmp_path.glob("*.so"))
