"""The port's open-vocabulary evaluation path against the JAX package, on the
same numpy inputs (CPU, float32): shape buckets, fusion with bucket padding,
instance extraction, the statistics runner, the host evaluators, the
eval-time resizes (against cv2, which the JAX package uses), the synthetic
records, the vocabulary wrapper on a non-square two-crop bucket, and one
task of the eval loop against the JAX package's composition of the same
steps (``do_test`` in ``tools/train_net.py``).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from odise_tpu.data import build as jbuild  # noqa: E402
from odise_tpu.data import synthetic as jsynth  # noqa: E402
from odise_tpu.data import transforms as jtf  # noqa: E402
from odise_tpu.evaluation import buckets as jbuckets  # noqa: E402
from odise_tpu.evaluation import device_eval as jde  # noqa: E402
from odise_tpu.evaluation import evaluator as jevaluator  # noqa: E402
from odise_tpu.evaluation.instance_eval import InstanceSegEvaluator as JInst  # noqa: E402
from odise_tpu.evaluation.panoptic_eval import PanopticEvaluator as JPan  # noqa: E402
from odise_tpu.evaluation.sem_seg_eval import SemSegEvaluator as JSem  # noqa: E402
from odise_tpu.models import inference as jinf  # noqa: E402
from odise_torch.data import build, synthetic, transforms  # noqa: E402
from odise_torch.evaluation import buckets, device_eval, evaluator  # noqa: E402
from odise_torch.evaluation.instance_eval import InstanceSegEvaluator  # noqa: E402
from odise_torch.evaluation.panoptic_eval import PanopticEvaluator  # noqa: E402
from odise_torch.evaluation.run import evaluate_open_vocab  # noqa: E402
from odise_torch.evaluation.sem_seg_eval import SemSegEvaluator  # noqa: E402
from odise_torch.models import inference  # noqa: E402
from .torch_threads import one_thread  # noqa: F401,E402

T = torch.from_numpy


# ---------------------------------------------------------------- labels, buckets

@pytest.mark.parametrize("dataset", ["coco_panoptic", "ade20k_150"])
@pytest.mark.parametrize("prompt_engineered", [False, True])
def test_labels_match_jax(dataset, prompt_engineered):
    labels = build.get_openseg_labels(dataset, prompt_engineered)
    assert labels == jbuild.get_openseg_labels(dataset, prompt_engineered)
    for prompt in (None, "a", "photo", "scene"):
        assert build.prompt_labels(labels, prompt) == jbuild.prompt_labels(labels, prompt)


def test_coco_thing_mask_matches_jax_catalog():
    from odise_tpu.data.datasets.register_coco import coco_panoptic_categories

    thing = build.coco_panoptic_thing_mask()
    want = np.asarray([bool(c["isthing"]) for c in coco_panoptic_categories()])
    assert thing.dtype == bool and thing.shape == (133,) and thing.sum() == 80
    assert np.array_equal(thing, want)
    # every vocabulary of the JAX package is copied into the port
    assert build.get_openseg_labels("lvis_1203") == jbuild.get_openseg_labels("lvis_1203")


def test_buckets_match_jax():
    for args in [(), (1024, 2560), (800, 1333), (128, 320), (512, 1000, 32)]:
        assert buckets.compute_eval_buckets(*args) == jbuckets.compute_eval_buckets(*args)
    b = buckets.compute_eval_buckets()
    rng = np.random.RandomState(0)
    for h, w in list(rng.randint(1, 2700, (200, 2))) + [(1024, 1365), (2560, 1024)]:
        assert buckets.pick_bucket(h, w, b) == jbuckets.pick_bucket(h, w, b)


# ---------------------------------------------------------------- fusion

def _fusion_case(seed, Q=12, K=3, H=48, W=40):
    """Query q owns block q of a 3x4 grid; two stuff queries merge, one is
    null, one is swallowed; the padding (rows >= 37, cols >= 29) carries
    strong logits that would win every pixel there if it were not masked."""
    rng = np.random.RandomState(seed)
    mask_cls = rng.randn(Q, K + 1).astype(np.float32)
    mask_cls[np.arange(Q), rng.randint(0, K, Q)] += 8.0
    mask_cls[3, 2] = mask_cls[5, 2] = 20.0
    mask_cls[7, K] = 30.0
    mask_pred = rng.randn(Q, H, W).astype(np.float32) - 6.0
    for q in range(Q):
        r, c = divmod(q, 4)
        mask_pred[q, r * 12:(r + 1) * 12, c * 8:(c + 1) * 8] += 12.0
    mask_pred[11, 24:36, 16:32] += 12.0
    mask_pred[0, 37:, :] += 20.0
    mask_pred[1, :, 29:] += 20.0
    return mask_cls, mask_pred, np.array([True, True, False])


@pytest.mark.parametrize("valid_hw", [(37, 29), (48, 40), (12, 8), (1, 40)])
def test_panoptic_inference_with_valid_hw_agrees_exactly(valid_hw):
    mask_cls, mask_pred, thing = _fusion_case(1)
    ref = jinf.panoptic_inference(jnp.asarray(mask_cls), jnp.asarray(mask_pred),
                                  jnp.asarray(thing), object_mask_threshold=0.0,
                                  overlap_threshold=0.8, valid_hw=valid_hw)
    out = inference.panoptic_inference(T(mask_cls), T(mask_pred), T(thing),
                                       object_mask_threshold=0.0,
                                       overlap_threshold=0.8, valid_hw=valid_hw)
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if valid_hw == (37, 29):
        assert int(out.num_segments) >= 3
        assert not out.panoptic_seg[37:].any() and not out.panoptic_seg[:, 29:].any()


def _tied_case():
    """Exact ties: query 5 repeats query 2's logits, and query 8 holds three
    equal class logits; every query's mask differs, so the masks pin the
    query each top-k row came from."""
    mask_cls, mask_pred, thing = _fusion_case(2)
    mask_cls[5] = mask_cls[2]
    mask_cls[8, :3] = 1.5
    return mask_cls, mask_pred, thing


@pytest.mark.parametrize("case,topk,valid_hw", [
    ("ties", 7, None), ("ties", 20, (37, 29)), ("plain", 100, (30, 21)),
    ("plain", 36, None)])  # 100 > Q*K = 36: capped
def test_instance_inference_matches_jax(case, topk, valid_hw):
    """Classes and masks exactly, the lower flat index first among equal
    scores; scores and mask scores within 1e-6 (float32 sums over the
    mask in another order)."""
    mask_cls, mask_pred, thing = _tied_case() if case == "ties" else _fusion_case(3)
    ref = jinf.instance_inference(jnp.asarray(mask_cls), jnp.asarray(mask_pred),
                                  jnp.asarray(thing), topk=topk, valid_hw=valid_hw)
    out = inference.instance_inference(T(mask_cls), T(mask_pred), T(thing),
                                       topk=topk, valid_hw=valid_hw)
    assert out.scores.shape == (min(topk, 36),)
    assert out.classes.dtype == torch.int32
    assert np.array_equal(out.classes.numpy(), np.asarray(ref.classes))
    assert np.array_equal(out.masks.numpy(), np.asarray(ref.masks))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out.mask_scores.numpy(), np.asarray(ref.mask_scores),
                               rtol=1e-6, atol=1e-7)
    assert (out.scores.numpy() == 0).sum() == (np.asarray(ref.scores) == 0).sum()


def test_tie_order_is_jax_top_k():
    """A stable descending sort gives jax.lax.top_k's indices on exact ties."""
    x = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.9, 0.5, 0.0, 0.5], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), 6)
    _, got = torch.sort(T(x), descending=True, stable=True)
    assert got[:6].tolist() == np.asarray(want).tolist() == [1, 3, 5, 0, 2, 6]


def test_sem_seg_postprocess_matches_jax():
    x = np.random.RandomState(4).randn(5, 24, 32).astype(np.float32)
    ref = jinf.sem_seg_postprocess(jnp.asarray(x), (20, 27), (41, 13))
    out = inference.sem_seg_postprocess(T(x), (20, 27), (41, 13))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- device statistics

def test_resize_chw_and_sem_labels_match_jax():
    """The tent resize within 1e-5 (float32 products in another order); the
    chunked semantic argmax exactly, with 260 classes (three chunks of 128)
    and exact ties across chunk borders and inside a chunk, where the first
    class wins. The masks sit at +-100, where both sigmoids give exactly 0 or
    1, so a tie stays exact through any order of summation."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 24, 32).astype(np.float32) * 3
    for src, dst, grid in [((20, 28), (13, 17), (16, 24)), ((24, 32), (40, 50), (48, 64)),
                           ((22, 29), (19, 27), (20, 28))]:
        ref = np.asarray(jde.resize_chw(jnp.asarray(x), src, dst, grid))
        out = device_eval.resize_chw(T(x), src, dst, grid).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        assert not out[:, dst[0]:].any() and not out[:, :, dst[1]:].any()
    mask_cls = rng.randn(6, 261).astype(np.float32)
    mask_cls[:, 200] = mask_cls[:, 3]    # tie across chunks: 3 wins
    mask_cls[:, 130] = mask_cls[:, 129]  # tie inside a chunk: 129 wins
    mask_cls[:, 3] += 6.0
    mask_cls[:, 200] += 6.0
    masks = np.where(rng.rand(6, 20, 28) < 0.5, 100.0, -100.0).astype(np.float32)
    ref = np.asarray(jde._sem_labels(jnp.asarray(mask_cls), jnp.asarray(masks)))
    out = device_eval._sem_labels(T(mask_cls), T(masks)).numpy()
    assert np.array_equal(out, ref)
    assert (out == 3).any() and not (out == 200).any()


def _runner_pair(**kw):
    args = dict(num_classes=7, thing_mask=np.arange(7) < 3, object_mask_threshold=0.0,
                overlap_threshold=0.8, topk=10, ignore_label=255,
                grids=((20, 28), (32, 40)), s_max=8)
    args.update(kw)
    return device_eval.DeviceEvalRunner(**args), jde.DeviceEvalRunner(**args)


def _assert_same_stats(got, want):
    """Key for key and dtype for dtype; integers exactly, floats within 1e-6
    (float32 sums over a mask in another order)."""
    if want is None:
        assert got is None
        return
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, int):
            assert type(g) is int and g == w, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert np.array_equal(g, w), k


def _image_case(seed, q=12, k=7, hp=24, wp=32, oh=19, ow=27):
    rng = np.random.RandomState(seed)
    mask_cls = rng.randn(q, k + 1).astype(np.float32) * 2
    mask_cls[np.arange(q), rng.randint(0, k, q)] += 5.0
    mask_pred = rng.randn(q, hp, wp).astype(np.float32) * 3
    sem_gt = rng.randint(0, k, (oh, ow)).astype(np.int32)
    sem_gt[0, :5] = 255
    sem_gt[1, :3] = k + 2  # out of range: ignored as in the JAX runner
    gt_ids = np.zeros((oh, ow), np.uint32)
    gt_ids[2:10, 3:12] = 7
    gt_ids[11:oh - 1, 5:20] = 42
    gt_ids[0:6, 15:ow - 1] = 13
    gt_ids[oh - 1, :4] = 99  # an id no segment lists: void row
    seg_ids = np.asarray([42, 7, 13], np.uint32)
    inst = np.stack([gt_ids == 7, gt_ids == 13])
    return mask_cls, mask_pred, sem_gt, gt_ids, seg_ids, inst


def test_device_eval_runner_matches_jax():
    port, ref = _runner_pair()
    for seed, src, orig, kw in [
            (1, (22, 29), (19, 27), {}),
            (2, (24, 32), (30, 33), {}),                       # the second grid
            (3, (20, 30), (19, 27), dict(inst=np.zeros((0, 19, 27), bool))),
            (4, (22, 29), (19, 27), dict(sem_only=True))]:
        mask_cls, mask_pred, sem_gt, gt_ids, seg_ids, inst = _image_case(
            seed, oh=orig[0], ow=orig[1])
        gts = dict(sem_gt=sem_gt, pan_gt_ids=gt_ids, pan_seg_ids=seg_ids,
                   inst_gt_masks=kw.get("inst", inst))
        if kw.get("sem_only"):
            gts = dict(sem_gt=sem_gt)
        got = port.process(T(mask_cls), T(mask_pred), src, orig, **gts)
        want = ref.process(jnp.asarray(mask_cls), jnp.asarray(mask_pred), src, orig, **gts)
        _assert_same_stats(got, want)
        assert kw.get("sem_only") or got["pan_counts"].sum() == orig[0] * orig[1]
    # the confusion matrix accumulated over the four images
    conf = port.flush_confusion()
    assert conf.dtype == np.int64 and conf.sum() > 0
    assert np.array_equal(conf, ref.flush_confusion())


def test_device_eval_runner_none_and_empty_cases_match_jax():
    mask_cls, mask_pred, sem_gt, gt_ids, seg_ids, inst = _image_case(6)
    args = (T(mask_cls), T(mask_pred)), (jnp.asarray(mask_cls), jnp.asarray(mask_pred))
    cases = [
        dict(orig=(40, 27), gts=dict(sem_gt=np.zeros((40, 27), np.int32))),  # no grid fits
        dict(orig=(19, 27), gts=dict(pan_gt_ids=gt_ids,                      # 9 > s_max
                                     pan_seg_ids=np.arange(1, 10, dtype=np.uint32))),
        dict(orig=(19, 27), gts=dict(inst_gt_masks=np.zeros((129, 19, 27), bool))),
        dict(orig=(19, 27), gts={}),                                         # no gt: {}
    ]
    port, ref = _runner_pair()
    for c in cases:
        got = port.process(*args[0], (22, 29), c["orig"], **c["gts"])
        want = ref.process(*args[1], (22, 29), c["orig"], **c["gts"])
        _assert_same_stats(got, want)
    assert port.process(*args[0], (22, 29), (19, 27)) == {}
    port_off, ref_off = _runner_pair(panoptic_on=False, instance_on=False)
    gts = dict(sem_gt=sem_gt, pan_gt_ids=gt_ids, pan_seg_ids=seg_ids, inst_gt_masks=inst)
    _assert_same_stats(port_off.process(*args[0], (22, 29), (19, 27), **gts),
                       ref_off.process(*args[1], (22, 29), (19, 27), **gts))
    assert np.array_equal(port_off.flush_confusion(), ref_off.flush_confusion())


# ---------------------------------------------------------------- host evaluators

def test_evaluators_match_jax():
    """mIoU, PQ (from maps and from counts) and mask AP, per-class keys too,
    within 1e-9 of the JAX package's on the same inputs."""
    rng = np.random.RandomState(7)
    names = [f"c{i}" for i in range(5)]
    pairs = [(SemSegEvaluator(5, 255, names), JSem(5, 255, names)),
             (PanopticEvaluator(range(5), {i: i < 3 for i in range(5)}),
              JPan(range(5), {i: i < 3 for i in range(5)})),
             (InstanceSegEvaluator(5, class_names=names), JInst(5, class_names=names))]
    for _ in range(3):
        pred = rng.randint(0, 5, (30, 40))
        gt = rng.randint(0, 5, (30, 40))
        gt[:3] = 255
        for ev in pairs[0]:
            ev.process(pred, gt)
        gt_seg = np.repeat(np.repeat(rng.randint(0, 6, (3, 4)), 10, 0), 10, 1).astype(np.uint32)
        pred_seg = gt_seg.copy()
        pred_seg[rng.rand(30, 40) < 0.3] = rng.randint(0, 6)
        gt_segments = [{"id": i, "category_id": int(rng.randint(0, 5)), "iscrowd": int(i == 5)}
                       for i in range(1, 6)]
        pred_segments = [{"id": i, "category_id": s["category_id"] if rng.rand() < 0.7
                          else int(rng.randint(0, 5))} for i, s in enumerate(gt_segments, 1)]
        for ev in pairs[1]:
            ev.process(gt_seg, gt_segments, pred_seg, pred_segments)
            counts = np.zeros((6, 6), np.int64)
            np.add.at(counts, (gt_seg.ravel(), pred_seg.ravel()), 1)
            ev.process_counts(counts, gt_segments, pred_segments)
        gm = rng.rand(4, 30, 40) < 0.3
        dm = rng.rand(6, 30, 40) < 0.3
        dm[:3] = gm[[0, 1, 1]] ^ (rng.rand(3, 30, 40) < 0.05)
        args = (dm, rng.randint(0, 3, 6), rng.rand(6) + 0.01, gm, rng.randint(0, 3, 4),
                np.array([False, False, True, False]))
        for ev in pairs[2]:
            ev.process(*args)
    for port, ref in pairs:
        got, want = port.evaluate(), ref.evaluate()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)
    assert np.array_equal(pairs[0][0].conf, pairs[0][1].conf)


def test_inference_on_dataset_and_csv_format_match_jax(caplog):
    class Count:
        def reset(self):
            self.n = 0

        def evaluate(self):
            return {"n": float(self.n), "IoU-x": 1.0}

    def process(ev, batch, outputs):
        ev.n += int(outputs[0].sum())

    data = [np.full((2,), i) for i in range(7)]
    got = evaluator.inference_on_dataset(lambda b: (T(b),), data, process, Count(),
                                         total=7, num_warmup=2, log_interval=3)
    want = jevaluator.inference_on_dataset(lambda b: (jnp.asarray(b),), data,
                                           process, Count(), total=7, num_warmup=2,
                                           log_interval=3)
    assert got == want == {"n": 42.0, "IoU-x": 1.0}
    with caplog.at_level(logging.INFO):
        evaluator.print_csv_format({"main": got})
        jevaluator.print_csv_format({"main": want})
    lines = [r.getMessage() for r in caplog.records if "copypaste" in r.getMessage()]
    assert lines[:3] == lines[3:] == ["copypaste: Task: main", "copypaste: n",
                                      "copypaste: 42.0000"]


# ---------------------------------------------------------------- transforms, records

@pytest.mark.parametrize("hw", [(64, 64), (40, 64), (64, 25), (33, 91)])
def test_resize_shortest_edge_matches_cv2(hw):
    """Against the JAX package's cv2 resizes. Images: bilinear
    ``F.interpolate`` (no antialias) rounded to uint8 is within one level of
    cv2's fixed-point ``INTER_LINEAR``; on these four shapes 8.2 to 12.8% of
    the values are one level off and none more. Label maps: exactly (see
    the next test for why the port does not use ``F.interpolate`` there)."""
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    sem = rng.randint(0, 200, hw).astype(np.int32)
    pan = rng.randint(0, 2 ** 24, hw).astype(np.int32)
    ref = jtf.ResizeShortestEdge(128, 320)(jtf.AugInput(image=img, sem_seg=sem, pan_seg=pan))
    out = transforms.ResizeShortestEdge(128, 320)(
        transforms.AugInput(image=T(img), sem_seg=T(sem), pan_seg=T(pan)))
    assert out.image.dtype == torch.uint8 and out.image.shape == ref.image.shape
    diff = np.abs(out.image.numpy().astype(int) - ref.image.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.13
    assert np.array_equal(out.sem_seg.numpy(), ref.sem_seg)
    assert np.array_equal(out.pan_seg.numpy(), ref.pan_seg)


def test_resize_nearest_matches_cv2_on_random_shapes():
    """Label maps exactly, on 60 random shape pairs. The port gathers at
    cv2's ``INTER_NEAREST`` source index, floor(dst / (out / in)) in double
    precision; ``F.interpolate(mode="nearest")`` floors with a float32
    scale and lands a row or column off on 3 of these 60 pairs. Float maps
    (unit normal) within 2e-4 of cv2's ``INTER_LINEAR``, which computes its
    source coordinates and weights in float32 in another way (the largest
    gap on these pairs is 9.8e-5)."""
    import cv2
    import torch.nn.functional as F

    rng = np.random.RandomState(8)
    interpolate_misses = 0
    for h, w, oh, ow in rng.randint(3, 300, (60, 4)):
        x = rng.randint(0, 1000, (h, w)).astype(np.int32)
        want = cv2.resize(x, (int(ow), int(oh)), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(transforms.resize_nearest(T(x), oh, ow).numpy(), want)
        near = F.interpolate(T(x)[None, None].double(), size=(int(oh), int(ow)),
                             mode="nearest")[0, 0].numpy()
        interpolate_misses += not np.array_equal(near, want)
        f = rng.randn(h, w).astype(np.float32)
        want = cv2.resize(f, (int(ow), int(oh)), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(transforms.resize_bilinear(T(f), oh, ow).numpy(), want,
                                   rtol=0, atol=2e-4)
    assert interpolate_misses == 3
    ids = rng.randint(0, 2 ** 24, (5, 7)).astype(np.uint32)
    assert np.array_equal(transforms.rgb2id(transforms.id2rgb(ids)), ids)
    assert np.array_equal(transforms.id2rgb(ids), jtf.id2rgb(ids))


def test_synthetic_records_match_jax_pngs(tmp_path):
    from PIL import Image

    for vary, captions in [(False, False), (True, True)]:
        want = jsynth.make_shapes_records(str(tmp_path), 3, size=48, seed=5,
                                          with_captions=captions, vary=vary)
        got = synthetic.make_shapes_records(3, size=48, seed=5, with_captions=captions,
                                            vary=vary)
        for g, w in zip(got, want):
            assert np.array_equal(g["image"], np.asarray(Image.open(w["file_name"])))
            assert np.array_equal(g["pan_seg"], jtf.rgb2id(np.asarray(
                Image.open(w["pan_seg_file_name"]).convert("RGB"))))
            assert np.array_equal(g["sem_seg"], np.asarray(Image.open(w["sem_seg_file_name"])))
            for key in ("image_id", "segments_info", "captions", "words"):
                assert g.get(key) == w.get(key), key
    assert synthetic.synth_categories() == jsynth.synth_categories()


# ---------------------------------------------------------------- the vocabulary wrapper

VOCAB = (("cat", "feline"), ("dog",), ("grass",))
THING = np.array([True, True, False])
TRAIN = (("cat",), ("dog",), ("stuff c",))


def test_open_panoptic_inference_on_a_two_crop_bucket_matches_jax():
    """TINY CategoryODISE on a 128x192 image with a 128x128 backbone window
    (two SD crops, non-square levels for the deformable attention): the
    vocabulary within 1e-5, mask_cls and mask_pred within 1e-4 (float32
    through the whole model, as in tests/test_torch_model.py)."""
    from odise_tpu.model_zoo.factory import build_category_odise as jbuild_model
    from odise_tpu.models import wrapper as jwrapper
    from odise_tpu.models.odise import CategoryODISE as JCategoryODISE
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.model_zoo.from_jax import load_flax_params
    from odise_torch.models.clip.tokenizer import tokenize
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary

    from .test_torch_towers import perturbed_params

    jm = jbuild_model("tiny", train_labels=TRAIN, backbone_in_size=(128, 128))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), jnp.zeros((3, 16)),
        method=JCategoryODISE.init_full))
    params = perturbed_params(shapes, seed=11)
    pm = build_category_odise("tiny", train_labels=TRAIN, device="cpu",
                              backbone_in_size=(128, 128))
    load_flax_params(pm, params)

    # the JAX vocabulary from the port's token ids (one tokenizer for both)
    encode = jax.jit(lambda p, t: jm.apply(p, t, method=JCategoryODISE.encode_vocab))
    clip_labels = tuple(tuple(g) for g in jbuild.prompt_labels([list(g) for g in VOCAB],
                                                               "photo"))
    jvocab = jwrapper.OpenVocabulary(
        labels=VOCAB,
        text_embed_raw=encode(params, jnp.asarray(tokenize([s for g in VOCAB for s in g]))),
        clip_labels=clip_labels,
        clip_text_embed=encode(params, jnp.asarray(tokenize([s for g in clip_labels
                                                             for s in g]))),
        category_overlap=jnp.asarray([1, 1, 0]), thing_mask=jnp.asarray(THING))
    pvocab = build_open_vocabulary(pm, VOCAB, thing_mask=THING)
    assert pvocab.labels == jvocab.labels and pvocab.clip_labels == clip_labels
    assert pvocab.category_overlap.tolist() == [1, 1, 0]
    assert pvocab.thing_mask.tolist() == THING.tolist()
    for name in ("text_embed_raw", "clip_text_embed"):
        np.testing.assert_allclose(getattr(pvocab, name).numpy(),
                                   np.asarray(getattr(jvocab, name)), rtol=1e-5, atol=1e-5)

    img = np.random.RandomState(12).rand(1, 128, 192, 3).astype(np.float32)
    j_cls, j_pred = jwrapper.OpenPanopticInference(jm, params, jvocab)(jnp.asarray(img))
    p_cls, p_pred = OpenPanopticInference(pm, pvocab)(img)
    assert p_cls.shape == (1, 10, 4) and p_pred.shape == (1, 10, 128, 192)
    np.testing.assert_allclose(p_cls.numpy(), np.asarray(j_cls), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(p_pred.numpy(), np.asarray(j_pred), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- one eval task

LABELS = jsynth.SYNTH_LABELS
SYNTH_THING = np.asarray(jsynth.SYNTH_THING)
SHORT, LONG = 128, 320
Q = 6


def _records():
    """Two 64-px synthetic records, one cut to 40x64 (a 128x256 bucket),
    and one without any gt."""
    recs = synthetic.make_shapes_records(3, size=64, seed=3)
    cut = dict(recs[1])
    for key in ("image", "pan_seg", "sem_seg"):
        cut[key] = cut[key][:40]
    present = set(np.unique(cut["pan_seg"]).tolist())
    cut["segments_info"] = [s for s in cut["segments_info"] if s["id"] in present]
    return [recs[0], cut, {"image": recs[2]["image"]}]


def _outputs(records):
    """Model outputs that follow the gt: query q < 3 paints segment q + 1
    with class q, the rest is noise; the bucket padding holds large logits
    that only ``valid_hw`` keeps out."""
    rng = np.random.RandomState(13)
    resize = jtf.ResizeShortestEdge(SHORT, LONG)
    buckets_ = jbuckets.compute_eval_buckets(SHORT, LONG)
    out = []
    for rec in records:
        h, w = resize(jtf.AugInput(image=rec["image"])).image.shape[:2]
        bh, bw = jbuckets.pick_bucket(-(-h // 64) * 64, -(-w // 64) * 64, buckets_)
        mask_pred = rng.randn(Q, bh, bw).astype(np.float32) * 2 - 1
        mask_pred[:, h:, :] += 10.0
        mask_pred[:, :, w:] += 10.0
        mask_cls = rng.randn(1, Q, len(LABELS) + 1).astype(np.float32)
        if "pan_seg" in rec:
            ids = jtf._resize(rec["pan_seg"].astype(np.int32), h, w, "nearest")
            for q in range(3):
                mask_pred[q, :h, :w] += np.where(ids == q + 1, 8.0, -8.0)
                mask_cls[0, q, q] += 6.0
        out.append((mask_cls, mask_pred[None]))
    return out


class _Injected:
    """``infer`` that hands out fixed outputs in call order."""

    def __init__(self, outputs, model, to_tensor):
        self.outputs, self.model, self.to_tensor, self.shapes = iter(outputs), model, to_tensor, []

    def __call__(self, images):
        self.shapes.append(tuple(images.shape))
        return tuple(self.to_tensor(o) for o in next(self.outputs))


class _Model:
    object_mask_threshold, overlap_threshold, test_topk_per_image = 0.0, 0.8, 100


def _jax_task(records, infer, device_stats):
    """One task of tools/train_net.py's do_test, with the JAX package's
    modules and cv2, on records that carry their gt as arrays."""
    import cv2

    K = len(LABELS)
    thing_arr = jnp.asarray(SYNTH_THING)
    buckets_ = jbuckets.compute_eval_buckets(SHORT, LONG)
    resize = jtf.ResizeShortestEdge(SHORT, LONG)
    sem_ev = JSem(num_classes=K, ignore_label=255)
    pan_ev = JPan(categories=list(range(K)), isthing_map={i: bool(SYNTH_THING[i]) for i in range(K)})
    inst_ev = JInst(num_classes=K)
    runner = jde.DeviceEvalRunner(
        num_classes=K, thing_mask=SYNTH_THING, object_mask_threshold=0.0,
        overlap_threshold=0.8, topk=100, ignore_label=255) if device_stats else None
    n = n_fallback = 0
    for rec in records:
        img = rec["image"]
        oh, ow = img.shape[:2]
        h, w = resize(jtf.AugInput(image=img)).image.shape[:2]
        bh, bw = jbuckets.pick_bucket(-(-h // 64) * 64, -(-w // 64) * 64, buckets_)
        mc, mp = infer(np.zeros((1, bh, bw, 3), np.float32))
        mc, mp = mc[0], mp[0]
        sem_gt = rec.get("sem_seg")
        gt_ids = rec.get("pan_seg")
        gt_segments = rec.get("segments_info")
        inst_masks = inst_classes = inst_crowd = None
        if gt_ids is not None:
            things = [s for s in gt_segments if SYNTH_THING[s["category_id"]]]
            inst_masks = np.stack([gt_ids == s["id"] for s in things])
            inst_classes = np.asarray([s["category_id"] for s in things], np.int64)
            inst_crowd = np.zeros(len(things), bool)
        stats = None
        if runner is not None and gt_ids is not None:
            stats = runner.process(mc, mp, (h, w), (oh, ow), sem_gt=sem_gt,
                                   pan_gt_ids=gt_ids,
                                   pan_seg_ids=np.asarray([s["id"] for s in gt_segments],
                                                          np.uint32),
                                   inst_gt_masks=inst_masks)
            by_id = {s["id"]: s for s in gt_segments}
            nseg = stats["pan_num_segments"]
            pan_ev.process_counts(
                stats["pan_counts"][:, :nseg + 1],
                [by_id[int(i)] for i in stats["pan_gt_ids_sorted"]],
                [{"category_id": int(stats["pan_segment_category"][i]),
                  "isthing": bool(stats["pan_segment_isthing"][i])} for i in range(nseg)])
            keep = stats["inst_scores"] > 0
            inst_ev.process_from_counts(
                stats["inst_scores"][keep], stats["inst_classes"][keep],
                stats["inst_dt_area"][keep], stats["inst_inter"][keep], inst_classes,
                stats["inst_gt_area"], inst_crowd)
        elif gt_ids is not None:
            n_fallback += 1
            sem = np.asarray(jinf.semantic_inference(mc, mp), np.float32)[:, :h, :w]
            sem_r = cv2.resize(sem.transpose(1, 2, 0), (ow, oh), interpolation=cv2.INTER_LINEAR)
            sem_ev.process(np.argmax(sem_r, -1).astype(np.int32), sem_gt)
            pan = jinf.panoptic_inference(mc, mp, thing_arr, object_mask_threshold=0.0,
                                          overlap_threshold=0.8, valid_hw=(h, w))
            pan_seg = cv2.resize(np.asarray(pan.panoptic_seg)[:h, :w].astype(np.int32),
                                 (ow, oh), interpolation=cv2.INTER_NEAREST)
            nseg = int(pan.num_segments)
            pan_ev.process(gt_ids, gt_segments, pan_seg.astype(np.uint32),
                           [{"id": i + 1, "category_id": int(pan.segment_category[i]),
                             "isthing": bool(pan.segment_isthing[i])} for i in range(nseg)])
            inst = jinf.instance_inference(mc, mp, thing_arr, topk=100, valid_hw=(h, w))
            masks = np.stack([cv2.resize(m.astype(np.uint8), (ow, oh),
                                         interpolation=cv2.INTER_NEAREST).astype(bool)
                              for m in np.asarray(inst.masks)[:, :h, :w]])
            scores = np.asarray(inst.scores)
            keep = scores > 0
            inst_ev.process(masks[keep], np.asarray(inst.classes)[keep], scores[keep],
                            inst_masks, inst_classes, inst_crowd)
        n += 1
    if runner is not None:
        sem_ev.add_confusion(runner.flush_confusion())
    r = {**sem_ev.evaluate(), **pan_ev.evaluate(), **inst_ev.evaluate(), "images": n}
    if runner is not None:
        r["host_fallback_images"] = n_fallback
    return r


@pytest.mark.parametrize("device_stats", [True, False], ids=["device_stats", "host_path"])
def test_evaluate_open_vocab_matches_jax_composition(device_stats):
    """The same model outputs through the port's evaluate_open_vocab and
    through the JAX package's steps: equal padded shapes and equal result
    dicts (timing aside)."""
    records = _records()
    outputs = _outputs(records)
    port_infer = _Injected(outputs, _Model(), T)
    jax_infer = _Injected(outputs, _Model(), jnp.asarray)
    got = evaluate_open_vocab(port_infer, records, labels=LABELS, thing_mask=SYNTH_THING,
                              device_stats=device_stats, short_side=SHORT, max_size=LONG)
    want = _jax_task(records, jax_infer, device_stats)
    assert port_infer.shapes == jax_infer.shapes == [(1, 128, 128, 3), (1, 128, 256, 3),
                                                     (1, 128, 128, 3)]
    assert got.pop("s_per_img") > 0
    assert got == want
    assert got["PQ"] > 20 and got["mIoU"] > 20 and got["AP"] > 20
    assert got.get("host_fallback_images", 0) == 0
