"""Batched open-vocabulary inference: ``OpenPanopticInference`` over a
fixed vocabulary, then ``semantic_inference`` and ``panoptic_inference`` on
each image, closed loop with one call in flight; a call ends when its
images' semantic and panoptic maps are on the host.

Traffic parameters (``traffic/<name>.json``): ``batch`` images a call;
``block``, the calls of each shape bucket ("HxW") in every run of
consecutive calls, shuffled block by block from the seed, so that every
seed gives the same work in another order; ``resized``, each bucket's image
size before the zero padding (the eval loop pads so); ``pool`` images drawn
per bucket; ``check_images``, the window's images held to the reference;
``trace_calls``, the calls of each traced stretch.

The window's calls carry the harness's CUDA events (before the call into
the model, after its outputs, after the maps' copy to the host), read for
``trunk_ms.infer`` and ``head_fusion_ms.infer``. The sampled calls hand
the program's discrete choices (``common/choices.py``) for the sampled
image to the reference, which follows them and checks them against its
own (``reference/decisions.py``).
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time

import torch

from perfbench.common import choices, device, trace, weights
from perfbench.common.window import rate, run_window
from perfbench.reference import labels as ref_labels

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _hw(bucket: str):
    h, w = bucket.split("x")
    return int(h), int(w)


def plan(traffic: dict, seed: int, n_calls: int):
    """[(bucket, pool indices)] for ``n_calls`` calls."""
    rng = random.Random(seed)
    block = [b for b, n in traffic["block"] for _ in range(n)]
    out = []
    while len(out) < n_calls:
        order = list(block)
        rng.shuffle(order)
        out += [(b, rng.sample(range(traffic["pool"]), traffic["batch"])) for b in order]
    return out[:n_calls]


def draw_pools(traffic: dict, seed: int, device, scale_hw=None):
    """Per bucket, ``pool`` smooth images [pool, H, W, 3] in [0, 1] at their
    resized size, zero-padded to the bucket; drawn on the device."""
    gen = torch.Generator(device=device).manual_seed((int(seed) + 1) % 2 ** 63)
    pools = {}
    for bucket, _ in traffic["block"]:
        H, W = _hw(bucket)
        h, w = traffic["resized"][bucket]
        if scale_hw is not None:
            H, W, h, w = scale_hw(H), scale_hw(W), scale_hw(h), scale_hw(w)
        n = traffic["pool"]
        coarse = torch.rand((n, 3, max(h // 32, 2), max(w // 32, 2)), generator=gen,
                            device=device)
        img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic",
                                              align_corners=False)
        img = img + 0.1 * torch.randn((n, 3, h, w), generator=gen, device=device)
        padded = torch.zeros((n, H, W, 3), device=device)
        padded[:, :h, :w] = img.clamp(0, 1).permute(0, 2, 3, 1)
        pools[bucket] = (padded, h, w)
    return pools


class Reservoir:
    """A seeded uniform sample of ``k`` of the window's calls, one image
    each. Whether a call is kept, and which of its images, is drawn before
    the call, so that the program's choices for that image are taken as it
    makes them. The outputs and choices are copied into buffers allocated
    at set-up for the largest bucket, so that the sample adds the same
    memory to every run's peak."""

    def __init__(self, k: int, seed: int, cls_shape, pred_numel: int, choice_shapes,
                 device):
        self.k, self.rng, self.n = k, random.Random(int(seed) * 7 + 3), 0
        self.cls = torch.empty((k,) + tuple(cls_shape), device=device)
        self.pred = torch.empty((k, pred_numel), device=device)
        self.choices = [[torch.empty(s, dtype=torch.bool, device=device)
                         for s in choice_shapes] for _ in range(k)]
        self.kept = [None] * k
        self.shapes = []

    def draw(self, batch: int):
        """(slot, image) for the next call, or (None, None) if it is not kept."""
        slot = self.n if self.n < self.k else self.rng.randrange(self.n + 1)
        self.n += 1
        if slot >= self.k:
            return None, None
        return slot, self.rng.randrange(batch)

    def sink(self, slot: int, i: int):
        """The sink of the program's choices for image ``i``: each is copied
        into the slot's next buffer."""
        self.shapes = []
        bufs = self.choices[slot]

        def take(t):
            v = t[i]
            bufs[len(self.shapes)][tuple(slice(0, d) for d in v.shape)].copy_(v)
            self.shapes.append(tuple(v.shape))
        return take

    def keep(self, slot, i, bucket, idx, mask_cls, mask_pred):
        self.cls[slot].copy_(mask_cls[i])
        self.pred[slot, :mask_pred[i].numel()].copy_(mask_pred[i].flatten())
        self.kept[slot] = (bucket, idx[i], tuple(mask_pred[i].shape), self.shapes)

    def items(self):
        for slot, item in enumerate(self.kept):
            if item is not None:
                bucket, index, shape, shapes = item
                choices = [b[tuple(slice(0, d) for d in s)]
                           for b, s in zip(self.choices[slot], shapes)]
                yield (bucket, index, self.cls[slot],
                       self.pred[slot, :math.prod(shape)].view(shape), choices)


def build_program(run, labels):
    from odise_torch.model_zoo.factory import build_caption_odise, build_category_odise

    cfg = run.config
    build = {"category": build_category_odise, "caption": build_caption_odise}[cfg["kind"]]
    dtype = DTYPES[run.dtype or cfg["infer"]["dtype"]]
    return build(run.scale or cfg["scale"], train_labels=labels,
                 with_clip_head=cfg["infer"]["with_clip_head"], device=run.device,
                 dtype=dtype)


def drive(run, fault=None) -> None:
    """Set up, measure for ``run.seconds``, trace if asked, then hold the
    window's sampled outputs to the reference. ``fault`` (tests only)
    alters the program's outputs where they are produced."""
    from odise_torch.models.inference import panoptic_inference, semantic_inference
    from odise_torch.models.wrapper import OpenPanopticInference, build_open_vocabulary

    tr, dev = run.traffic, run.device
    labels = ref_labels.coco_panoptic_labels()
    thing = torch.as_tensor(ref_labels.coco_panoptic_thing_mask(), device=dev)
    model = build_program(run, labels)
    spec = weights.specs(model)
    weights.fill_(model, run.seed)
    vocab = build_open_vocabulary(model, labels, thing_mask=thing.cpu().numpy())
    infer = OpenPanopticInference(model, vocab)
    # the test configuration's images: a sixteenth of each side, in 32s
    small = (lambda v: max(32, round(v / 16 / 32) * 32)) if run.scale == "tiny" else None
    pools = draw_pools(tr, run.seed, dev, small)
    obj_thr, ovl_thr = float(model.object_mask_threshold), float(model.overlap_threshold)
    B = tr["batch"]
    shapes = {}
    planted = fault.install() if hasattr(fault, "install") else None
    if planted is not None:
        fault = None
    taken = choices.Choices()
    undo_choices = choices.install(taken)

    def call(bucket, idx, marks=None):
        padded, h, w = pools[bucket]
        images = padded[torch.as_tensor(idx, device=dev)]
        if marks is not None:
            marks[0].record()
        mask_cls, mask_pred = infer(images)
        if fault is not None:
            mask_cls, mask_pred = fault(mask_cls, mask_pred)
        if marks is not None:
            marks[1].record()
        maps = []
        for i in range(B):
            sem = semantic_inference(mask_cls[i], mask_pred[i])[:, :h, :w]
            pan = panoptic_inference(mask_cls[i], mask_pred[i], thing,
                                     object_mask_threshold=obj_thr,
                                     overlap_threshold=ovl_thr, valid_hw=(h, w))
            maps += [sem.argmax(dim=0).int().flatten(), pan.panoptic_seg[:h, :w].flatten()]
        torch.cat(maps).cpu()
        shapes["cls"], shapes["q"] = mask_cls.shape, mask_pred.shape[1]
        if marks is not None:
            marks[2].record()
        return mask_cls, mask_pred

    # warm-up: every bucket the traffic uses, once, learning the shapes of
    # the program's choices for one image
    choice_shapes = []
    for bucket, _ in tr["block"]:
        got = []
        taken.sink = lambda t: got.append(tuple(t[0].shape))
        call(bucket, list(range(B)))
        choice_shapes = got if not choice_shapes else [
            tuple(max(a, b) for a, b in zip(x, y)) for x, y in zip(choice_shapes, got)]
    taken.sink = None
    if dev != "cpu":
        torch.cuda.synchronize()
    calls = plan(tr, run.seed, 100000)
    largest = max(h * w for h, w in (_hw(b) for b, _ in tr["block"]))
    if small is not None:
        largest = max(pools[b][0].shape[1] * pools[b][0].shape[2] for b, _ in tr["block"])
    reservoir = Reservoir(tr["check_images"], run.seed, shapes["cls"][1:],
                          shapes["q"] * largest, choice_shapes, dev)
    timing = dev != "cpu"
    marks = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(3))
             for _ in range(1024)] if timing else []
    by_bucket = {}
    run.window_opens()

    per_call = []
    host = device.ThreadCPU()

    def once(i):
        bucket, idx = calls[i]
        t = time.perf_counter()
        slot, img = reservoir.draw(B)
        if slot is not None:
            taken.sink = reservoir.sink(slot, img)
        if timing and i >= len(marks):
            marks.append(tuple(torch.cuda.Event(enable_timing=True) for _ in range(3)))
        mask_cls, mask_pred = call(bucket, idx, marks[i] if timing else None)
        if slot is not None:
            taken.sink = None
            reservoir.keep(slot, img, bucket, idx, mask_cls, mask_pred)
        per_call.append((bucket, time.perf_counter() - t))
        by_bucket[bucket] = by_bucket.get(bucket, 0) + 1

    n, window = run_window(run.seconds, once)
    run.attempted, run.failed = n * B, 0
    run.log.append(f"window: {n} calls of {B} images in {window!r} s; calls by bucket "
                   f"{by_bucket}; the main thread's CPU {host.stop():.3f} s")
    med = {b: statistics.median(t for bb, t in per_call if bb == b) for b in by_bucket}
    run.log.append("call seconds, the first ten: " + " ".join(
        f"{b}:{t:.3f}" for b, t in per_call[:10]) + f"; median by bucket {med}")
    run.e2e["infer_img_per_s"] = rate(n, B, window)
    run.extra.update(window_s=window, calls_by_bucket=by_bucket, batch=B,
                     kind=run.config["kind"], with_clip_head=run.config["infer"]["with_clip_head"],
                     n_text=int(vocab.text_embed_raw.shape[0]),
                     n_clip_text=int(vocab.clip_text_embed.shape[0])
                     if vocab.clip_text_embed is not None else 0)
    if timing:
        torch.cuda.synchronize()
        # the harness's CUDA events around every call of the window
        run.extra["trunk_ms"] = sum(a.elapsed_time(b) for a, b, _ in marks[:n]) / (n * B)
        run.extra["head_fusion_ms"] = sum(b.elapsed_time(c) for _, b, c in marks[:n]) / (n * B)
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        run.e2e["peak_mem_gib"] = run.memory_peak_bytes / 2 ** 30
    undo_choices()
    if planted is not None:
        planted()

    if run.trace:
        _traced(run, call, calls[n:], tr)

    kept = [(pools[bucket][0][i].clone(), pools[bucket][1], pools[bucket][2], c, m, ch)
            for bucket, i, c, m, ch in reservoir.items()]
    del model, infer, vocab, pools, reservoir
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    _hold_to_reference(run, spec, labels, kept)


def _traced(run, call, upcoming, tr):
    """Two traced stretches of ``trace_calls`` calls: a plain one (idle
    share, launches, the breakdown), then one with the metrics' ranges
    (the rooflines)."""
    from perfbench.common import manifest

    k = tr["trace_calls"]
    stretch, ranges = {}, {}
    torch.cuda.synchronize()
    with trace.traced(stretch):
        for bucket, idx in upcoming[:k]:
            call(bucket, idx)
    run.stretch = stretch["trace"]
    run.extra["stretch_images"] = k * tr["batch"]

    installs = []
    for name, mod in manifest.per_layer_modules(run.workload).items():
        if hasattr(mod, "install"):
            installs.append(mod.install(run))
    torch.cuda.synchronize()
    with trace.traced(ranges):
        for bucket, idx in upcoming[k:2 * k]:
            call(bucket, idx)
    torch.cuda.synchronize()
    for undo in installs:
        undo()
    run.ranges = ranges["trace"]


def _hold_to_reference(run, spec, labels, kept) -> None:
    """The reference, float32 with TF32 off, on each kept image, following
    the program's choices for it; the numbers of ``gaps``, the largest over
    the images."""
    from perfbench.reference import decisions, evaluate

    limits = run.extra["limits"]
    cfg = run.config
    ref = evaluate.build_reference(cfg["kind"], run.scale or cfg["scale"], labels,
                                   cfg["infer"]["with_clip_head"], run.device)
    if weights.specs(ref) != spec:
        raise RuntimeError("the program's parameters differ from the reference's in name "
                           "or shape: the seeded weights cannot be handed to both")
    weights.fill_(ref, run.seed)
    got, ctl = [], []
    for image, h, w, mask_cls, mask_pred, handed in kept:
        with decisions.following([c[None] for c in handed], keep_on=run.device) as book:
            r_cls, r_pred = evaluate.outputs(ref, labels, image[None])
        got.append(gaps(mask_cls, mask_pred, r_cls[0], r_pred[0], h, w, book))
        if run.extra.get("control"):
            ctl.append(control_gaps(ref, labels, image, h, w))
    got = {k: max(g[k] for g in got) for k in got[0]}
    run.extra["reference_images"] = len(kept)
    run.extra["gaps"] = got
    run.log.append("reference: " + ", ".join(f"{k} {v:.4g}" for k, v in got.items())
                   + f" (the largest of {len(kept)} images)")
    for name in limits:
        run.check(name, got[name], limits[name])
    if ctl:
        run.extra["control_gaps"] = {k: max(g[k] for g in ctl) for k in ctl[0]}


def gaps(mask_cls, mask_pred, r_cls, r_pred, h, w, book) -> dict:
    """One image's numbers: the relative L2 gap of its class log-scores
    (``cls_gap``), of its upsampled mask logits (``mask_gap``) and the
    median query's inside the image (``mask_query_gap``); the share of the
    handed choices that the reference's own logits contradict beyond the
    margin (``flip_share``; any handed choice left over or of another
    shape makes it infinite)."""
    from perfbench.common.compare import rel_l2

    broken = book.mismatched or book.handed
    inside = (slice(None), slice(0, h), slice(0, w))
    per_query = [rel_l2(a, b) for a, b in zip(mask_pred[inside], r_pred[inside])]
    return {"cls_gap": rel_l2(mask_cls, r_cls), "mask_gap": rel_l2(mask_pred, r_pred),
            "mask_query_gap": statistics.median(per_query),
            "flip_share": float("inf") if broken else book.flip_share}


def control_gaps(ref, labels, image, h, w):
    """The control: the reference with every Dense and Conv rounded through
    float8 e4m3 in the program's place on the same image, making its own
    choices; the float32 reference follows them."""
    from perfbench.reference import decisions, evaluate, modules

    modules.LOW_PRECISION = torch.float8_e4m3fn
    try:
        with decisions.following(None, keep_on=image.device) as own:
            c_cls, c_pred = evaluate.outputs(ref, labels, image[None])
    finally:
        modules.LOW_PRECISION = None
    with decisions.following(own.kept, keep_on=image.device) as book:
        r_cls, r_pred = evaluate.outputs(ref, labels, image[None])
    return gaps(c_cls[0], c_pred[0], r_cls[0], r_pred[0], h, w, book)
