"""Training: ``engine.train_loop.Trainer`` over the port's train step
(``make_caption_train_step`` or ``make_category_train_step``), fed by
``data/loader.py::build_grain_train_loader`` with worker processes and
the COCO panoptic mapper (LSJ, target slots, caption words) over a
COCO-layout set drawn from the seed (``common/dataset.py``).

Set-up builds the one trainer object and drives it through its first
``follow`` steps, one ``Trainer.train`` call each as in the window, which
warm every shape. Over those steps the harness keeps the batches, the
first step's gradient before the clip (``clip_by_global_norm_`` wrapped)
and the program's discrete choices (``common/choices.py``: attention
masks, hard pooling masks, the matcher's assignments); the reference
follows the same steps afterwards from the same seeded weights, batches
and draws, taking the program's choices and checking them against its
own (``reference/decisions.py``). The window then runs whole steps until
``--seconds`` have passed.

Traffic parameters (``traffic/<name>.json``): ``batch`` images a step,
``records`` drawn, ``workers`` loader processes, ``num_words`` caption
words an image, ``follow`` steps held to the reference.
"""

from __future__ import annotations

import gc
import importlib
import shutil
import statistics
import time

import torch

from perfbench.common import choices, dataset, trace, weights
from perfbench.common.window import rate, run_window
from perfbench.reference import labels as ref_labels

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def options(run) -> dict:
    opts = dict(run.config["train"])
    opts.update(run.extra.get("opts_override", {}))
    return opts


def build_program(run, labels, opts):
    from odise_torch.engine import partition_params
    from odise_torch.model_zoo.factory import build_caption_odise, build_category_odise

    build = {"category": build_category_odise, "caption": build_caption_odise}[run.config["kind"]]
    model = build(run.scale or run.config["scale"], train_labels=labels,
                  with_clip_head=opts["with_clip_head"], use_checkpoint=opts["use_checkpoint"],
                  slide_training=opts["slide_training"], slide_serial=opts["slide_serial"],
                  device=run.device, dtype=DTYPES[run.dtype or opts["compute_dtype"]])
    trainable, _ = partition_params(model)
    return model, trainable


def drive(run, fault=None) -> None:
    """Set up, measure for ``run.seconds``, trace if asked, then hold the
    first steps to the reference. ``fault`` (tests only) wraps the train
    step."""
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_grain_train_loader
    from odise_torch.engine import (Trainer, make_caption_train_step,
                                    make_category_train_step, make_optimizer)
    from odise_torch.losses import CriterionConfig
    from odise_torch.models.clip.tokenizer import tokenize

    tr, dev, opts = run.traffic, run.device, options(run)
    kind = run.config["kind"]
    caption = kind == "caption"
    labels = ref_labels.coco_panoptic_labels()
    B = tr["batch"]
    records = dataset.write(run.seed, tr["records"], run.workload)
    mapper = COCOPanopticDatasetMapper(image_size=opts["image_size"],
                                       max_instances=opts["max_instances"],
                                       with_captions=caption, num_words=tr["num_words"],
                                       device=dev)
    loader = build_grain_train_loader(records, mapper, B, seed=run.seed % 4_000_000,
                                      worker_count=tr["workers"])
    model, trainable = build_program(run, labels, opts)
    spec = weights.specs(model)
    weights.fill_(model, run.seed)
    opt = make_optimizer(trainable, lr=opts["lr"], weight_decay=opts["weight_decay"])
    crit = CriterionConfig(num_classes=1 if caption else len(labels),
                           num_points=opts["num_points"])
    text_dim = model.text_encoder.text_projection.shape[1]
    if caption:
        step = make_caption_train_step(model, opt, crit, grad_clip=opts["grad_clip"])
    else:
        flat = [t for g in labels for t in g]
        with torch.no_grad():
            text = model.encode_vocab(torch.from_numpy(tokenize(flat)).long().to(dev))
        step = make_category_train_step(model, opt, crit, text, labels,
                                        grad_clip=opts["grad_clip"])
    planted = fault.install() if hasattr(fault, "install") else None
    if fault is not None and planted is None:
        step = fault(step, trainable)
    gen = torch.Generator(device=dev).manual_seed((int(run.seed) + 2) % 2 ** 63)
    gen_state = gen.get_state()
    follow = tr["follow"]
    kept = []

    def feed():
        for batch in loader:
            if len(kept) < follow:
                kept.append({k: v.detach().cpu() for k, v in batch.items()})
            yield batch

    trainer = Trainer(step, feed(), gen)
    first_grad, handed = _followed(trainer, trainable, follow)
    run.log.append(trainer.matching_log)
    after = {n: p.detach().cpu().clone() for n, p in trainable.items()}

    run.window_opens()
    step_s, cpu_s = [], []

    def once(i):
        t, c = time.perf_counter(), time.thread_time()
        trainer.train(follow + i, follow + i + 1)
        step_s.append(time.perf_counter() - t)
        cpu_s.append(time.thread_time() - c)

    steps, window = run_window(run.seconds, once)
    it = follow + steps
    hist = trainer.metrics_history
    run.attempted, run.failed = steps * B, 0
    run.e2e["train_img_per_s"] = rate(steps, B, window)
    run.extra.update(window_s=window, steps=steps, batch=B, kind=kind,
                     n_text=sum(len(g) for g in labels), text_dim=text_dim,
                     data_time_ms=[1e3 * m["data_time"] for m in hist[follow:]],
                     loss_follow=[m["total_loss"] for m in hist[:follow]])
    run.log.append(f"window: {steps} steps of {B} images in {window!r} s; loader wait "
                   f"median {statistics.median(run.extra['data_time_ms']):.3f} ms; step "
                   "seconds " + " ".join(f"{t:.3f}" for t in step_s))
    run.log.append("the main thread's CPU seconds a step " + " ".join(f"{t:.3f}" for t in cpu_s))
    if dev != "cpu":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        run.e2e["peak_mem_gib"] = run.memory_peak_bytes / 2 ** 30

    if run.trace:
        _traced(run, trainer, it)
        it += 2

    if planted is not None:
        planted()
    loader.close()
    stop_helpers()
    del model, trainable, opt, trainer, step, loader
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    try:
        _hold_to_reference(run, spec, labels, kept, gen_state, first_grad, handed, after, opts)
    finally:
        shutil.rmtree(dataset.root(run.seed, run.workload), ignore_errors=True)


def _followed(trainer, trainable, follow):
    """Steps 0 to ``follow`` - 1, one ``Trainer.train`` call each, keeping
    the first step's gradient as the clip receives it and every choice the
    program makes, on the host; the wrappers are taken off after."""
    import odise_torch.engine.train_loop as loop

    first, handed = {}, []
    clip = loop.clip_by_global_norm_

    def keep_first(grads, max_norm, norm):
        if not first:
            first.update({n: p.grad.detach().cpu().clone() for n, p in trainable.items()
                          if p.grad is not None})
        return clip(grads, max_norm, norm)

    taken = choices.Choices()
    taken.sink = lambda t: handed.append(t.detach().cpu())
    excess = []
    taken.on_assignment = lambda cost, got: excess.append(own_excess(cost, got))
    lap = importlib.import_module("odise_torch.ops.lap").auction_lap
    before = (lap.calls, lap.rounds, lap.filled)
    undo = choices.install(taken)
    loop.clip_by_global_norm_ = keep_first
    try:
        for i in range(follow):
            trainer.train(i, i + 1)
    finally:
        loop.clip_by_global_norm_ = clip
        undo()
    if not first:
        raise RuntimeError("the train step never reached the gradient clip")
    calls, rounds, filled = (a - b for a, b in zip((lap.calls, lap.rounds, lap.filled), before))
    trainer.matching_log = (f"the program's matching over the followed steps: {calls} auctions, "
                            f"{rounds} rounds, {filled} targets filled in order at the cap; "
                            "its cost above the exact optimum of its own costs, per target "
                            "told apart, the largest of each auction: "
                            + " ".join(f"{e:.4g}" for e in excess))
    return first, handed


def own_excess(cost: torch.Tensor, got: torch.Tensor) -> float:
    """The cost of the program's assignment ``got`` [B, T] above the exact
    optimum of its own ``cost`` [B, Q, T], per target told apart, the
    largest over the batch (scipy's Hungarian method on the host)."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().double().cpu()
    worst = 0.0
    for b in range(c.shape[0]):
        rows, cols = linear_sum_assignment(c[b].numpy())
        best = float(c[b][torch.as_tensor(rows), torch.as_tensor(cols)].sum())
        picked = float(torch.gather(c[b], 0, got[b].cpu()[None]).sum())
        told = max(int((c[b].amax(0) != c[b].amin(0)).sum()), 1)
        worst = max(worst, (picked - best) / told)
    return worst


def stop_helpers() -> None:
    """Stop the processes that the loader's worker pool left running for
    reuse (multiprocessing's fork server and resource tracker) and wait for
    them, so that the run leaves no process behind."""
    from multiprocessing import forkserver, resource_tracker

    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(helper, "_stop", None)
        if stop is not None:
            stop()


def _traced(run, trainer, it) -> None:
    """One traced whole step plain (idle share, launches, the breakdown),
    then one with the metrics' ranges (rooflines)."""
    from perfbench.common import manifest

    stretch, ranges = {}, {}
    torch.cuda.synchronize()
    with trace.traced(stretch):
        trainer.train(it, it + 1)
    run.stretch = stretch["trace"]
    run.extra["stretch_images"] = run.traffic["batch"]
    installs = [mod.install(run) for mod in manifest.per_layer_modules(run.workload).values()
                if hasattr(mod, "install")]
    torch.cuda.synchronize()
    with trace.traced(ranges):
        trainer.train(it + 1, it + 2)
    for undo in installs:
        undo()
    run.ranges = ranges["trace"]
    r = run.ranges
    names = {}
    for e in r.host:
        if e.name.startswith("perfbench."):
            names[(e.name, e.kind, e.thread)] = names.get((e.name, e.kind, e.thread), 0) + 1
    threads = {}
    for e in r.runtime.values():
        threads[e.thread] = threads.get(e.thread, 0) + 1
    linked = sum(1 for d in r.device if d.corr in r.runtime)
    run.log.append(f"instrumented stretch: {len(r.device)} device events ({linked} linked to "
                   f"a runtime call), {len(r.runtime)} runtime calls by thread {threads}, "
                   f"ranges {names}, deform calls {len(run.extra.get('deform_work', []))}, "
                   f"fwd ns {r.range_device_ns('perfbench.deform_fwd')}, bwd ns "
                   f"{r.range_device_ns('perfbench.deform_bwd')}")


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Per leaf, the gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger; with both norms."""
    ref_n = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in keep}
    med = statistics.median(ref_n.values())
    out = {}
    for n in keep:
        p = float(torch.linalg.vector_norm(prog[n].double()))
        out[n] = (abs(p - ref_n[n]) / max(ref_n[n], med), p, ref_n[n])
    return out


def total_diff(prog: dict, ref: dict, keep) -> float:
    """||prog - ref|| / ||ref|| over every element of the kept leaves together."""
    num = sum(float(torch.sum((prog[n].double() - ref[n].double()) ** 2)) for n in keep)
    den = sum(float(torch.sum(ref[n].double() ** 2)) for n in keep)
    return (num / den) ** 0.5


def worst(gaps: dict, k: int = 3) -> str:
    top = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:k]
    return "; ".join(f"{n} {g:.4g} ({p:.4g} vs {r:.4g})" for n, (g, p, r) in top)


def compare(losses, first_grad, after, ref, start, keep, book) -> dict:
    """The numbers of one side (the program, or the control) against the
    reference's ``ref`` (``reference.train.follow``, which followed that
    side's choices as ``book`` recorded): the losses' gaps over the steps
    and at the first; the first gradient's difference over the kept leaves
    together, and the largest and the median leaf's gap of norms; the same
    of the parameters' change over the steps; the shares of handed
    thresholds and points that the reference contradicts, in the first
    step (``flip_share``, ``point_share``) and over all (``_3``); the
    largest cost of a handed assignment above the optimum (any handed
    choice left over or of another shape makes the shares and the excess
    infinite)."""
    grads = leaf_gaps(first_grad, ref["first_grad"], keep)
    d_prog = {n: after[n] - start[n] for n in keep}
    d_ref = {n: ref["params"][n] - start[n] for n in keep}
    updates = leaf_gaps(d_prog, d_ref, keep)
    broken = book.mismatched or book.handed
    first = book.marks[0]
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"])),
            "first_loss_gap": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_diff": total_diff(first_grad, ref["first_grad"], keep),
            "update_diff": total_diff(d_prog, d_ref, keep),
            "grad_gap": max(g for g, _, _ in grads.values()),
            "update_gap": max(g for g, _, _ in updates.values()),
            "median_grad_gap": statistics.median(g for g, _, _ in grads.values()),
            "median_update_gap": statistics.median(g for g, _, _ in updates.values()),
            "flip_share": float("inf") if broken else first.flip_share,
            "point_share": float("inf") if broken else first.point_share,
            "flip_share_3": float("inf") if broken else book.flip_share,
            "point_share_3": float("inf") if broken else book.point_share,
            "match_excess": float("inf") if broken else book.match_excess,
            "_grads": grads, "_updates": updates}


def _hold_to_reference(run, spec, labels, kept, gen_state, first_grad, handed, after,
                       opts) -> None:
    from perfbench.reference import decisions
    from perfbench.reference import modules as rmodules
    from perfbench.reference import train as rtrain

    limits = run.extra["limits"]
    ref = rtrain.build(run.config["kind"], run.scale or run.config["scale"], labels, opts,
                       run.device)
    if weights.specs(ref) != spec:
        raise RuntimeError("the program's parameters differ from the reference's in name "
                           "or shape: the seeded weights cannot be handed to both")

    def follow(choices):
        weights.fill_(ref, run.seed)
        gen = torch.Generator(device=run.device)
        gen.set_state(gen_state)
        with decisions.following(choices) as book:
            out = rtrain.follow(ref, run.config["kind"], labels, kept, gen, opts)
        return out, book

    weights.fill_(ref, run.seed)
    start = {n: p.detach().cpu().clone() for n, p in ref.named_parameters()
             if rtrain.is_trainable(n)}
    out, book = follow(handed)
    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in out["first_grad"].items()}
    med = statistics.median(norms.values())
    # leaves that the reference's gradient leaves at rounding noise move by it alone
    keep = [n for n in norms if norms[n] >= 1e-3 * med]
    got = compare(run.extra["loss_follow"], first_grad, after, out, start, keep, book)
    run.extra.update(reference_losses=out["losses"], leaves_kept=len(keep),
                     leaves=len(norms), gaps={k: v for k, v in got.items() if k[0] != "_"})
    run.log.append(f"reference: losses program {run.extra['loss_follow']} reference "
                   f"{out['losses']}; {len(keep)} of {len(norms)} leaves compared; "
                   f"{book.thresholds} handed thresholds, {book.mismatched} not taken")
    run.log.append(f"worst gradient leaves: {worst(got['_grads'])}")
    run.log.append(f"worst update leaves: {worst(got['_updates'])}")
    run.log.append("numbers: " + ", ".join(f"{k} {v:.4g}" for k, v in run.extra["gaps"].items()))
    for name in limits:
        run.check(name, got[name], limits[name])
    if run.extra.get("control"):
        # the control makes its own choices; the float32 reference follows them
        rmodules.LOW_PRECISION = torch.float8_e4m3fn
        try:
            low, own = follow(None)
        finally:
            rmodules.LOW_PRECISION = None
        ref2, book2 = follow(own.kept)
        ctl = compare(low["losses"], low["first_grad"], low["params"], ref2, start, keep, book2)
        run.extra["control_gaps"] = {k: v for k, v in ctl.items() if k[0] != "_"}
