"""Synthetic train-then-evaluate convergence run (counterpart of
``tools/convergence.py``).

Trains TINY CategoryODISE or CaptionODISE on the synthetic shapes task
(``data/synthetic.py``: a red rectangle, a blue disk, grass) with the full
training recipe (LSJ mapper, matcher, auxiliary and point-sampled mask
losses, AdamW with the clip, warmup and milestones) and evaluates before and
after through ``train_net.do_test``. A wrong-sign matching cost, a wrong
assignment or a broken gradient cannot pass: the loss must fall and PQ,
mIoU and AP must rise far above their untrained values. The caption variant
learns with no category label at all: open-vocabulary classification has
to emerge from the grounding loss between mask and caption-word embeds.

    python -m odise_torch.convergence [--variant caption] [--steps 100] [--shipped-category]
        [--world-size 2 [--collect-mode diff]]

prints one JSON line with the loss curve's ends and the metrics before and
after. It runs on the card; ``--cpu`` runs it on the CPU. ``--world-size``
runs it on that many ranks (``engine.launch``), each with its share of the
batch, the caption grounding's negatives gathered over the ranks by
``--collect-mode``, the evaluation shared out: the counterpart of the JAX
run's ``--data-mesh``, which shards the batch over one process's devices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[conv t={time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def run_convergence(
    *,
    variant: str = "category",
    steps: int = 300,
    batch: int = 4,
    accum_steps: int = 1,
    lr: float = 1e-3,
    grad_clip: float = 0.01,
    weight_decay: float = 0.05,
    size: int = 64,
    n_train: int = 64,
    n_val: int = 8,
    max_instances: int = 8,
    num_points: int = 256,
    seed: int = 0,
    eval_before: bool = True,
    log_every: int = 25,
    dataset_name: str = "_synth_convergence_val",
    use_checkpoint: bool = False,
    slide_training: bool = False,
    backbone_in_size=None,
    collect_mode=None,
    device=None,
    world_size: int = 1,
) -> dict:
    """``use_checkpoint``, ``slide_training`` and ``backbone_in_size`` turn on
    the shipped category training features (the serial checkpointed slide
    over a crop grid); ``collect_mode`` is the caption grounding's, which on
    one process means the local batch. ``device`` defaults to CUDA.
    ``world_size`` > 1 runs on that many ranks through ``engine.launch``
    (``device`` as ``launch`` takes it), each loading
    ``batch / world_size`` images a step; it returns rank 0's result, which
    every rank shares. The JAX run writes its records to PNG files under an
    output directory; these are in memory."""
    kwargs = dict(locals())
    if world_size > 1:
        import os
        import tempfile

        from .engine.launch import launch

        del kwargs["world_size"]
        with tempfile.TemporaryDirectory() as tmp:
            launch(_convergence_rank, world_size, dist_url=f"file://{tmp}/rendezvous",
                   args=(kwargs, os.path.join(tmp, "result.json")), device=device)
            with open(os.path.join(tmp, "result.json")) as f:
                return json.load(f)

    from . import train_net
    from .config import ConfigDict
    from .data.catalog import DatasetCatalog, MetadataCatalog
    from .data.dataset_mapper import COCOPanopticDatasetMapper
    from .data.loader import build_train_loader
    from .data.synthetic import SYNTH_LABELS, make_shapes_records, synth_categories
    from .engine import make_caption_train_step, make_category_train_step, make_optimizer
    from .engine.train_loop import check_finite, partition_params
    from .losses import CriterionConfig, GroundingConfig
    from .model_zoo.factory import build_caption_odise, build_category_odise, resolve_device
    from .models.clip.tokenizer import tokenize
    from .parallel import get_data_rank, get_data_world_size, get_world_size

    assert variant in ("category", "caption"), variant
    caption = variant == "caption"
    device = resolve_device(device)
    log(f"dataset: {n_train} train / {n_val} val shapes images @ {size}px (variant={variant})")
    # the caption variant needs varied content: the grounding loss contrasts
    # images through their word sets, which must not all be the same
    train_records = make_shapes_records(n_train, size=size, seed=seed + 1,
                                        with_captions=caption, vary=caption)
    val_records = make_shapes_records(n_val, size=size, seed=seed + 2, vary=caption)
    DatasetCatalog.remove(dataset_name)
    DatasetCatalog.register(dataset_name, lambda: val_records)
    MetadataCatalog.get(dataset_name).set(ignore_label=255, categories=synth_categories())

    torch.manual_seed(seed)
    build = build_caption_odise if caption else build_category_odise
    model = build("tiny", train_labels=SYNTH_LABELS, with_clip_head=False,
                  use_checkpoint=use_checkpoint, slide_training=slide_training,
                  backbone_in_size=backbone_in_size, device=device)
    # the raw text embeds the eval wrapper computes: the flat synonyms
    # through the frozen text tower
    flat = [t for group in SYNTH_LABELS for t in group]
    with torch.no_grad():
        text_raw = model.encode_vocab(torch.from_numpy(tokenize(flat)).long().to(device))

    trainable, _ = partition_params(model)
    log(f"model built: {sum(p.numel() for p in trainable.values())} trainable params")
    opt = make_optimizer(trainable, lr=lr, weight_decay=weight_decay,
                         milestones=(int(steps * 8 / 9), int(steps * 17 / 18)),
                         warmup_steps=min(10, steps // 10))
    if caption:
        step = make_caption_train_step(
            model, opt, CriterionConfig(num_classes=1, num_points=num_points),
            GroundingConfig(collect_mode=collect_mode), grad_clip=grad_clip,
            accum_steps=accum_steps)
    else:
        step = make_category_train_step(
            model, opt, CriterionConfig(num_classes=len(SYNTH_LABELS), num_points=num_points),
            text_raw, SYNTH_LABELS, grad_clip=grad_clip, accum_steps=accum_steps)

    mapper = COCOPanopticDatasetMapper(image_size=size, max_instances=max_instances,
                                       with_captions=caption, num_words=4 if caption else 8,
                                       device=device)
    loader = build_train_loader(train_records, mapper, batch,
                                num_hosts=get_data_world_size(), host_id=get_data_rank(),
                                seed=seed)
    eval_cfg = ConfigDict(dataloader=ConfigDict(
        wrapper=ConfigDict(labels=[list(l) for l in SYNTH_LABELS], dataset_name=dataset_name,
                           semantic_on=True, panoptic_on=True, instance_on=True),
        eval_short_side=size, eval_max_size=2 * size))

    def evaluate():
        r = train_net.do_test(eval_cfg, model)["main"]
        return {k: float(v) for k, v in r.items() if isinstance(v, (int, float))}

    before = None
    if eval_before:
        log("eval (untrained baseline)")
        before = evaluate()
        log(f"untrained: PQ={before['PQ']:.2f} mIoU={before['mIoU']:.2f} AP={before['AP']:.2f}")

    gen = torch.Generator(device=device).manual_seed(seed + 100)
    losses = []
    t_train0 = time.perf_counter()
    for it in range(steps):
        metrics = step(next(loader), gen)
        total = float(metrics["total_loss"])
        check_finite({"total_loss": total}, it)
        losses.append(total)
        if it % log_every == 0 or it == steps - 1:
            log(f"step {it:4d} total_loss={total:8.3f} "
                f"grad_norm={float(metrics['grad_norm']):9.3f}")
    train_s = time.perf_counter() - t_train0

    log("eval (trained)")
    after = evaluate()
    log(f"trained: PQ={after['PQ']:.2f} mIoU={after['mIoU']:.2f} AP={after['AP']:.2f}")

    k = max(len(losses) // 10, 1)
    DatasetCatalog.remove(dataset_name)
    return {
        "variant": variant,
        "steps": steps,
        "batch": batch,
        "world_size": get_world_size(),
        "accum_steps": accum_steps,
        "lr": lr,
        "loss_first10_mean": float(np.mean(losses[:k])),
        "loss_last10_mean": float(np.mean(losses[-k:])),
        "loss_drop_pct": float(100.0 * (1.0 - np.mean(losses[-k:]) / np.mean(losses[:k]))),
        "metrics_before": before,
        "metrics_after": after,
        "train_seconds": train_s,
        "sec_per_step": train_s / steps,
    }


def _convergence_rank(kwargs: dict, result_path: str) -> None:
    from .parallel import get_rank

    result = run_convergence(**kwargs)
    if get_rank() == 0:
        with open(result_path, "w") as f:
            json.dump(result, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="category", choices=["category", "caption"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-clip", type=float, default=0.01)
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=8)
    ap.add_argument("--num-points", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-eval-before", action="store_true")
    ap.add_argument("--shipped-category", action="store_true",
                    help="the shipped category features: the serial checkpointed "
                    "slide over a 2x2 crop grid (128-px images over the TINY "
                    "model's 64-px backbone window)")
    ap.add_argument("--collect-mode", default=None, choices=["diff", "concat"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--world-size", type=int, default=1, help="ranks (engine.launch)")
    args = ap.parse_args()
    shipped = {}
    if args.shipped_category:
        shipped = dict(use_checkpoint=True, slide_training=True,
                       backbone_in_size=(64, 64), size=128)
    result = run_convergence(
        variant=args.variant, steps=args.steps, batch=args.batch,
        accum_steps=args.accum_steps, lr=args.lr, grad_clip=args.grad_clip,
        n_train=args.n_train, n_val=args.n_val, num_points=args.num_points,
        seed=args.seed, eval_before=not args.no_eval_before,
        collect_mode=args.collect_mode, device="cpu" if args.cpu else None,
        world_size=args.world_size, **shipped)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
