"""Train and evaluate from a config (counterpart of ``tools/train_net.py``).

    python -m odise_torch.train_net --config-file odise_torch/configs/Panoptic/odise_label_coco_50e.py \\
        [--num-gpus N] [--num-machines M --machine-rank R --dist-url tcp://host:port] \\
        [--eval-only] [--resume] [--init-from PATH] [--output DIR] [a.b.c=value ...]

Loads the lazy config, scales it to the world size (``auto_scale_workers``),
applies ``--output``/``--tag``/``--ref`` and the dotted overrides, sets up the
output directory (``log.txt``, ``config.yaml``, seeds), then trains
(``do_train``: checkpoints under ``<output>/checkpoints``, ``metrics.json``,
periodic and final evaluation) or evaluates (``do_test``). The model runs on
``train.device``: CUDA in the shipped configs, which raises without a card;
``train.device=cpu`` runs on the CPU. Nothing falls back to the CPU.

``--num-gpus N`` starts N processes on this machine through
``engine.launch`` (``--num-machines``, ``--machine-rank`` and ``--dist-url``
join several machines): rank r trains on card r over NCCL, or on the CPU
over gloo with ``train.device=cpu``. Each rank loads its slice of the batch
(the loader's ``num_hosts``/``host_id``), the train step averages the
gradients over the ranks, and the evaluation shares the records out over
the ranks and merges their statistics (``dataloader.eval_multihost``,
default on). Only rank 0 writes ``log.txt``, ``config.yaml``,
``metrics.json`` and the checkpoints; rank r > 0 logs to ``log.txt.rank<r>``.
The CLI never puts two ranks on one card: ``train.device=cuda:k`` with
``--num-gpus`` above 1 raises (``engine.launch``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import (apply_overrides, auto_scale_workers, instantiate, instantiate_odise,
                     load_config, resolve)
from .data.catalog import DatasetCatalog, MetadataCatalog
from .data.datasets.register_ade20k import load_ade_instance_gt_index
from .data.datasets.register_coco import load_instance_gt_index
from .engine.checkpoint import BestCheckpointer, Checkpointer
from .engine.defaults import default_setup
from .engine.hooks import EvalHook, PeriodicCheckpointer, PeriodicWriter
from .engine.launch import launch
from .engine.optimizer import make_optimizer
from .engine.train_loop import (Trainer, make_caption_train_step, make_category_train_step,
                                partition_params)
from .evaluation.run import evaluate_open_vocab
from .model_zoo.factory import resolve_device
from .models.clip.tokenizer import tokenize
from .models.wrapper import OpenPanopticInference, build_open_vocabulary
from .parallel.multihost import (get_data_rank, get_data_world_size, get_world_size,
                                 is_main_process, sync_global_devices)
from .utils.events import (CommonMetricPrinter, EventStorage, JSONWriter, WandbWriter,
                           WriterStack)

logger = logging.getLogger("odise_torch")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-from", default="", help="initial checkpoint path")
    p.add_argument("--output", default="", help="override train.output_dir")
    p.add_argument("--tag", default="", help="run tag")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of steps 10-15 to <output>/profile")
    p.add_argument("--ref", type=int, default=-1,
                   help="reference world size for auto scaling")
    p.add_argument("--max-eval-images", type=int, default=-1,
                   help="cap eval images per task (smoke runs)")
    p.add_argument("--num-gpus", type=int, default=1, help="processes (cards) per machine")
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0, help="this machine's rank")
    p.add_argument("--dist-url", default="auto",
                   help="the process group's rendezvous: tcp://host:port, file:///path, "
                        "or auto (a free port on this machine)")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="dotted config overrides: a.b.c=value")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """The run's config: loaded, scaled to the world size, overridden; the
    output directory set up. In a process group a CUDA ``train.device``
    becomes the rank's card. Raises if ``train.device`` is CUDA and there is
    no card."""
    cfg = load_config(args.config_file)
    if args.output:
        cfg.train.output_dir = args.output
    if args.tag:
        cfg.train.run_tag = args.tag
    if args.ref > 0:
        cfg.train.reference_world_size = args.ref
    cfg = auto_scale_workers(cfg, get_data_world_size())
    if args.opts:
        apply_overrides(cfg, [o for o in args.opts if "=" in o])
    device = resolve_device(cfg.train.device)
    if get_world_size() > 1 and device.type == "cuda":
        cfg.train.device = f"cuda:{torch.cuda.current_device()}"
    default_setup(cfg, args)
    return cfg


def build_model(cfg):
    """The config's model on ``train.device``, initialised from ``train.seed``
    (training and ``--eval-only`` get the same frozen towers)."""
    torch.manual_seed(cfg.train.seed)
    return instantiate_odise(cfg.model, device=cfg.train.device)


def build_vocab_and_thing_mask(model, wrapper_cfg, train_labels):
    labels = wrapper_cfg["labels"]
    meta = MetadataCatalog.get(wrapper_cfg["dataset_name"])
    thing_mask = None
    if meta.get("categories"):
        thing_mask = np.asarray([bool(c["isthing"]) for c in meta.get("categories")])
    else:
        # stuff merging in panoptic fusion is disabled under the all-things
        # default; silent metadata gaps would quietly change PQ
        logger.warning(
            "Dataset %s metadata has no 'categories': thing_mask defaults to "
            "all-things (panoptic stuff merging disabled)", wrapper_cfg["dataset_name"])
    return build_open_vocabulary(model, labels, train_labels=train_labels,
                                 thing_mask=thing_mask,
                                 with_clip_head=model.clip_head is not None)


def do_test(cfg, model, max_images: int = -1, final_iter: bool = True) -> Dict[str, dict]:
    """Open-vocabulary evaluation of the main task and the extra tasks
    (those marked ``final_iter_only`` only when ``final_iter``). An extra
    task is skipped with a warning, as in ``tools/train_net.py``, where its
    dataset is not registered or fails to load, has no records, or its first
    record's image file is absent. The main task in that state raises: a run
    does not go on without its evaluation. Under ``dataloader.eval_multihost``
    (default True) the ranks share each task's records and return the same
    merged metrics."""
    tasks = {"main": cfg.dataloader.wrapper}
    for name, t in cfg.get("extra_task", {}).items():
        if t.get("final_iter_only") and not final_iter:
            continue
        tasks[name] = t["task"]["wrapper"]
    eval_short = cfg.dataloader.get("eval_short_side", 1024)
    eval_max = cfg.dataloader.get("eval_max_size", 2560)
    across_ranks = bool(cfg.dataloader.get("eval_multihost", True))

    # every task's records first, so that a main task that cannot be
    # evaluated fails the call before any evaluation runs
    runs = []
    for task_name, wrapper in tasks.items():
        wrapper_cfg = instantiate(wrapper)
        dataset_name = wrapper_cfg["dataset_name"]
        try:
            records = DatasetCatalog.get(dataset_name)
            if not records:
                raise ValueError(f"dataset '{dataset_name}' has no records")
            first = records[0]
            if "image" not in first and not os.path.isfile(first.get("file_name", "")):
                raise FileNotFoundError(f"dataset '{dataset_name}': its first image "
                                        f"{first.get('file_name')!r} is not there")
        except Exception as err:  # a task's data that cannot be read
            if task_name == "main":
                raise
            logger.warning("Skipping task %s: %s", task_name, err)
            continue
        if max_images > 0:
            records = records[:max_images]
        runs.append((task_name, wrapper_cfg, dataset_name, records))

    results = {}
    for task_name, wrapper_cfg, dataset_name, records in runs:
        meta = MetadataCatalog.get(dataset_name)
        instance_on = wrapper_cfg.get("instance_on", True)
        inst_json, thing_ids = meta.get("json_file"), meta.get("thing_dataset_id_to_contiguous_id")
        # the instances json is the instance gt where the dataset has one;
        # its ids map into the task's contiguous classes. ADE20K's names its
        # masks by PNG and its images by file name (ROADMAP C34)
        load_index = (load_ade_instance_gt_index
                      if meta.get("evaluator_type") == "ade20k_panoptic_seg"
                      else load_instance_gt_index)
        inst_gt_index = (load_index(inst_json, thing_ids)
                         if instance_on and inst_json and thing_ids
                         and os.path.isfile(inst_json) else None)
        vocab = build_vocab_and_thing_mask(model, wrapper_cfg, model.train_labels)
        r = evaluate_open_vocab(
            OpenPanopticInference(model, vocab), records, labels=vocab.labels,
            thing_mask=vocab.thing_mask.cpu().numpy(),
            device_stats=cfg.dataloader.get("eval_device_stats", True),
            short_side=eval_short, max_size=eval_max,
            semantic_on=wrapper_cfg.get("semantic_on", True),
            panoptic_on=wrapper_cfg.get("panoptic_on", True),
            instance_on=instance_on, ignore_label=int(meta.get("ignore_label", 255)),
            inst_gt_index=inst_gt_index, task=task_name, across_ranks=across_ranks)
        results[task_name] = r
        logger.info("Task %s: %s", task_name,
                    {k: round(float(v), 2) for k, v in r.items() if isinstance(v, float)})
    return results


class _ProfileWindow:
    """A ``torch.profiler`` trace of the steps ``start_iter + 10`` to
    ``start_iter + 14``, written to ``<out_dir>/trace.json``."""

    def __init__(self, start_iter: int, out_dir: str):
        self.first, self.last = start_iter + 9, start_iter + 14
        self.out_dir = out_dir
        self.prof = None

    def due(self, iteration: int) -> bool:
        return iteration in (self.first, self.last)

    def __call__(self, iteration: int, metrics) -> None:
        if iteration == self.first:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif iteration == self.last and self.prof is not None:
            self.prof.stop()
            os.makedirs(self.out_dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
            self.prof = None


@dataclasses.dataclass
class TrainRun:
    """What ``do_train`` leaves: the trained model and optimizer, the
    iteration it started at, the optimizer's update count right after
    ``resume_or_load``, every step's metrics and the last evaluation."""

    cfg: object
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    start_iter: int
    start_count: int
    history: list
    eval_results: dict


def do_train(args, cfg) -> TrainRun:
    cfg = resolve(cfg)
    device = resolve_device(cfg.train.device)
    model = build_model(cfg)
    criterion_cfg = instantiate(cfg.criterion)
    if "mapper" in cfg.dataloader.train:
        cfg.dataloader.train.mapper.device = str(device)
    if get_data_world_size() > 1:  # each data rank loads its slice of the stream
        cfg.dataloader.train.num_hosts = get_data_world_size()
        cfg.dataloader.train.host_id = get_data_rank()
    train_loader = instantiate(cfg.dataloader.train)
    batch0 = next(train_loader)
    is_caption = "word_tokens" in batch0

    # the training vocabulary's text embeds, once, from the frozen text tower
    labels = model.train_labels
    if not is_caption:
        flat = [t for group in labels for t in group]
        with torch.no_grad():
            text_embed_raw = model.encode_vocab(
                torch.from_numpy(tokenize(flat)).long().to(device))

    trainable, _ = partition_params(model)
    opt = make_optimizer(trainable, lr=cfg.optimizer.lr,
                         weight_decay=cfg.optimizer.weight_decay,
                         milestones=tuple(cfg.optimizer.milestones),
                         warmup_steps=int(cfg.optimizer.get("warmup_steps", 0)),
                         warmup_factor=float(cfg.optimizer.get("warmup_factor", 1e-3)))
    ck = Checkpointer(os.path.join(cfg.train.output_dir, "checkpoints"),
                      max_to_keep=cfg.train.checkpointer.max_to_keep,
                      backend=cfg.train.checkpointer.get("backend", "torch"))
    start_iter, _ = ck.resume_or_load(args.init_from or None, trainable,
                                      resume=args.resume, optimizer=opt)
    logger.info("Starting at iteration %d, optimizer update count %d", start_iter, opt.count)
    start_count = opt.count
    best_ck = BestCheckpointer(ck, metric="main/PQ", mode="max")
    storage = EventStorage(start_iter)
    eval_results: dict = {}

    def run_eval(final_iter: bool, next_iter: int) -> None:
        # every rank evaluates its share, or the main process all of it
        results = {}
        if cfg.dataloader.get("eval_multihost", True) or is_main_process():
            results = do_test(cfg, model, max_images=args.max_eval_images,
                              final_iter=final_iter)
        flat = {f"{task}/{k}": v for task, r in results.items()
                for k, v in r.items() if isinstance(v, (int, float))}
        if is_main_process():
            best_ck.maybe_save(flat, trainable, opt, next_iter)
        if not final_iter:
            storage.put_scalars(**flat)
        eval_results.clear()
        eval_results.update(results)
        sync_global_devices("eval_done")

    accum = int(cfg.train.get("accum_steps", 1))
    if accum > 1:
        logger.info("Gradient accumulation: %d micro-steps per update", accum)
    if is_caption:
        step_fn = make_caption_train_step(model, opt, criterion_cfg,
                                          instantiate(cfg.grounding_criterion),
                                          grad_clip=cfg.optimizer.grad_clip,
                                          accum_steps=accum)
    else:
        step_fn = make_category_train_step(model, opt, criterion_cfg, text_embed_raw,
                                           labels, grad_clip=cfg.optimizer.grad_clip,
                                           accum_steps=accum)

    # the metrics are the ranks' mean, the same on every rank: rank 0 writes
    writers, hooks = [], []
    if is_main_process():
        writers = [CommonMetricPrinter(cfg.train.max_iter),
                   JSONWriter(os.path.join(cfg.train.output_dir, "metrics.json"))]
        if args.wandb:
            writers.append(WandbWriter(max_iter=cfg.train.max_iter))
        hooks.append(PeriodicCheckpointer(ck, trainable, opt, cfg.train.checkpointer.period,
                                          cfg.train.max_iter))
    hooks += [EvalHook(cfg.train.eval_period, run_eval, cfg.train.max_iter,
                       eval_after_train=cfg.train.eval_period > 0),
              PeriodicWriter(writers, storage, cfg.train.log_period)]
    if args.profile and is_main_process():
        hooks.append(_ProfileWindow(start_iter,
                                    os.path.join(cfg.train.output_dir, "profile")))

    def batches():
        yield batch0
        yield from train_loader

    trainer = Trainer(step_fn, batches(),
                      torch.Generator(device=device).manual_seed(cfg.train.seed + 1),
                      hooks=hooks, log_period=cfg.train.log_period)
    try:
        with WriterStack(writers):
            trainer.train(start_iter, cfg.train.max_iter)
    finally:
        if hasattr(train_loader, "close"):  # a worker loader's processes exit
            train_loader.close()
    sync_global_devices("train_end")  # rank 0's last checkpoint is written
    return TrainRun(cfg=cfg, model=model, optimizer=opt, start_iter=start_iter,
                    start_count=start_count, history=trainer.metrics_history,
                    eval_results=eval_results)


def main(argv: Optional[List[str]] = None):
    """Run the CLI on ``argv`` (default ``sys.argv``); returns the
    ``TrainRun``, or with ``--eval-only`` the results by task. With more
    than one process (``--num-gpus``, ``--num-machines``) the ranks run
    ``run`` through ``launch`` and this returns None."""
    args = parse_args(argv)
    if args.num_gpus * args.num_machines == 1:
        return run(args)
    # the ranks' device from the config and its overrides, before any starts
    cfg = load_config(args.config_file)
    apply_overrides(cfg, [o for o in args.opts if "=" in o])
    return launch(run, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url,
                  args=(args,), device=cfg.train.device)


def run(args: argparse.Namespace):
    """``main`` in one process, of a process group or alone."""
    cfg = setup(args)
    if not args.eval_only:
        return do_train(args, cfg)
    cfg = resolve(cfg)
    model = build_model(cfg)
    if args.init_from:
        Checkpointer(os.path.dirname(args.init_from) or ".").load(
            args.init_from, dict(model.named_parameters()))
    return do_test(cfg, model, max_images=args.max_eval_images)


if __name__ == "__main__":
    main()
