"""The port's hooks, events, checkpoints and resume (``odise_torch/engine``,
``odise_torch/utils/events.py``) against the JAX package's: every hook,
timer, writer, schedule and masking case of ``tests/test_engine.py`` on
the port; the ``Checkpointer`` held to the JAX one (``backend="pickle"``)
over the same saves; and a TINY run resumed from a checkpoint held to the
same run straight through."""

import json
import logging
import os
import sys
import time

import numpy as np
import pytest
import torch

from odise_torch.engine.checkpoint import BestCheckpointer, Checkpointer, split_frozen
from odise_torch.engine.hooks import EvalHook, PeriodicCheckpointer, PeriodicWriter
from odise_torch.engine.optimizer import make_optimizer, multistep_lr
from odise_torch.engine.train_loop import Trainer, partition_params
from odise_torch.utils.events import (CommonMetricPrinter, EventStorage, JSONWriter,
                                      WandbWriter, WriterStack)
from .torch_threads import one_thread  # noqa: F401,E402


@pytest.fixture
def port_log(caplog):
    """caplog on the package logger, which stops propagating once
    ``setup_logger`` has run."""
    logger = logging.getLogger("odise_torch")
    logger.addHandler(caplog.handler)
    yield caplog
    logger.removeHandler(caplog.handler)


def test_eval_hook_period_and_final_dedup():
    calls = []

    def eval_fn(final_iter, next_iter):
        calls.append((final_iter, next_iter))

    hook = EvalHook(period=2, eval_fn=eval_fn, max_iter=6)
    for it in range(6):
        hook(it, {})
    # periods at 2, 4 (in-loop, final_iter=False); 6 == max_iter -> only the
    # after-train eval runs
    assert calls == [(False, 2), (False, 4), (True, 6)]
    assert [it for it in range(6) if hook.due(it)] == [1, 3, 5]


def test_iteration_timer_and_writer():
    storage = EventStorage()
    writer_calls = []

    class W:
        def write(self, s):
            writer_calls.append(s.iter)

    pw = PeriodicWriter([W()], storage, period=2)
    for it in range(4):
        # the keys Trainer puts into each step's metrics
        metrics = {"loss": float(it), "data_time": 0.001, "time": 0.01 * (it + 1)}
        pw(it, metrics)
    assert len(writer_calls) == 2
    assert storage.iter == 4
    assert storage.latest()["time"] == (3, 0.04)


def test_multistep_lr_values():
    sched = multistep_lr(1e-4, milestones=[10, 20], gamma=0.1, warmup_steps=5,
                         warmup_factor=0.0)
    np.testing.assert_allclose(float(sched(0)), 0.0, atol=1e-12)
    np.testing.assert_allclose(float(sched(5)), 1e-4, rtol=1e-6)
    np.testing.assert_allclose(float(sched(15)), 1e-5, rtol=1e-6)
    np.testing.assert_allclose(float(sched(25)), 1e-6, rtol=1e-6)


def test_optimizer_masks_frozen_params():
    model = torch.nn.ModuleDict({"decoder": torch.nn.Linear(4, 4, bias=False),
                                 "unet": torch.nn.Linear(4, 4, bias=False)})
    trainable, frozen = partition_params(model)
    assert list(trainable) == ["decoder.weight"] and list(frozen) == ["unet.weight"]
    assert not model["unet"].weight.requires_grad
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(trainable, lr=0.1, weight_decay=0.0)
    for p in trainable.values():
        p.grad = torch.ones_like(p)
    opt.step()
    assert not torch.equal(model["decoder"].weight.detach(), before["decoder.weight"])
    assert torch.equal(model["unet"].weight, before["unet.weight"])


def test_periodic_checkpointer_names(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=10)
    params = {"decoder.weight": torch.ones(2, 2)}
    hook = PeriodicCheckpointer(ck, params, None, period=2, max_iter=5)
    for it in range(5):
        hook(it, {})
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint", "model_0000001.pth",
                                            "model_0000003.pth", "model_final.pth"]
    assert [it for it in range(5) if hook.due(it)] == [1, 3, 4]
    assert ck.load(ck.get_checkpoint_file(), params)[0] == 5


def test_trainer_flushes_when_a_hook_is_due():
    """With a log window of 10, a hook that is due after step 2 sees steps 0
    to 2 before step 3 runs; every step's metrics carry ``time``."""
    events = []

    def step(batch, generator):
        events.append(("step", batch))
        return {"total_loss": torch.tensor(float(batch))}

    class Due:
        def due(self, it):
            return it == 2

        def __call__(self, it, metrics):
            events.append(("hook", it))

    trainer = Trainer(step, iter(range(100)), hooks=[Due()], log_period=10)
    trainer.train(0, 5)
    assert events == [("step", 0), ("step", 1), ("step", 2), ("hook", 0), ("hook", 1),
                      ("hook", 2), ("step", 3), ("step", 4), ("hook", 3), ("hook", 4)]
    assert all(m["time"] >= 0 and "data_time" in m for m in trainer.metrics_history)


def test_writers(tmp_path, port_log):
    storage = EventStorage(start_iter=7)
    storage.put_scalars(total_loss=2.0, time=0.5, lr=1e-4)
    path = str(tmp_path / "metrics.json")
    printer = CommonMetricPrinter(max_iter=10)
    with port_log.at_level(logging.INFO, logger="odise_torch"):
        with pytest.raises(RuntimeError):
            with WriterStack([JSONWriter(path), printer]) as writers:
                for w in writers:
                    w.write(storage)
                raise RuntimeError("the stack closes its writers all the same")
    assert json.loads(open(path).read()) == {"iteration": 7, "lr": 1e-4, "time": 0.5,
                                             "total_loss": 2.0}
    assert "eta: 0:00:01  iter: 7" in port_log.text and "total_loss: 2" in port_log.text


def test_wandb_writer_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails: a no-op writer
    w = WandbWriter(max_iter=10)
    w.write(EventStorage())
    w.close()


def _kept(directory):
    return sorted(os.path.splitext(f)[0] for f in os.listdir(directory)
                  if f.endswith((".pth", ".ckpt")))


@pytest.mark.parametrize("max_to_keep", [1, 2, 3])
def test_checkpointer_matches_jax(tmp_path, max_to_keep):
    """The same saves through both packages' checkpointers keep the same
    names, point ``last_checkpoint`` at the same one, leave the frozen
    towers out and resume at the same iteration."""
    from odise_tpu.engine.checkpoint import Checkpointer as JaxCheckpointer

    jparams = {"decoder": {"w": np.ones((2, 2), np.float32)},
               "unet": {"w": np.ones((2, 2), np.float32)}}
    tparams = {"decoder.w": torch.ones(2, 2), "unet.w": torch.ones(2, 2)}
    jck = JaxCheckpointer(str(tmp_path / "jax"), max_to_keep=max_to_keep, backend="pickle")
    tck = Checkpointer(str(tmp_path / "torch"), max_to_keep=max_to_keep)
    assert not jck.has_checkpoint() and not tck.has_checkpoint()
    assert (jck.resume_or_load(None, jparams, resume=True)[2]
            == tck.resume_or_load(None, tparams, resume=True)[0] == 0)
    for name, step in [("model_0000001", 2), ("model_0000003", 4), ("model_best", 4),
                       ("model_0000005", 6), ("model_0000007", 8), ("model_final", 8)]:
        jck.save(name, jparams, None, step)
        tck.save(name, tparams, None, step)
        time.sleep(0.01)  # the oldest goes first, by modification time
        assert _kept(jck.save_dir) == _kept(tck.save_dir)
        assert (open(os.path.join(jck.save_dir, "last_checkpoint")).read()
                == open(os.path.join(tck.save_dir, "last_checkpoint")).read() == name)
    assert (jck.resume_or_load(None, jparams, resume=True)[2]
            == tck.resume_or_load(None, tparams, resume=True)[0] == 8)
    best = os.path.join(tck.save_dir, "model_best.pth")
    assert (jck.resume_or_load(os.path.join(jck.save_dir, "model_best.ckpt"), jparams,
                               resume=False)[2]
            == tck.resume_or_load(best, tparams, resume=False)[0] == 4)
    assert list(torch.load(best, weights_only=True)["params"]) == ["decoder.w"]


def test_checkpoint_round_trip_and_missing_report(tmp_path, port_log):
    params = {"decoder.w": torch.randn(3, 3), "unet.w": torch.randn(2)}
    trainable, frozen = split_frozen(params)
    assert list(trainable) == ["decoder.w"] and list(frozen) == ["unet.w"]
    ck = Checkpointer(str(tmp_path))
    ck.save("model_final", params, None, 5, {"note": "x"})
    target = {"decoder.w": torch.zeros(3, 3), "unet.w": torch.zeros(2),
              "head.extra": torch.zeros(1)}
    with port_log.at_level(logging.WARNING, logger="odise_torch"):
        step, extra = ck.load(ck.get_checkpoint_file(), target)
    assert (step, extra) == (5, {"note": "x"})
    assert torch.equal(target["decoder.w"], params["decoder.w"])
    assert torch.equal(target["unet.w"], torch.zeros(2))  # frozen: not in the file
    assert "Missing 1 trainable keys (common prefix 'head.extra.')" in port_log.text
    with pytest.raises(ValueError):
        Checkpointer(str(tmp_path), backend="orbax")


def test_best_checkpointer(tmp_path):
    ck = Checkpointer(str(tmp_path))
    best = BestCheckpointer(ck, metric="main/PQ", mode="max")
    params = {"decoder.w": torch.ones(1)}
    assert best.maybe_save({"main/PQ": 10.0}, params, step=2)
    assert not best.maybe_save({"main/PQ": 5.0}, params, step=4)
    assert not best.maybe_save({"main/mIoU": 50.0}, params, step=6)
    assert best.maybe_save({"main/PQ": 11.0}, params, step=8)
    assert ck.load(os.path.join(str(tmp_path), "model_best.pth"), params) == (
        8, {"best_metric": 11.0})


def test_adamw_state_carries_the_count():
    p = torch.nn.Parameter(torch.ones(2, 2))
    opt = make_optimizer({"w": p}, lr=0.1, warmup_steps=4)
    p.grad = torch.ones(2, 2)
    opt.step()
    opt.step()
    sd = opt.state_dict()
    assert sd["count"] == 2
    fresh = make_optimizer({"w": p}, lr=0.1, warmup_steps=4)
    fresh.load_state_dict(sd)
    assert fresh.count == 2
    assert torch.equal(fresh.state[p]["mu"], opt.state[p]["mu"])


def _tiny_run(batches, generator, model_seed_noise=False):
    """TINY CategoryODISE with the synthetic labels, its trainable
    parameters, AdamW (warmup over 3 updates, a milestone at 3) and the
    category train step."""
    from odise_torch.data.synthetic import SYNTH_LABELS
    from odise_torch.engine import make_category_train_step
    from odise_torch.losses import CriterionConfig
    from odise_torch.model_zoo.factory import build_category_odise
    from odise_torch.models.clip.tokenizer import tokenize

    torch.manual_seed(0)
    model = build_category_odise("tiny", train_labels=SYNTH_LABELS, with_clip_head=False,
                                 use_checkpoint=False, slide_training=False, device="cpu")
    trainable, _ = partition_params(model)
    if model_seed_noise:  # a fresh model's trainable weights differ from the saved ones
        with torch.no_grad():
            for p in trainable.values():
                p.add_(0.1)
    opt = make_optimizer(trainable, lr=2e-3, milestones=(3,), warmup_steps=3,
                         warmup_factor=0.1)
    with torch.no_grad():
        text = model.encode_vocab(torch.from_numpy(tokenize([l[0] for l in SYNTH_LABELS])).long())
    step = make_category_train_step(model, opt, CriterionConfig(num_classes=3, num_points=32),
                                    text, SYNTH_LABELS)
    return model, trainable, opt, step


def test_resume_equals_straight_run(tmp_path):
    """k = 2 steps, save, load into a fresh TINY model and AdamW, 2 more
    steps on the same batches and generator state: equal to 4 steps
    straight through, with the warmup and a milestone inside the 4. A
    checkpoint without the optimizer's update count restarts the warmup and
    the bias corrections, and fails this."""
    from odise_torch.data.dataset_mapper import COCOPanopticDatasetMapper
    from odise_torch.data.loader import build_train_loader
    from odise_torch.data.synthetic import make_shapes_records

    loader = build_train_loader(make_shapes_records(6, size=64, seed=1),
                                COCOPanopticDatasetMapper(image_size=64, max_instances=4,
                                                          device="cpu"), 2, seed=3)
    batches = [next(loader) for _ in range(4)]
    _, straight, _, step = _tiny_run(batches, None)
    gen = torch.Generator().manual_seed(5)
    for b in batches:
        step(b, gen)

    _, first, opt, step = _tiny_run(batches, None)
    gen = torch.Generator().manual_seed(5)
    for b in batches[:2]:
        step(b, gen)
    ck = Checkpointer(str(tmp_path))
    ck.save("model_0000001", first, opt, 2)
    gen_state = gen.get_state()

    _, resumed, opt, step = _tiny_run(batches, None, model_seed_noise=True)
    start, _ = ck.resume_or_load(None, resumed, resume=True, optimizer=opt)
    start_count = opt.count
    gen = torch.Generator()
    gen.set_state(gen_state)
    for b in batches[start:]:
        step(b, gen)
    for name, p in straight.items():
        assert torch.equal(resumed[name], p), name
    assert (start, start_count) == (2, 2)
