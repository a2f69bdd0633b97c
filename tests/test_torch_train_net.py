"""The port's train and eval CLI (``python -m odise_torch.train_net``) and its
convergence run at TINY on the CPU: train, checkpoint, resume, evaluate from
a checkpoint, as ``tools/train_net.py`` does; the real convergence run is on
the card (``chip_smoke.py`` phase 10)."""

import logging
import os

import pytest
import torch

from odise_torch import train_net

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "odise_torch", "configs", "Panoptic")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's TINY runs: the suite runs files
    in parallel processes, and torch's default of a thread per core in each
    of them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", ["label", "caption"])
def test_train_resume_eval(tmp_path, variant):
    """3 steps with a checkpoint at 2 and the final eval; --resume to 4 from
    the last checkpoint (``model_best``, written by the final eval) with the
    optimizer's count; --eval-only --init-from model_final gives the
    resumed run's final eval."""
    cfg_file = os.path.join(CONFIGS, f"odise_{variant}_tiny_synth.py")
    common = ["--config-file", cfg_file, "--output", str(tmp_path), "--max-eval-images", "2"]
    opts = ["train.device=cpu", "train.eval_period=3", "train.checkpointer.period=2"]
    run = train_net.main(common + opts + ["train.max_iter=3"])
    ck_dir = tmp_path / "checkpoints"
    assert sorted(os.listdir(ck_dir)) == ["last_checkpoint", "model_0000001.pth",
                                          "model_best.pth", "model_final.pth"]
    assert (ck_dir / "last_checkpoint").read_text() == "model_best"
    assert (run.start_iter, run.start_count, run.optimizer.count) == (0, 0, 3)
    assert len(run.history) == 3
    assert all(m["grad_norm"] > 0 and m["total_loss"] > 0 for m in run.history)
    assert run.eval_results["main"]["images"] == 2
    assert os.path.isfile(tmp_path / "config.yaml")
    assert len((tmp_path / "metrics.json").read_text().splitlines()) == 3
    frozen = [p for p in run.model.parameters() if not p.requires_grad]
    fresh = train_net.build_model(run.cfg)
    for (name, p), q in zip(run.model.named_parameters(), fresh.parameters()):
        if not p.requires_grad:
            assert torch.equal(p, q), name
    assert frozen

    resumed = train_net.main(common + ["--resume"] + opts + ["train.max_iter=4"])
    assert (resumed.start_iter, resumed.start_count, resumed.optimizer.count) == (3, 3, 4)
    assert len(resumed.history) == 1

    evaluated = train_net.main(common + ["--eval-only", "--init-from",
                                         str(ck_dir / "model_final.pth"), "train.device=cpu"])
    assert evaluated["main"].keys() == resumed.eval_results["main"].keys()
    for k in ("PQ", "mIoU", "AP", "images"):
        assert evaluated["main"][k] == resumed.eval_results["main"][k], k


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_net.main(["--config-file", os.path.join(CONFIGS, "odise_label_tiny_synth.py"),
                        "--output", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.fixture
def port_log(caplog):
    """caplog on the package logger, which stops propagating once
    ``setup_logger`` has run."""
    logger = logging.getLogger("odise_torch")
    logger.addHandler(caplog.handler)
    yield caplog
    logger.removeHandler(caplog.handler)


def test_do_test_skips_unregistered_tasks(port_log):
    """The shipped extra tasks instantiate their vocabularies (every label
    file is there) and are skipped by name with a warning: their datasets
    are registered, but their files are not under the dataset root."""
    from odise_torch.config import get_config, resolve

    cfg = get_config("Panoptic/odise_label_tiny_synth.py")
    cfg.extra_task = get_config("Panoptic/odise_label_coco_50e.py").extra_task
    cfg.train.device = "cpu"
    cfg = resolve(cfg)
    model = train_net.build_model(cfg)
    with port_log.at_level(logging.WARNING, logger="odise_torch"):
        results = train_net.do_test(cfg, model, max_images=1, final_iter=True)
    assert list(results) == ["main"]
    for task in ("eval_ade150", "eval_ctx59", "eval_ade847", "eval_ctx459", "eval_pas21"):
        assert f"Skipping task {task}" in port_log.text
    port_log.clear()
    with port_log.at_level(logging.WARNING, logger="odise_torch"):
        train_net.do_test(cfg, model, max_images=1, final_iter=False)
    assert "eval_ade847" not in port_log.text and "eval_ade150" in port_log.text


@pytest.mark.parametrize("case", ["main_unregistered", "main_without_images",
                                  "extra_without_images"])
def test_do_test_refuses_what_it_cannot_evaluate(case, port_log):
    """An unregistered main dataset, and a main dataset whose first record
    names an image file that is not there, fail the evaluation before it
    starts: a run does not go on unevaluated. An extra task in that state is
    skipped with a warning and the main task is evaluated, as in
    ``tools/train_net.py``."""
    from odise_torch.config import get_config, resolve
    from odise_torch.data.catalog import DatasetCatalog

    DatasetCatalog.remove("_no_images")
    DatasetCatalog.register("_no_images", lambda: [{"file_name": "0.jpg", "image_id": 0}])
    cfg = get_config("Panoptic/odise_label_tiny_synth.py")
    task = cfg.dataloader.wrapper if case.startswith("main") else dict(cfg.dataloader.wrapper)
    task["dataset_name"] = "_unregistered" if case == "main_unregistered" else "_no_images"
    try:
        if case == "extra_without_images":
            cfg.extra_task = {"eval_files": {"task": {"wrapper": task}}}
            cfg.train.device = "cpu"
            cfg = resolve(cfg)
            with port_log.at_level(logging.WARNING, logger="odise_torch"):
                results = train_net.do_test(cfg, train_net.build_model(cfg), max_images=1)
            assert list(results) == ["main"] and results["main"]["images"] == 1
            assert "Skipping task eval_files" in port_log.text and "0.jpg" in port_log.text
        else:
            want = KeyError if case == "main_unregistered" else FileNotFoundError
            with pytest.raises(want):
                train_net.do_test(resolve(cfg), model=None)
    finally:
        DatasetCatalog.remove("_no_images")


def test_profile_window(tmp_path):
    window = train_net._ProfileWindow(start_iter=5, out_dir=str(tmp_path))
    assert [it for it in range(30) if window.due(it)] == [14, 19]
    window(14, {})
    torch.ones(4).sum()
    window(19, {})
    assert os.path.isfile(tmp_path / "trace.json")


@pytest.mark.parametrize("variant", ["category", "caption"])
def test_convergence_plumbing(variant):
    """Three steps of the convergence run: finite, and evaluated before and
    after through ``train_net.do_test``."""
    from odise_torch.convergence import run_convergence

    kw = (dict(use_checkpoint=True, slide_training=True, backbone_in_size=(64, 64), size=128)
          if variant == "category" else dict(collect_mode=None))
    r = run_convergence(variant=variant, steps=3, batch=2, n_train=4, n_val=1,
                        num_points=32, device="cpu", dataset_name=f"_conv_{variant}", **kw)
    assert r["metrics_before"]["images"] == r["metrics_after"]["images"] == 1
    assert r["loss_first10_mean"] > 0 and r["loss_last10_mean"] > 0
