"""The correctness check fails what it must, at TINY on the CPU: each
cell's run is driven (set-up, window, the check against the reference)
with the harness's look for a card skipped, the program at float32, and
then with the timed path broken underneath; ``correct`` has to come out
true for the sound run and false for each fault the cell can have. The
control (the reference through float8 e4m3 in the program's place, making
its own choices, which the float32 reference follows) has to read above
the cell's limits."""

import time

import pytest
import torch

from perfbench.common import manifest
from perfbench.common.context import Run
from perfbench.tests import faults

MAN = manifest.manifest()
INFER = [w["name"] for w in MAN["workloads"]
         if manifest.traffic(w["traffic"])["driver"] == "infer"]
TRAIN = [w["name"] for w in MAN["workloads"]
         if manifest.traffic(w["traffic"])["driver"] == "train"]
TINY_TRAIN = {"image_size": 64, "num_points": 256, "max_instances": 10}


@pytest.fixture(autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_run(cell, seconds=1.0, **traffic):
    w = manifest.cell(cell, MAN)
    tr = dict(manifest.traffic(w["traffic"]), **traffic)
    run = Run(workload=cell, seed=2 ** 33 + 11, seconds=seconds, trace=False,
              config=manifest.config(w["config"]), traffic=tr, t0=time.perf_counter(),
              device="cpu", scale="tiny", dtype="float32")
    run.extra["limits"] = manifest.limits(cell)
    run.extra["opts_override"] = TINY_TRAIN
    return run, manifest.driver(tr["driver"])


# -- inference -------------------------------------------------------------

@pytest.mark.parametrize("cell", INFER)
@pytest.mark.parametrize("fault", [None, *faults.INFER.values()],
                         ids=["sound", *faults.INFER])
def test_infer_check(cell, fault):
    run, drv = tiny_run(cell, check_images=64)
    drv.drive(run, fault=fault)
    assert run.correct == (fault is None), run.checks


@pytest.mark.parametrize("cell", INFER)
def test_infer_control_fails_the_limits(cell):
    run, drv = tiny_run(cell, check_images=64)
    run.extra["control"] = True
    drv.drive(run)
    assert run.correct, run.checks
    limits = run.extra["limits"]
    gaps = run.extra["control_gaps"]
    assert any(gaps[k] > limits[k] for k in limits), (gaps, limits)


# -- training --------------------------------------------------------------

@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [None, *faults.TRAIN.values()],
                         ids=["sound", *faults.TRAIN])
def test_train_check(cell, fault):
    run, drv = tiny_run(cell, seconds=0.5, workers=0)
    drv.drive(run, fault=fault)
    assert run.correct == (fault is None), run.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_fails_the_limits(cell):
    """The control (the reference through float8, e5m2 gradients) in the
    program's place reads above one of the cell's limits."""
    run, drv = tiny_run(cell, seconds=0.5, workers=0)
    run.extra["control"] = True
    drv.drive(run)
    assert run.correct, run.checks
    limits, gaps = run.extra["limits"], run.extra["control_gaps"]
    assert any(gaps[k] > limits[k] for k in limits), (gaps, limits)
