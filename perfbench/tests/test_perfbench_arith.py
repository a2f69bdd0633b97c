"""The window, rate, idle-share and roofline arithmetic on synthetic
timelines and shapes worked by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.arith import deform, peaks
from perfbench.common import trace, window
from perfbench.common.trace import Event, Trace


def test_window_counts_whole_units_and_their_time():
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731

    def once(i):
        t[0] += 0.3  # each unit takes 0.3 s

    n, elapsed = window.run_window(1.0, once, clock)
    # units start at 0, 0.3, 0.6, 0.9; the last ends at 1.2
    assert n == 4 and elapsed == pytest.approx(1.2)
    assert window.rate(n, 8, elapsed) == pytest.approx(32 / 1.2)
    with pytest.raises(ValueError):
        window.rate(0, 8, 0.0)


def _trace():
    # a 100 ns stretch; kernels at [10, 30], [20, 40] (overlapping), [60, 70]
    # and one that runs past the end [95, 120]; a launch call before each
    host = [Event(trace.STRETCH, "user_annotation", 0, 100, 1),
            Event("perfbench.op", "user_annotation", 5, 25, 1),
            Event("aten::mm", "cpu_op", 45, 65, 1)]
    runtime = {}
    for i, s in enumerate((3, 18, 52, 90)):
        r = Event("cudaLaunchKernel", "cuda_runtime", s, s + 1, 1, corr=i + 1)
        runtime[i + 1] = r
        host.append(r)
    device = [Event("k0", "kernel", 10, 30, corr=1), Event("k1", "kernel", 20, 40, corr=2),
              Event("k2", "kernel", 60, 70, corr=3), Event("k0", "kernel", 95, 120, corr=4)]
    return Trace((0, 100), device, host, runtime)


def test_idle_share_busy_and_launches():
    t = _trace()
    # busy: [10, 40] + [60, 70] + [95, 100] = 45 of 100
    assert t.busy_ns() == 45
    assert t.idle_share() == pytest.approx(0.55)
    assert t.launches() == 4
    assert t.window_s == pytest.approx(1e-7)


def test_range_device_time_counts_kernels_launched_inside():
    t = _trace()
    # of the launches at 3 and 18 only the one at 18 (k1, 20 ns) is in [5, 25]
    assert t.range_device_ns("perfbench.op") == 20
    assert t.range_device_ns("perfbench.absent") is None


def test_breakdown_lists():
    t = _trace()
    ops = dict(t.device_ops())
    assert ops["k0"] == pytest.approx(45e-9) and ops["k1"] == pytest.approx(20e-9)
    gaps = dict(t.idle_gaps())
    # gaps [0, 10], [40, 60], [70, 95]: the op at each midpoint
    assert gaps["perfbench.op"] == pytest.approx(10e-9)       # mid 5
    assert gaps["aten::mm"] == pytest.approx(20e-9)           # mid 50
    assert gaps[trace.STRETCH] == pytest.approx(25e-9)        # mid 82
    assert sum(gaps.values()) == pytest.approx(55e-9)


def test_merged_clips_to_the_window():
    evs = [Event("a", "kernel", -5, 5), Event("b", "kernel", 3, 8), Event("c", "kernel", 9, 20)]
    assert trace.merged(evs, (0, 10)) == [(0, 8), (9, 10)]


def test_deform_work_by_hand():
    # one level of 4x4, batch 1, 2 queries, 1 head of 2 channels, 1 point
    value = torch.zeros(1, 16, 1, 2, dtype=torch.bfloat16)
    loc = torch.tensor([0.5, 0.5, 0.0, 0.0]).reshape(1, 2, 1, 1, 1, 2)
    attn = torch.ones(1, 2, 1, 1, 1, dtype=torch.bfloat16)
    # query 0 at the centre: all 4 corners inside; query 1 at (0, 0):
    # x = y = -0.5, corners at -1 and 0: only (0, 0) inside
    assert int(deform.inside_corners(loc, [(4, 4)])) == 5
    n_bytes, flops = deform.forward_work(value, loc, attn, [(4, 4)])
    # value 32 values * 2 B, loc 4 * 4 B, attn 2 * 2 B, out 2 * 1 * 2 * 2 B
    assert n_bytes == 64 + 16 + 4 + 8
    assert int(flops) == 5 * 2 * 2
    b_bytes, b_flops = deform.backward_work(value, loc, attn, [(4, 4)])
    assert b_bytes == 2 * 64 + 2 * 16 + 2 * 4 + 8
    # 2 samples * 8 + 5 corners * 2, times 2 channels
    assert int(b_flops) == (2 * 8 + 5 * 2) * 2
    assert deform.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert deform.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_peaks_are_the_data_sheet_s():
    assert (peaks.HBM_BYTES_PER_S, peaks.F32_FLOPS, peaks.BF16_FLOPS) == (3.35e12, 67e12, 989e12)


def test_flop_counter_counts_products_on_meta_by_hand():
    """The counting path the MFU uses: a Dense of 4 -> 3 on 2 rows is
    2 * 2 * 4 * 3 FLOPs, a 3x3 Conv of 2 -> 5 channels on 6x6 is 2 * 5 * 36
    * 2 * 9, on the meta device."""
    from perfbench.reference.modules import Conv, Dense

    with torch.device("meta"):
        d, c = Dense(4, 3), Conv(2, 5, 3, padding=1)
        x, im = torch.zeros(2, 4), torch.zeros(1, 2, 6, 6)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        d(x)
    assert fc.get_total_flops() == 2 * 2 * 4 * 3
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        c(im)
    assert fc.get_total_flops() == 2 * 5 * 36 * 2 * 9


def test_model_flops_scale_with_the_batch():
    from perfbench.arith import flops

    one = flops.infer_flops("category", "tiny", True, (64, 96), 1, 5, 5)
    two = flops.infer_flops("category", "tiny", True, (64, 96), 2, 5, 5)
    assert 0 < one and two == pytest.approx(2 * one, rel=0.02)
    step = flops.train_flops("category", "tiny", 2, 64, 5, 8, 16)
    assert step > 0
