"""The program ranges' exclusive device time and idle time by layer
(``common/spans.py``) on a hand-built train step: forward ranges on the
main thread, backward ranges on the autograd thread, two of which overlap
without nesting, a crop range replayed inside the backbone's backward, and
idle gaps under each."""

from types import SimpleNamespace

import pytest

from perfbench.common import spans, trace
from perfbench.common.trace import Event, Trace

MAIN, AUTOGRAD = 1, 2
RANGES = [("odise.step", 0, 1000, MAIN),
          ("odise.backbone", 10, 200, MAIN),
          ("odise.backbone.crop", 20, 100, MAIN),
          ("odise.sem_seg_head", 200, 400, MAIN),
          ("odise.pixel_decoder", 210, 300, MAIN),
          ("odise.ms_deform_attn", 250, 280, MAIN),
          ("odise.criterion", 400, 500, MAIN),
          ("odise.matcher", 410, 480, MAIN),
          ("odise.criterion.bwd", 520, 640, AUTOGRAD),
          ("odise.sem_seg_head.bwd", 600, 760, AUTOGRAD),   # overlaps criterion.bwd
          ("odise.backbone.bwd", 770, 900, AUTOGRAD),
          ("odise.backbone.crop", 780, 850, AUTOGRAD),     # the recompute
          ("odise.optimizer", 910, 990, MAIN)]
# (launch time, launching thread, device start, device end)
KERNELS = [(30, MAIN, 30, 60), (150, MAIN, 150, 190), (260, MAIN, 260, 290),
           (350, MAIN, 350, 380), (420, MAIN, 420, 430), (505, MAIN, 505, 515),
           (530, AUTOGRAD, 530, 560), (620, AUTOGRAD, 620, 650), (700, AUTOGRAD, 700, 720),
           (790, AUTOGRAD, 790, 840), (920, MAIN, 920, 930)]


def _trace(thread_ids=lambda t: t):
    host = [Event(trace.STRETCH, "user_annotation", 0, 1000, MAIN),
            Event("aten::mm", "cpu_op", 260, 262, MAIN)]
    host += [Event(n, "user_annotation", s, e, t) for n, s, e, t in RANGES]
    runtime, device = {}, []
    for i, (at, t, s, e) in enumerate(KERNELS, 1):
        runtime[i] = Event("cudaLaunchKernel", "cuda_runtime", at, at + 1, thread_ids(t), corr=i)
        host.append(runtime[i])
        device.append(Event(f"k{i}", "kernel", s, e, corr=i))
    # a copy linked to no runtime call, running past the stretch's end
    device.append(Event("Memcpy", "gpu_memcpy", 995, 1010, corr=99))
    return Trace((0, 1000), device, host, runtime)


def test_each_kernel_counts_once_for_its_innermost_range():
    sp = spans.Spans(_trace())
    own = {(sp.ranges[i].name, sp.ranges[i].start): ns for i, ns in sp.device_ns.items()
           if i is not None}
    assert own == {("odise.backbone.crop", 20): 30, ("odise.backbone", 10): 40,
                   ("odise.ms_deform_attn", 250): 30, ("odise.sem_seg_head", 200): 30,
                   ("odise.matcher", 410): 10, ("odise.step", 0): 10,
                   ("odise.criterion.bwd", 520): 30,
                   # opened after criterion.bwd, so the kernel at 620 is its
                   ("odise.sem_seg_head.bwd", 600): 50,
                   ("odise.backbone.crop", 780): 50, ("odise.optimizer", 910): 10}
    assert sp.device_ns[None] == 5           # the unlinked copy, clipped at the end
    assert sum(sp.device_ns.values()) == sp.trace.busy_ns() == 295


def test_a_layer_adds_up_the_ranges_nested_in_it_on_its_thread():
    sp = spans.Spans(_trace())
    assert sp.layer_ns(["odise.backbone", "odise.backbone.bwd"]) == 30 + 40 + 50
    assert sp.layer_ns(["odise.sem_seg_head", "odise.sem_seg_head.bwd"]) == 60 + 50
    assert sp.layer_ns(["odise.pixel_decoder"]) == 30
    assert sp.layer_ns(["odise.criterion", "odise.criterion.bwd"]) == 10 + 30
    # the backward ranges run on another thread than odise.step
    step = sp.by_layer(["odise.step"])
    assert step["odise.step"] == 160 and step[None] == 135
    # nearest layer first: the deformable op's time is not the decoder's too
    got = sp.by_layer(["odise.sem_seg_head", "odise.pixel_decoder", "odise.ms_deform_attn"])
    assert (got["odise.sem_seg_head"], got["odise.pixel_decoder"],
            got["odise.ms_deform_attn"]) == (30, 0, 30)
    assert sum(got.values()) == 295


def test_idle_goes_to_the_range_opened_last_on_any_thread():
    sp = spans.Spans(_trace())
    assert sum(sp.idle_ns.values()) == 1000 - 295
    assert sp.layer_ns(["odise.matcher"], idle=True) == 75
    assert sp.layer_ns(["odise.optimizer"], idle=True) == 65
    assert sp.layer_ns(["odise.backbone", "odise.backbone.bwd"], idle=True) == 30 + 90 + 80
    # [720, 790] falls while the main thread waits in odise.step and the
    # autograd thread is in odise.sem_seg_head.bwd
    assert sp.layer_ns(["odise.sem_seg_head.bwd"], idle=True) == 50 + 70
    assert sp.layer_ns(["odise.criterion"], idle=True) == 40 + 75
    assert sp.idle_ns[None] == 0


def test_launches_on_threads_the_ranges_do_not_share_go_by_time():
    # a launch on the main thread inside a backward range's time counts for
    # the main thread's ranges; where the profiler numbers the runtime's
    # threads apart from the ranges', by time alone
    tr = _trace()
    tr.runtime[10].thread = MAIN   # the recompute's kernel at 790
    assert spans.Spans(tr).layer_ns(["odise.backbone.bwd"]) == 0
    apart = spans.Spans(_trace(thread_ids=lambda t: 100 + t))
    assert apart.layer_ns(["odise.backbone.bwd"]) == 50
    assert apart.layer_ns(["odise.sem_seg_head.bwd"]) == 50


def test_metrics_read_nothing_from_a_program_without_ranges():
    tr = _trace()
    run = SimpleNamespace(stretch=tr, extra={"stretch_images": 5})
    assert spans.ms_per_img(run, ["odise.matcher"], idle=True) == pytest.approx(75 / 1e6 / 5)
    assert spans.of(run) is spans.of(run)
    tr.host = [e for e in tr.host if not e.name.startswith(spans.PREFIX)]
    bare = SimpleNamespace(stretch=tr, extra={"stretch_images": 5})
    assert spans.ms_per_img(bare, ["odise.matcher"], idle=True) is None
    assert spans.ms_per_img(SimpleNamespace(stretch=None, extra={}), ["odise.step"]) is None
