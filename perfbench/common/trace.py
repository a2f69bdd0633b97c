"""Reading a ``torch.profiler`` trace of a steady stretch of whole calls or
steps: the device's busy time and idle share, kernel launches counted at
the CUDA runtime, device time inside named ranges, and the breakdown the
result line carries.

The stretch is the one ``record_function`` range named ``STRETCH``; device
work is every kernel, copy and fill that ran on the device (the ranges that
``record_function`` mirrors onto the device timeline are not work). A
kernel belongs to a named range when the runtime call that launched it
started inside that range on the same host thread.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

STRETCH = "perfbench.stretch"
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaLaunchCooperativeKernelMultiDevice")
TOP = 10


@dataclass
class Event:
    name: str
    kind: str        # the profiler's activity type
    start: int       # ns
    end: int         # ns
    thread: int = 0
    corr: int = 0    # a runtime call's correlation id, or a device op's link to it


@dataclass
class Trace:
    """What a traced stretch gives; times in ns."""

    window: Tuple[int, int]
    device: List[Event]
    host: List[Event]
    runtime: Dict[int, Event] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_ns(self) -> int:
        return sum(e - s for s, e in merged(self.device, self.window))

    def idle_share(self) -> float:
        return 1.0 - self.busy_ns() / (self.window[1] - self.window[0])

    def launches(self) -> int:
        w0, w1 = self.window
        return sum(1 for e in self.host if e.kind in ("cuda_runtime", "cuda_driver")
                   and e.name in LAUNCH_CALLS and w0 <= e.start <= w1)

    def range_device_ns(self, name: str) -> Optional[int]:
        """Device time of the work launched inside the ranges called
        ``name``; None where there is no such range. A launch belongs to a
        range that holds its start on the same host thread; where the
        profiler numbers the runtime's threads apart from the ranges'
        (no launch shares a thread with any range), by its start alone."""
        spans = defaultdict(list)
        for e in self.host:
            if e.name == name and e.kind == "user_annotation":
                spans[e.thread].append((e.start, e.end))
        if not spans:
            return None
        range_threads = {e.thread for e in self.host if e.kind == "user_annotation"}
        by_thread = any(r.thread in range_threads for r in self.runtime.values())
        every = [iv for ivs in spans.values() for iv in ivs]
        total = 0
        for d in self.device:
            r = self.runtime.get(d.corr)
            if r is None:
                continue
            ivs = spans.get(r.thread, ()) if by_thread else every
            if any(s <= r.start <= e for s, e in ivs):
                total += d.end - d.start
        return total

    def device_ops(self) -> List[Tuple[str, float]]:
        by = defaultdict(int)
        for d in self.device:
            by[d.name] += d.end - d.start
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle stretches of the device, summed by the innermost host op
        running at each one's midpoint."""
        busy = merged(self.device, self.window)
        gaps, edge = [], self.window[0]
        for s, e in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if self.window[1] > edge:
            gaps.append((edge, self.window[1]))
        ops = sorted((e for e in self.host if e.kind in ("cpu_op", "user_annotation",
                                                         "cuda_runtime", "cuda_driver",
                                                         "python_function")),
                     key=lambda e: e.start)
        starts = [e.start for e in ops]
        by = defaultdict(int)
        import bisect
        for s, e in gaps:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            best = None
            # the innermost op containing mid: scan back over ops that started before it
            for j in range(i - 1, max(i - 4000, -1), -1):
                o = ops[j]
                if o.end >= mid and (best is None or o.end - o.start < best.end - best.start):
                    best = o
            by["(no host op)" if best is None else best.name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, ns / 1e9] for name, ns in top]


def merged(events: List[Event], window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The union of the events' intervals, clipped to the window."""
    w0, w1 = window
    out: List[List[int]] = []
    for ev in sorted(events, key=lambda x: x.start):
        s, e = max(ev.start, w0), min(ev.end, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _kind(k) -> str:
    """The profiler's activity type of a kineto event; worked out from its
    device, name and annotation flag where this PyTorch does not expose it."""
    at = getattr(k, "activity_type", None)
    if at is not None:
        return at()
    name = k.name()
    user = bool(getattr(k, "is_user_annotation", lambda: False)())
    if str(k.device_type()).endswith("CUDA"):
        if user or name.startswith("perfbench."):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if user:
        return "user_annotation"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op"


def from_profiler(prof) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``."""
    device, host, runtime, window = [], [], {}, None
    for k in prof.profiler.kineto_results.events():
        kind = _kind(k)
        ev = Event(k.name(), kind, k.start_ns(), k.start_ns() + k.duration_ns(),
                   k.start_thread_id(), 0)
        if kind in DEVICE_WORK:
            # the runtime call's id (CUPTI's); the linked id names the host op
            ev.corr = k.correlation_id() or k.linked_correlation_id()
            device.append(ev)
        elif kind == "gpu_user_annotation":
            continue
        else:
            if kind in ("cuda_runtime", "cuda_driver"):
                ev.corr = k.correlation_id()
                runtime[ev.corr] = ev
            host.append(ev)
            if ev.name == STRETCH and kind == "user_annotation":
                window = (ev.start, ev.end)
    if window is None:
        raise RuntimeError(f"the trace holds no {STRETCH} range")
    return Trace(window, device, host, runtime)


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body on the host and the card inside one ``STRETCH``
    range; ``out["trace"]`` holds the ``Trace`` afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            yield
    out["trace"] = from_profiler(prof)


class Range:
    """A named host range that can open and close in different places (the
    op's backward opens where autograd reaches its output and closes where
    it leaves its inputs)."""

    def __init__(self, name: str):
        self.name = name
        self.handle = None

    def enter(self):
        import torch
        self.handle = torch.ops.profiler._record_function_enter_new(self.name, None)

    def exit(self):
        import torch
        if self.handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(self.handle)
            self.handle = None
