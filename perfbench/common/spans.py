"""The program's own ranges in a traced stretch: device time and idle time
by layer.

The program opens a ``record_function`` range named ``odise.<layer>``
around each layer's forward work and a range ``odise.<layer>.bwd`` around
its backward, while a profiler records (``odise_torch/utils/tracing.py``);
they share the profiler's clock with the device's kernels.

- Device time, exclusive: a kernel, copy or fill counts for the innermost
  program range that holds its launch: of the ranges open when the runtime
  call that launched it started, on its thread, the one opened last (on
  any thread where the profiler numbers the runtime's threads apart from
  the ranges', as ``Trace.range_device_ns`` allows). So no device time
  counts twice, and two backward ranges that overlap without nesting split
  the kernels between them.
- Idle time: each idle gap of the device goes to the program range opened
  last of those open, on any thread, at the gap's midpoint. Unlike the
  breakdown's ``idle_gaps`` it has no look-back limit.
- A layer adds up its own ranges and every range nested in one of them on
  the same thread (``odise.ms_deform_attn`` counts for
  ``odise.pixel_decoder``); ``by_layer`` gives each range to the nearest
  of the layers named, itself first.

Device time is clipped to the stretch, as ``Trace.busy_ns`` clips it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

from .trace import Event, Trace, merged

PREFIX = "odise."


class Spans:
    """The program ranges of one ``Trace``, with the device time and the
    idle time that each range holds itself (``None`` holds what no program
    range holds)."""

    def __init__(self, trace: Trace):
        self.trace = trace
        w0, w1 = trace.window
        self.ranges: List[Event] = sorted(
            (e for e in trace.host if e.kind == "user_annotation" and e.name.startswith(PREFIX)
             and e.end >= w0 and e.start <= w1), key=lambda e: e.start)
        self._starts = [r.start for r in self.ranges]
        range_threads = {r.thread for r in self.ranges}
        self.by_thread = any(c.thread in range_threads for c in trace.runtime.values())
        self.device_ns: Dict[Optional[int], int] = defaultdict(int)
        for d in trace.device:
            ns = min(d.end, w1) - max(d.start, w0)
            if ns <= 0:
                continue
            call = trace.runtime.get(d.corr)
            owner = None if call is None else self.owner(
                call.start, call.thread if self.by_thread else None)
            self.device_ns[owner] += ns
        self.idle_ns: Dict[Optional[int], int] = defaultdict(int)
        for s, e in self.gaps():
            self.idle_ns[self.owner((s + e) // 2)] += e - s
        self._parents = self._nesting()

    def gaps(self) -> List[tuple]:
        """The stretch's idle gaps, as ``Trace.idle_gaps`` finds them."""
        w0, w1 = self.trace.window
        out, edge = [], w0
        for s, e in merged(self.trace.device, self.trace.window):
            if s > edge:
                out.append((edge, s))
            edge = max(edge, e)
        if w1 > edge:
            out.append((edge, w1))
        return out

    def owner(self, t: int, thread: Optional[int] = None) -> Optional[int]:
        """The index of the range opened last of those open at ``t`` (on
        ``thread``, where given); None where none is."""
        for i in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            r = self.ranges[i]
            if r.end >= t and (thread is None or r.thread == thread):
                return i
        return None

    def _nesting(self) -> List[List[int]]:
        """For each range, the ranges it is nested in on its thread,
        innermost first."""
        out = []
        for r in self.ranges:
            outer = [j for j, p in enumerate(self.ranges) if p is not r
                     and p.thread == r.thread and p.start <= r.start and r.end <= p.end]
            out.append(sorted(outer, key=lambda j: -self.ranges[j].start))
        return out

    def names(self) -> set:
        return {r.name for r in self.ranges}

    def by_layer(self, layers: Sequence[str], idle: bool = False) -> Dict[Optional[str], int]:
        """Device (or idle) ns by layer: each range's own goes to the
        nearest of ``layers`` among itself and the ranges it is nested in;
        None takes the rest."""
        own = self.idle_ns if idle else self.device_ns
        out: Dict[Optional[str], int] = defaultdict(int)
        for i, ns in own.items():
            name = None
            if i is not None:
                for j in [i] + self._parents[i]:
                    if self.ranges[j].name in layers:
                        name = self.ranges[j].name
                        break
            out[name] += ns
        return out

    def layer_ns(self, layers: Iterable[str], idle: bool = False) -> Optional[int]:
        """Device (or idle) ns of the named layers together; None where
        the stretch holds none of their ranges (a program without them)."""
        layers = list(layers)
        if not self.names() & set(layers):
            return None
        got = self.by_layer(layers, idle)
        return sum(got[n] for n in layers)


def of(run) -> Optional[Spans]:
    """The plain traced stretch's ``Spans``, made once a run."""
    if run.stretch is None:
        return None
    got = run.extra.get("spans")
    if got is None or got.trace is not run.stretch:
        got = run.extra["spans"] = Spans(run.stretch)
    return got


def ms_per_img(run, layers: Sequence[str], idle: bool = False) -> Optional[float]:
    """Milliseconds an image of the layers' device (or idle) time over the
    plain stretch; None where the program opens none of their ranges."""
    spans = of(run)
    ns = None if spans is None else spans.layer_ns(layers, idle)
    return None if ns is None else ns / 1e6 / run.extra["stretch_images"]
