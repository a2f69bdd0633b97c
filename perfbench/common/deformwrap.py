"""The deformable-attention ranges of the instrumented traced stretch,
installed once however many roofline metrics ask for them. Each call's
forward and backward work (bytes and operations, ``arith/deform.py``) is
counted from its inputs before its forward range opens."""

from __future__ import annotations

from perfbench.arith import deform
from perfbench.common import opwrap

FWD = "perfbench.deform_fwd"
BWD = "perfbench.deform_bwd"


def install(run, entry: str):
    if "deform_work" in run.extra:
        return lambda: None
    work = run.extra["deform_work"] = []

    def count(value, shapes, loc, attn):
        shapes = [tuple(int(v) for v in s) for s in shapes]
        work.append((deform.forward_work(value, loc, attn, shapes),
                     deform.backward_work(value, loc, attn, shapes),
                     loc.requires_grad or value.requires_grad or attn.requires_grad))

    return opwrap.wrap(entry, FWD, BWD, count)


def share(run, backward: bool):
    """Least time over device time inside the op's ranges, in percent;
    None where the stretch ran no such range."""
    work = run.extra.get("deform_work")
    if not work or run.ranges is None:
        return None
    name = BWD if backward else FWD
    ns = run.ranges.range_device_ns(name)
    if not ns:
        return None
    least = sum(deform.least_seconds(b, float(f)) for fw, bw, grad in work
                for b, f in [bw if backward else fw] if grad or not backward)
    return 100.0 * least / (ns / 1e9)
