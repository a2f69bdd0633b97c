"""One traced run of a cell, as ``perfbench/run.py --trace 1`` makes it
(its result line is the last line of standard output), and a report of
the program's ranges in its plain traced stretch (``common/spans.py``),
written as one JSON object to ``--out``:

- device ms and idle ms by range name, each range's own and each layer's
  (the range and those nested in it);
- how much of the stretch's busy device time and of its idle time the
  program's ranges claim, the five ranges with the most idle time, and
  the idle time that the breakdown's ``idle_gaps`` gives to no host op;
- in an eval cell, the model's call (``odise.infer``) split into the
  backbone, the two decoders, the CLIP head, the mask upsample and the
  vocabulary head, and what none of them claims;
- each range's five largest kernels, by name, from its own time;
- the ranges opened a call or a step, and the cost of a span site's gate
  with no profiler recording, timed on this host.

    python3 perfbench/tests/span_report.py --workload label_infer_b4 --seed 1 \
        --seconds 51 --out spans/label_infer_b4.json

It runs against a program without the ranges too: the report is then
mostly empty.
"""

import argparse
import bisect
import json
import os
import sys
import timeit
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
INFER_PARTS = ["odise.backbone", "odise.pixel_decoder", "odise.mask_decoder",
               "odise.clip_head", "odise.mask_upsample", "odise.vocab_head"]


def no_host_op_gaps(trace, gaps):
    """The gaps that ``Trace.idle_gaps`` gives to no host op: none of the
    4,000 host events that started last before the midpoint is open at it."""
    ops = sorted((e for e in trace.host if e.kind in (
        "cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")),
        key=lambda e: e.start)
    starts = [e.start for e in ops]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        if not any(ops[j].end >= mid for j in range(i - 1, max(i - 4000, -1), -1)):
            out.append((s, e))
    return out


def gate_cost_us():
    """Microseconds a span site and a bracket site cost with no profiler
    recording, on this host."""
    import torch

    try:
        from odise_torch.utils.tracing import bracket, span
    except ImportError:  # a program without the ranges
        return None

    x = torch.ones(3, requires_grad=True)

    def span_site():
        with span("odise.x"):
            pass

    def bracket_site():
        got, bwd = bracket("odise.x", x)
        bwd(got)

    n = 200000
    return {name: min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6
            for name, fn in (("span", span_site), ("bracket", bracket_site))}


def report(run):
    from perfbench.common.spans import Spans

    sp = Spans(run.stretch)
    tr = run.stretch
    busy, window = tr.busy_ns(), tr.window[1] - tr.window[0]
    idle = window - busy
    # device time event by event (overlapping events each count in full)
    total = sum(max(0, min(d.end, tr.window[1]) - max(d.start, tr.window[0]))
                for d in tr.device)
    names = sorted(sp.names())
    own_dev, own_idle = defaultdict(int), defaultdict(int)
    for i, ns in sp.device_ns.items():
        own_dev[None if i is None else sp.ranges[i].name] += ns
    for i, ns in sp.idle_ns.items():
        own_idle[None if i is None else sp.ranges[i].name] += ns
    ms = lambda ns: ns / 1e6  # noqa: E731
    out = {"workload": run.workload, "seed": run.seed, "window_ms": ms(window),
           "busy_ms": ms(busy), "idle_ms": ms(idle), "images": run.extra["stretch_images"],
           "own_device_ms": {str(k): ms(v) for k, v in own_dev.items()},
           "own_idle_ms": {str(k): ms(v) for k, v in own_idle.items()},
           "layer_device_ms": {n: ms(sp.layer_ns([n])) for n in names},
           "layer_idle_ms": {n: ms(sp.layer_ns([n], idle=True)) for n in names},
           "ranges_opened": dict(Counter(r.name for r in sp.ranges)),
           "device_event_ms": ms(total),
           "device_claimed_share": 1 - own_dev[None] / total if total else None,
           "idle_claimed_share": 1 - own_idle[None] / idle if idle else None,
           "top_idle": sorted(((str(k), ms(v)) for k, v in own_idle.items()),
                              key=lambda kv: -kv[1])[:5],
           "no_kernel_twice": sum(own_dev.values()) == total}
    # each range name's five largest kernels by name, from its own time
    by_kernel = defaultdict(lambda: defaultdict(int))
    for d in tr.device:
        call = tr.runtime.get(d.corr)
        if call is not None:
            i = sp.owner(call.start, call.thread if sp.by_thread else None)
            by_kernel[None if i is None else sp.ranges[i].name][d.name[:240]] += d.end - d.start
    out["top_kernels_ms"] = {str(n): sorted(((k, ms(v)) for k, v in ks.items()),
                                            key=lambda kv: -kv[1])[:5]
                             for n, ks in by_kernel.items()}
    lone = no_host_op_gaps(tr, sp.gaps())
    lone_ns = sum(e - s for s, e in lone)
    below = defaultdict(int)
    for s, e in lone:
        i = sp.owner((s + e) // 2)
        below[None if i is None else sp.ranges[i].name] += e - s
    out["no_host_op_ms"] = ms(lone_ns)
    out["no_host_op_by_range_ms"] = {str(k): ms(v) for k, v in below.items()}
    if "odise.infer" in names:
        parts = sp.by_layer(INFER_PARTS + ["odise.infer"])
        total = sp.layer_ns(["odise.infer"])
        out["infer"] = {"device_ms": ms(total),
                        "parts_ms": {n: ms(parts[n]) for n in INFER_PARTS},
                        "unclaimed_ms": ms(parts["odise.infer"]),
                        "parts_share": sum(parts[n] for n in INFER_PARTS) / total,
                        "idle_share_under_infer": sp.layer_ns(["odise.infer"], True) / idle,
                        "idle_share_under_fusion":
                            (sp.layer_ns(["odise.fusion"], True) or 0) / idle}
    if "odise.step" in names:
        step = sp.by_layer(["odise.step"])
        out["step"] = {"device_share_below_step": 1 - (own_dev["odise.step"]
                                                       + own_dev[None]) / total,
                       "idle_share_under_a_range": 1 - own_idle[None] / idle,
                       "no_host_op_share_below_step":
                           1 - (below["odise.step"] + below[None]) / lone_ns if lone_ns else None,
                       "step_thread_device_ms": ms(step["odise.step"])}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from perfbench import run as runner
    from perfbench.common import manifest

    runs, driver = [], manifest.driver

    def keeping(name):
        mod = driver(name)
        drive = mod.drive

        def kept(run, fault=None):
            runs.append(run)
            drive(run, fault)

        mod.drive = kept
        return mod

    manifest.driver = keeping
    rc = runner.main(["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", "1"])
    got = report(runs[0]) if runs and runs[0].stretch is not None else {}
    got["rc"] = rc
    got["gate_us"] = gate_cost_us()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(got, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
