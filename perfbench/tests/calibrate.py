"""Readings that the correctness limits are set from, on the card, at the
cell's own size: for each seed, a short window of the cell (``--seconds``)
and its check against the reference, then the control (the reference
through float8 e4m3, making its own choices, which the float32 reference
then follows) on the same images or batches. Prints one JSON line a seed.

    python3 perfbench/tests/calibrate.py --workload label_infer_b4 --seconds 4 --seeds 1 2 3 \
        [--control N] [--fault NAME]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="run the control on the first N seeds")
    ap.add_argument("--fault", default=None, help="a fault of perfbench/tests/faults.py")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from perfbench.common import device, manifest
    from perfbench.common.context import Run

    cell = manifest.cell(args.workload)
    device.require_cards(int(cell["chips"]))
    traffic = manifest.traffic(cell["traffic"])
    drv = manifest.driver(traffic["driver"])
    from perfbench.tests import faults

    fault = None
    if args.fault:
        fault = {**faults.INFER, **faults.TRAIN}[args.fault]
    for i, seed in enumerate(args.seeds):
        torch.cuda.reset_peak_memory_stats()
        run = Run(workload=args.workload, seed=seed, seconds=args.seconds, trace=False,
                  config=manifest.config(cell["config"]), traffic=traffic,
                  t0=time.perf_counter())
        run.extra["limits"] = manifest.limits(args.workload)
        run.extra["control"] = i < args.control
        drv.drive(run, fault=fault)
        limits, ctl = run.extra["limits"], run.extra.get("control_gaps")
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": run.correct,
                          "control_correct": None if ctl is None else
                          all(ctl[k] <= limits[k] for k in limits),
                          "program": run.extra.get("gaps") or {n: v for n, v, _ in run.checks},
                          "control": run.extra.get("control_gaps"), "log": run.log,
                          "e2e": run.e2e, "setup_s": run.setup_s}), flush=True)


if __name__ == "__main__":
    main()
