"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``perfbench/configs/<name>.json``) and a traffic
mix (``perfbench/traffic/<name>.json``), whose ``driver`` is
``perfbench/drivers/<driver>.py``. The run sets up the program from the
seed, measures for ``--seconds``, with ``--trace 1`` traces stretches
after the window and reads the cell's per-layer metrics
(``perfbench/metrics/<name>.py``), then holds the window's outputs to the
plain reference (``perfbench/reference``). Its last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.

It needs the cards the cell asks for (exit 3 without them) and the program
``odise_torch`` beside it (exit 2 without it). It exits 4, with no
result, if JAX, flax or the JAX package were imported.
"""

import time

T0 = time.perf_counter()  # setup_s counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "perfbench", ".cache")
# every compile cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
FORBIDDEN = ("jax", "jaxlib", "flax", "odise_tpu")
PROGRAM = "odise_torch"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(run, metrics_out, breakdown):
    from perfbench.common.device import device_entry

    device = device_entry(int(run.extra.get("chips", 1)), run.memory_peak_bytes)
    if run.trace:
        device["busy_s"] = run.stretch.busy_ns() / 1e9
        device["window_s"] = run.stretch.window_s
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics_out, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        print(f"perfbench: no program: {PROGRAM}/ is not beside perfbench/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from perfbench.common import device, manifest
    from perfbench.common.context import Run

    man = manifest.manifest()
    cell = manifest.cell(args.workload, man)
    device.require_cards(int(cell["chips"]))
    import torch

    torch.cuda.set_device(0)
    traffic = manifest.traffic(cell["traffic"])
    run = Run(workload=args.workload, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), config=manifest.config(cell["config"]),
              traffic=traffic, t0=T0)
    run.extra["chips"] = cell["chips"]
    run.extra["limits"] = manifest.limits(args.workload)
    print(f"perfbench: {args.workload} seed {args.seed} seconds {args.seconds} trace "
          f"{args.trace}; torch {torch.__version__} CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    device.log_facts("before the run")
    manifest.driver(traffic["driver"]).drive(run)
    device.log_facts("after the run")
    for line in run.log:
        print(f"perfbench: {line}", file=sys.stderr)

    metrics_out, breakdown = {}, None
    if run.trace:
        for entry in manifest.per_layer(args.workload, man):
            value = manifest.metric(entry["name"]).read(run)
            if value is not None:
                metrics_out[entry["name"]] = {"value": value, "unit": entry["unit"]}
        breakdown = {"device_ops": run.stretch.device_ops(),
                     "idle_gaps": run.stretch.idle_gaps()}
    else:
        run.e2e["setup_s"] = run.setup_s
        for entry in manifest.end_to_end(args.workload, man):
            if entry["name"] not in run.e2e:
                print(f"perfbench: the driver gave no {entry['name']}", file=sys.stderr)
                return 5
            metrics_out[entry["name"]] = {"value": run.e2e[entry["name"]],
                                          "unit": entry["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process imported {bad}: no result", file=sys.stderr)
        return 4
    line = result_line(run, metrics_out, breakdown)
    for name, v, lim in run.checks:
        ok = math.isfinite(v) and v <= lim
        print(f"perfbench: check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
