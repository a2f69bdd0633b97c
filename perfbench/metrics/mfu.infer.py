"""The eval call's share of the card's bf16 peak: the model FLOPs of the
window's calls (``arith/flops.py``, counted over the reference on the meta
device, by bucket) over the window's seconds, over 989e12 FLOP/s
(``arith/peaks.py``)."""

from perfbench.arith import flops, peaks

LAYER = "whole step (a call or a train step)"
UNIT = "%"
MOVES = "infer_img_per_s"


def read(run):
    x = run.extra
    if "calls_by_bucket" not in x:
        return None
    total = 0
    for bucket, n in x["calls_by_bucket"].items():
        h, w = (int(v) for v in bucket.split("x"))
        total += n * flops.infer_flops(x["kind"], run.scale or run.config["scale"],
                                       x["with_clip_head"], (h, w), x["batch"],
                                       x["n_text"], x["n_clip_text"])
    return 100.0 * total / x["window_s"] / peaks.BF16_FLOPS
