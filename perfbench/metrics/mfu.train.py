"""The train step's share of the card's bf16 peak: the model FLOPs of a
step (``arith/flops.py``: forward and backward of what the step
differentiates, over the reference on the meta device) times the window's
steps, over the window's seconds, over 989e12 FLOP/s (``arith/peaks.py``).
Recomputation under checkpointing, the matching and the point sampling
are not counted."""

from perfbench.arith import flops, peaks

LAYER = "whole step (a call or a train step)"
UNIT = "%"
MOVES = "train_img_per_s"


def read(run):
    x = run.extra
    if "steps" not in x:
        return None
    opts = dict(run.config["train"], **x.get("opts_override", {}))
    per_step = flops.train_flops(x["kind"], run.scale or run.config["scale"], x["batch"],
                                 opts["image_size"], x["n_text"], run.traffic["num_words"],
                                 x["text_dim"])
    return 100.0 * per_step * x["steps"] / x["window_s"] / peaks.BF16_FLOPS
