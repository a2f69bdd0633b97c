"""The matcher's auction rounds a step: ``auction_lap.rounds`` over the
instrumented traced step, snapshotted by ``install`` before it and by its
undo after it. Every auction runs to its 2,000-round cap where the
assignment is not complete before."""

import importlib

LAYER = "criterion, matcher and grounding loss (losses/, ops/lap.py)"
UNIT = "rounds/step"
MOVES = "train_img_per_s"


def install(run):
    lap = importlib.import_module("odise_torch.ops.lap").auction_lap
    before = lap.rounds

    def undo():
        run.extra["auction_rounds"] = lap.rounds - before

    return undo


def read(run):
    return run.extra.get("auction_rounds")
