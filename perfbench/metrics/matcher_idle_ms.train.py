"""Milliseconds an image that the device sits idle inside the matcher
(``odise.matcher``: the cost matrices and the auction, whose host checks
wait on the device) over the plain traced train step (``common/spans.py``)."""

from perfbench.common import spans

LAYER = "criterion, matcher and grounding loss (losses/, ops/lap.py)"
UNIT = "ms/img"
MOVES = "train_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.matcher"], idle=True)
