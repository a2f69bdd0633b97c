"""Milliseconds an image that the device sits idle inside the optimizer
(``odise.optimizer``: the global norm, the clip and AdamW, leaf by leaf)
over the plain traced train step (``common/spans.py``)."""

from perfbench.common import spans

LAYER = "optimizer (engine/optimizer.py)"
UNIT = "ms/img"
MOVES = "train_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.optimizer"], idle=True)
