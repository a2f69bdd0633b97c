"""Device milliseconds an image in the SD backbone over the plain traced
train step: its forward over the serial crops (``odise.backbone``) and its
backward (``odise.backbone.bwd``), which holds each crop's recompute
(``common/spans.py``)."""

from perfbench.common import spans

LAYER = "SD backbone (models/backbone, models/sd, the captioner's CLIP tower)"
UNIT = "ms/img"
MOVES = "train_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.backbone", "odise.backbone.bwd"])
