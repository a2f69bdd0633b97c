"""Milliseconds an image that the device sits idle inside semantic and
panoptic fusion (``odise.fusion``: the host syncs of the id assignment)
over the plain traced stretch of whole eval calls (``common/spans.py``)."""

from perfbench.common import spans

LAYER = "fusion (models/inference.py) and the copy to the host"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.fusion"], idle=True)
