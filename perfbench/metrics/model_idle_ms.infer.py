"""Milliseconds an image that the device sits idle inside the model's call
(``odise.infer`` or a range nested in it: the trunk and the vocabulary
head) over the plain traced stretch of whole eval calls; each idle gap
goes to the program range opened last of those open at its midpoint
(``common/spans.py``)."""

from perfbench.common import spans

LAYER = "model (models/odise.py and below: SD backbone, pixel and mask decoders, CLIP head)"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.infer"], idle=True)
