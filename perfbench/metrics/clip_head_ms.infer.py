"""Device milliseconds an image in the CLIP head (``odise.clip_head``: the
resize to 336 px, the masked ViT-L/14 and the ensemble with the
vocabulary head's logits) over the plain traced stretch of whole eval
calls (``common/spans.py``)."""

from perfbench.common import spans

LAYER = "CLIP head (models/odise.py PoolingCLIPHead, models/clip)"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.clip_head"])
