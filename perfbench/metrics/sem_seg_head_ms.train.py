"""Device milliseconds an image in the pixel and mask decoders over the
plain traced train step, forward (``odise.sem_seg_head``) and backward
(``odise.sem_seg_head.bwd``) (``common/spans.py``)."""

from perfbench.common import spans

LAYER = "MaskFormer head (pixel and mask decoders, models/decoder)"
UNIT = "ms/img"
MOVES = "train_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.sem_seg_head", "odise.sem_seg_head.bwd"])
