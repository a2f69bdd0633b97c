"""Device milliseconds an image in the SD backbone (the VAE and UNet taps,
the implicit captioner, the projections; ``odise.backbone``) over the plain
traced stretch of whole eval calls: every kernel, copy and fill whose
innermost program range at launch is that range or one nested in it
(``common/spans.py``)."""

from perfbench.common import spans

LAYER = "SD backbone (models/backbone, models/sd, the captioner's CLIP tower)"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.backbone"])
