"""Device milliseconds an image in the deformable pixel decoder
(``odise.pixel_decoder``, its deformable attention included) over the plain
traced stretch of whole eval calls (``common/spans.py``)."""

from perfbench.common import spans

LAYER = "pixel decoder (models/decoder/pixel_decoder.py)"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.pixel_decoder"])
