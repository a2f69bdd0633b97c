"""Device milliseconds an image in the masked transformer decoder
(``odise.mask_decoder``: its 9 layers, the prediction heads, the mask
pooling) over the plain traced stretch of whole eval calls
(``common/spans.py``)."""

from perfbench.common import spans

LAYER = "mask decoder (models/decoder/transformer_decoder.py)"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.mask_decoder"])
