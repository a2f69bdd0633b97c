"""Device milliseconds an image in the losses over the plain traced train
step: the set criterion with its matcher (``odise.criterion``), the
grounding loss (``odise.grounding``) and their backwards
(``common/spans.py``)."""

from perfbench.common import spans

LAYER = "criterion, matcher and grounding loss (losses/, ops/lap.py)"
UNIT = "ms/img"
MOVES = "train_img_per_s"


def read(run):
    return spans.ms_per_img(run, ["odise.criterion", "odise.criterion.bwd",
                                  "odise.grounding", "odise.grounding.bwd"])
