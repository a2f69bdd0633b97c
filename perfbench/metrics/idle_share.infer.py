"""The device's idle share over the plain traced stretch of whole eval
calls: the share of the stretch in which no kernel, copy or fill ran
(``common/trace.py``)."""

LAYER = "device"
UNIT = "%"
MOVES = "infer_img_per_s"


def read(run):
    return None if run.stretch is None else 100.0 * run.stretch.idle_share()
