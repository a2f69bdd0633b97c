"""Kernel launches an image: the CUDA runtime's launch calls over the plain
traced stretch of whole train steps, over the stretch's images."""

LAYER = "host issue (the Python path down to the CUDA runtime)"
UNIT = "launches/img"
MOVES = "train_img_per_s"


def read(run):
    if run.stretch is None:
        return None
    return run.stretch.launches() / run.extra["stretch_images"]
