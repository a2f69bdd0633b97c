"""Kernel launches an image: the CUDA runtime's launch calls over the plain
traced stretch of whole eval calls, over the stretch's images."""

LAYER = "host issue (the Python path down to the CUDA runtime)"
UNIT = "launches/img"
MOVES = "infer_img_per_s"


def read(run):
    if run.stretch is None:
        return None
    return run.stretch.launches() / run.extra["stretch_images"]
