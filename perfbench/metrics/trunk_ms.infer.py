"""Device milliseconds an image from the harness's CUDA event before its
call into the model (``OpenPanopticInference``: the trunk, then the
vocabulary head) to the event after the model's outputs, summed over every
call of the measured window (no profiler, no wrap) over its images."""

LAYER = "model (models/odise.py and below: SD backbone, pixel and mask decoders, CLIP head)"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return run.extra.get("trunk_ms")
