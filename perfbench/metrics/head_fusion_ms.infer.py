"""Device milliseconds an image from the model's outputs through semantic
and panoptic fusion (``models/inference.py``) and the maps' copy to the
host, between the harness's CUDA events, summed over every call of the
measured window (no profiler, no wrap) over its images."""

LAYER = "fusion (models/inference.py) and the copy to the host"
UNIT = "ms/img"
MOVES = "infer_img_per_s"


def read(run):
    return run.extra.get("head_fusion_ms")
