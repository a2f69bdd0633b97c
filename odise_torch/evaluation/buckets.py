"""Static shape buckets for variable-size evaluation (counterpart of
``odise_tpu/evaluation/buckets.py``, copied as it is).

Each resized image is padded into one of a few canonical (H, W) shapes;
``valid_hw`` in ``models.inference`` masks the padding out of fusion. The
JAX package buckets to bound its compiles; the port keeps the same shapes so
both packages see the same padded inputs, and PyTorch's allocator reuses
blocks of those few sizes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

# ratios covering COCO/ADE/Pascal val aspect distributions; max jump 1.25x
# bounds the padded-compute waste at ~25%
DEFAULT_RATIOS = (1.0, 4 / 3, 5 / 3, 2.0, 2.5)


def compute_eval_buckets(
    short_side: int = 1024,
    max_size: int = 2560,
    divisibility: int = 64,
    ratios: Sequence[float] = DEFAULT_RATIOS,
) -> List[Tuple[int, int]]:
    """Canonical (H, W) bucket shapes, landscape + portrait, /divisibility."""
    def ceil_div(x: float) -> int:
        return int(math.ceil(x / divisibility)) * divisibility

    max_long = ceil_div(max_size) if max_size % divisibility else max_size
    shapes = set()
    short = ceil_div(short_side)
    for r in ratios:
        long = min(ceil_div(short_side * r), max_long)
        shapes.add((short, long))
        shapes.add((long, short))
    return sorted(shapes)


def pick_bucket(h: int, w: int,
                buckets: Sequence[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
    """Smallest-area bucket that contains (h, w); None if nothing fits."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fitting:
        return None
    return min(fitting, key=lambda b: b[0] * b[1])
