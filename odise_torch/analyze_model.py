"""Parameter tables of CategoryODISE (counterpart of
``tools/analyze_model.py``).

    python -m odise_torch.analyze_model [--scale full|tiny] [--max-depth N] [--device cpu]

Builds CategoryODISE with the CLIP head and 133 labels at the named scale
on ``--device`` (default CUDA) and prints the table of all parameters, the
table of the trainable ones (what ``engine.partition_params`` leaves
trainable) and the totals: at FULL 28,591,297 trainable, which the
reference rounds to 28.1M.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from .model_zoo.factory import build_category_odise
from .utils.parameter_count import parameter_count, parameter_count_table

NUM_LABELS = 133


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", default="full", choices=["full", "tiny"])
    ap.add_argument("--max-depth", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    labels = tuple((f"c{i}",) for i in range(NUM_LABELS))
    model = build_category_odise(args.scale, train_labels=labels, with_clip_head=True,
                                 use_checkpoint=False, slide_training=False,
                                 device=args.device)
    print("=== all parameters ===")
    print(parameter_count_table(model, max_depth=args.max_depth))
    print("\n=== trainable parameters ===")
    print(parameter_count_table(model, max_depth=args.max_depth, trainable_only=True))
    total = parameter_count(model)[""]
    trainable = parameter_count(model, trainable_only=True)[""]
    print(f"\ntotal: {total / 1e6:.1f}M  trainable: {trainable / 1e6:.1f}M "
          f"(reference: 28.1M trainable)  exact: {total:,} total, {trainable:,} trainable")
    return {"total": total, "trainable": trainable}


if __name__ == "__main__":
    main()
