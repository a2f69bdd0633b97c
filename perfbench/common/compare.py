"""The numbers the correctness check compares."""

import torch


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    """||x - ref|| / ||ref|| over every element, in float64."""
    x, ref = x.double(), ref.double().to(x.device)
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


