"""The matcher's assignment, solved exactly on the host
(``scipy.optimize.linear_sum_assignment``, the Hungarian method)."""

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from . import decisions


def assign_from_cost(cost: torch.Tensor) -> torch.Tensor:
    """cost [B, Q, T] -> the query matched to each target [B, T]: every
    target gets its own query (T <= Q), at the least total cost."""
    B, Q, T = cost.shape
    c = cost.detach().double().cpu().numpy()
    out = np.zeros((B, T), np.int64)
    for b in range(B):
        rows, cols = linear_sum_assignment(c[b])
        out[b, cols] = rows
    return decisions.assignment(torch.from_numpy(out).to(cost.device), cost)
