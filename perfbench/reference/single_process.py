"""The collectives the copied criterion and grounding loss call, at one
process: the reference is one plain process on one device."""

import torch


def get_data_world_size() -> int:
    return 1


def get_data_rank() -> int:
    return 0


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def all_gather_rows(x: torch.Tensor, differentiable: bool = True) -> torch.Tensor:
    return x
