"""Linear assignment by the auction algorithm, batched over problems
(counterpart of ``odise_tpu/ops/lap.py``).

The JAX package runs a Jacobi auction [Bertsekas 1988] in a vmapped
``lax.while_loop``: every round, each unassigned row bids for its best
column, each column goes to its highest bidder. Here all problems run the
same rounds together; a problem with no unassigned row is left unchanged by
a round, exactly as the vmapped loop leaves it. Asking the device whether
any row is still unassigned costs a host sync, so the loop asks every
``check_every`` rounds; the rounds in between change nothing once all rows
are assigned, and the 2000-round cap is kept exactly.

Ties are broken as the JAX code breaks them: ``lax.top_k`` and
``jnp.argmax`` take the lowest index, and so do ``torch.argmax`` and
``torch.max(dim)``; ``topk`` is not used, since it promises no order.
"""

from __future__ import annotations

import torch

__all__ = ["assign_from_cost", "auction_lap", "linear_sum_assignment"]

_NEG = -1e30


def auction_lap(benefit: torch.Tensor, max_iters: int = 2000,
                check_every: int = 16) -> torch.Tensor:
    """Maximize sum(benefit[b, i, col[b, i]]) over permutations, for each of
    the [B, N, N] problems, bidding in increments of (the range of the
    problem's benefit) * 1e-4 / N. Returns col_of_row [B, N] int64."""
    if benefit.dim() != 3 or benefit.shape[1] != benefit.shape[2]:
        raise ValueError(f"benefit must be [B, N, N], got {tuple(benefit.shape)}")
    benefit = benefit.float()
    B, N, _ = benefit.shape
    dev = benefit.device
    flat = benefit.reshape(B, -1)
    eps = torch.clamp(flat.amax(1) - flat.amin(1), min=1e-6) * 1e-4 / N

    price = torch.zeros((B, N), dtype=torch.float32, device=dev)
    owner = torch.full((B, N), -1, dtype=torch.long, device=dev)
    obj_of_row = torch.full((B, N), -1, dtype=torch.long, device=dev)
    obj_ids = torch.arange(N, device=dev).expand(B, N)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)

    def round_():
        nonlocal price, owner, obj_of_row
        unassigned = obj_of_row < 0
        vals = benefit - price[:, None, :]
        best_j = vals.argmax(-1)                                   # [B, N]
        v1 = vals.gather(-1, best_j[..., None])[..., 0]
        v2 = vals.scatter(-1, best_j[..., None], float("-inf")).amax(-1)
        bid_amt = price.gather(1, best_j) + (v1 - v2) + eps[:, None]
        bid_amt = torch.where(unassigned, bid_amt, neg)
        bids = torch.full((B, N, N), _NEG, dtype=torch.float32, device=dev)
        bids.scatter_(2, best_j[..., None], bid_amt[..., None])   # row i bids on best_j[i]
        wbid, winner = bids.max(dim=1)                             # per column
        has_bid = wbid > _NEG / 2
        # previous owners of re-auctioned columns lose them; rows index N are
        # dropped, as the JAX code's mode="drop" scatters drop them
        pad = torch.cat([obj_of_row, obj_of_row.new_full((B, 1), -1)], 1)
        lose = torch.where(has_bid & (owner >= 0), owner, N)
        pad.scatter_(1, lose, -1)
        price = torch.where(has_bid, wbid, price)
        owner = torch.where(has_bid, winner, owner)
        win = torch.where(has_bid, winner, N)
        pad.scatter_(1, win, torch.where(has_bid, obj_ids, -1))
        obj_of_row = pad[:, :N]

    it = 0
    while it < max_iters:
        for _ in range(min(check_every, max_iters - it)):
            round_()
            it += 1
        if not bool((obj_of_row < 0).any()):
            break
    # rows still unassigned at the cap take the unclaimed columns, in order
    claimed = torch.zeros((B, N + 1), dtype=torch.long, device=dev)
    claimed.scatter_(1, torch.where(obj_of_row >= 0, obj_of_row, N), 1)
    free_objs = torch.argsort(claimed[:, :N], dim=1, stable=True)
    needs = obj_of_row < 0
    order = torch.argsort((~needs).long(), dim=1, stable=True)
    fill = torch.zeros_like(obj_of_row).scatter(1, order, free_objs)
    return torch.where(needs, fill, obj_of_row)


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Batched LAP minimizing [B, N, M] costs with M <= N. Returns
    col_of_row [B, N]: each row's column, or a value >= M where the row is
    matched to a padding column (unmatched)."""
    B, N, M = cost.shape
    if M > N:
        raise ValueError("linear_sum_assignment needs cols <= rows (pad targets)")
    benefit = -cost.float()
    if M < N:
        lo = benefit.reshape(B, -1).amin(1) - 1.0
        benefit = torch.cat([benefit, lo[:, None, None].expand(B, N, N - M)], dim=2)
    return auction_lap(benefit)


def assign_from_cost(cost: torch.Tensor) -> torch.Tensor:
    """cost [B, Q, T] -> the query matched to each target [B, T] (0 where
    no query is), one batched auction for all problems."""
    B, Q, T = cost.shape
    col_of_row = linear_sum_assignment(cost)                       # [B, Q]
    matched = torch.zeros((B, T + 1), dtype=torch.long, device=cost.device)
    rows = torch.arange(Q, device=cost.device).expand(B, Q)
    matched.scatter_(1, torch.where(col_of_row < T, col_of_row, T), rows)
    return matched[:, :T]
