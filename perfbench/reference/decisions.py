"""The discrete choices of a forward or a step, which the reference can take
from the side it is compared with instead of making them itself.

A threshold on a logit (the masked decoder's attention masks, the mask
pooling's hard masks, the CLIP head's patch masks), the matcher's
assignment and the criterion's choice of its most uncertain points are
steps, not slopes: where two sides compute a logit a
rounding apart, a choice that lies within that rounding of its threshold
goes either way, and one flipped attention mask moves every query after it.
So the reference follows the choices the compared side made, in the order
it made them, and checks each against its own: a threshold against its own
logits, beyond a margin of ``MARGIN`` times the root mean square of the
logits it thresholds; an assignment by its cost under the reference's own
cost matrix, above the exact optimum; a point by its uncertainty against
the reference's own cutoff.

    with decisions.following(handed) as book:   # handed: a list, or None
        ... the reference's forward or step ...
    book.kept        # the choices the reference made or took, in order
    book.flip_share  # handed thresholds that the reference's own logits
                     # contradict beyond the margin, over all handed ones
    book.match_excess  # the largest cost of a handed assignment above the
                     # optimum, per target told apart
    book.point_share # handed importance-sampled points that the reference's
                     # own uncertainties put below its cutoff beyond the
                     # margin, over all handed ones
    book.marks       # the counts at each ``mark()`` (the end of a train step)

With no book open every choice is the reference's own.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

MARGIN = 0.05  # of the thresholded logits' root mean square

_BOOK: Optional["Book"] = None


class Book:
    def __init__(self, handed: Optional[List[torch.Tensor]], keep_on: str):
        self.handed = list(handed) if handed is not None else None
        self.keep_on = keep_on
        self.kept: List[torch.Tensor] = []
        self.thresholds = 0          # handed threshold choices
        self.flips = 0               # of them contradicted beyond the margin
        self.match_excess = 0.0
        self.points = 0              # handed importance-sampled points
        self.point_flips = 0         # of them below the own cutoff beyond the margin
        self.mismatched = 0          # handed choices of another shape, not taken
        self.marks: List["Book"] = []

    def counts(self) -> "Book":
        """The counts so far, without the choices."""
        c = Book(None, self.keep_on)
        for k in ("thresholds", "flips", "match_excess", "points",
                  "point_flips", "mismatched"):
            setattr(c, k, getattr(self, k))
        return c

    @property
    def flip_share(self) -> float:
        return self.flips / max(self.thresholds, 1)

    @property
    def point_share(self) -> float:
        return self.point_flips / max(self.points, 1)

    def _next(self, like: torch.Tensor) -> Optional[torch.Tensor]:
        if self.handed is None:
            return None
        if not self.handed:
            raise RuntimeError("the reference made more choices than it was handed")
        h = self.handed.pop(0)
        if tuple(h.shape) != tuple(like.shape):
            self.mismatched += 1
            return None
        return h.to(like.device)

    def _keep(self, t: torch.Tensor) -> None:
        self.kept.append(t.detach().to(self.keep_on))


@contextlib.contextmanager
def following(handed: Optional[List[torch.Tensor]] = None, keep_on: str = "cpu"):
    global _BOOK
    book = Book(handed, keep_on)
    old, _BOOK = _BOOK, book
    try:
        yield book
    finally:
        _BOOK = old


def mark() -> None:
    """Keep the counts so far (the end of one train step) in ``book.marks``."""
    if _BOOK is not None:
        _BOOK.marks.append(_BOOK.counts())


def threshold(own: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``own``: the reference's bool choice from ``logits`` (broadcast to its
    shape). Returns the choice to go on with."""
    book = _BOOK
    if book is None:
        return own
    h = book._next(own)
    if h is None:
        book._keep(own)
        return own
    z = logits.detach().double().expand(own.shape) if logits.shape != own.shape \
        else logits.detach().double()
    rms = torch.sqrt(torch.mean(z * z))
    differ = h != own
    book.thresholds += own.numel()
    book.flips += int((differ & (z.abs() > MARGIN * rms)).sum())
    book._keep(h)
    return h


def assignment(own: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """``own``: the reference's optimal assignment [B, T] (the query of each
    target) of ``cost`` [B, Q, T]. Returns the assignment to go on with."""
    book = _BOOK
    if book is None:
        return own
    h = book._next(own)
    if h is None:
        book._keep(own)
        return own
    c = cost.detach().double()
    picked = torch.gather(c, 1, h[:, None, :]).squeeze(1).sum(-1)
    best = torch.gather(c, 1, own[:, None, :]).squeeze(1).sum(-1)
    told_apart = (c.amax(1) != c.amin(1)).sum(-1).clamp(min=1)
    book.match_excess = max(book.match_excess,
                            float(((picked - best) / told_apart).max()))
    book._keep(h)
    return h


def points(own: torch.Tensor, n_unc: int, uncertainty_of, cutoff: torch.Tensor,
           logits: torch.Tensor) -> torch.Tensor:
    """``own``: the reference's points [N, P, 2], the first ``n_unc`` its
    most uncertain candidates, whose least uncertainty is ``cutoff`` [N];
    ``uncertainty_of(points)`` gives its uncertainty (-|logit|) at points;
    ``logits``: the candidates' logits. Returns the points to go on with."""
    book = _BOOK
    if book is None:
        return own
    h = book._next(own)
    if h is None:
        book._keep(own)
        return own
    u = uncertainty_of(h[:, :n_unc]).double()
    rms = torch.sqrt(torch.mean(logits.detach().double() ** 2))
    book.points += u.numel()
    book.point_flips += int((u < cutoff.double()[:, None] - MARGIN * rms).sum())
    book._keep(h)
    return h
