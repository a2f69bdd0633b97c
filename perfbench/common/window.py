"""The measured window: whole units of work (calls or steps), started
while the window is open, each ending in a host sync, and the rate over
all of them and all of the time to the last one's end."""

from __future__ import annotations

import time
from typing import Callable, Tuple


def run_window(seconds: float, once: Callable[[int], None],
               clock: Callable[[], float] = time.perf_counter) -> Tuple[int, float]:
    """Call ``once(i)`` for i = 0, 1, ... while fewer than ``seconds`` have
    passed since the window opened. Returns (units done, seconds from the
    window's opening to the last unit's end)."""
    t0 = clock()
    n = 0
    while clock() - t0 < seconds:
        once(n)
        n += 1
    return n, clock() - t0


def rate(units: int, per_unit: int, elapsed: float) -> float:
    """Items a second: every item of every whole unit over the window's time."""
    if elapsed <= 0:
        raise ValueError("an empty window has no rate")
    return units * per_unit / elapsed
