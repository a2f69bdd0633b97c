"""What one run carries from the driver to the metric readers and to the
result line."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    t0: float                           # the process's start, perf_counter
    device: str = "cuda"
    scale: Optional[str] = None         # None: the configuration's own; tests pass "tiny"
    dtype: Optional[str] = None         # None: the configuration's own
    setup_s: Optional[float] = None
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    memory_peak_bytes: Optional[int] = None
    stretch: Any = None                 # the Trace of the plain traced stretch
    ranges: Any = None                  # the Trace of the instrumented stretch
    extra: Dict[str, Any] = field(default_factory=dict)
    log: List[str] = field(default_factory=list)

    def window_opens(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        import math
        return bool(self.checks) and all(math.isfinite(v) and v <= lim
                                         for _, v, lim in self.checks)
