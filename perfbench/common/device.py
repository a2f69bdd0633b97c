"""Facts about the card, read beside every run: its name and memory, and
``nvidia-smi``'s SM clock, power draw, power limit and temperature."""

from __future__ import annotations

import subprocess
import sys
import time

import torch

SMI_FIELDS = "name,clocks.sm,power.draw,power.limit,temperature.gpu"


def require_cards(n: int) -> None:
    """Exit (code 3) without a result unless CUDA sees ``n`` cards."""
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is false: no card, no result",
              file=sys.stderr)
        sys.exit(3)
    if torch.cuda.device_count() < n:
        print(f"perfbench: the cell needs {n} cards, CUDA sees "
              f"{torch.cuda.device_count()}: no result", file=sys.stderr)
        sys.exit(3)


def smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def log_facts(when: str) -> None:
    print(f"perfbench: card {when} ({SMI_FIELDS}): {smi()}", file=sys.stderr, flush=True)


def device_entry(count: int, peak: int) -> dict:
    """The result's ``device``; ``peak`` is the program's peak, read when
    the window closed, before the reference ran."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


class ThreadCPU:
    """The calling thread's CPU seconds from its making to ``stop()``."""

    def __init__(self):
        self.t = time.thread_time()

    def stop(self) -> float:
        return time.thread_time() - self.t
