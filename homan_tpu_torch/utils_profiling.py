"""Per-stage wall timers (the StageTimers of homan_tpu/utils_profiling.py).

A timer that is asked to sync waits for the card with
`torch.cuda.synchronize()` before it stops, so work queued on the device is
charged to the stage that queued it. Device traces come from
`torch.profiler` (chip_smoke.py's profile windows).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimers:
    """Accumulating named wall timers."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync: bool = False):
        """Time the block under `name`. With sync the clock stops after
        torch.cuda.synchronize(), where CUDA is in use (the JAX timers
        block on a pytree there)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[name]
            lines.append(f"{name:32s} {self.totals[name]:8.2f}s"
                         f"  x{n}  ({self.totals[name] / n * 1000:8.1f} ms avg)")
        return "\n".join(lines)
