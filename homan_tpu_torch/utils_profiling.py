"""Per-stage wall timers, program spans and counters, and device traces
(homan_tpu/utils_profiling.py).

A timer that is asked to sync waits for the card with
`torch.cuda.synchronize()` before it stops, so work queued on the device is
charged to the stage that queued it.

Spans and counters record only inside `tracing()`, and are off by default.
A span is a `torch.profiler.record_function` range, so it lands in the same
profiler trace as the device's kernels, on the trace's clock; off, `span`
returns a shared null context after one boolean test. A counter adds a
mask's nonzero count and its size (`count`), or the sums of a kernel's own
count and total tensors (`tally`), to accumulators on the device, with no
host sync; `counters()` reads and resets them. Tracing changes no
value the program computes.

Device traces come from `torch.profiler` in place of the JAX package's
xplane files: the device's busy time is the union of the CUDA kernel, copy
and set intervals of the trace, read from its raw events (the profiler's
own aggregation, `key_averages`, takes minutes over ~10^6 events).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

_tracing = False
_NULL = contextlib.nullcontext()
# (counter name, device) -> [hits (a device tensor), total (an int or a
# device tensor)]
_counts: Dict[Tuple[str, torch.device], list] = {}


@contextlib.contextmanager
def tracing():
    """Spans and counters on for the block. The outermost block starts
    with no counts."""
    global _tracing
    before = _tracing
    if not before:
        _counts.clear()
    _tracing = True
    try:
        yield
    finally:
        _tracing = before


def span(name: str):
    """A profiler range named `name` while tracing is on; otherwise a
    null context."""
    if not _tracing:
        return _NULL
    return torch.profiler.record_function(name)


def physical(x: torch.Tensor) -> torch.Tensor:
    """The tensor beneath torch.func.vmap's batched wrappers (x itself
    outside vmap): all of the vmapped entries at once."""
    from torch._C import _functorch
    while _functorch.is_batchedtensor(x):
        x = _functorch.get_unwrapped(x)
    return x


def _add(name: str, device, hits, n) -> None:
    acc = _counts.get((name, device))
    if acc is None:
        _counts[(name, device)] = [hits, n]
    else:
        acc[0] = acc[0] + hits
        acc[1] = acc[1] + n


def count(name: str, mask: torch.Tensor) -> None:
    """While tracing is on, add mask's nonzero entries and its size to
    counter `name`; under vmap every vmapped entry counts."""
    if not _tracing:
        return
    x = physical(mask)
    _add(name, x.device, torch.count_nonzero(x), x.numel())


def tally(name: str, hits: torch.Tensor, total: torch.Tensor) -> None:
    """While tracing is on, add the sum of hits' entries and the sum of
    total's to counter `name`: counts a kernel wrote (one a frame, say),
    summed on their device; under vmap every vmapped entry counts."""
    if not _tracing:
        return
    h, n = physical(hits), physical(total)
    _add(name, h.device, h.sum(), n.sum())


def counters() -> Dict[str, Tuple[int, int]]:
    """{name: (nonzero entries, entries)} counted since the last call (or
    the outermost tracing block's start), as host ints after one device
    synchronize; resets them."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out: Dict[str, Tuple[int, int]] = {}
    for (name, _), (hits, n) in _counts.items():
        h0, n0 = out.get(name, (0, 0))
        out[name] = (h0 + int(hits), n0 + int(n))
    _counts.clear()
    return out


class StageTimers:
    """Accumulating named wall timers."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync: bool = False):
        """Time the block under `name`, inside span(name). With sync the
        clock stops after torch.cuda.synchronize(), where CUDA is in use
        (the JAX timers block on a pytree there)."""
        with span(name):
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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """A torch.profiler window of CPU and CUDA activity around a block;
    yields the profiler (parse_trace_device_time reads it). With log_dir,
    the Chrome trace is written there as trace.json when the block ends."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        import os
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def parse_trace_device_time(prof, top: int = 10):
    """Device time of a finished profile_trace window: {device_busy_s, the
    union of its CUDA intervals; span_s, first start to last end;
    duty_cycle, busy over span; launch_calls, cudaLaunchKernel calls;
    per_op_s, the `top` kernels by device time}. None when the window holds
    no device event (a CPU run)."""
    cuda_t = torch.autograd.DeviceType.CUDA
    spans, per_op, launches = [], defaultdict(float), 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda_t:
            spans.append((e.start_ns(), e.end_ns()))
            per_op[e.name()] += e.duration_ns() / 1e9
        elif e.name().startswith("cudaLaunchKernel"):
            launches += 1
    if not spans:
        return None
    spans.sort()
    busy_ns, end = 0, None
    for start, stop in spans:
        if end is None or start >= end:
            busy_ns += stop - start
            end = stop
        elif stop > end:
            busy_ns += stop - end
            end = stop
    span_s = (max(s for _, s in spans) - spans[0][0]) / 1e9
    return {
        "device_busy_s": busy_ns / 1e9,
        "span_s": span_s,
        "duty_cycle": busy_ns / 1e9 / max(span_s, 1e-9),
        "launch_calls": launches,
        "per_op_s": dict(sorted(per_op.items(), key=lambda kv: -kv[1])[:top]),
    }


def measure_duty_cycle(fn, log_dir: Optional[str] = None):
    """Run fn() in a profile_trace window, waiting for the card at its end;
    returns parse_trace_device_time's numbers (none on a CPU run) with
    wall_s and duty_cycle_vs_wall (busy over wall). A profiler failure
    raises: a wall time alone is not a duty cycle."""
    t0 = time.perf_counter()
    with profile_trace(log_dir) as prof:
        fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = parse_trace_device_time(prof) or {}
    stats["wall_s"] = wall
    if "device_busy_s" in stats:
        stats["duty_cycle_vs_wall"] = stats["device_busy_s"] / max(wall, 1e-9)
    return stats
