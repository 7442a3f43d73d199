"""Reductions of a profiler trace: device busy time as the union of the
device's operation intervals, the idle gaps between them, time by
operation name, and the launch calls the host made.

The union arithmetic is that of homan_tpu_torch/utils_profiling.py
`parse_trace_device_time`; the span is not. Idle time is taken over the
traced stretch's wall on the host clock, so the idle time at the stretch's
edges (the device waiting for the host's first launch, or the host for the
device's last kernel) counts."""
from __future__ import annotations

from collections import defaultdict

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel",
                   "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")


def busy_s(ops):
    """Seconds in which at least one device operation ran; ops: (name,
    start_ns, end_ns)."""
    total, end = 0, None
    for _, start, stop in sorted(ops, key=lambda o: o[1]):
        if end is None or start >= end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e9


def idle_gaps(ops, top: int = 10):
    """The longest gaps between device operations, each named by the
    operation that ends it: [[name, seconds], ...]."""
    gaps, end = [], None
    for name, start, stop in sorted(ops, key=lambda o: o[1]):
        if end is not None and start > end:
            gaps.append(["before_" + name[:57], (start - end) / 1e9])
        end = stop if end is None else max(end, stop)
    return sorted(gaps, key=lambda g: -g[1])[:top]


def time_by_name(ops):
    """{name: device seconds}."""
    out = defaultdict(int)
    for name, start, stop in ops:
        out[name] += stop - start
    return {k: v / 1e9 for k, v in out.items()}


def top_ops(ops, top: int = 10):
    by = time_by_name(ops)
    return [[k[:64], v] for k, v in sorted(by.items(),
                                           key=lambda kv: -kv[1])[:top]]


def kernel_s(ops, fragment: str) -> float:
    """Device seconds of the operations whose name holds `fragment`."""
    return sum(stop - start for name, start, stop in ops
               if fragment in name) / 1e9


def count_launches(host_calls) -> int:
    return sum(1 for name in host_calls if name.startswith(LAUNCH_PREFIXES))
