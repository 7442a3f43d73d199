"""Per-stage wall timers, device traces and analytic work counts
(homan_tpu/utils_profiling.py).

A timer that is asked to sync waits for the card with
`torch.cuda.synchronize()` before it stops, so work queued on the device is
charged to the stage that queued it. Device traces come from
`torch.profiler` in place of the JAX package's xplane files: the device's
busy time is the union of the CUDA kernel, copy and set intervals of the
trace, read from its raw events (the profiler's own aggregation,
`key_averages`, takes minutes over ~10^6 events).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

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


# Operation counts of the TPU kernels' formulation
# (homan_tpu/render/pallas_shade.py, interactions/pallas_sdf.py), kept under
# the JAX package's names so a bench reads the same keys: per (pixel,
# edge slot) ~13 winding and ~40 distance operations forward, one compare of
# the one-hot backward and its (P, Ke) x (P, 4) matmul at 3 bf16 passes.
# The card's kernels count their own work: render/shade.py `fwd_work` and
# interactions/voxelize.py `work_ops`.
SHADE_FWD_OPS_PER_PIX_EDGE = 53.0
SHADE_BWD_VPU_OPS_PER_PIX_EDGE = 1.0
SHADE_BWD_MXU_FLOPS_PER_PIX_EDGE = 24.0


def shade_flops_per_iter(batch: int, image_size: int, edges_per_tile: int):
    """Operations of one silhouette step's shade forward and backward in
    the TPU kernels' formulation, every pixel against every edge slot of
    its tile: B S^2 Ke times the per-pair counts. Returns {vpu_flops,
    mxu_flops}."""
    pix_edge = float(batch) * image_size * image_size * edges_per_tile
    return {
        "vpu_flops": pix_edge * (SHADE_FWD_OPS_PER_PIX_EDGE
                                 + SHADE_BWD_VPU_OPS_PER_PIX_EDGE),
        "mxu_flops": pix_edge * SHADE_BWD_MXU_FLOPS_PER_PIX_EDGE,
    }


def voxelize_flops_per_iter(batch: int, n_meshes: int, faces: int,
                            grid_size: int = 32,
                            ops_per_pair: float = 150.0):
    """Operations of one grid-SDF step's voxelization in the TPU kernel's
    dense formulation, every (cell, face) pair at `ops_per_pair`. Returns
    {vpu_flops}."""
    return {"vpu_flops": (float(batch) * n_meshes * grid_size ** 3
                          * faces * ops_per_pair)}


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
