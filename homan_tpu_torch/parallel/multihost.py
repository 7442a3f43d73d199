"""Multi-process deployment helpers (homan_tpu/parallel/multihost.py).

Clips are independent, so several processes (hosts) split the sample index
space as the reference's jobs do (--data_step/--data_offset), and the only
traffic between them is the final gathering of metrics. The JAX package
uses jax.distributed; here `torch.distributed` with the gloo backend.

One clip's frames can also span the processes (parallel/frames.py), where
GSPMD would insert the collectives the math needs. Here two autograd
Functions carry them: `gather_frames` (every rank's frame-major rows in
rank order; its backward sums the ranks' upstream gradients and keeps this
rank's rows) and `replicate` (the identity; its backward sums the
gradient over ranks, as GSPMD all-reduces the global scales' gradients).
Both run on the tensors' own device: gloo takes CUDA tensors for
all_gather_into_tensor and all_reduce (scripts/probe_gloo_cuda.py). The
group stays gloo because NCCL refuses two ranks on one device, so only
gloo runs a process-spanning fit on one card.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout: datetime.timedelta = datetime.timedelta(minutes=5)):
    """Join the process group (gloo); a no-op for a single process.

    coordinator_address: host:port or a tcp:// URL; None reads it from
    MASTER_ADDR and MASTER_PORT (`env://`, as torchrun sets them).
    timeout: how long a collective waits for a peer before it fails the
    run.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None:
        if not (os.environ.get("MASTER_ADDR")
                and os.environ.get("MASTER_PORT")):
            raise ValueError(
                "no coordinator: pass coordinator_address (host:port or a "
                "tcp:// URL) or set MASTER_ADDR and MASTER_PORT")
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=url, world_size=num_processes,
        rank=-1 if process_id is None else process_id, timeout=timeout)


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_count() -> int:
    """Processes in the group (1 outside one)."""
    return _rank_world()[1]


def process_index() -> int:
    """This process's rank in the group (0 outside one)."""
    return _rank_world()[0]


def host_sample_indices(total: int, data_step: int = 1,
                        data_offset: int = 0) -> Sequence[int]:
    """This process's samples: the reference's striding
    (fit_vid_dataset.py:190), then every world-size-th from its rank."""
    rank, world = _rank_world()
    return list(range(data_offset, total, data_step))[rank::world]


def allgather_metrics(local_metrics: Dict[str, Sequence[float]]
                      ) -> Dict[str, np.ndarray]:
    """Every process's per-sample metric lists, concatenated in rank order
    (float32; each list must have the same length on every process, as
    the JAX package's process_allgather requires). A single process gets
    numpy arrays of its input."""
    _, world = _rank_world()
    if world == 1:
        return {k: np.asarray(v) for k, v in local_metrics.items()}
    out = {}
    for k, v in local_metrics.items():
        t = torch.as_tensor(np.asarray(v, np.float32))
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        out[k] = torch.cat(parts).numpy().reshape(-1)
    return out


def all_max(values: Sequence[int]) -> List[int]:
    """The elementwise maximum over ranks of a list of host ints."""
    _, world = _rank_world()
    if world == 1 or not values:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _sum_over_ranks(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over ranks (one all_reduce per dtype)."""
    out: List[torch.Tensor | None] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


_ALIGN = 8  # bytes: every dtype's segment of the gather buffer starts here


class _GatherFrames(torch.autograd.Function):
    """Forward: every rank's rows of each tensor, concatenated in rank
    order along dim 0, in one all_gather of the tensors' bytes (exact for
    every dtype). Backward: the ranks' upstream gradients summed (an
    all-reduce), cut to this rank's rows."""

    @staticmethod
    def forward(ctx, *tensors):
        rank, world = _rank_world()
        device = tensors[0].device
        segments, sizes = [], []
        for t in tensors:
            if t.dim() == 0 or t.device != device:
                raise ValueError("gather_frames takes frame-major tensors "
                                 "on one device")
            b = t.contiguous().reshape(-1).view(torch.uint8)
            sizes.append(b.numel())
            pad = -b.numel() % _ALIGN
            segments.append(b)
            if pad:
                segments.append(b.new_zeros(pad))
        buf = torch.cat(segments)
        out = buf.new_empty(world * buf.numel())
        dist.all_gather_into_tensor(out, buf)
        out = out.view(world, buf.numel())
        gathered, offset = [], 0
        for t, n in zip(tensors, sizes):
            rows = out[:, offset:offset + n].contiguous().view(t.dtype)
            gathered.append(rows.reshape((world * t.shape[0],)
                                         + tuple(t.shape[1:])))
            offset += n + (-n % _ALIGN)
        ctx.rank = rank
        ctx.shapes = [t.shape for t in tensors]
        # The outputs of inputs that need a gradient (the same on every
        # rank): each rank all-reduces all of their gradients, zeros where
        # one is unused, so the collectives match across ranks.
        ctx.live = [i for i, need in enumerate(ctx.needs_input_grad)
                    if need]
        ctx.mark_non_differentiable(*[
            g for g, need in zip(gathered, ctx.needs_input_grad)
            if not need])
        return tuple(gathered)

    @staticmethod
    def backward(ctx, *grads):
        live = ctx.live
        summed = _sum_over_ranks([grads[i].contiguous() for i in live])
        out = [None] * len(grads)
        for i, g in zip(live, summed):
            rows = ctx.shapes[i][0]
            out[i] = g[ctx.rank * rows:(ctx.rank + 1) * rows]
        return tuple(out)


class _Replicate(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over ranks."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return tuple(_sum_over_ranks([g.contiguous() for g in grads]))


def gather_frames(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's frame-major rows of each tensor, in rank order (each
    rank holds the same count of rows of a tensor), through autograd.

    A rank that backpropagates loss / world from a loss every rank computes
    alike gets, at its rows, the loss's gradient: the backward sums the
    ranks' upstream gradients, so every rank applies the same all-reduced
    bits even where a backward (atomics) is not bit-reproducible. Outside
    a group the tensors come back as they are."""
    if process_count() == 1:
        return list(tensors)
    return list(_GatherFrames.apply(*tensors))


def replicate(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors (a global parameter held whole by every rank), whose
    gradient is summed over ranks in the backward. Outside a group the
    tensors come back as they are."""
    if process_count() == 1:
        return list(tensors)
    return list(_Replicate.apply(*tensors))
