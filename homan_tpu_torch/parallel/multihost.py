"""Multi-process deployment helpers (homan_tpu/parallel/multihost.py).

Clips are independent, so several processes (hosts) split the sample index
space as the reference's jobs do (--data_step/--data_offset), and the only
traffic between them is the final gathering of metrics. The JAX package
uses jax.distributed; here `torch.distributed` with the gloo backend: the
metrics are host floats, so gloo serves the CPU and the card's machine
alike.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Join the process group (gloo; the coordinator as host:port or a
    tcp:// URL); a no-op for a single process."""
    if num_processes is None or num_processes <= 1:
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id)


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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
