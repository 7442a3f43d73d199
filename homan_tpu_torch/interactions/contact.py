"""Hand-object distances (homan_tpu/interactions/contact.py:35).

Only `batch_pairwise_dist2` is ported in this slice: the coarse interaction
term always reports the `handobj_maxdist` metric through it. The contact and
collision losses belong to the interactions slice.
"""
from __future__ import annotations

import torch


def batch_pairwise_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances (B, N, M) via the matmul expansion, in full
    float32 (the package turns TF32 off)."""
    xx = (x * x).sum(-1)
    yy = (y * y).sum(-1)
    xy = x @ y.transpose(1, 2)
    return xx[:, :, None] + yy[:, None, :] - 2.0 * xy
