"""Rotation representations (counterpart of homan_tpu/core/geometry.py:18-75).

Conventions as in the JAX package: rotations act on ROW vectors from the
right, `v_rot = v @ R`; `rodrigues` returns column-convention matrices, as
the MANO layer consumes them.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """L2-normalize along `dim` (same eps semantics as F.normalize)."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def rot6d_to_matrix(rot_6d: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) or (..., 3, 2) -> (..., 3, 3) Gram-Schmidt frame,
    R[..., :, k] = b_k."""
    if rot_6d.shape[-1] == 6:
        batch_shape = rot_6d.shape[:-1]
    else:
        batch_shape = rot_6d.shape[:-2]
    r = rot_6d.reshape(batch_shape + (3, 2))
    a1 = r[..., 0]
    a2 = r[..., 1]
    b1 = normalize(a1)
    b2 = normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d(rotmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3, 2): the first two columns."""
    return rotmat[..., :, :2]


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> column-convention rotations (..., 3, 3).

    The norm is clamped under the sqrt so the gradient at ||aa|| = 0 stays
    finite, as in the JAX version.
    """
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(sq, min=1e-24))
    k = axis_angle / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([zero, -kz, ky], dim=-1),
        torch.stack([kz, zero, -kx], dim=-1),
        torch.stack([-ky, kx, zero], dim=-1),
    ], dim=-2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
