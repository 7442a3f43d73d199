"""Rotations and projections. Rotations act on row vectors from the right
(v @ R); `rodrigues` returns column-convention matrices, as MANO takes
them."""
from __future__ import annotations

import torch


def normalize(v, eps: float = 1e-12):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def rot6d_to_matrix(r):
    """(..., 3, 2) -> (..., 3, 3): the Gram-Schmidt frame of the two
    columns, R[..., :, k] = b_k."""
    a1, a2 = r[..., 0], r[..., 1]
    b1 = normalize(a1)
    b2 = normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rodrigues(aa):
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta = torch.sqrt(torch.clamp((aa * aa).sum(-1, keepdim=True),
                                   min=1e-24))
    k = aa / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([torch.stack([zero, -kz, ky], -1),
                     torch.stack([kz, zero, -kx], -1),
                     torch.stack([-ky, kx, zero], -1)], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)


def quaternion_to_matrix(q):
    """(..., 4) quaternions (w, x, y, z), normalized here -> (..., 3, 3)."""
    w, x, y, z = normalize(q).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(verts, K):
    """(N, V, 3) camera-space points, (N, 3, 3) K -> (N, V, 2) image
    coordinates (the units of K) and depth z (N, V)."""
    proj = verts @ K.transpose(-1, -2)
    return proj[..., :2] / torch.clamp(proj[..., 2:3], min=1e-9), \
        verts[..., 2]


def crop_intrinsics(K_px, boxes, size: int):
    """Pixel intrinsics (N, 3, 3) of the square crops `boxes` (N, 4) xyxy
    resized to size^2, normalized to the crop (divided by size)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    sx = size / torch.clamp(x2 - x1, min=1e-9)
    sy = size / torch.clamp(y2 - y1, min=1e-9)
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    K = torch.stack([
        torch.stack([K_px[..., 0, 0] * sx / size, K_px[..., 0, 1] * sx / size,
                     (K_px[..., 0, 2] - x1) * sx / size], -1),
        torch.stack([zeros, K_px[..., 1, 1] * sy / size,
                     (K_px[..., 1, 2] - y1) * sy / size], -1),
        torch.stack([zeros, zeros, ones], -1)], -2)
    return K
