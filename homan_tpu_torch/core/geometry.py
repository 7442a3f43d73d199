"""Rotation representations and sampling (counterpart of
homan_tpu/core/geometry.py:18-75 and :100-160).

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


def euler_angles_to_matrix(angles: torch.Tensor,
                           convention: str) -> torch.Tensor:
    """Euler angles (..., len(convention)) -> rotation matrices, intrinsic
    (homan_tpu/core/geometry.py:100)."""

    def axis_rot(axis: str, a: torch.Tensor) -> torch.Tensor:
        c, s = torch.cos(a), torch.sin(a)
        one, zero = torch.ones_like(a), torch.zeros_like(a)
        if axis == "X":
            rows = [(one, zero, zero), (zero, c, -s), (zero, s, c)]
        elif axis == "Y":
            rows = [(c, zero, s), (zero, one, zero), (-s, zero, c)]
        elif axis == "Z":
            rows = [(c, -s, zero), (s, c, zero), (zero, zero, one)]
        else:
            raise ValueError(f"bad axis {axis}")
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    R = axis_rot(convention[0], angles[..., 0])
    for i, axis in enumerate(convention[1:], start=1):
        R = R @ axis_rot(axis, angles[..., i])
    return R


def arvo_rotations(x: torch.Tensor) -> torch.Tensor:
    """Arvo's uniform SO(3) construction (homan_tpu/core/geometry.py:137-160)
    from (3, n) uniforms in [0, 1): a rotation about z composed with a
    Householder reflection, negated. Returns (n, 3, 3)."""
    x1, x2, x3 = x[0], x[1], x[2]
    tau = 2 * torch.pi
    c1, s1 = torch.cos(tau * x1), torch.sin(tau * x1)
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    R = torch.stack([torch.stack([c1, s1, zero], dim=1),
                     torch.stack([-s1, c1, zero], dim=1),
                     torch.stack([zero, zero, one], dim=1)], dim=1)
    v = torch.stack([torch.cos(tau * x2) * torch.sqrt(x3),
                     torch.sin(tau * x2) * torch.sqrt(x3),
                     torch.sqrt(1.0 - x3)], dim=1)
    H = (torch.eye(3, dtype=x.dtype, device=x.device)[None]
         - 2.0 * v[:, :, None] * v[:, None, :])
    return -(H @ R)


def random_rotations(n: int, generator: torch.Generator | None = None,
                     upright: bool = False, device=None) -> torch.Tensor:
    """n rotation matrices (n, 3, 3), uniform over SO(3) by default
    (homan_tpu/core/geometry.py:122).

    The uniforms are drawn on the CPU from `generator` (a CPU generator;
    torch's default one when None), so a seed gives the same rotations on
    every device; the result is placed on `device`. upright: yaw in
    [0, 2 pi), pitch in [-pi/6, pi/6), roll in [-pi/12, pi/12), "YXZ".
    """
    u = torch.rand((3, n), generator=generator, dtype=torch.float32)
    if upright:
        lo = torch.tensor([0.0, -torch.pi / 6, -torch.pi / 12])
        hi = torch.tensor([2 * torch.pi, torch.pi / 6, torch.pi / 12])
        angles = (lo[:, None] + u * (hi - lo)[:, None]).T
        R = euler_angles_to_matrix(angles, "YXZ")
    else:
        R = arvo_rotations(u)
    return R.to(device) if device is not None else R


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3), column
    convention (homan_tpu/core/geometry.py:78)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)[..., None]
    t = theta[..., None]
    scale = torch.where(sin_theta > 1e-6,
                        t / torch.clamp(2.0 * sin_theta, min=1e-12),
                        0.5 + t ** 2 / 12.0)  # small-angle series
    return w * scale


def center_vertices(vertices: torch.Tensor, faces: torch.Tensor,
                    flip_y: bool = True):
    """Centroid-align (V, 3) vertices; optionally flip y (image coords) and
    rewind the (F, 3) faces."""
    vertices = vertices - vertices.mean(dim=0, keepdim=True)
    if flip_y:
        vertices = vertices * torch.tensor([1.0, -1.0, 1.0],
                                           dtype=vertices.dtype,
                                           device=vertices.device)
        faces = faces.flip(-1)
    return vertices, faces


def compute_dist_z(verts1: torch.Tensor, verts2: torch.Tensor):
    """Gap between the z-extents of two (V, 3) vertex sets; 0 where they
    overlap."""
    a, b = verts1[:, 2].min(), verts1[:, 2].max()
    c, d = verts2[:, 2].min(), verts2[:, 2].max()
    overlap = (d >= a) & (b >= c)
    gap = torch.minimum((c - b).abs(), (a - d).abs())
    return torch.where(overlap, torch.zeros_like(gap), gap)


def combine_verts(verts_list) -> torch.Tensor:
    """Concatenate (B, V_i, 3) vertex sets along the vertex axis."""
    b = verts_list[0].shape[0]
    return torch.cat([v.reshape(b, -1, 3) for v in verts_list], dim=1)
