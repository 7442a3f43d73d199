"""A MANO-shaped hand: the synthetic layer at MANO's published sizes (778
vertices, 16 joints, 45 pose dimensions, 10 shape coefficients; 1,552
faces), built from a numpy seed, and the MANO forward (shape blend shapes,
pose correctives, linear blend skinning, PCA pose)."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.geometry import rodrigues

NUM_VERTS = 778
NUM_JOINTS = 16
PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)


def synthetic_arrays(seed: int) -> dict:
    """The synthetic hand model of homan_tpu's tests and benches, from a
    numpy seed: a bumpy ellipsoid of 778 vertices with random blend
    shapes, a Gaussian joint regressor and skinning weights, and an
    orthonormal PCA pose basis."""
    rng = np.random.RandomState(seed)
    rings, cols = 8, 97
    theta = np.pi * (np.arange(1, rings + 1)) / (rings + 1)
    phi = 2 * np.pi * np.arange(cols) / cols
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    ring_pts = np.stack([np.sin(tt) * np.cos(pp),
                         0.4 * np.sin(tt) * np.sin(pp),
                         np.cos(tt)], axis=-1).reshape(-1, 3)
    v_template = np.concatenate(
        [np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]), ring_pts])
    w = rng.randn(3, 3)
    bump = 1.0 + 0.15 * np.sin(v_template @ w[0]) \
        + 0.1 * np.cos(2.0 * v_template @ w[1])
    v_template = v_template * bump[:, None] * np.array([0.04, 0.04, 0.09])

    def vid(r, c):
        return 2 + r * cols + (c % cols)

    tris = []
    for c in range(cols):
        tris.append((0, vid(0, c), vid(0, c + 1)))
        tris.append((1, vid(rings - 1, c + 1), vid(rings - 1, c)))
    for r in range(rings - 1):
        for c in range(cols):
            a, b = vid(r, c), vid(r, c + 1)
            d, e = vid(r + 1, c), vid(r + 1, c + 1)
            tris.append((a, d, b))
            tris.append((b, d, e))
    faces = np.asarray(tris, np.int64)
    shapedirs = 0.01 * rng.randn(NUM_VERTS, 3, 10)
    posedirs = 0.001 * rng.randn(NUM_VERTS, 3, 135)
    centers = rng.randn(NUM_JOINTS, 3) * 0.05
    d2 = ((v_template[None] - centers[:, None]) ** 2).sum(-1)
    J_regressor = np.exp(-d2 / 0.002)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    weights = np.exp(-d2.T / 0.004)
    weights /= weights.sum(axis=1, keepdims=True)
    comps, _ = np.linalg.qr(rng.randn(45, 45))
    hands_mean = 0.1 * rng.randn(45)
    return {"v_template": v_template, "shapedirs": shapedirs,
            "posedirs": posedirs, "J_regressor": J_regressor,
            "weights": weights, "hands_components": comps,
            "hands_mean": hands_mean, "faces": faces}


def to_tensors(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v),
                               dtype=torch.int64 if k == "faces"
                               else torch.float32, device=device)
            for k, v in arrays.items()}


def pca_to_axis_angle(params, pca):
    """PCA coefficients (N, P) -> right-hand axis-angle pose (N, 45)."""
    return pca @ params["hands_components"][:pca.shape[-1]] \
        + params["hands_mean"]


def forward(params, betas, global_orient, hand_pose):
    """betas (N, 10), global_orient (N, 3), hand_pose (N, 45) axis-angle
    -> vertices (N, 778, 3)."""
    N = global_orient.shape[0]
    pose = torch.cat([global_orient, hand_pose], -1).reshape(N, NUM_JOINTS,
                                                             3)
    v_shaped = params["v_template"] + torch.einsum(
        "vck,nk->nvc", params["shapedirs"], betas)
    joints = torch.einsum("jv,nvc->njc", params["J_regressor"], v_shaped)
    R = rodrigues(pose)  # (N, 16, 3, 3)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    v_posed = v_shaped + torch.einsum(
        "vcf,nf->nvc", params["posedirs"], (R[:, 1:] - eye).reshape(N, -1))
    # Forward kinematics along the tree, 4x4 transforms built out of place.
    rel = torch.stack([joints[:, 0]] + [joints[:, j] - joints[:, PARENTS[j]]
                                        for j in range(1, NUM_JOINTS)], 1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(N, NUM_JOINTS, 1, 4)
    local = torch.cat([torch.cat([R, rel[..., None]], -1), bottom], -2)
    world = [local[:, 0]]
    for j in range(1, NUM_JOINTS):
        world.append(world[PARENTS[j]] @ local[:, j])
    world = torch.stack(world, 1)  # (N, 16, 4, 4)
    rot = world[:, :, :3, :3]
    trans = world[:, :, :3, 3] - torch.einsum("njac,njc->nja", rot, joints)
    A = torch.cat([rot, trans[..., None]], -1)  # (N, 16, 3, 4)
    T = torch.einsum("vj,njac->nvac", params["weights"], A)
    return (torch.einsum("nvac,nvc->nva", T[..., :3], v_posed)
            + T[..., 3])
