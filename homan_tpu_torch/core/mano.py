"""MANO parametric hand model in PyTorch (counterpart of homan_tpu/core/mano.py).

Shape blendshapes, pose correctives, linear blend skinning over 16 joints and
the PCA pose parameterization. `mano_forward` is written batched (the JAX
version is single-sample under vmap). `synthetic_mano_params` is seeded by
numpy and builds the same hand as the JAX package bit for bit.
`load_mano_params` reads the license-gated MANO_{RIGHT,LEFT}.pkl files in
their original format without chumpy.

Parameters are a dict of tensors on one device.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core.geometry import rodrigues

NUM_VERTS = 778
NUM_JOINTS = 16  # wrist + 15 articulated
NUM_POSE_DIMS = 45  # 15 joints x 3 axis-angle
# Fingertip vertices: thumb, index, middle, ring, pinky.
TIP_VERTEX_IDS = (745, 317, 444, 556, 673)
# (16 MANO joints + 5 tips appended) -> standard 21-joint order.
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19,
                 7, 8, 9, 20)
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)


def _synthetic_arrays(seed: int) -> Dict[str, np.ndarray]:
    """The numpy construction of homan_tpu/core/mano.py:145-210, verbatim."""
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
    for c in range(cols):  # pole caps
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
    parents = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14])
    comps = rng.randn(45, 45)
    comps, _ = np.linalg.qr(comps)
    hands_mean = 0.1 * rng.randn(45)
    return {
        "v_template": v_template, "shapedirs": shapedirs,
        "posedirs": posedirs, "J_regressor": J_regressor,
        "weights": weights, "parents": parents,
        "hands_components": comps, "hands_mean": hands_mean, "faces": faces,
    }


class _ChumpyStub:
    """Stand-in for chumpy.Ch so MANO pickles load without chumpy."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _ManoUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_array(value) -> np.ndarray:
    if isinstance(value, np.ndarray):
        return np.asarray(value)
    if isinstance(value, _ChumpyStub):
        for attr in ("x", "a", "v"):
            if attr in value.__dict__:
                return _to_array(value.__dict__[attr])
        raise ValueError("Unrecognized chumpy payload in MANO pickle")
    if hasattr(value, "toarray"):  # scipy sparse J_regressor
        return np.asarray(value.toarray())
    return np.asarray(value)


def load_mano_params(path: str, device=None) -> Dict[str, Any]:
    """A MANO_{RIGHT,LEFT}.pkl (homan_tpu/core/mano.py:77) as float32 and
    int64 tensors on `device` (default `cuda`; raises when CUDA is absent):
    v_template (778, 3), shapedirs (778, 3, 10), posedirs (778, 3, 135),
    J_regressor (16, 778), weights (778, 16), parents (16,), the first -1,
    hands_components (45, 45), hands_mean (45,), faces (F, 3)."""
    with open(path, "rb") as f:
        raw = _ManoUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    kintree = _to_array(raw["kintree_table"]).astype(np.int64)
    parents = kintree[0].copy()
    parents[0] = -1
    shapedirs = _to_array(raw["shapedirs"]).astype(np.float64)
    return params_to_tensors({
        "v_template": _to_array(raw["v_template"]),
        "shapedirs": shapedirs[..., :10],
        "posedirs": _to_array(raw["posedirs"]),
        "J_regressor": _to_array(raw["J_regressor"]),
        "weights": _to_array(raw["weights"]),
        "parents": parents,
        "hands_components": _to_array(raw["hands_components"]),
        "hands_mean": _to_array(raw["hands_mean"]),
        "faces": _to_array(raw["f"]).astype(np.int64),
    }, resolve_device(device))


def params_to_tensors(arrays: Dict[str, Any], device) -> Dict[str, Any]:
    """numpy MANO arrays -> float32 / int64 tensors on `device`."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if k in ("parents", "faces"):
            out[k] = torch.from_numpy(a.astype(np.int64)).to(device)
        else:
            out[k] = torch.from_numpy(a.astype(np.float32)).to(device)
    return out


def synthetic_mano_params(seed: int = 0, device=None) -> Dict[str, Any]:
    """Structurally faithful random MANO-like model for tests and benchmarks."""
    return params_to_tensors(_synthetic_arrays(seed), resolve_device(device))


def mirror_mano_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Right-hand params -> left-hand params (mirror across x = 0); see the
    derivation at homan_tpu/core/mano.py:105-142."""
    dev = params["v_template"].device
    dt = params["v_template"].dtype
    flip_x = torch.tensor([-1.0, 1.0, 1.0], dtype=dt, device=dev)
    aa_signs = torch.tensor([1.0, -1.0, -1.0], dtype=dt,
                            device=dev).repeat(NUM_POSE_DIMS // 3)
    i_idx = np.arange(9) // 3
    j_idx = np.arange(9) % 3
    feat9 = (np.where(i_idx == 0, -1.0, 1.0)
             * np.where(j_idx == 0, -1.0, 1.0))
    feat_signs = torch.tensor(np.tile(feat9, NUM_POSE_DIMS // 3), dtype=dt,
                              device=dev)
    return {
        "v_template": params["v_template"] * flip_x,
        "shapedirs": params["shapedirs"] * flip_x[None, :, None],
        "posedirs": (params["posedirs"] * flip_x[None, :, None]
                     * feat_signs[None, None, :]),
        "J_regressor": params["J_regressor"],
        "weights": params["weights"],
        "parents": params["parents"],
        "hands_components": params["hands_components"] * aa_signs[None, :],
        "hands_mean": params["hands_mean"] * aa_signs,
        "faces": params["faces"].flip(-1),
    }


def _rigid_transforms(rot_mats: torch.Tensor, joints: torch.Tensor,
                      parents=MANO_PARENTS):
    """Batched forward-kinematic chain.

    rot_mats (B, J, 3, 3) column convention; joints (B, J, 3) rest pose.
    Returns rel_T (B, J, 4, 4) (rest-joint contribution removed) and posed
    joints (B, J, 3).
    """
    B, J = joints.shape[:2]
    parents_np = np.asarray(parents)
    par = torch.as_tensor(np.maximum(parents_np, 0), device=joints.device)
    has_parent = torch.as_tensor(parents_np >= 0, device=joints.device)
    rel = joints - torch.where(has_parent[None, :, None], joints[:, par],
                               torch.zeros((), dtype=joints.dtype,
                                           device=joints.device))
    # Built out of place, so the chain also runs under torch.func.vmap.
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=joints.dtype,
                          device=joints.device).expand(B, J, 1, 4)
    local_T = torch.cat([torch.cat([rot_mats, rel[..., None]], dim=-1),
                         bottom], dim=-2)
    world = [local_T[:, 0]]
    for j in range(1, J):
        world.append(world[parents_np[j]] @ local_T[:, j])
    world_T = torch.stack(world, dim=1)  # (B, J, 4, 4)
    posed_joints = world_T[:, :, :3, 3]
    correction = torch.einsum("bjac,bjc->bja", world_T[:, :, :3, :3], joints)
    rel_T = torch.cat([
        torch.cat([world_T[:, :, :3, :3],
                   (world_T[:, :, :3, 3] - correction)[..., None]], dim=-1),
        world_T[:, :, 3:, :]], dim=-2)
    return rel_T, posed_joints


def mano_forward(params: Dict[str, Any], betas: torch.Tensor,
                 global_orient: torch.Tensor, hand_pose: torch.Tensor,
                 transl: torch.Tensor | None = None):
    """Batched MANO forward.

    betas (B, 10), global_orient (B, 3), hand_pose (B, 45) axis-angle.
    Returns dict verts (B, 778, 3), joints (B, 16, 3).
    """
    B = global_orient.shape[0]
    dtype = params["v_template"].dtype
    full_pose = torch.cat([global_orient, hand_pose], dim=-1).reshape(
        B, NUM_JOINTS, 3)
    v_shaped = params["v_template"] + torch.einsum(
        "vck,bk->bvc", params["shapedirs"], betas.to(dtype))
    joints_rest = torch.einsum("jv,bvc->bjc", params["J_regressor"],
                               v_shaped)
    rot_mats = rodrigues(full_pose)  # (B, 16, 3, 3)
    eye = torch.eye(3, dtype=dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)  # (B, 135)
    v_posed = v_shaped + torch.einsum("vcf,bf->bvc", params["posedirs"],
                                      pose_feature)
    rel_T, posed_joints = _rigid_transforms(rot_mats, joints_rest)
    T = torch.einsum("vj,bjac->bvac", params["weights"], rel_T)
    verts = (torch.einsum("bvac,bvc->bva", T[:, :, :3, :3], v_posed)
             + T[:, :, :3, 3])
    if transl is not None:
        verts = verts + transl[:, None]
        posed_joints = posed_joints + transl[:, None]
    return {"verts": verts, "joints": posed_joints}


def pca_to_axis_angle(params: Dict[str, Any], pca_pose: torch.Tensor,
                      is_left: bool = False,
                      flat_hand_mean: bool = False) -> torch.Tensor:
    """PCA coefficients -> 45-dim axis-angle pose (left hand: y/z flipped
    before the mean is added)."""
    ncomps = pca_pose.shape[-1]
    aa = pca_pose @ params["hands_components"][:ncomps]
    if is_left:
        sign = torch.tensor([1.0, -1.0, -1.0], dtype=aa.dtype,
                            device=aa.device).repeat(NUM_POSE_DIMS // 3)
        aa = aa * sign
    if not flat_hand_mean:
        aa = aa + params["hands_mean"]
    return aa


def axis_angle_to_pca(params: Dict[str, Any], aa_pose: torch.Tensor,
                      ncomps: int = 45, is_left: bool = False,
                      flat_hand_mean: bool = False) -> torch.Tensor:
    """Inverse of pca_to_axis_angle (homan/datasets/manoutils.py:41-58):
    through the model's orthogonal (45, 45) PCA basis."""
    if not flat_hand_mean:
        aa_pose = aa_pose - params["hands_mean"]
    if is_left:
        sign = torch.tensor([1.0, -1.0, -1.0], dtype=aa_pose.dtype,
                            device=aa_pose.device).repeat(NUM_POSE_DIMS // 3)
        aa_pose = aa_pose * sign
    return (aa_pose @ params["hands_components"].T)[..., :ncomps]


def add_tips_and_reorder(verts: torch.Tensor,
                         joints: torch.Tensor) -> torch.Tensor:
    """16 MANO joints + 5 fingertip vertices -> 21-joint skeleton."""
    tips = verts[..., list(TIP_VERTEX_IDS), :]
    full = torch.cat([joints, tips], dim=-2)
    return full[..., list(JOINT_REORDER), :]


class ManoLayer:
    """Left + right parameter dicts with a batched PCA entry point."""

    def __init__(self, right_params: Dict[str, Any],
                 left_params: Dict[str, Any] | None = None,
                 pca_comps: int = 16):
        self.pca_comps = pca_comps
        self.params = {
            "right": right_params,
            "left": (left_params if left_params is not None
                     else mirror_mano_params(right_params)),
        }

    @classmethod
    def from_folder(cls, mano_root: str, pca_comps: int = 16,
                    device=None) -> "ManoLayer":
        """MANO_RIGHT.pkl of `mano_root`, and MANO_LEFT.pkl where present
        (else the mirrored right hand)."""
        device = resolve_device(device)
        right = load_mano_params(os.path.join(mano_root, "MANO_RIGHT.pkl"),
                                 device)
        left_path = os.path.join(mano_root, "MANO_LEFT.pkl")
        left = (load_mano_params(left_path, device)
                if os.path.exists(left_path) else None)
        return cls(right, left, pca_comps)

    @classmethod
    def synthetic(cls, seed: int = 0, pca_comps: int = 16,
                  device=None) -> "ManoLayer":
        return cls(synthetic_mano_params(seed, device=device),
                   pca_comps=pca_comps)

    def faces(self, side: str) -> torch.Tensor:
        return self.params[side]["faces"]

    def forward_pca(self, pca_pose, rot, betas, side: str = "right",
                    flat_hand_mean: bool = False):
        """pca_pose (B, <=45), rot (B, 3), betas (B, 10) -> verts, joints,
        hand_aa_pose."""
        p = self.params[side]
        aa = pca_to_axis_angle(p, pca_pose[..., : self.pca_comps],
                               is_left=(side == "left"),
                               flat_hand_mean=flat_hand_mean)
        out = mano_forward(p, betas, rot, aa)
        out["hand_aa_pose"] = aa
        return out
