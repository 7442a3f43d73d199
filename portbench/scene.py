"""The clips a cell fits, made on the device from the seed.

Each clip is a synthetic hand-object scene of `frames` frames seen by a
HO-3D camera (640 x 480): an object turning slowly and drifting, a
MANO-shaped hand beside it whose pose waves, both on smooth random
trajectories. Its evidence is what a detector would give: the object's
occlusion-aware mask in a square ROI around the object, rendered at
rend_size, and the 2D positions of the hand's vertices. The fit starts from
the ground truth perturbed (translations and 6D rotations by 0.04, the PCA
pose by 0.2).

Every random number comes from one torch.Generator on the device, seeded
with the run's seed, drawn for all clips at once. The object meshes and the
hand model are fixed by the configuration, as a dataset's meshes and the
MANO model are. The inputs are returned in the reference's layout
(reference/losses.py); recipes/joint_fit.py hands the same tensors to
the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import mano as mano_ref
from portbench.reference import meshes, silhouette
from portbench.reference.geometry import (crop_intrinsics, project,
                                          quaternion_to_matrix, rodrigues)


def object_meshes(objects):
    """The traffic's objects padded to one vertex and face count: verts
    (n, V, 3) float32, faces (n, F, 3), topology arrays (n, E, ...)."""
    raw = [meshes.bumpy_potato(o["subdivisions"], o["radius"], o["seed"])
           for o in objects]
    nv = max(len(v) for v, _ in raw)
    nf = max(len(f) for _, f in raw)
    padded = [meshes.pad_mesh(v, f, nv, nf) for v, f in raw]
    topos = [meshes.edge_topology(f) for _, f in padded]
    ne = max(len(t["edges"]) for t in topos)
    topos = [meshes.pad_topology(t, ne) for t in topos]
    return {"verts": np.stack([v for v, _ in padded]),
            "faces": np.stack([f for _, f in padded]),
            "topo": {k: np.stack([t[k] for t in topos]) for k in topos[0]}}


def _smooth(g, C, B, amp, device):
    """Per-clip offsets (C, B, 3) that vary smoothly over the frames."""
    freq = 0.5 + torch.rand((C, 1, 3), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((C, 1, 3), generator=g, device=device)
    t = torch.linspace(0, 1, B, device=device)[None, :, None]
    return amp * torch.sin(2 * math.pi * freq * t + phase)


def _square_boxes(uv_px, expand):
    """Square xyxy boxes (N, 4) around points uv_px (N, V, 2), side the
    larger extent times 1 + expand."""
    lo, hi = uv_px.amin(1), uv_px.amax(1)
    c = (lo + hi) / 2
    half = (hi - lo).amax(-1, keepdim=True) * (1 + expand) / 2
    return torch.cat([c - half, c + half], -1)


def make_clips(cfg: dict, traffic: dict, seed: int, device):
    """(state, consts, info): the clips' initial leaves and fixed inputs in
    the reference's layout, and what else the program is handed."""
    dev = torch.device(device)
    C, B = int(traffic["clips"]), int(cfg["frames"])
    sc, cam = cfg["scene"], cfg["camera"]
    S, W = int(cfg["rend_size"]), int(cfg["image_size"])
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    hand_np = mano_ref.synthetic_arrays(int(cfg["hand"]["seed"]))
    mano = mano_ref.to_tensors({k: v for k, v in hand_np.items()
                                if k != "faces"}, dev)
    hand_faces = torch.as_tensor(hand_np["faces"], device=dev)
    hand_topo = {k: torch.as_tensor(v, device=dev) for k, v in
                 meshes.edge_topology(hand_np["faces"]).items()}
    objs = object_meshes(traffic["objects"])
    which = torch.arange(C) % len(traffic["objects"])
    verts_obj = torch.as_tensor(objs["verts"], device=dev)[which.to(dev)]
    obj_topo = {"faces": torch.as_tensor(objs["faces"], device=dev)}
    obj_topo.update({k: torch.as_tensor(v, device=dev)
                     for k, v in objs["topo"].items()})
    obj_topo = {k: v[which.to(dev)] for k, v in obj_topo.items()}

    # Ground truth.
    rot0 = quaternion_to_matrix(randn(C, 4))
    depth = float(sc["depth"])
    t_obj = (torch.tensor([0.0, 0.0, depth], device=dev)
             + _smooth(g, C, B, float(sc["object_drift"]), dev))
    turn = rodrigues(float(sc["object_turn"]) * torch.arange(
        B, device=dev, dtype=torch.float32)[:, None]
        * torch.tensor([0.0, 1.0, 0.0], device=dev))  # (B, 3, 3)
    R_obj = turn[None] @ rot0[:, None]
    off = float(sc["hand_offset"])
    t_hand = (torch.tensor([off, 0.0, depth], device=dev)
              + _smooth(g, C, B, float(sc["hand_drift"]), dev))
    P = int(cfg["hand"]["pca_comps"])
    pca = float(sc["pose_wave"]) * torch.sin(
        torch.arange(P, device=dev, dtype=torch.float32)[None]
        + 0.3 * torch.arange(B, device=dev, dtype=torch.float32)[:, None])
    eye6 = torch.eye(3, device=dev)[:, :2]
    gt = {"t_obj": t_obj[:, :, None], "r_obj": R_obj[..., :2],
          "t_hand": t_hand[:, :, None],
          "r_hand": eye6.expand(C, B, 3, 2).clone(),
          "pca": pca.expand(C, B, P).clone(),
          "betas": torch.zeros((C, B, 10), device=dev),
          "mano_rot": torch.zeros((C, B, 3), device=dev),
          "mano_trans": torch.tensor([float(sc["mano_offset"]), 0.0, 0.0],
                                     device=dev).expand(C, B, 3).clone(),
          "s_obj": torch.ones((C, 1), device=dev),
          "s_hand": torch.ones((C, 1), device=dev)}

    K_px = torch.tensor(cam["K"], dtype=torch.float32, device=dev)
    K = K_px.clone()
    K[:2] = K[:2] / W
    K = K.expand(C, B, 3, 3)
    consts = {"verts_obj": verts_obj, "obj_topo": obj_topo, "mano": mano,
              "hand_faces": hand_faces, "K": K}
    from portbench.reference.losses import frame_topology, posed
    with torch.no_grad():
        v_obj, v_hand, _, _ = posed(gt, consts)
        N = C * B
        vo, vh = v_obj.reshape(N, -1, 3), v_hand.reshape(N, -1, 3)
        K_n = K.reshape(N, 3, 3)
        expand = float(cam["roi_expand"])
        K_roi = crop_intrinsics(
            K_px, _square_boxes(project(vo, K_n)[0] * W, expand), S)
        K_roi_hand = crop_intrinsics(
            K_px, _square_boxes(project(vh, K_n)[0] * W, expand), S)
        obj_cov = silhouette.coverage(vo, K_roi,
                                      frame_topology(obj_topo, B), S)
        hand_cov = silhouette.coverage(
            vh, K_roi, {k: v[None].expand((N,) + tuple(v.shape))
                        for k, v in dict(hand_topo, faces=hand_faces)
                        .items()}, S)
        target = torch.where(hand_cov & ~obj_cov, -1.0, obj_cov.float())
        consts.update({
            "ref_mask": (target > 0).float().reshape(C, B, S, S),
            "keep": (target >= 0).float().reshape(C, B, S, S),
            "K_roi": K_roi.reshape(C, B, 3, 3),
            "K_roi_hand": K_roi_hand.reshape(C, B, 3, 3),
            "ref2d": (project(vh, K_n)[0] * W).reshape(C, B, -1, 2),
            "gt_verts_hand": v_hand})

    # The perturbed start.
    jit = float(sc["perturb"])
    state = dict(gt)
    for k, s in (("t_obj", jit), ("r_obj", jit), ("t_hand", jit),
                 ("r_hand", jit), ("pca", 5 * jit)):
        state[k] = gt[k] + s * randn(*gt[k].shape)
    return state, consts, {"hand_topo": hand_topo}
