"""Each loss term of the joint fit, for a batch of clips.

State leaves carry (C, B, ...) for C clips of B frames (one hand a frame);
the scales (C, 1). Every term is a (C,) vector, one value per clip, so the
sum over clips gives each clip its own gradient. The terms and their
meaning follow HOMan's step-1 and step-2 recipes:

- pca: mean squared PCA pose coefficient;
- smooth_obj, smooth_hand: mean squared frame-to-frame vertex motion;
- v2d_hand: mean squared 2D distance of the 778 projected hand vertices
  to their targets, in units of the image size;
- sil_obj: occlusion-aware squared silhouette error in the object's ROI,
  over the kept pixels, divided by the frame count;
- inter: squared distance between the hand's and the object's centroids,
  summed over the frames whose projected boxes overlap and whose depth
  ranges lie within 3 units; neither the hand's articulation nor the
  object moves by it;
- scale_obj, scale_hand: squared deviation of the intrinsic scales from 1;
- collision: each mesh's interior SDF grid sampled at the other mesh's
  vertices, in units of the grid's box, summed (the object held still);
- contact: mean over the hand vertices of 0.02 tanh(d / 0.02), d the
  distance to the nearest object vertex, on the vertices the object's
  sampled SDF does not call exterior (sdf < 0: none, as the grids are
  clamped at 0, so every vertex; HOMan's own behaviour).
"""
from __future__ import annotations

import torch

from portbench.reference import mano as mano_ref
from portbench.reference import silhouette, voxel
from portbench.reference.geometry import project, rot6d_to_matrix

ORDER = ("pca", "smooth_obj", "smooth_hand", "collision", "contact",
         "v2d_hand", "sil_obj", "inter", "scale_obj", "scale_hand")


def posed(state, consts):
    """Object vertices (C, B, Vo, 3); hand vertices (C, B, 778, 3), the
    same with the articulation held (det) and with the scale held
    (detscale)."""
    C, B = state["t_obj"].shape[:2]
    R_o = rot6d_to_matrix(state["r_obj"])
    v_obj = (torch.abs(state["s_obj"])[:, :, None, None]
             * consts["verts_obj"][:, None]) @ R_o + state["t_obj"]
    p = consts["mano"]
    aa = mano_ref.pca_to_axis_angle(p, state["pca"].reshape(C * B, -1))
    vm = mano_ref.forward(p, state["betas"].reshape(C * B, -1),
                          state["mano_rot"].reshape(C * B, 3), aa)
    vm = vm.reshape(C, B, -1, 3) + state["mano_trans"][:, :, None]
    R_h = rot6d_to_matrix(state["r_hand"])
    s_h = state["s_hand"][:, :, None, None]
    hand = (s_h * vm) @ R_h + state["t_hand"]
    det = (s_h * vm).detach() @ R_h + state["t_hand"]
    detscale = (s_h.detach() * vm) @ R_h + state["t_hand"]
    return v_obj, hand, det, detscale


def _bbox(verts, K, expansion):
    uv = project(verts, K)[0]
    lo, hi = uv.amin(-2), uv.amax(-2)
    c, e = (lo + hi) / 2, (hi - lo) / 2 * (1 + expansion)
    return torch.cat([c - e, c + e], -1)


def _iou(b1, b2):
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    wh = torch.clamp(torch.minimum(b1[..., 2:], b2[..., 2:])
                     - torch.maximum(b1[..., :2], b2[..., :2]), min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(a1 + a2 - inter, min=1e-9)


def interaction(hand_det, obj, K, z_thresh=3.0, expansion=0.2):
    with torch.no_grad():
        iou = _iou(_bbox(obj, K, expansion), _bbox(hand_det, K, expansion))
        a, b = hand_det[..., 2].amin(-1), hand_det[..., 2].amax(-1)
        c, d = obj[..., 2].amin(-1), obj[..., 2].amax(-1)
        gap = torch.where((d >= a) & (b >= c), torch.zeros_like(a),
                          torch.minimum((c - b).abs(), (a - d).abs()))
        on = (iou > 0) & (gap < z_thresh)
    err = ((hand_det.mean(-2) - obj.mean(-2)) ** 2).mean(-1)
    return (err * on).sum(-1)


def _nearest_distance(hand, obj, block: int = 1 << 26):
    """Distance from each hand vertex to its nearest object vertex (by
    direct differences), with gradient to both: (N, Vh)."""
    N, Vh, Vo = hand.shape[0], hand.shape[1], obj.shape[1]
    step = max(1, block // (Vh * Vo * 3))
    idx = []
    with torch.no_grad():
        for n0 in range(0, N, step):
            d2 = ((hand[n0:n0 + step, :, None] - obj[n0:n0 + step, None])
                  ** 2).sum(-1)
            idx.append(d2.argmin(-1))
    idx = torch.cat(idx)
    near = torch.gather(obj, 1, idx[..., None].expand(-1, -1, 3))
    return torch.sqrt(torch.clamp(((near - hand) ** 2).sum(-1), min=1e-18))


def terms(state, consts, rc, lw):
    """The weighted recipe's terms, each (C,), and the total (C,).

    rc: the recipe (rend_size, image_size, sigma, bin_margin_px, sdf_grid);
    lw: the loss weights, "lw_<term>"."""
    C, B = state["t_obj"].shape[:2]
    v_obj, hand, det, detscale = posed(state, consts)
    out = {}
    if lw["lw_pca"] > 0:
        out["pca"] = (state["pca"] ** 2).mean((1, 2))
    if lw["lw_smooth_obj"] > 0 or lw["lw_smooth_hand"] > 0:
        out["smooth_obj"] = ((v_obj[:, 1:] - v_obj[:, :-1]) ** 2).mean(
            (1, 2, 3))
        out["smooth_hand"] = ((hand[:, 1:] - hand[:, :-1]) ** 2).mean(
            (1, 2, 3))
    if lw["lw_collision"] > 0 or lw["lw_contact"] > 0:
        out.update(_sdf_terms(detscale, v_obj, consts, rc, lw))
    if lw["lw_v2d_hand"] > 0:
        pred = project(hand, consts["K"])[0]
        tar = consts["ref2d"] / rc["image_size"]
        out["v2d_hand"] = ((pred - tar) ** 2).sum(-1).mean((1, 2))
    if lw["lw_sil_obj"] > 0:
        S = rc["rend_size"]
        sil = silhouette.soft_silhouette(
            v_obj.reshape(C * B, -1, 3), consts["K_roi"].reshape(C * B, 3, 3),
            frame_topology(consts["obj_topo"], B), S, rc["sigma"],
            (rc["bin_margin_px"] / S) ** 2).reshape(C, B, S, S)
        keep = consts["keep"]
        out["sil_obj"] = (((keep * sil - consts["ref_mask"]) ** 2).sum(
            (1, 2, 3)) / keep.sum((1, 2, 3)) / B)
    if lw["lw_inter"] > 0:
        out["inter"] = interaction(det, v_obj.detach(), consts["K"])
    if lw["lw_scale_obj"] > 0:
        out["scale_obj"] = ((state["s_obj"] - 1.0) ** 2).sum(-1)
    if lw["lw_scale_hand"] > 0:
        out["scale_hand"] = ((state["s_hand"] - 1.0) ** 2).sum(-1)
    total = sum(lw["lw_" + k] * out[k] for k in ORDER if k in out)
    return out, total


def frame_topology(topo, B: int):
    """Per-clip topology arrays (C, ...) -> per-frame (C B, ...) views."""
    return {k: v[:, None].expand((v.shape[0], B) + tuple(v.shape[1:]))
            .reshape((-1,) + tuple(v.shape[1:])) for k, v in topo.items()}


def _sdf_terms(detscale, v_obj, consts, rc, lw):
    C, B = v_obj.shape[:2]
    G = rc["sdf_grid"]
    hand = detscale.reshape(C * B, -1, 3)
    obj = v_obj.reshape(C * B, -1, 3)
    obj_det = obj.detach()
    out = {}
    c_o, s_o = voxel.unit_box(obj_det)
    at_hand = (hand - c_o) / s_o
    phi_o = voxel.voxelize((obj_det - c_o) / s_o, frame_topology(
        {"f": consts["obj_topo"]["faces"]}, B)["f"], G, at=at_hand)[0]
    obj_at_hand = voxel.sample(phi_o, at_hand)  # box units
    if lw["lw_collision"] > 0:
        c_h, s_h = voxel.unit_box(hand)
        at_obj = (obj_det - c_h) / s_h
        phi_h = voxel.voxelize(((hand - c_h) / s_h).detach(),
                               consts["hand_faces"], G, at=at_obj)[0]
        hand_at_obj = voxel.sample(phi_h, at_obj)
        out["collision"] = (hand_at_obj.sum(-1)
                            + obj_at_hand.sum(-1)).reshape(C, B).sum(1)
    if lw["lw_contact"] > 0:
        exterior = obj_at_hand * s_o[..., 0] < 0.0
        near = 0.02 * torch.tanh(_nearest_distance(hand, obj) / 0.02)
        keep = (~exterior).to(near.dtype).reshape(C, -1)
        out["contact"] = torch.where(
            keep.sum(1) > 0, (near.reshape(C, -1) * keep).sum(1)
            / torch.clamp(keep.sum(1), min=1.0), torch.zeros((),
                                                              device=hand.device))
    return out
