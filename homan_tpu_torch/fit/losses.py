"""Loss library for the joint fit (counterpart of homan_tpu/fit/losses.py).

Each term reproduces a reference loss; a zero weight skips its branch, as
the JAX package prunes it at trace time. Every term of the JAX package is
ported, the triangle-triangle collision (`collision_mode="tritri"`,
interactions/intersect.py) included.

Ordinal depth: the reference's own call of this loss never ran
(homan/homan.py:507 passes no arguments); as in the JAX package it is wired
to the model renders as HOMan.compute_ordinal_depth_loss intends.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from homan_tpu_torch.core import camera as cam
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.interactions import contact as contact_lib
from homan_tpu_torch.interactions import intersect as intersect_lib
from homan_tpu_torch.interactions import sdf as sdf_lib
from homan_tpu_torch.render.rasterizer import (MeshTopology, RasterSettings,
                                               rasterize_depth,
                                               rasterize_soft)
from homan_tpu_torch.utils_profiling import span

DEFAULT_LW = {
    "lw_smooth_obj": 2000.0,
    "lw_smooth_hand": 2000.0,
    "lw_v2d_hand": 50.0,
    "lw_inter": 1.0,
    "lw_contact": 0.0,
    "lw_depth": 0.0,
    "lw_pca": 0.004,
    "lw_sil_obj": 1.0,
    "lw_sil_hand": 0.0,
    "lw_collision": 0.0,
    "lw_scale_obj": 0.001,
    "lw_scale_hand": 0.001,
}



def _faces_of(topo_or_faces):
    """Raw (F, 3) faces from either a MeshTopology or a face tensor."""
    if isinstance(topo_or_faces, MeshTopology):
        return topo_or_faces.faces
    return topo_or_faces


def batch_mask_iou(pred, ref, thresh: float = 0.5):
    """Per-sample IoU of (soft) masks, binarized at `thresh`."""
    p = pred > thresh
    r = ref > thresh
    inter = (p & r).sum(dim=(-2, -1)).to(torch.float32)
    union = (p | r).sum(dim=(-2, -1)).to(torch.float32)
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       torch.zeros((), device=pred.device))


def compute_smooth_loss(verts_hand, verts_obj, hand_nb: int):
    """Mean squared frame difference; a frame's hands are concatenated along
    the vertex axis first."""
    all_hand = torch.cat([verts_hand[i::hand_nb] for i in range(hand_nb)],
                         dim=1)
    smooth_hand = ((all_hand[1:] - all_hand[:-1]) ** 2).mean()
    smooth_obj = ((verts_obj[1:] - verts_obj[:-1]) ** 2).mean()
    return {"loss_smooth_obj": smooth_obj, "loss_smooth_hand": smooth_hand}


def compute_pca_loss(mano_pca_pose):
    return {"loss_pca": (mano_pca_pose ** 2).mean()}


def compute_intrinsic_scale_prior(scales, mean: float = 1.0):
    return ((scales - mean) ** 2).sum() / scales.shape[0]


def compute_v2d_loss_hand(verts_hand, camintr, ref_verts2d, image_size: int,
                          hand_nb: int):
    """2D reprojection of all 778 hand vertices."""
    K = torch.repeat_interleave(camintr, hand_nb, dim=0)
    pred = cam.batch_proj2d(verts_hand, K)
    tar = ref_verts2d / image_size
    loss = ((pred - tar) ** 2).sum(-1).mean()
    with torch.no_grad():
        dist_px = torch.linalg.vector_norm(pred * image_size - ref_verts2d,
                                           dim=-1).mean()
    return {"loss_v2d_hand": loss}, {"v2d_hand": dist_px}


def compute_sil_loss_object(verts_obj, faces_obj, camintr_rois, ref_mask,
                            keep_mask, settings: RasterSettings,
                            rendered=None):
    """Occlusion-aware silhouette L2 in the ROI.

    `edge_budget_excess` > 0 at any iteration means contour edges were
    dropped by the per-tile budget, which corrupts the winding region.
    rendered: rasterize_soft's output for these inputs, where the caller
    rendered them already (render_terms).
    """
    out = rendered
    if out is None:
        out = rasterize_soft(verts_obj, faces_obj, camintr_rois, settings)
    image = keep_mask * out["sil"]
    l_m = ((image - ref_mask) ** 2).sum() / keep_mask.sum()
    loss = l_m / verts_obj.shape[0]
    with torch.no_grad():
        metrics = {
            "iou_object": batch_mask_iou(image, ref_mask).mean(),
            "edge_budget_excess": (out["edge_demand"].max()
                                   - out["edge_capacity"]).to(torch.float32),
        }
    return {"loss_sil_obj": loss}, metrics


def compute_sil_loss_hand(verts_hand, faces_hand, camintr_rois, ref_mask,
                          keep_mask, settings: RasterSettings, rendered=None):
    """Per-hand silhouette L2, batched; `rendered` as for the object."""
    rend = (rendered if rendered is not None
            else rasterize_soft(verts_hand, faces_hand, camintr_rois,
                                settings)["sil"])
    image = keep_mask * rend
    per = (((image - ref_mask) ** 2).sum(dim=(1, 2))
           / keep_mask.sum(dim=(1, 2)))
    return {"loss_sil_hand": per.mean()}


def _project_bbox(verts, camintr, expansion: float = 0.2):
    """Projected 2D bbox with expansion, normalized coords."""
    uv = cam.batch_proj2d(verts, camintr)
    lo = uv.amin(dim=1)
    hi = uv.amax(dim=1)
    center = (lo + hi) / 2
    extent = (hi - lo) / 2 * (1 + expansion)
    return torch.cat([center - extent, center + extent], dim=1)


def _bbox_iou_pairwise(b1, b2):
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = torch.maximum(b1[:, :2], b2[:, :2])
    rb = torch.minimum(b1[:, 2:], b2[:, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[:, 0] * wh[:, 1]
    return inter / torch.clamp(a1 + a2 - inter, min=1e-9)


def compute_interaction_loss(verts_hand_det, verts_obj, camintr, cfg,
                             z_thresh: float = 3.0, expansion: float = 0.2):
    """Coarse interaction: per frame and hand, if the projected bboxes
    overlap and the z-extents are within `z_thresh`, pull the centroids
    ('centroid') or the closest points ('min') together. Returns the
    un-normalized sum over interacting pairs, as the reference does."""
    hand_nb = cfg.hand_nb
    losses, indicators, min_dists = [], [], []
    for h in range(hand_nb):
        vh = verts_hand_det[h::hand_nb]
        with torch.no_grad():
            bo = _project_bbox(verts_obj, camintr, expansion)
            bh = _project_bbox(vh, camintr, expansion)
            iou = _bbox_iou_pairwise(bo, bh)
            a = vh[..., 2].amin(dim=1)
            b = vh[..., 2].amax(dim=1)
            c = verts_obj[..., 2].amin(dim=1)
            d = verts_obj[..., 2].amax(dim=1)
            gap = torch.where((d >= a) & (b >= c), torch.zeros_like(a),
                              torch.minimum((c - b).abs(), (a - d).abs()))
            inter = (iou > 0) & (gap < z_thresh)
        if cfg.inter_type == "centroid":
            err = ((vh.mean(dim=1) - verts_obj.mean(dim=1)) ** 2).mean(dim=-1)
        else:  # min
            err = contact_lib.batch_pairwise_dist2(vh, verts_obj).amin(
                dim=(1, 2))
        losses.append(err)
        indicators.append(inter)
        with torch.no_grad():
            d2 = contact_lib.batch_pairwise_dist2(vh, verts_obj)
            min_dists.append(torch.sqrt(torch.clamp(d2.amin(dim=(1, 2)),
                                                    min=0.0)))
    err = torch.stack(losses)
    ind = torch.stack(indicators)
    loss = (err * ind).sum()
    handobj_maxdist = torch.stack(min_dists).amin(dim=0).amax()
    return {"loss_inter": loss}, {"handobj_maxdist": handobj_maxdist}


def build_interaction_grids(verts_hand_detscale, verts_obj, faces_obj,
                            closed_hand_faces, hand_nb: int,
                            sdf_grid: int = 32):
    """Voxelize each hand and the object once for all SDF terms of a step
    (the reference shares one SDFSceneLoss, homan/lossutils.py:43-64,
    112-130); the grids carry no gradient, so sharing them is exact.
    Layout: [hand_0 .. hand_{H-1}, object]."""
    hand_verts = [verts_hand_detscale[i::hand_nb] for i in range(hand_nb)]
    scene_verts = hand_verts + [verts_obj.detach()]
    scene_faces = [closed_hand_faces] * hand_nb + [faces_obj]
    grids = sdf_lib.build_scene_sdfs(scene_verts, scene_faces,
                                     grid_size=sdf_grid)
    return grids, hand_verts


def compute_collision_loss(verts_hand_detscale, verts_obj_det, faces_obj,
                           closed_hand_faces, hand_nb: int, sdf_grid: int = 32,
                           grids=None, hand_verts=None):
    """SDF scene penetration (homan/lossutils.py:43-64). The voxelizer is
    winding-invariant, so the reference's flipped closed-fist faces for two
    hands (:54) give the same grids."""
    if grids is None:
        grids, hand_verts = build_interaction_grids(
            verts_hand_detscale, verts_obj_det, faces_obj, closed_hand_faces,
            hand_nb, sdf_grid)
    loss, _ = sdf_lib.sdf_penetration_from_grids(
        hand_verts + [verts_obj_det], grids)
    return {"loss_collision": loss}


def compute_contact_loss_term(verts_hand_detscale, verts_obj, faces_obj,
                              closed_hand_faces, hand_nb: int,
                              sdf_grid: int = 32, grids=None,
                              hand_verts=None):
    """Contact (homan/lossutils.py:112-130): the shared object grid (the
    last) sampled at each hand's verts feeds only boolean masks, so sharing
    it with the collision term is exact."""
    if grids is None:
        grids, hand_verts = build_interaction_grids(
            verts_hand_detscale, verts_obj, faces_obj, closed_hand_faces,
            hand_nb, sdf_grid)
    obj_idx = len(grids["phis"]) - 1
    missed_sum, contact_sum = 0.0, 0.0
    for h in range(hand_nb):
        obj_sdf_at_hand = sdf_lib.sample_scene_sdf(grids, obj_idx,
                                                   hand_verts[h])
        m, c, _, _ = contact_lib.compute_contact_loss(
            hand_verts[h], closed_hand_faces, verts_obj, faces_obj,
            sdf_grid=sdf_grid, obj_sdf_at_hand=obj_sdf_at_hand)
        missed_sum = missed_sum + m
        contact_sum = contact_sum + c
    return {"loss_contact": (missed_sum + contact_sum) / hand_nb}


def compute_interaction_sdf_terms(verts_hand_detscale, verts_obj, faces_obj,
                                  closed_hand_faces, hand_nb: int,
                                  with_collision: bool, with_contact: bool,
                                  sdf_mode: str = "grid", sdf_grid: int = 32,
                                  grids=None):
    """Collision and contact with the SDF work done once per step.

    sdf_mode "grid": the reference's semantics, each mesh voxelized into a
    G^3 interior grid and sampled trilinearly (the voxelizer kernel runs
    here, unless the caller passes the step's `grids`). "direct": the exact
    interior distance at the sampled vertices only
    (interior_sdf_at_points).
    """
    hand_verts = [verts_hand_detscale[i::hand_nb] for i in range(hand_nb)]
    obj_det = verts_obj.detach()
    out = {}
    if sdf_mode == "direct":
        if with_collision:
            scene_verts = hand_verts + [obj_det]
            scene_faces = [closed_hand_faces] * hand_nb + [faces_obj]
            loss, meta = sdf_lib.sdf_scene_loss_direct(scene_verts,
                                                       scene_faces)
            out["loss_collision"] = loss
            obj_at_hand = [meta["dist_values"][(hand_nb, h)]
                           for h in range(hand_nb)]
        else:
            obj_at_hand = [sdf_lib.interior_sdf_at_points(hv, obj_det,
                                                          faces_obj)
                           for hv in hand_verts]
    elif sdf_mode == "grid":
        if grids is None:
            grids, _ = build_interaction_grids(
                verts_hand_detscale, verts_obj, faces_obj, closed_hand_faces,
                hand_nb, sdf_grid)
        if with_collision:
            out.update(compute_collision_loss(
                verts_hand_detscale, obj_det, faces_obj, closed_hand_faces,
                hand_nb, sdf_grid, grids=grids, hand_verts=hand_verts))
        obj_idx = len(grids["phis"]) - 1
        obj_at_hand = [sdf_lib.sample_scene_sdf(grids, obj_idx, hv)
                       for hv in hand_verts]
    else:
        raise ValueError(f"unknown sdf_mode {sdf_mode}")
    if with_contact:
        missed_sum, contact_sum = 0.0, 0.0
        for h in range(hand_nb):
            m, c, _, _ = contact_lib.compute_contact_loss(
                hand_verts[h], closed_hand_faces, verts_obj, faces_obj,
                sdf_grid=sdf_grid, obj_sdf_at_hand=obj_at_hand[h])
            missed_sum = missed_sum + m
            contact_sum = contact_sum + c
        out["loss_contact"] = (missed_sum + contact_sum) / hand_nb
    return out


def compute_ordinal_depth_loss(masks, silhouettes, depths):
    """Ordinal depth (homan/lossutils.py:133-169): penalize pixels where the
    ground truth puts entity i in front of j and the render disagrees,
    normalized by the number of i != j pairs with any joint coverage.

    masks (B, N, S, S) bool full-image GT masks; silhouettes, depths: N
    renders (B, S, S) each, bool coverage and depth.
    """
    dev = depths[0].device
    loss = torch.zeros((), device=dev)
    num_pairs = torch.zeros((), device=dev)
    n = len(silhouettes)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            has_pred = silhouettes[i] & silhouettes[j]
            pairs = (has_pred.sum(dim=(1, 2)) > 0).sum().to(torch.float32)
            front_i_gt = masks[:, i] & ~masks[:, j]
            front_j_pred = depths[j] < depths[i]
            m = (front_i_gt & front_j_pred & has_pred).to(torch.float32)
            msum = m.sum()
            dists = torch.clamp(depths[i] - depths[j], 0.0, 2.0)
            term = torch.where(
                msum > 0,
                (torch.log1p(torch.exp(dists)) * m).sum()
                / torch.clamp(msum, min=1.0),
                torch.zeros((), device=dev))
            loss = loss + term
            num_pairs = num_pairs + pairs
    return {"loss_depth": loss / torch.clamp(num_pairs, min=1.0)}


def _sdf_plan(cfg: M.HomanConfig, lw: Dict[str, float]):
    """(tritri collision, SDF terms run, grids built) for these weights."""
    with_sdf_terms = lw["lw_collision"] > 0 or lw["lw_contact"] > 0
    tritri = cfg.collision_mode == "tritri" and lw["lw_collision"] > 0
    # With tritri on, the SDF terms run for contact alone, and not at all
    # (no voxelizer launch) when lw_contact is 0.
    sdf_terms = with_sdf_terms and (lw["lw_contact"] > 0 or not tritri)
    return tritri, sdf_terms, sdf_terms and cfg.sdf_mode == "grid"


def render_terms(state: M.HomanState, consts: M.HomanConsts,
                 cfg: M.HomanConfig, lw: Dict[str, float],
                 closed_hand_faces=None,
                 roi_settings: RasterSettings | None = None,
                 full_settings: RasterSettings | None = None) -> Dict:
    """The per-frame work of a step: the posed vertices (MANO), the
    silhouette and depth renders and the SDF grids, so every kernel launch
    of the step. Each frame's outputs depend on its own rows of state and
    consts and on the global scales only, so a frame-sharded fit
    (parallel/frames.py) runs this per shard and concatenates.

    Returns a dict of frame-major tensors (and dicts and lists of them):
    verts_object, verts_hand, verts_hand_det, and as the weights need
    verts_hand_detscale, grids, sil_object (rasterize_soft's output),
    sil_hand, depth (rasterize_depth's outputs, object then each hand).
    """
    if roi_settings is None:
        roi_settings = RasterSettings(image_size=cfg.rend_size)
    with_sdf_terms = lw["lw_collision"] > 0 or lw["lw_contact"] > 0
    if with_sdf_terms and closed_hand_faces is None:
        raise ValueError("collision and contact need closed_hand_faces")
    _, _, with_grids = _sdf_plan(cfg, lw)
    out = {}
    out["verts_object"], _ = M.get_verts_object(state, consts)
    out["verts_hand"], out["verts_hand_det"] = M.get_verts_hand(
        state, consts, cfg)
    # The scale-detached variant needs a second MANO pass; only the
    # collision and contact terms read it (homan/homan.py:432).
    if with_sdf_terms:
        with span("interactions"):
            out["verts_hand_detscale"], _ = M.get_verts_hand(
                state, consts, cfg, detach_scale=True)
            if with_grids:
                out["grids"], _ = build_interaction_grids(
                    out["verts_hand_detscale"], out["verts_object"],
                    _faces_of(consts.faces_object),
                    _faces_of(closed_hand_faces), cfg.hand_nb)
    if lw["lw_sil_obj"] > 0:
        out["sil_object"] = rasterize_soft(
            out["verts_object"], consts.faces_object,
            consts.camintr_rois_object, roi_settings)
    if lw["lw_sil_hand"] > 0:
        out["sil_hand"] = rasterize_soft(
            out["verts_hand"], consts.faces_hand, consts.camintr_rois_hand,
            roi_settings)["sil"]
    if lw["lw_depth"] > 0:
        if full_settings is None:
            full_settings = RasterSettings(image_size=cfg.image_size)
        # Hard z-buffer depth and coverage of the object and each hand at
        # full image size; the loss never reads soft silhouette values.
        out["depth"] = [rasterize_depth(out["verts_object"],
                                        consts.faces_object, consts.camintr,
                                        full_settings)]
        for h in range(cfg.hand_nb):
            out["depth"].append(rasterize_depth(
                out["verts_hand"][h::cfg.hand_nb], consts.faces_hand,
                consts.camintr, full_settings))
    return out


def reduce_terms(rendered: Dict, state: M.HomanState, consts: M.HomanConsts,
                 cfg: M.HomanConfig, lw: Dict[str, float],
                 closed_hand_faces=None,
                 roi_settings: RasterSettings | None = None
                 ) -> Tuple[Dict, Dict]:
    """The gated loss and metric dicts from a step's render_terms, in the
    JAX package's insertion order so weighted sums add up alike. Reads
    state only for the PCA and scale priors."""
    if roi_settings is None:
        roi_settings = RasterSettings(image_size=cfg.rend_size)
    loss_dict: Dict[str, torch.Tensor] = {}
    metric_dict: Dict[str, torch.Tensor] = {}
    tritri, sdf_terms, _ = _sdf_plan(cfg, lw)
    verts_object = rendered["verts_object"]
    verts_hand = rendered["verts_hand"]

    if lw["lw_pca"] > 0:
        loss_dict.update(compute_pca_loss(state.mano_pca_pose))
    if lw["lw_smooth_hand"] > 0 or lw["lw_smooth_obj"] > 0:
        loss_dict.update(compute_smooth_loss(verts_hand, verts_object,
                                             cfg.hand_nb))
    if tritri:
        # The BVH branch (homan/lossutils.py:66-104): intersecting
        # triangle pairs, point-to-plane penetration. The object is
        # detached, so collision only pushes the hand (the reference's
        # verts_object.detach(), homan/homan.py:445-447).
        loss_dict["loss_collision"] = \
            intersect_lib.compute_collision_loss_tritri(
                rendered["verts_hand_detscale"],
                _faces_of(closed_hand_faces), verts_object.detach(),
                _faces_of(consts.faces_object), cfg.hand_nb)
    if sdf_terms:
        with span("interactions"):
            loss_dict.update(compute_interaction_sdf_terms(
                rendered["verts_hand_detscale"], verts_object,
                _faces_of(consts.faces_object), _faces_of(closed_hand_faces),
                cfg.hand_nb, with_collision=lw["lw_collision"] > 0
                and not tritri, with_contact=lw["lw_contact"] > 0,
                sdf_mode=cfg.sdf_mode, grids=rendered.get("grids")))
    if lw["lw_v2d_hand"] > 0:
        l, m = compute_v2d_loss_hand(verts_hand, consts.camintr,
                                     consts.ref_verts2d_hand, cfg.image_size,
                                     cfg.hand_nb)
        loss_dict.update(l)
        metric_dict.update(m)
    if lw["lw_sil_obj"] > 0:
        l, m = compute_sil_loss_object(
            verts_object, consts.faces_object, consts.camintr_rois_object,
            consts.ref_mask_object, consts.keep_mask_object, roi_settings,
            rendered=rendered["sil_object"])
        loss_dict.update(l)
        metric_dict.update(m)
    if lw["lw_sil_hand"] > 0:
        loss_dict.update(compute_sil_loss_hand(
            verts_hand, consts.faces_hand, consts.camintr_rois_hand,
            consts.ref_mask_hand, consts.keep_mask_hand, roi_settings,
            rendered=rendered["sil_hand"]))
    if lw["lw_inter"] > 0:
        obj_for_inter = (verts_object if cfg.optimize_object_scale
                         else verts_object.detach())
        l, m = compute_interaction_loss(rendered["verts_hand_det"],
                                        obj_for_inter, consts.camintr, cfg)
        loss_dict.update(l)
        metric_dict.update(m)
    if lw["lw_scale_obj"] > 0:
        loss_dict["loss_scale_obj"] = compute_intrinsic_scale_prior(
            state.int_scales_object)
    if lw["lw_scale_hand"] > 0:
        loss_dict["loss_scale_hand"] = compute_intrinsic_scale_prior(
            state.int_scales_hand)
    if lw["lw_depth"] > 0:
        renders = rendered["depth"]
        all_masks = torch.stack(
            [consts.masks_object]
            + [consts.masks_hand[h::cfg.hand_nb] for h in range(cfg.hand_nb)],
            dim=1).to(torch.bool)
        loss_dict.update(compute_ordinal_depth_loss(
            all_masks, [r["covered"] for r in renders],
            [r["depth"] for r in renders]))
    return loss_dict, metric_dict


def compute_all_losses(state: M.HomanState, consts: M.HomanConsts,
                       cfg: M.HomanConfig, lw: Dict[str, float],
                       closed_hand_faces=None,
                       roi_settings: RasterSettings | None = None,
                       full_settings: RasterSettings | None = None,
                       ) -> Tuple[Dict, Dict]:
    """Gated loss and metric dicts (homan_tpu/fit/losses.py:357):
    render_terms then reduce_terms.

    closed_hand_faces: (F, 3) hand topology of the collision and contact
    terms. full_settings: the full-image depth renders of the ordinal-depth
    term; None reproduces the JAX default,
    RasterSettings(image_size=cfg.image_size).
    """
    rendered = render_terms(state, consts, cfg, lw, closed_hand_faces,
                            roi_settings, full_settings)
    return reduce_terms(rendered, state, consts, cfg, lw, closed_hand_faces,
                        roi_settings)


def weighted_sum(loss_dict: Dict[str, torch.Tensor],
                 lw: Dict[str, float]) -> torch.Tensor:
    """Sum of losses, each times its matching lw_ weight."""
    total = 0.0
    for k, v in loss_dict.items():
        total = total + v * lw[k.replace("loss", "lw")]
    return total
