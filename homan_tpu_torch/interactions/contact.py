"""Hand-object contact attraction and collision repulsion (counterpart of
homan_tpu/interactions/contact.py).

Reference quirk, reproduced by default: the reference computes
`exterior = sdf < 0` (contactloss.py:173) on SDF values clamped to >= 0
(scenesdf.py:121), so `exterior` is always False: the attraction ("missed")
term vanishes and the repulsion mask covers every hand vertex, which makes
the shipped contact loss a saturating tanh attraction of all hand vertices
toward the object. `strict_exterior=True` gives the intended semantics
(exterior <=> sampled SDF == 0).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from homan_tpu_torch.core.mano import TIP_VERTEX_IDS


def load_contact_zones(path: str):
    """The zone-id -> vertex-index-list mapping of the reference's contact
    zones pickle (`data/contact_zones.pkl`, contactloss.py:301-309), for
    compute_contact_loss(contact_zones=<dict>)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return data["contact_zones"]


def batch_pairwise_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances (B, N, M) via the matmul expansion, in full
    float32 (the package turns TF32 off)."""
    xx = (x * x).sum(-1)
    yy = (y * y).sum(-1)
    xy = x @ y.transpose(1, 2)
    return xx[:, :, None] + yy[:, None, :] - 2.0 * xy


def masked_mean_loss(dists: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(mask * dists) / sum(mask), 0 when the mask is empty
    (contactloss.py:50-57)."""
    mask = mask.to(dists.dtype)
    valid = mask.sum()
    return torch.where(valid > 0,
                       (mask * dists).sum() / torch.clamp(valid, min=1.0),
                       torch.zeros((), device=dists.device))


def compute_contact_loss(hand_verts, hand_faces, obj_verts, obj_faces,
                         contact_thresh: float = 0.010,
                         contact_mode: str = "dist_tanh",
                         collision_thresh: float = 0.020,
                         collision_mode: str = "dist_tanh",
                         contact_target: str = "all",
                         contact_zones="all",
                         strict_exterior: bool = False,
                         sdf_grid: int = 32,
                         obj_sdf_at_hand=None):
    """Attraction of near-surface hand verts + repulsion of penetrating ones.

    hand_verts (B, 778, 3); hand_faces (Fh, 3) closed-fist topology;
    obj_verts (B, Vo, 3); obj_faces (Fo, 3). obj_sdf_at_hand: optional
    precomputed (B, 778) object interior SDF at the hand verts, to share the
    collision term's grids; without it the object alone is voxelized here.
    contact_zones: "all", "tips", or a zone -> vertex ids dict
    (load_contact_zones).

    Returns (missed_loss, penetr_loss, contact_info, metrics), the contract
    of contactloss.compute_contact_loss (contactloss.py:149-309).
    """
    d2 = batch_pairwise_dist2(hand_verts, obj_verts)  # (B, 778, Vo)
    mins21 = d2.amin(dim=2)
    min21_idx = d2.argmin(dim=2)  # the first minimum, as jnp.argmin

    if obj_sdf_at_hand is None:
        from homan_tpu_torch.interactions import sdf as sdf_lib
        grids = sdf_lib.build_scene_sdfs([obj_verts], [obj_faces],
                                         grid_size=sdf_grid)
        obj_sdf_at_hand = sdf_lib.sample_scene_sdf(grids, 0, hand_verts)
    if strict_exterior:
        exterior = obj_sdf_at_hand <= 0.0
    else:  # the reference's behaviour (see the module docstring)
        exterior = obj_sdf_at_hand < 0.0
    penetr_mask = ~exterior

    # Closest object point per hand vertex.
    results_close = torch.gather(
        obj_verts, 1, min21_idx[..., None].expand(-1, -1, 3))

    if contact_target == "all":
        diff = results_close - hand_verts
    elif contact_target == "obj":
        diff = results_close - hand_verts.detach()
    elif contact_target == "hand":
        diff = results_close.detach() - hand_verts
    else:
        raise ValueError(f"contact_target {contact_target}")
    anchor_dists = torch.sqrt(torch.clamp((diff ** 2).sum(-1), min=1e-18))

    if contact_mode == "dist_sq":
        contact_vals = (diff ** 2).sum(-1)
        below_dist = mins21 < contact_thresh ** 2
    elif contact_mode == "dist":
        contact_vals = anchor_dists
        below_dist = mins21 < contact_thresh
    elif contact_mode == "dist_tanh":
        contact_vals = contact_thresh * torch.tanh(anchor_dists
                                                   / contact_thresh)
        below_dist = torch.ones_like(mins21, dtype=torch.bool)
    else:
        raise ValueError(f"contact_mode {contact_mode}")

    if collision_mode == "dist_sq":
        collision_vals = (diff ** 2).sum(-1)
    elif collision_mode == "dist":
        collision_vals = anchor_dists
    elif collision_mode == "dist_tanh":
        collision_vals = collision_thresh * torch.tanh(anchor_dists
                                                       / collision_thresh)
    else:
        raise ValueError(f"collision_mode {collision_mode}")

    missed_mask = below_dist & exterior
    dev = hand_verts.device
    if isinstance(contact_zones, str) and contact_zones == "tips":
        tips = torch.zeros(hand_verts.shape[1], dtype=torch.bool, device=dev)
        tips[list(TIP_VERTEX_IDS)] = True
        missed_mask = missed_mask & tips[None, :]
    elif isinstance(contact_zones, dict):
        # Per zone, only the zone vertex now closest to the object takes
        # part in the attraction (contactloss.py:264-275).
        B = hand_verts.shape[0]
        matching = torch.zeros_like(missed_mask)
        rows = torch.arange(B, device=dev)
        for zone_idxs in contact_zones.values():
            zi = torch.as_tensor(np.asarray(zone_idxs, np.int64), device=dev)
            cont = zi[torch.argmin(mins21[:, zi], dim=1)]  # (B,)
            matching[rows, cont] = True
        missed_mask = missed_mask & matching
    elif contact_zones != "all":
        raise ValueError(f"contact_zones {contact_zones}")

    missed_loss = masked_mean_loss(contact_vals, missed_mask)
    penetr_loss = masked_mean_loss(collision_vals, penetr_mask)

    with torch.no_grad():
        pen = penetr_mask.to(anchor_dists.dtype)
        anchor_det = anchor_dists.detach()
        metrics = {
            "max_penetr": (anchor_det * pen).amax(dim=1).mean(),
            "mean_penetr": (anchor_det * pen).mean(dim=1).mean(),
        }
    contact_info = {
        "attraction_masks": missed_mask,
        "repulsion_masks": penetr_mask,
        "contact_points": results_close,
        "min_dists": mins21,
    }
    return missed_loss, penetr_loss, contact_info, metrics


def thresh_contact_iou(gt_dists: torch.Tensor, pred_dists: torch.Tensor,
                       threshs=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10)):
    """Contact IoU per sample averaged over thresholds, and its AUC over
    the thresholds (contactloss.py:22-47). gt_dists, pred_dists (B, N)."""
    all_ious = []
    for thresh in threshs:
        gt_c = gt_dists <= thresh
        pr_c = pred_dists <= thresh
        inter = (gt_c & pr_c).sum(dim=1).to(torch.float32)
        union = (gt_c | pr_c).sum(dim=1).to(torch.float32)
        all_ious.append(torch.where(union > 0,
                                    inter / torch.clamp(union, min=1),
                                    torch.zeros_like(inter)))
    ious = torch.stack(all_ious)  # (T, B)
    x = torch.as_tensor(threshs, dtype=torch.float32, device=ious.device)
    auc = torch.trapezoid(ious, x=x, dim=0).mean()
    return ious.mean(dim=1), auc
