"""Point-cloud metrics: chamfer, ADD-S, per-vertex error, hand-aligned
variants and SDF interaction metrics (homan_tpu/eval/pointmetrics.py).

Nearest neighbours are the dense (N, M) squared-distance matrix of
`batch_pairwise_dist2`, in full float32. Metric functions take tensors on
any device and return lists of Python floats, one per frame.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from homan_tpu_torch.interactions.contact import batch_pairwise_dist2


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric squared chamfer per batch element: mean_a min_b d^2 +
    mean_b min_a d^2. a (B, N, 3), b (B, M, 3) -> (B,)."""
    d2 = batch_pairwise_dist2(a, b)
    return d2.amin(dim=2).mean(dim=1) + d2.amin(dim=1).mean(dim=1)


def add_s(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """ADD-S: mean nearest-neighbour distance from GT points to predicted
    points, (B,) meters."""
    d2 = batch_pairwise_dist2(gt, pred)
    return torch.sqrt(torch.clamp(d2.amin(dim=2), min=1e-18)).mean(dim=1)


def verts_dists(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean per-vertex L2 where vertices correspond, (B,)."""
    return torch.linalg.vector_norm(gt - pred, dim=-1).mean(dim=1)


def _floats(x: torch.Tensor):
    return [float(v) for v in x.detach().cpu().numpy()]


def get_point_metrics(gt_verts, pred_verts) -> Dict:
    """chamfer_dists, add-s and verts_dists, one float per frame."""
    with torch.no_grad():
        return {"chamfer_dists": _floats(chamfer_distance(gt_verts,
                                                          pred_verts)),
                "add-s": _floats(add_s(gt_verts, pred_verts)),
                "verts_dists": _floats(verts_dists(gt_verts, pred_verts))}


def get_align_metrics(gt_hand, pred_hand, gt_obj, pred_obj) -> Dict:
    """Hand-centred, hand-scale-normalised errors, with the reference's
    semantics (JAX pointmetrics.py:53):

      * hand rows are frame-major, hand index fastest; the first hand of
        each frame defines the centroid and the scale;
      * both scenes are centred by the GT hand centroid (the reference
        computes the prediction's centroid from the GT hand too, so a
        translation error of the prediction stays in the aligned metrics);
      * scale is the RMS distance from the centroid; the prediction is
        rescaled by gt_scale / pred_scale.

    gt_hand, pred_hand (B * hand_nb, 778, 3); gt_obj, pred_obj (B, M, 3).
    Returns hand_mean_aligned (B * hand_nb floats), obj_chamfer_aligned (B).
    """
    hand_nb = gt_hand.shape[0] // gt_obj.shape[0]

    def per_hand(x):  # (B, ...) -> (B * hand_nb, ...), hand fastest
        return torch.repeat_interleave(x, hand_nb, dim=0)

    with torch.no_grad():
        gt_cent = gt_hand[::hand_nb].mean(dim=1, keepdim=True)  # (B, 1, 3)
        pred_cent = gt_cent  # the reference's quirk, kept for parity
        gt_hand_c = gt_hand - per_hand(gt_cent)
        pred_hand_c = pred_hand - per_hand(pred_cent)
        gt_obj_c = gt_obj - gt_cent
        pred_obj_c = pred_obj - pred_cent

        def rms_scale(hand_c):  # (B,) over the first hand's verts
            first = hand_c[::hand_nb]
            return torch.sqrt((first ** 2).sum(-1).sum(1) / first.shape[1])

        gt_scale = torch.clamp(rms_scale(gt_hand_c), min=1e-9)
        pred_scale = torch.clamp(rms_scale(pred_hand_c), min=1e-9)
        ratio = (gt_scale / pred_scale)[:, None, None]
        return {
            "hand_mean_aligned": _floats(verts_dists(
                gt_hand_c, pred_hand_c * per_hand(ratio))),
            "obj_chamfer_aligned": _floats(chamfer_distance(
                pred_obj_c * ratio, gt_obj_c)),
        }


def get_inter_metrics(hand_verts, obj_verts, hand_faces, obj_faces,
                      sdf_grid: int = 32) -> Dict:
    """Penetration depth of the hand into the object and a contact flag per
    frame: the object's interior SDF (voxelized at sdf_grid, on the card by
    the voxelizer kernel) sampled at the hand's vertices, positive inside.
    Only the object is voxelized; hand_faces is taken for the reference's
    signature. hand_verts (B, N, 3), obj_verts (B, M, 3); faces are (F, 3)
    arrays, tensors or MeshTopology."""
    from homan_tpu_torch.interactions.sdf import (build_scene_sdfs,
                                                  sample_scene_sdf)
    from homan_tpu_torch.render.rasterizer import MeshTopology

    faces = obj_faces.faces if isinstance(obj_faces, MeshTopology) \
        else torch.as_tensor(np.asarray(obj_faces), device=obj_verts.device)
    with torch.no_grad():
        grids = build_scene_sdfs([obj_verts], [faces.to(obj_verts.device)],
                                 grid_size=sdf_grid)
        pen = sample_scene_sdf(grids, 0, hand_verts)
    return {"pen_depths": _floats(pen.amax(dim=1)),
            "has_contact": [bool(x) for x in (pen > 0).any(dim=1).cpu()]}


def interpolate_sequence(chunk_frames, chunk_values, full_frame_ids):
    """Linear interpolation of per-chunk results to whole sequences.

    chunk_frames (N,) sorted frame ids holding values; chunk_values
    (N, ...); full_frame_ids (M,). Returns (M, ...) numpy values.
    """
    chunk_frames = np.asarray(chunk_frames, np.float64)
    vals = np.asarray(chunk_values)
    full = np.asarray(full_frame_ids, np.float64)
    flat = vals.reshape(vals.shape[0], -1)
    out = np.stack([np.interp(full, chunk_frames, flat[:, i])
                    for i in range(flat.shape[1])], axis=1)
    return out.reshape((len(full),) + vals.shape[1:])
