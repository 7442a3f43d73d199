"""Stage A and B from dataset ground truth, the --gt_masks path
(homan_tpu/frontend/gtevidence.py): hand and object visibility masks
rendered from the GT meshes in one z-buffered scene, hand keypoint evidence
from GT projections, the MANO initialization aligned to the GT hand, and
the object-pose search on the object masks.

Where the port departs from the JAX package, it sizes a budget from the
measured demand instead of taking a default that drops geometry:
  * the instance render's faces_per_tile is the per-tile face demand of the
    fixed GT poses, at the tile that keeps the render's temporaries
    smallest (the JAX package keeps 256 faces a tile, which drops most of
    the object where the hand's faces crowd a tile);
  * the search's edges_per_tile is sized from the demand of its initial
    candidates (poseinit.search_edge_settings), and a search whose renders
    still overflowed is run again with the budget bumped past the measured
    demand.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core import bbox as bbox_ops
from homan_tpu_torch.core import mano as mano_lib
from homan_tpu_torch.core.meshes import merge_meshes
from homan_tpu_torch.fit import poseinit
from homan_tpu_torch.frontend import masks as mask_lib
from homan_tpu_torch.frontend.evidence import build_object_mask_info
from homan_tpu_torch.render.rasterizer import (MeshTopology, RasterSettings,
                                               as_topology,
                                               bump_edge_settings,
                                               hard_face_settings,
                                               rasterize_hard,
                                               rasterize_soft)

logger = logging.getLogger(__name__)


def render_full_mask(verts, topo, K_px, image_size: int,
                     device=None) -> np.ndarray:
    """(B, S, S) bool full-image masks of meshes `verts` (B, V, 3) under
    pixel intrinsics K_px (B, 3, 3) (JAX gtevidence.py:24).

    One forward-only render at min(image_size, 256)^2, tile 64, 128 edge
    slots a tile, thresholded at 0.5 and upsampled on the device to
    image_size^2; one transfer to the host.
    """
    device = resolve_device(device)
    Kn = np.asarray(K_px, np.float64).copy()
    Kn[:, :2] = Kn[:, :2] / image_size
    settings = RasterSettings(image_size=min(image_size, 256),
                              edges_per_tile=128)
    with torch.no_grad():
        sil = rasterize_soft(
            torch.as_tensor(np.asarray(verts, np.float32), device=device),
            as_topology(topo, device=device),
            torch.as_tensor(Kn, dtype=torch.float32, device=device),
            settings)["sil"]
        masks = _upsample_full(sil > 0.5, image_size)
    return masks.cpu().numpy()


def mask_to_bbox(mask: np.ndarray) -> np.ndarray:
    """Tight xyxy box (4,) of a mask's nonzero pixels; [0, 0, 1, 1] when
    the mask is empty."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                    np.float32)


def _upsample_full(masks: torch.Tensor, image_size: int) -> torch.Tensor:
    """(N, S0, S0) bool masks -> (N, image_size, image_size) bool, by the
    full-frame crop_and_resize at 0.5."""
    S0 = masks.shape[-1]
    if S0 == image_size:
        return masks
    full = torch.tensor([[0, 0, S0, S0]], dtype=torch.float32,
                        device=masks.device).expand(masks.shape[0], 4)
    return mask_lib.crop_and_resize_dev(masks.to(torch.float32), full,
                                        image_size) >= 0.5


def render_instance_masks(verts_list, faces_list, K_px: np.ndarray,
                          image_size: int, device=None):
    """Per-instance visibility masks from one z-buffered render of all
    instances (JAX gtevidence.py:44): instances occlude each other as in a
    real detection, each one colored by a one-hot RGB channel.

    verts_list: (B, Vi, 3) camera-space verts per instance (1 to 3);
    faces_list: (Fi, 3) per instance; K_px (B, 3, 3) pixel intrinsics.
    Renders at min(image_size, 256)^2 with faces_per_tile sized from the
    poses' per-tile face demand (hard_face_settings), thresholds at 0.5 and
    upsamples to image_size^2 on the device; one transfer to the host.

    Returns (list of (B, image_size, image_size) bool masks, one per
    instance; {"tile_px", "faces_per_tile", "face_demand": {tile: demand}}).
    """
    device = resolve_device(device)
    n = len(verts_list)
    if not 1 <= n <= 3:
        raise ValueError("instance masks ride the RGB channels: 1 to 3 "
                         f"instances, got {n}")
    B = verts_list[0].shape[0]
    _, merged_f = merge_meshes(
        [(np.zeros((v.shape[1], 3), np.float32), f)
         for v, f in zip(verts_list, faces_list)])
    verts = np.concatenate([np.asarray(v, np.float32) for v in verts_list],
                           axis=1)
    colors = np.zeros((merged_f.shape[0], 3), np.float32)
    off = 0
    for i, f in enumerate(faces_list):
        colors[off:off + len(np.asarray(f)), i] = 1.0
        off += len(np.asarray(f))
    Kn = np.asarray(K_px, np.float64).copy()
    Kn[:, :2] = Kn[:, :2] / image_size
    base = RasterSettings(image_size=min(image_size, 256),
                          edges_per_tile=128)
    with torch.no_grad():
        v = torch.as_tensor(verts, device=device)
        topo = MeshTopology.from_faces(merged_f, device=device)
        K = torch.as_tensor(Kn, dtype=torch.float32, device=device)
        settings, demand = hard_face_settings(v, topo, K, base)
        rgb = rasterize_hard(v, topo, K, torch.as_tensor(colors,
                                                         device=device),
                             settings, background=0.0, ambient=1.0,
                             diffuse=0.0, specular=0.0, shading="flat")["rgb"]
        S0 = settings.image_size
        chans = (rgb[..., :n] > 0.5).permute(3, 0, 1, 2).reshape(
            n * B, S0, S0)
        m_all = _upsample_full(chans, image_size).cpu().numpy().reshape(
            n, B, image_size, image_size)
    budget = {"tile_px": settings.tile_px,
              "faces_per_tile": settings.faces_per_tile,
              "face_demand": demand}
    return [m_all[i] for i in range(n)], budget


def procrustes_rigid(src: np.ndarray, dst: np.ndarray):
    """Best-fit rotation and translation dst ~ src @ R + t (row vectors, the
    model's convention) (JAX gtevidence.py:116): the GT path's stand-in for
    a detector's global hand pose."""
    src_c = src - src.mean(0)
    dst_c = dst - dst.mean(0)
    H = src_c.T @ dst_c
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt  # src-row @ R ~ dst-row
    t = dst.mean(0) - src.mean(0) @ R
    return R.astype(np.float32), t.astype(np.float32)


def _to_host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def search_object_poses(obj_verts_can, obj_faces, annotations, Ks,
                        image_size: int, args, rend_size: int, device):
    """Stage B on GT evidence with a sized edge budget: Ke from the initial
    candidates' demand (poseinit.search_edge_settings); when a render of
    the search still overflowed, the search runs again with the budget
    bumped past the measured demand, up to four searches
    (bump_edge_settings raises when tile 16 cannot cover it). Returns (per-frame results, {"settings", "initial_demand",
    "edge_demand", "edge_capacity", "attempts"})."""
    topo = as_topology(obj_faces, device=device)
    settings, initial = poseinit.search_edge_settings(
        obj_verts_can, topo, annotations[0], Ks[0],
        RasterSettings(image_size=rend_size),
        num_initializations=args.num_initializations, seed=args.seed,
        rend_size=rend_size, device=device)
    for attempt in range(1, 5):
        result = poseinit.find_optimal_poses(
            obj_verts_can, topo, annotations, Ks, (image_size, image_size),
            num_initializations=args.num_initializations,
            num_iterations=args.num_obj_iterations,
            parallel_frames=bool(getattr(args, "stageb_parallel_frames", 0)),
            rend_size=rend_size, settings=settings, seed=args.seed,
            device=device)
        demand = result[0]["edge_demand"]
        capacity = result[0]["edge_capacity"]
        if demand <= capacity:
            return result, {"tile_px": settings.tile_px,
                            "edges_per_tile": settings.edges_per_tile,
                            "initial_demand": initial,
                            "edge_demand": demand,
                            "edge_capacity": capacity, "attempts": attempt}
        bumped = bump_edge_settings(settings, demand)
        logger.warning(
            "stage B edge budget overflowed (demand %d > %d slots); "
            "searching again with edges_per_tile %d -> %d (tile_px %d -> %d)",
            demand, capacity, settings.edges_per_tile, bumped.edges_per_tile,
            settings.tile_px, bumped.tile_px)
        settings = bumped
    raise RuntimeError("stage B edge budget still overflowing after four "
                       "searches")


def prepare_independent_fit(annots: Dict, args, dataset, mano_layer,
                            image_size: int, rend_size: int = 256,
                            sample_folder: str | None = None,
                            device=None) -> Dict:
    """The indep_fit payload (person and object parameters) from a clip's
    ground truth (JAX gtevidence.py:135), every array numpy.

    args needs num_initializations, num_obj_iterations, seed and optionally
    stageb_parallel_frames. `dataset` and `sample_folder` are unused, as in
    the JAX package. Besides the JAX payload it holds "budgets": the
    instance render's and the search's (see render_instance_masks and
    search_object_poses).
    """
    device = resolve_device(device)
    T = len(annots["frame_idxs"])
    K_px = np.asarray(annots["camera"]["K"], np.float64)
    hand_infos = list(annots["hands"])
    hand_sides = [h["label"].replace("_hand", "") for h in hand_infos]
    H = len(hand_sides)

    obj = annots["objects"][0]
    obj_verts_can = np.asarray(obj["canverts3d"])
    if obj_verts_can.ndim == 3:
        obj_verts_can = obj_verts_can[0]
    obj_faces = np.asarray(obj["faces"])
    if obj_faces.ndim == 3:
        obj_faces = obj_faces[0]

    # GT masks: one z-buffered scene, per-instance visibility; hands
    # without GT verts keep empty masks and stay out of the scene.
    hand_faces = mano_layer.faces("right").cpu().numpy()
    live = [h for h in range(H)
            if np.abs(np.asarray(hand_infos[h]["verts3d"])).sum() > 0]
    scene_verts = [np.asarray(hand_infos[h]["verts3d"], np.float32)
                   for h in live]
    scene_faces = [hand_faces for _ in live]
    scene_verts.append(np.asarray(obj["verts3d"], np.float32))
    scene_faces.append(obj_faces)
    vis, mask_budget = render_instance_masks(scene_verts, scene_faces, K_px,
                                             image_size, device=device)
    obj_masks = vis[-1]
    hand_masks_all = [np.zeros_like(obj_masks) for _ in range(H)]
    for i, h in enumerate(live):
        hand_masks_all[h] = vis[i]

    # Object evidence and the stage-B search.
    annotations = []
    for t in range(T):
        occluders = np.stack([hm[t] for hm in hand_masks_all]) if H else None
        info = build_object_mask_info(obj_masks[t], mask_to_bbox(obj_masks[t]),
                                      occluders, rend_size)
        info["full_mask"] = obj_masks[t].astype(np.float32)
        annotations.append(info)
    found, search_budget = search_object_poses(
        obj_verts_can, obj_faces, annotations, [K_px[t] for t in range(T)],
        image_size, args, rend_size, device)
    object_parameters = []
    for t in range(T):
        frame = {k: _to_host(v) for k, v in found[t].items()}
        frame["masks"] = obj_masks[t].astype(np.float32)
        frame["full_mask"] = obj_masks[t].astype(np.float32)
        object_parameters.append(frame)

    # Hand evidence.
    rows = {"verts": [], "verts2d": [], "rotations": [], "translations": [],
            "mano_pca_pose": [], "mano_rot": [], "mano_trans": [],
            "mano_betas": [], "masks": []}
    rest_by_side = {}
    with torch.no_grad():
        for side in set(hand_sides):
            zeros = torch.zeros((1, 48), device=device)
            rest_by_side[side] = mano_lib.mano_forward(
                mano_layer.params[side], zeros[:, :10], zeros[:, :3],
                zeros[:, 3:])["verts"][0].cpu().numpy()
    for t in range(T):
        for h, hand in enumerate(hand_infos):
            side = hand_sides[h]
            hv = np.asarray(hand["verts3d"][t], np.float32)
            if np.abs(hv).sum() == 0:  # no GT: rest-pose init at 0.6 m
                hv = rest_by_side[side] + np.array([0, 0, 0.6], np.float32)
            proj = hv @ np.asarray(K_px[t], np.float32).T
            uv = proj[:, :2] / np.maximum(proj[:, 2:], 1e-9)
            # Zero articulation; the global pose is the Procrustes alignment
            # of the rest hand to the GT vertices. verts_hand_og is the
            # local-frame twin of the GT verts, (hv - t) R^T, so the initial
            # render lands on the GT masks without posing twice.
            R_init, t_init = procrustes_rigid(rest_by_side[side], hv)
            rows["verts"].append((hv - t_init) @ R_init.T)
            rows["verts2d"].append(uv.astype(np.float32))
            rows["rotations"].append(R_init)
            rows["translations"].append(t_init[None])
            rows["mano_pca_pose"].append(np.zeros(16, np.float32))
            rows["mano_rot"].append(np.zeros(3, np.float32))
            rows["mano_trans"].append((hv.mean(0) * 0).astype(np.float32))
            rows["mano_betas"].append(np.zeros(10, np.float32))
            rows["masks"].append(hand_masks_all[h][t].astype(np.float32))
    person_parameters = {k: np.stack(v) for k, v in rows.items() if len(v)}

    # Occlusion-aware hand targets. Hand ROI boxes: the dataset's GT hand
    # boxes squared with a 0.1 expansion, as the reference driver squares
    # them; the rendered mask's tight box where the dataset has none.
    bboxes = []
    for t in range(T):
        for h in range(H):
            hb = hand_infos[h].get("bbox")
            if hb is not None and np.asarray(hb).size:
                hb = np.asarray(hb, np.float32)
                box_t = hb[t] if hb.ndim == 2 else hb
                sq = bbox_ops.make_bbox_square(
                    bbox_ops.bbox_xy_to_wh(box_t), bbox_expansion=0.1)
                bboxes.append(np.asarray(
                    bbox_ops.bbox_wh_to_xy(np.clip(sq, 0, None)),
                    np.float32))
            else:
                bboxes.append(mask_to_bbox(hand_masks_all[h][t]))
    pp = {"bboxes": np.stack(bboxes), "masks": person_parameters["masks"]}
    # One call over all T*H rows (i = t*H + h), per-row object masks and K.
    obj_full_per_hand = np.repeat(obj_masks.astype(np.float32), H, axis=0)
    K_per_row = np.repeat(np.asarray(K_px, np.float32), H, axis=0)
    batched = mask_lib.add_target_hand_occlusions(
        pp, {"full_mask": obj_full_per_hand}, K_per_row,
        rend_size=rend_size)
    person_parameters["target_masks"] = batched["target_masks"]
    person_parameters["K_roi"] = batched["K_roi"]
    person_parameters["bboxes"] = pp["bboxes"]

    return {
        "person_parameters": person_parameters,
        "object_parameters": object_parameters,
        "obj_verts_can": obj_verts_can,
        "obj_faces": obj_faces,
        "hand_sides": hand_sides,
        "budgets": {"instance_masks": mask_budget,
                    "stage_b": search_budget},
    }
