"""Stage B — object 6DoF pose search from instance masks
(homan_tpu/fit/poseinit.py).

Hundreds of random-rotation candidates are refined in parallel against an
occlusion-aware silhouette loss; frames run in order, each frame's
candidates starting from the previous frame's refined rotations; the winner
is the candidate with the best mean IoU over the clip.

The JAX package compiles each refinement into one `lax.scan` over a
`lax.map` of candidate chunks, padding the candidate count up to a multiple
of the chunk. Here it is an eager loop: each Adam step runs the chunks in
turn (the last one may be short; nothing is padded), calls `backward()` once
a chunk into one (C, 3, 2) rotation leaf and one (C, 1, 3) translation leaf,
then takes one `torch.optim.Adam` step. A candidate's gradient depends only
on its own chunk, so this is optax's update. The per-step history stays on
the device: the loop makes no host sync. Renders without a gradient (the
final evaluation of a refinement, the full-resolution rescore) run under
`torch.no_grad()` and take the shade kernel's forward-only mode.

Every render also reports its largest per-tile contour-edge demand; the
search returns the largest over all its renders beside the capacity, so a
caller can tell whether the edge budget dropped edges anywhere (the JAX
package does not check). `search_edge_settings` sizes that budget before
the search from the demand of its initial candidates.

Not ported: `prewarm_programs` (it overlaps XLA compiles; eager PyTorch has
nothing to compile) and `visualize_optimal_poses` (a matplotlib grid of the
best candidates that no driver calls).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core import camera as cam
from homan_tpu_torch.core import geometry as geo
from homan_tpu_torch.fit.losses import batch_mask_iou
from homan_tpu_torch.frontend.masks import crop_and_resize
from homan_tpu_torch.render.rasterizer import (MeshTopology, RasterSettings,
                                               as_topology,
                                               auto_edge_settings,
                                               check_edge_budget,
                                               rasterize_soft)

RENDER_FAR = 100.0  # NMR renderer default far plane


def compute_optimal_translation(bbox_target_xywh, vertices, f,
                                img_size: int = 256, iters: int = 50):
    """Iterative depth/centre fit of the projected box to a target box
    (JAX poseinit.py:42). vertices (B, V, 3), already rotated; returns
    (B, 1, 3)."""
    bbox = torch.as_tensor(np.asarray(bbox_target_xywh, np.float32),
                           device=vertices.device)
    mask_center = bbox[:2] + bbox[2:] / 2
    diag_mask = torch.sqrt(bbox[2] ** 2 + bbox[3] ** 2)
    B = vertices.shape[0]
    x = vertices.new_zeros(B)
    y = vertices.new_zeros(B)
    z = 2.5 * vertices.new_ones(B)
    for _ in range(iters):
        v = vertices + torch.stack([x, y, z], dim=-1)[:, None, :]
        proj = (f * v[..., :2] / v[..., 2:] + 0.5) * img_size
        u, vv = proj[..., 0], proj[..., 1]
        x1, x2 = u.amin(1), u.amax(1)
        y1, y2 = vv.amin(1), vv.amax(1)
        w, h = x2 - x1, y2 - y1
        diag_proj = torch.sqrt(w ** 2 + h ** 2)
        z = z + z * (diag_proj / diag_mask - 1.0)
        cx, cy = x1 + w / 2, y1 + h / 2
        x = x + (mask_center[0] - cx) * z / f / img_size
        y = y + (mask_center[1] - cy) * z / f / img_size
    return torch.stack([x, y, z], dim=-1)[:, None, :]


def tco_init_from_boxes_autodepth(bbox_xywh, model_points_3d, K_px,
                                  iters: int = 10):
    """Auto-depth translation init (JAX poseinit.py:81): bbox_xywh (4,)
    target box in pixels, model_points_3d (B, V, 3) rotated model points,
    K_px (3, 3) pixel intrinsics. Returns (B, 3) translations."""
    dev = model_points_3d.device
    bbox = torch.as_tensor(np.asarray(bbox_xywh, np.float32), device=dev)
    boxes = torch.stack([bbox[0], bbox[1], bbox[0] + bbox[2],
                         bbox[1] + bbox[3]])
    diag_bb = torch.linalg.vector_norm(boxes[2:] - boxes[:2])
    bb_center = (boxes[:2] + boxes[2:]) / 2
    K = torch.as_tensor(K_px, dtype=torch.float32, device=dev)
    fxfy = torch.stack([K[0, 0], K[1, 1]])
    cxcy = torch.stack([K[0, 2], K[1, 2]])
    B = model_points_3d.shape[0]
    Kb = K.expand(B, 3, 3)
    z = torch.ones((B, 1), device=dev)
    xy = (bb_center[None] - cxcy[None]) * z / fxfy[None]
    for _ in range(iters):
        pts = model_points_3d + torch.cat([xy, z], dim=1)[:, None, :]
        proj = cam.batch_proj2d(pts, Kb)
        lo = proj.amin(dim=1)
        hi = proj.amax(dim=1)
        diag_proj = torch.linalg.vector_norm(lo - hi, dim=-1)
        centers = (lo + hi) / 2
        z = z + z * (diag_proj / diag_bb - 1.0)[:, None]
        xy = xy + ((bb_center[None] - centers) * z) / fxfy[None]
    return torch.cat([xy, z], dim=1)


def _chain_init(vertices, rotations, bbox_xywh, K_px):
    """Candidate init of one frame (JAX poseinit.py:126): rotate the
    canonical vertices by every candidate, fit the translations to the
    box. Returns rot6d (C, 3, 2) and translations (C, 1, 3)."""
    rotated = torch.einsum("vj,cjk->cvk", vertices, rotations)
    trans = tco_init_from_boxes_autodepth(bbox_xywh, rotated,
                                          K_px)[:, None, :]
    return geo.matrix_to_rot6d(rotations), trans


def _prune_select(c_ious, rot6d, trans, prune_to: int):
    """Successive-halving survivors (JAX poseinit.py:138): the best
    `prune_to` by IoU, ties in candidate order (a stable sort, as
    `jnp.argsort` is)."""
    keep_idx = torch.argsort(-c_ious, stable=True)[:prune_to]
    return rot6d[keep_idx], trans[keep_idx]


def _select_best(rot_all, trans_all, ious_all, vertices):
    """Best mean IoU over the clip (JAX poseinit.py:149); the first maximum
    wins. rot_all (T, C, 3, 3), trans_all (T, C, 1, 3), ious_all (T, C).
    Returns R (T, 3, 3), t (T, 1, 3), transformed verts (T, V, 3), the
    winning index and its mean IoU."""
    mean_ious = ious_all.mean(dim=0)
    best_idx = torch.argmax(mean_ious)
    R = rot_all[:, best_idx]
    t = trans_all[:, best_idx]
    vt = torch.einsum("vj,tjk->tvk", vertices, R) + t
    return R, t, vt, best_idx, mean_ious[best_idx]


def _maxpool_edges(sil: torch.Tensor, kernel: int = 7) -> torch.Tensor:
    """maxpool(k, stride 1, same) - sil of (B, S, S) silhouettes; the
    window pads with -inf, as the JAX `reduce_window` does."""
    pooled = F.max_pool2d(sil[:, None], kernel, stride=1,
                          padding=kernel // 2)[:, 0]
    return pooled - sil


def reference_edge_edt(mask: np.ndarray, kernel: int = 7,
                       power: float = 0.25) -> np.ndarray:
    """Distance transform of the target mask's edge, on the host
    (JAX poseinit.py:179): (squared EDT to the pooled edge)^power, by
    scipy's exact EDT (the JAX package's fallback for its native one)."""
    from scipy.ndimage import distance_transform_edt
    m = torch.as_tensor((np.asarray(mask) > 0).astype(np.float32))
    edge = _maxpool_edges(m[None], kernel)[0].numpy() > 0
    edt2 = distance_transform_edt(~edge).astype(np.float64) ** 2
    return edt2 ** power


class _PerCandidate:
    """One evidence array per candidate, held as `x` (G, ...) with one entry
    per `group` consecutive candidates: candidate i reads x[i // group].

    `chunk(s, e)` gives candidates s..e-1: a view when they read one entry
    (or one entry each), else a concatenation of broadcast views."""

    def __init__(self, x: torch.Tensor, nd: int, n: int, group: int = 1):
        if x.dim() == nd:  # shared by every candidate
            x, group = x[None], n
        if x.shape[0] * group < n:
            raise ValueError(f"evidence for {x.shape[0] * group} "
                             f"candidates, {n} needed")
        self.x, self.group = x, group

    def chunk(self, s: int, e: int) -> torch.Tensor:
        x, g = self.x, self.group
        if g == 1:
            return x[s:e]
        first, last = s // g, (e - 1) // g
        if first == last:
            return x[first].expand((e - s,) + x.shape[1:])
        parts = []
        for k in range(first, last + 1):
            n = min(e, (k + 1) * g) - max(s, k * g)
            parts.append(x[k].expand((n,) + x.shape[1:]))
        return torch.cat(parts)


def _chunks(n: int, chunk: int):
    chunk = min(chunk, n)
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def _score_candidates(vertices, topo, target_mask, keep_mask, K_roi,
                      rot6d, trans, settings: RasterSettings,
                      candidate_chunk: int = 125, group: int = 1):
    """Forward-only IoU (C,) of C candidates against their evidence (JAX
    poseinit.py:194), chunk by chunk, and the renders' largest per-tile
    contour-edge demand as a 0-d tensor. Evidence arrays are shared ((S, S),
    (3, 3)) or hold one entry per `group` consecutive candidates."""
    C = rot6d.shape[0]
    ref_c = _PerCandidate(target_mask, 2, C, group)
    keep_c = _PerCandidate(keep_mask, 2, C, group)
    K_c = _PerCandidate(K_roi, 2, C, group)
    ious, demand = [], []
    with torch.no_grad():
        for s, e in _chunks(C, candidate_chunk):
            R = geo.rot6d_to_matrix(rot6d[s:e])
            verts = torch.einsum("vj,cjk->cvk", vertices, R) + trans[s:e]
            out = rasterize_soft(verts, topo, K_c.chunk(s, e), settings)
            ious.append(batch_mask_iou(keep_c.chunk(s, e) * out["sil"],
                                       ref_c.chunk(s, e)))
            demand.append(out["edge_demand"].max())
    return torch.cat(ious), torch.stack(demand).max()


def candidate_loss_terms(verts, topo, target_mask, keep_mask, edt, K_roi,
                         settings: RasterSettings, lw_chamfer: float = 0.0):
    """Per-candidate stage-B loss terms (JAX poseinit.py:227): a dict of (C,)
    tensors `mask` (keep-masked silhouette L2), `chamfer` (maxpool edge x
    EDT, weighted by lw_chamfer), `off_xy`/`off_z` (the offscreen penalty's
    parts, unweighted; xy in the [0, 1] normalized projection), `iou`, and
    `edge_demand`, each render's largest per-tile contour-edge demand."""
    out = rasterize_soft(verts, topo, K_roi, settings)
    sil = out["sil"]
    image = keep_mask * sil
    l_mask = ((image - target_mask) ** 2).sum(dim=(1, 2))
    if lw_chamfer > 0:
        l_chamfer = lw_chamfer * (_maxpool_edges(image) * edt).sum(
            dim=(1, 2))
    else:
        l_chamfer = torch.zeros_like(l_mask)
    proj = cam.batch_proj2d(verts, K_roi)
    zc = verts[..., 2]
    off_xy = (torch.clamp(proj - 1.0, min=0.0).sum(dim=(1, 2))
              + torch.clamp(-proj, min=0.0).sum(dim=(1, 2)))
    off_z = (torch.clamp(-zc, min=0.0).sum(dim=1)
             + torch.clamp(zc - RENDER_FAR, min=0.0).sum(dim=1))
    return {"mask": l_mask, "chamfer": l_chamfer, "off_xy": off_xy,
            "off_z": off_z, "iou": batch_mask_iou(image, target_mask),
            "edge_demand": out["edge_demand"]}


@dataclasses.dataclass
class PoseFitResult:
    rotations: torch.Tensor     # (C, 3, 3) refined
    translations: torch.Tensor  # (C, 1, 3)
    ious: torch.Tensor          # (C,)
    losses: torch.Tensor        # (C,) final total loss
    history: Dict[str, torch.Tensor]


def _fit_candidates(vertices, topo, target_mask, keep_mask, edt, K_roi,
                    rot6d_init, trans_init, settings: RasterSettings,
                    num_iterations: int = 50, lr: float = 1e-2,
                    lw_chamfer: float = 0.0, candidate_chunk: int = 125,
                    group: int = 1):
    """Refine C pose candidates with Adam against their evidence (JAX
    poseinit.py:269).

    Evidence is shared ((S, S) masks, (3, 3) K) or holds one entry per
    `group` consecutive candidates ((G, S, S), (G, 3, 3)). Each step runs
    the candidates in chunks of `candidate_chunk`, a bound on memory: a
    chunk's render intermediates live until its backward.

    Returns (params {"rot6d", "trans"}, final totals (C,), final IoUs (C,),
    history {"loss_min", "iou_max"} (num_iterations,) and "edge_demand",
    the largest per-tile contour-edge demand of every render, 0-d), every
    tensor on the candidates' device; the history holds each step's values
    before its update.
    """
    C = rot6d_init.shape[0]
    bounds = _chunks(C, candidate_chunk)
    ev = {k: _PerCandidate(x, 2, C, group) for k, x in (
        ("ref", target_mask), ("keep", keep_mask), ("edt", edt),
        ("K", K_roi))}
    rot6d = rot6d_init.detach().clone().requires_grad_(True)
    trans = trans_init.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([rot6d, trans], lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    def chunk_loss(s, e):
        R = geo.rot6d_to_matrix(rot6d[s:e])
        verts = torch.einsum("vj,cjk->cvk", vertices, R) + trans[s:e]
        t = candidate_loss_terms(verts, topo, ev["ref"].chunk(s, e),
                                 ev["keep"].chunk(s, e),
                                 ev["edt"].chunk(s, e), ev["K"].chunk(s, e),
                                 settings, lw_chamfer=lw_chamfer)
        total = t["mask"] + t["chamfer"] + 1e5 * (t["off_xy"] + t["off_z"])
        return total, t["iou"], t["edge_demand"].max()

    loss_min, iou_max = [], []
    demand = torch.zeros((), dtype=torch.int64, device=rot6d.device)
    for _ in range(num_iterations):
        opt.zero_grad(set_to_none=True)
        totals, ious = [], []
        for s, e in bounds:
            total, iou, d = chunk_loss(s, e)
            total.sum().backward()
            totals.append(total.detach())
            ious.append(iou)
            demand = torch.maximum(demand, d)
        opt.step()
        loss_min.append(torch.cat(totals).min())
        iou_max.append(torch.cat(ious).max())
    with torch.no_grad():
        final = [chunk_loss(s, e) for s, e in bounds]
    for _, _, d in final:
        demand = torch.maximum(demand, d)
    params = {"rot6d": rot6d.detach(), "trans": trans.detach()}
    history = {"loss_min": torch.stack(loss_min) if loss_min
               else rot6d.new_zeros(0),
               "iou_max": torch.stack(iou_max) if iou_max
               else rot6d.new_zeros(0),
               "edge_demand": demand}
    return (params, torch.cat([f[0] for f in final]),
            torch.cat([f[1] for f in final]), history)


def _snap_size(size: int, tile_px: int, floor: int = 32) -> int:
    return max(floor, size // tile_px * tile_px)


def _refine_settings(settings: RasterSettings, refine_scale: float):
    """The refinement's raster settings (JAX poseinit.py:673-679): the
    render snapped down to a multiple of the tile at refine_scale < 1 (for
    images over 64 pixels), else `settings` itself."""
    if refine_scale < 1.0 and settings.image_size > 64:
        size = _snap_size(int(settings.image_size * refine_scale),
                          settings.tile_px)
        if size != settings.image_size:
            return dataclasses.replace(settings, image_size=size)
    return settings


def _frame_evidence(annot, K, rend_size: int, device):
    """Full-resolution evidence of one frame (JAX poseinit.py:684): the
    {-1, 0, 1} crop mask (host), its target and keep masks, and the ROI's
    normalized intrinsics, copied to the device once."""
    mask = np.asarray(annot["target_crop_mask"])
    ref = torch.as_tensor((mask > 0).astype(np.float32), device=device)
    keep = torch.as_tensor((mask >= 0).astype(np.float32), device=device)
    x, y, b = (float(v) for v in annot["square_bbox"][:3])
    K_roi_px = cam.get_K_crop_resize_np(
        np.asarray(K, np.float32)[None],
        np.asarray([[x, y, x + b, y + b]], np.float32), rend_size)[0]
    K_roi_px[:2] /= rend_size
    return mask, ref, keep, torch.as_tensor(K_roi_px, device=device)


def _refine_evidence(mask, refine_size: int | None, lw_chamfer: float,
                     device):
    """Target, keep and EDT masks of the refinement (JAX poseinit.py:701):
    the mask's own, or, given a refine_size, resampled to it on the
    host."""
    if refine_size is None:
        m, ref, keep = mask, mask > 0, mask >= 0
    else:
        R0 = mask.shape[0]
        m = crop_and_resize(mask[None].astype(np.float32),
                            np.array([[0, 0, R0, R0]]), refine_size)[0]
        ref, keep = m > 0.5, m >= -0.5
    if lw_chamfer > 0:
        edt = reference_edge_edt(np.asarray(m))
    else:
        edt = np.zeros(m.shape, np.float32)
    return tuple(torch.as_tensor(a.astype(np.float32), device=device)
                 for a in (ref, keep, edt))


def find_optimal_poses(
    vertices,
    faces,
    annotations: Sequence[Dict],
    Ks: Sequence[np.ndarray],
    image_size,
    num_initializations: int = 500,
    num_iterations: int = 50,
    rend_size: int = 256,
    settings: RasterSettings | None = None,
    seed: int = 0,
    lw_chamfer: float = 0.0,
    prune_to: int | str | None = "auto",
    coarse_iterations: int = 35,
    parallel_frames: bool = False,
    refine_scale: float = 0.5,
    candidate_chunk: int = 125,
    device=None,
) -> List[Dict]:
    """Per-frame candidate refinement and best-motion selection (JAX
    poseinit.py:595).

    Defaults, as in the JAX package (prune_to=None, refine_scale=1.0 give
    the exact reference schedule):
      * successive halving (prune_to="auto" = max(C // 4, 16) when C >= 64):
        frame 0 first runs all candidates for `coarse_iterations` at the
        refinement resolution and keeps the best `prune_to` by IoU;
      * low-resolution refinement (refine_scale=0.5): refinement renders at
        half resolution, then one forward-only full-resolution pass rescores
        every frame's candidates before the selection.

    Args:
      vertices: (V, 3) canonical object vertices.
      faces: (F, 3) or MeshTopology.
      annotations: per frame dicts with target_crop_mask (R, R) in
        {-1, 0, 1}, bbox (4,) xywh pixels, square_bbox (x, y, side[, side])
        (the crop of the target mask), and optionally full_mask.
      Ks: per frame (3, 3) pixel intrinsics of the full image.
      image_size: (H, W, ...) of the full image.
      seed: seeds the CPU `torch.Generator` that draws the initial
        rotations (`geometry.random_rotations`).
      parallel_frames: refine frames 1..T-1 together, each from frame 0's
        refined candidates, in chunks of min(3 x candidate_chunk, (T-1) C),
        instead of chaining frame to frame.
      candidate_chunk: candidates rendered together, a bound on memory.
      device: where the search runs (default `cuda`; raises when CUDA is
        absent).
    Returns:
      per frame dicts: rotations (1, 3, 3), translations (1, 1, 3),
      verts_trans (1, V, 3), target_masks (1, R, R), K_roi (1, 3, 3),
      masks, verts (1, V, 3), full_mask (tensors on the device), and
      best_iou, a float; edge_demand, the largest per-tile contour-edge
      demand of every render of the search, and edge_capacity, the edge
      slots a tile had: edges were dropped where the demand exceeds it.
    """
    device = resolve_device(device)
    topo = as_topology(faces, device=device)
    topo = MeshTopology(**{k: v.to(device) for k, v in vars(topo).items()})
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    if settings is None:
        settings = RasterSettings(image_size=rend_size)
    if prune_to == "auto":
        prune_to = (max(num_initializations // 4, 16)
                    if num_initializations >= 64 else None)
    refine_settings = _refine_settings(settings, refine_scale)
    refine_size = refine_settings.image_size
    need_rescore = refine_size != settings.image_size

    def as_K(K):
        return torch.as_tensor(np.asarray(K, np.float32), device=device)

    def refine_evidence(mask):
        return _refine_evidence(mask, refine_size if need_rescore else None,
                                lw_chamfer, device)

    previous_rotations = None
    demands = []  # each refinement's and the rescore's largest edge demand
    all_params = []
    all_ious = []
    full_evidence = []  # (ref, keep, K_roi) per frame, full res, for rescore
    frame_iter = ([(annotations[0], Ks[0])] if parallel_frames
                  and len(annotations) > 1 else list(zip(annotations, Ks)))
    for frame_i, (annot, K) in enumerate(frame_iter):
        mask, ref_full, keep_full, K_roi = _frame_evidence(
            annot, K, rend_size, device)
        ref_r, keep_r, edt_r = refine_evidence(mask)
        full_evidence.append((ref_full, keep_full, K_roi))

        if previous_rotations is None:
            rotations = geo.random_rotations(
                num_initializations,
                generator=torch.Generator().manual_seed(seed), device=device)
        else:
            rotations = previous_rotations
        rot6d, trans = _chain_init(vertices, rotations,
                                   np.asarray(annot["bbox"], np.float32),
                                   as_K(K))

        if prune_to is not None and frame_i == 0 and \
                prune_to < num_initializations:
            c_params, _, c_ious, c_hist = _fit_candidates(
                vertices, topo, ref_r, keep_r, edt_r, K_roi, rot6d, trans,
                refine_settings, num_iterations=coarse_iterations,
                lw_chamfer=0.0, candidate_chunk=candidate_chunk)
            rot6d, trans = _prune_select(c_ious, c_params["rot6d"],
                                         c_params["trans"], prune_to)
            demands.append(c_hist["edge_demand"])

        params, _, ious, hist = _fit_candidates(
            vertices, topo, ref_r, keep_r, edt_r, K_roi, rot6d, trans,
            refine_settings, num_iterations=num_iterations,
            lw_chamfer=lw_chamfer, candidate_chunk=candidate_chunk)

        demands.append(hist["edge_demand"])
        rot_final = geo.rot6d_to_matrix(params["rot6d"])
        previous_rotations = rot_final
        all_params.append({
            "rotations": rot_final,
            "rot6d": params["rot6d"],
            "translations": params["trans"],
            "target_masks": torch.as_tensor(mask, dtype=torch.float32,
                                            device=device),
            "K_roi": K_roi[None],
            "masks": annot.get("full_mask"),
        })
        all_ious.append(ious)

    if parallel_frames and len(annotations) > 1:
        C = all_params[0]["rotations"].shape[0]
        rot0 = all_params[0]["rotations"]  # (C, 3, 3)
        rotated = torch.einsum("vj,cjk->cvk", vertices, rot0)
        rest = list(zip(annotations[1:], Ks[1:]))
        masks_np, refs, keeps, edts, Krois, transs = [], [], [], [], [], []
        for annot, K in rest:
            mask, ref_full, keep_full, K_roi = _frame_evidence(
                annot, K, rend_size, device)
            ref_r, keep_r, edt_r = refine_evidence(mask)
            full_evidence.append((ref_full, keep_full, K_roi))
            masks_np.append(mask)
            refs.append(ref_r)
            keeps.append(keep_r)
            edts.append(edt_r)
            Krois.append(K_roi)
            transs.append(tco_init_from_boxes_autodepth(
                np.asarray(annot["bbox"], np.float32), rotated,
                as_K(K))[:, None, :])
        n_rest = len(rest)
        params, _, ious, hist = _fit_candidates(
            vertices, topo, torch.stack(refs), torch.stack(keeps),
            torch.stack(edts), torch.stack(Krois),
            geo.matrix_to_rot6d(rot0).repeat(n_rest, 1, 1),
            torch.cat(transs), refine_settings,
            num_iterations=num_iterations, lw_chamfer=lw_chamfer,
            candidate_chunk=min(3 * candidate_chunk, n_rest * C), group=C)
        demands.append(hist["edge_demand"])
        rot_final = geo.rot6d_to_matrix(params["rot6d"]).reshape(
            n_rest, C, 3, 3)
        rot6d_final = params["rot6d"].reshape(n_rest, C, 3, 2)
        trans_final = params["trans"].reshape(n_rest, C, 1, 3)
        for i, (annot, K) in enumerate(rest):
            all_params.append({
                "rotations": rot_final[i],
                "rot6d": rot6d_final[i],
                "translations": trans_final[i],
                "target_masks": torch.as_tensor(masks_np[i],
                                                dtype=torch.float32,
                                                device=device),
                "K_roi": Krois[i][None],
                "masks": annot.get("full_mask"),
            })
            all_ious.append(ious.reshape(n_rest, C)[i])

    if need_rescore:
        # One forward-only full-resolution pass over every frame's refined
        # candidates; each frame's evidence is read by its C candidates.
        C = all_params[0]["rotations"].shape[0]
        T = len(all_params)
        ious_full, demand = _score_candidates(
            vertices, topo, *(torch.stack([ev[i] for ev in full_evidence])
                              for i in range(3)),
            torch.cat([p["rot6d"] for p in all_params]),
            torch.cat([p["translations"] for p in all_params]), settings,
            candidate_chunk=candidate_chunk, group=C)
        demands.append(demand)
        all_ious = list(ious_full.reshape(T, C))

    rot_all = torch.stack([p["rotations"] for p in all_params])
    trans_all = torch.stack([p["translations"] for p in all_params])
    R_sel, t_sel, vt_sel, _, best_iou = _select_best(
        rot_all, trans_all, torch.stack(all_ious), vertices)
    best_iou = float(best_iou)
    edge_demand = int(torch.stack(demands).max())
    edge_capacity = min(settings.edges_per_tile, int(topo.edges.shape[0]))
    final = []
    for ti, frame_params in enumerate(all_params):
        final.append({
            "rotations": R_sel[ti][None],
            "translations": t_sel[ti][None],
            "verts_trans": vt_sel[ti][None],
            "target_masks": frame_params["target_masks"][None],
            "K_roi": frame_params["K_roi"],
            "masks": frame_params["masks"],
            "verts": vertices[None],
            "full_mask": frame_params["masks"],
            "best_iou": best_iou,
            "edge_demand": edge_demand,
            "edge_capacity": edge_capacity,
        })
    return final


def search_edge_settings(vertices, faces, annotation: Dict, K,
                         settings: RasterSettings,
                         num_initializations: int = 500, seed: int = 0,
                         rend_size: int = 256, refine_scale: float = 0.5,
                         device=None):
    """Edge slots for find_optimal_poses from the contour-edge demand of
    its initial candidates: frame 0's `num_initializations` rotations drawn
    from `seed` as the search draws them, placed by `_chain_init` in the
    frame's crop (`annotation`, pixel intrinsics K).

    The demand is measured at the refinement's size and at the full
    (rescore) size, each sized by auto_edge_settings (x1.3, the next
    bucket, halving the tile where no bucket fits); the search takes the
    smaller tile and the larger Ke. Returns (settings, {"refine",
    "rescore"}: the measured maximum demand at each size).
    """
    device = resolve_device(device)
    topo = as_topology(faces, device=device)
    topo = MeshTopology(**{k: v.to(device) for k, v in vars(topo).items()})
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    rotations = geo.random_rotations(
        num_initializations, generator=torch.Generator().manual_seed(seed),
        device=device)
    _, _, _, K_roi = _frame_evidence(annotation, K, rend_size, device)
    _, trans = _chain_init(
        vertices, rotations, np.asarray(annotation["bbox"], np.float32),
        torch.as_tensor(np.asarray(K, np.float32), device=device))
    with torch.no_grad():
        verts = torch.einsum("vj,cjk->cvk", vertices, rotations) + trans
    K_all = K_roi.expand(num_initializations, 3, 3)
    sized, demand = [], {}
    for name, st in (("refine", _refine_settings(settings, refine_scale)),
                     ("rescore", settings)):
        demand[name] = check_edge_budget(verts, topo, K_all,
                                         st)["max_demand"]
        sized.append(auto_edge_settings(verts, topo, K_all, st))
    return dataclasses.replace(
        settings, tile_px=min(x.tile_px for x in sized),
        edges_per_tile=max(x.edges_per_tile for x in sized)), demand
