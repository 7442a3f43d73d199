"""Synthetic ground-truth evidence (homan_tpu/frontend/gtsynth.py:47-233).

Builds a clip with an object and hand(s) moving smoothly in front of a
camera, renders the evidence from the ground truth (forward-only shade
kernel), optionally the image-sized entity masks of the ordinal-depth loss,
and perturbs an initial state for the fit to recover.

The JAX version draws the object's starting rotation from `jax.random`;
here the caller passes it as `obj_rot0`. Everything else comes from the
numpy seed, so both packages build the same scene from the same inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core import camera as cam
from homan_tpu_torch.core import geometry as geo
from homan_tpu_torch.core.mano import ManoLayer
from homan_tpu_torch.core.meshes import bumpy_potato
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.render.rasterizer import (MeshTopology, RasterSettings,
                                               rasterize_soft)


@dataclasses.dataclass
class SyntheticScene:
    consts: M.HomanConsts
    cfg: M.HomanConfig
    gt_state: M.HomanState
    init_state: M.HomanState
    gt_verts_object: torch.Tensor  # (B, Vo, 3)
    gt_verts_hand: torch.Tensor    # (B*H, 778, 3)
    closed_hand_faces: torch.Tensor  # (F, 3) hand topology of the SDF terms
    roi_settings: RasterSettings


def _smooth_trajectory(rng, frame_nb, scale):
    """Per-frame small offsets that vary smoothly over time."""
    t = np.linspace(0, 1, frame_nb)[:, None]
    freq = rng.uniform(0.5, 1.5, (1, 3))
    phase = rng.uniform(0, 2 * np.pi, (1, 3))
    return scale * np.sin(2 * np.pi * freq * t + phase)


def make_synthetic_scene(
    obj_rot0,
    seed: int = 0,
    frame_nb: int = 5,
    hand_sides=("right",),
    image_size: int = 128,
    rend_size: int = 64,
    obj_subdiv: int = 2,
    obj_radius: float = 0.08,
    perturb: float = 0.04,
    mano_layer: ManoLayer | None = None,
    obj_mesh=None,
    with_full_masks: bool = False,
    device=None,
) -> SyntheticScene:
    """obj_rot0: (3, 3) starting object rotation (row-vector convention).
    with_full_masks: also render the image-sized entity masks that only the
    ordinal-depth loss reads (left zero otherwise).
    device: where the scene lives (default `cuda`; raises without CUDA)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    cfg = M.HomanConfig(hand_sides=tuple(hand_sides), image_size=image_size,
                        rend_size=rend_size)
    H = cfg.hand_nb
    B = frame_nb

    layer = (mano_layer if mano_layer is not None
             else ManoLayer.synthetic(seed, device=dev))
    if obj_mesh is None:
        overts, ofaces = bumpy_potato(obj_subdiv, obj_radius, seed=seed)
    else:
        overts, ofaces = obj_mesh
    overts = torch.as_tensor(np.asarray(overts), dtype=torch.float32,
                             device=dev)
    obj_topo = MeshTopology.from_faces(ofaces, device=dev)

    # --- Ground-truth trajectories ---------------------------------------
    base_depth = 0.6
    obj_trans = np.tile([0.0, 0.0, base_depth], (B, 1)) + _smooth_trajectory(
        rng, B, 0.03)
    obj_rot0 = np.asarray(obj_rot0, np.float32)
    obj_rots = []
    for t in range(B):
        delta = geo.rodrigues(torch.tensor(
            0.1 * t * np.array([0.0, 1.0, 0.0]), dtype=torch.float32))
        obj_rots.append(delta.numpy() @ obj_rot0)
    obj_rots = np.stack(obj_rots)

    hand_trans = np.zeros((B * H, 1, 3), np.float32)
    hand_rots = np.zeros((B * H, 3, 3), np.float32)
    mano_pca = np.zeros((B * H, cfg.pca_comps), np.float32)
    mano_rot = np.zeros((B * H, 3), np.float32)
    mano_trans = np.zeros((B * H, 3), np.float32)
    for h in range(H):
        side_off = 0.18 if h == 0 else -0.18
        traj = _smooth_trajectory(rng, B, 0.02)
        for t in range(B):
            i = t * H + h
            hand_trans[i, 0] = [side_off * 0.5, 0.0, base_depth] + traj[t]
            hand_rots[i] = np.eye(3)
            # The JAX version draws (and discards) a randn here: keep the
            # numpy stream aligned.
            mano_pca[i] = 0.25 * rng.randn(cfg.pca_comps) * 0 + \
                0.25 * np.sin(np.arange(cfg.pca_comps) + t * 0.3)
            mano_trans[i] = [side_off * 0.2, 0.0, 0.0]

    gt_state = M.init_state(
        cfg,
        translations_object=obj_trans[:, None, :],
        rotations_object=obj_rots,
        translations_hand=hand_trans,
        rotations_hand=hand_rots,
        mano_pca_pose=mano_pca,
        mano_rot=mano_rot,
        mano_trans=mano_trans,
        mano_betas=np.zeros((B * H, 10), np.float32),
        device=dev,
    )

    # --- Camera ------------------------------------------------------------
    K_px = np.array([[image_size * 0.9, 0, image_size / 2],
                     [0, image_size * 0.9, image_size / 2],
                     [0, 0, 1]], np.float32)
    camintr = cam.normalize_K(torch.from_numpy(K_px), image_size)[None].repeat(
        B, 1, 1).to(dev)
    # Evidence is rendered over the full image re-scaled to rend_size
    # (identity ROI): normalized intrinsics are resolution-free.
    rois_object = camintr
    rois_hand = torch.repeat_interleave(camintr, H, dim=0)

    mano_params_by_side = {s: layer.params[s] for s in cfg.hand_sides}
    hand_topo = MeshTopology.from_faces(layer.faces("right"), device=dev)
    faces_hand = hand_topo.faces

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    consts_partial = M.HomanConsts(
        verts_object_og=overts,
        faces_object=obj_topo,
        verts_hand_og=zeros(B * H, 778, 3),
        faces_hand=hand_topo,
        ref_verts2d_hand=zeros(B * H, 778, 2),
        ref_mask_object=zeros(B, rend_size, rend_size),
        keep_mask_object=torch.ones((B, rend_size, rend_size), device=dev),
        ref_mask_hand=zeros(B * H, rend_size, rend_size),
        keep_mask_hand=torch.ones((B * H, rend_size, rend_size), device=dev),
        camintr_rois_object=rois_object,
        camintr_rois_hand=rois_hand,
        camintr=camintr,
        mano_params_by_side=mano_params_by_side,
        masks_object=zeros(B, image_size, image_size),
        masks_hand=zeros(B * H, image_size, image_size),
    )

    # --- Render GT evidence (forward-only shading) ---------------------------
    roi_settings = RasterSettings(image_size=rend_size, tile_px=16)
    with torch.no_grad():
        gt_verts_object, _ = M.get_verts_object(gt_state, consts_partial)
        gt_verts_hand, _ = M.get_verts_hand(gt_state, consts_partial, cfg)
        obj_sil = rasterize_soft(gt_verts_object, obj_topo, rois_object,
                                 roi_settings)["sil"] > 0.5
        hand_sil = rasterize_soft(gt_verts_hand, hand_topo, rois_hand,
                                  roi_settings)["sil"] > 0.5
        # Occlusion-aware targets: -1 where the other entity covers the
        # pixel.
        minus_one = torch.tensor(-1.0, device=dev)
        hand_per_frame = hand_sil.reshape(B, H, rend_size, rend_size).any(1)
        obj_target = torch.where(hand_per_frame & ~obj_sil, minus_one,
                                 obj_sil.to(torch.float32))
        obj_occl = torch.repeat_interleave(obj_sil, H, dim=0)
        hand_target = torch.where(obj_occl & ~hand_sil, minus_one,
                                  hand_sil.to(torch.float32))
        ref_verts2d = cam.batch_proj2d(gt_verts_hand, rois_hand) * image_size
        if with_full_masks:
            full = RasterSettings(image_size=image_size, tile_px=16)
            masks_object = (rasterize_soft(gt_verts_object, obj_topo,
                                           camintr, full)["sil"] > 0.5).to(
                torch.float32)
            masks_hand = (rasterize_soft(gt_verts_hand, hand_topo,
                                         rois_hand, full)["sil"] > 0.5).to(
                torch.float32)
        else:
            masks_object = consts_partial.masks_object
            masks_hand = consts_partial.masks_hand

    consts = dataclasses.replace(
        consts_partial,
        verts_hand_og=gt_verts_hand,
        ref_verts2d_hand=ref_verts2d,
        ref_mask_object=(obj_target > 0).to(torch.float32),
        keep_mask_object=(obj_target >= 0).to(torch.float32),
        ref_mask_hand=(hand_target > 0).to(torch.float32),
        keep_mask_hand=(hand_target >= 0).to(torch.float32),
        masks_object=masks_object,
        masks_hand=masks_hand,
    )

    # --- Perturbed init ------------------------------------------------------
    def jitter(x, s):
        noise = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
        return x + noise.to(dev) * s

    init_state = dataclasses.replace(
        gt_state,
        translations_object=jitter(gt_state.translations_object, perturb),
        rotations_object=jitter(gt_state.rotations_object, perturb),
        translations_hand=jitter(gt_state.translations_hand, perturb),
        rotations_hand=jitter(gt_state.rotations_hand, perturb),
        mano_pca_pose=jitter(gt_state.mano_pca_pose, perturb * 5),
    )
    # The synthetic hand's faces stand in for the closed-fist topology of
    # the SDF terms.
    return SyntheticScene(
        consts=consts, cfg=cfg, gt_state=gt_state, init_state=init_state,
        gt_verts_object=gt_verts_object, gt_verts_hand=gt_verts_hand,
        closed_hand_faces=faces_hand, roi_settings=roi_settings)
