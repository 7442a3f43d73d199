"""The joint hand+object scene model (counterpart of homan_tpu/fit/model.py).

`HomanState` holds the optimizable tensors, `HomanConsts` the fixed evidence
and model data, `HomanConfig` the static configuration. The getters
reproduce the reference's forward kinematics and detach topology:

  * get_verts_object: |scale| -> rot6d -> translate
  * get_verts_hand: MANO PCA forward per hand side on the interleaved
    [h1_t1, h2_t1, h1_t2, ...] batch, plus the twin whose articulation
    gradient is detached so interaction terms only steer the rigid transform
  * get_joints_hand: fingertips + 21-joint reorder
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from homan_tpu_torch.core import camera as cam
from homan_tpu_torch.core import geometry as geo
from homan_tpu_torch.core import mano as mano_lib


@dataclasses.dataclass
class HomanState:
    """Optimizable parameters. B = frame_nb; hands use B*hand_nb rows."""
    translations_object: torch.Tensor  # (B, 1, 3)
    rotations_object: torch.Tensor     # (B, 3, 2) rot6d
    translations_hand: torch.Tensor    # (B*H, 1, 3)
    rotations_hand: torch.Tensor       # (B*H, 3, 2) rot6d
    mano_pca_pose: torch.Tensor        # (B*H, P)
    mano_rot: torch.Tensor             # (B*H, 3)   frozen
    mano_trans: torch.Tensor           # (B*H, 3)   frozen
    mano_betas: torch.Tensor           # (B*H, 10)
    int_scales_object: torch.Tensor    # (1,)
    int_scales_hand: torch.Tensor      # (1,)
    cams_hand: torch.Tensor = None     # (B*H, 3), "ortho" mode only

    def map(self, fn) -> "HomanState":
        """A new state with fn applied to every tensor field."""
        return HomanState(**{
            f.name: (None if getattr(self, f.name) is None
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class HomanConfig:
    """Static model configuration."""
    hand_sides: Tuple[str, ...] = ("right",)
    image_size: int = 640
    rend_size: int = 256
    optimize_mano: bool = True
    optimize_mano_beta: bool = True
    optimize_object_scale: bool = False
    optimize_ortho_cam: bool = True
    hand_proj_mode: str = "persp"  # or "ortho"
    inter_type: str = "centroid"  # or "min"
    pca_comps: int = 16
    sdf_mode: str = "direct"
    collision_mode: str = "sdf"

    @property
    def hand_nb(self) -> int:
        return len(self.hand_sides)


@dataclasses.dataclass
class HomanConsts:
    """Fixed evidence and model data, on the fit's device."""
    verts_object_og: torch.Tensor      # (Vo, 3) canonical object
    faces_object: Any                  # MeshTopology
    verts_hand_og: torch.Tensor        # (B*H, 778, 3)
    faces_hand: Any                    # MeshTopology
    ref_verts2d_hand: torch.Tensor     # (B*H, 778, 2) pixel coords
    ref_mask_object: torch.Tensor      # (B, R, R)
    keep_mask_object: torch.Tensor     # (B, R, R)
    ref_mask_hand: torch.Tensor        # (B*H, R, R)
    keep_mask_hand: torch.Tensor       # (B*H, R, R)
    camintr_rois_object: torch.Tensor  # (B, 3, 3) normalized ROI K
    camintr_rois_hand: torch.Tensor    # (B*H, 3, 3)
    camintr: torch.Tensor              # (B, 3, 3) normalized full-image K
    mano_params_by_side: Dict[str, Any]  # side -> MANO param dict
    masks_object: torch.Tensor         # (B, S, S)
    masks_hand: torch.Tensor           # (B*H, S, S)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_state(cfg: HomanConfig, translations_object, rotations_object,
               translations_hand, rotations_hand, mano_pca_pose, mano_rot,
               mano_trans, mano_betas, cams_hand=None,
               int_scale_init: float = 1.0, device=None) -> HomanState:
    """Build the state (3x3 rotations -> rot6d, betas zeroed)."""
    rot_o = _f32(rotations_object, device)
    if rot_o.shape[-1] == 3:
        rot_o = geo.matrix_to_rot6d(rot_o)
    rot_h = _f32(rotations_hand, device)
    if rot_h.shape[-1] == 3:
        rot_h = geo.matrix_to_rot6d(rot_h)
    dev = rot_o.device
    return HomanState(
        translations_object=_f32(translations_object, dev),
        rotations_object=rot_o.contiguous(),
        translations_hand=_f32(translations_hand, dev),
        rotations_hand=rot_h.contiguous(),
        mano_pca_pose=_f32(mano_pca_pose, dev),
        mano_rot=_f32(mano_rot, dev),
        mano_trans=_f32(mano_trans, dev),
        mano_betas=torch.zeros_like(_f32(mano_betas, dev)),
        int_scales_object=torch.ones(1, device=dev) * int_scale_init,
        int_scales_hand=torch.ones(1, device=dev) * int_scale_init,
        cams_hand=(_f32(cams_hand, dev) if cams_hand is not None
                   else torch.zeros((rot_h.shape[0], 3), device=dev)),
    )


def get_verts_object_parts(rot6d, trans, scale, verts_og):
    """get_verts_object from its four leaves (rot6d (B, 3, 2), trans
    (B, 1, 3), scale (1,), verts_og (Vo, 3)), for callers that hold no
    consts (the driver's edge-budget check)."""
    R = geo.rot6d_to_matrix(rot6d)
    return cam.compute_transformation_persp(verts_og, trans, R,
                                            torch.abs(scale))


def get_verts_object(state: HomanState, consts: HomanConsts):
    """(B, Vo, 3) posed object vertices (+ mesh-detached twin)."""
    return get_verts_object_parts(state.rotations_object,
                                  state.translations_object,
                                  state.int_scales_object,
                                  consts.verts_object_og)


def _mano_verts_all_sides(state: HomanState, consts: HomanConsts,
                          cfg: HomanConfig, want_joints: bool = False):
    """MANO per hand side on the strided slices, re-interleaved; verts
    (B*H, 778, 3) [+ joints (B*H, 16, 3)] shifted by mano_trans."""
    h = cfg.hand_nb
    verts_l, joints_l = [], []
    for idx, side in enumerate(cfg.hand_sides):
        p = consts.mano_params_by_side[side]
        pca = state.mano_pca_pose[idx::h][..., : cfg.pca_comps]
        aa = mano_lib.pca_to_axis_angle(p, pca, is_left=(side == "left"))
        out = mano_lib.mano_forward(p, state.mano_betas[idx::h],
                                    state.mano_rot[idx::h], aa)
        verts_l.append(out["verts"])
        joints_l.append(out["joints"])
    verts = torch.stack(verts_l, dim=1).reshape(-1, mano_lib.NUM_VERTS, 3)
    verts = verts + state.mano_trans[:, None, :]
    if not want_joints:
        return verts, None
    joints = torch.stack(joints_l, dim=1).reshape(-1, joints_l[0].shape[1], 3)
    return verts, joints


def get_verts_hand(state: HomanState, consts: HomanConsts, cfg: HomanConfig,
                   detach_scale: bool = False):
    """(B*H, 778, 3) posed hand vertices (+ articulation-detached twin)."""
    if cfg.optimize_mano:
        verts_og, _ = _mano_verts_all_sides(state, consts, cfg)
    else:
        verts_og = consts.verts_hand_og
    scale = state.int_scales_hand
    if detach_scale:
        scale = scale.detach()
    if cfg.hand_proj_mode == "ortho":
        K = torch.repeat_interleave(consts.camintr, cfg.hand_nb, dim=0)
        return cam.compute_transformation_ortho(
            verts_og, state.cams_hand, intrinsic_scales=scale, K=K,
            image_size=cfg.image_size)
    R = geo.rot6d_to_matrix(state.rotations_hand)
    return cam.compute_transformation_persp(
        verts_og, state.translations_hand, R, scale)


def get_joints_hand(state: HomanState, consts: HomanConsts,
                    cfg: HomanConfig):
    """(B*H, 21, 3) posed 21-joint skeletons."""
    verts_og, joints16 = _mano_verts_all_sides(state, consts, cfg,
                                               want_joints=True)
    joints21 = mano_lib.add_tips_and_reorder(
        verts_og - state.mano_trans[:, None], joints16)
    joints21 = joints21 + state.mano_trans[:, None, :]
    R = geo.rot6d_to_matrix(state.rotations_hand)
    out, _ = cam.compute_transformation_persp(
        joints21, state.translations_hand, R, state.int_scales_hand)
    return out


def optimizer_param_labels(cfg: HomanConfig) -> Dict[str, str]:
    """Adam group of each state field: 'rigid' (lr), 'mano' (10 lr),
    'rot' (10 lr) or 'frozen' (never updated)."""
    scale_obj = "rigid" if cfg.optimize_object_scale else "frozen"
    scale_hand = "frozen" if cfg.optimize_mano_beta else "rigid"
    mano = "mano" if cfg.optimize_mano else "frozen"
    betas = "mano" if cfg.optimize_mano_beta else "frozen"
    cams = ("rigid" if (cfg.hand_proj_mode == "ortho"
                        and cfg.optimize_ortho_cam) else "frozen")
    return {
        "translations_object": "rigid",
        "rotations_object": "rot",
        "translations_hand": "rigid",
        "rotations_hand": "rot",
        "mano_pca_pose": mano,
        "mano_rot": "frozen",
        "mano_trans": "frozen",
        "mano_betas": betas,
        "int_scales_object": scale_obj,
        "int_scales_hand": scale_hand,
        "cams_hand": cams,
    }
