"""Final hand and object geometry from a saved fit state
(homan_tpu/fit/postprocess.py): MANO and the perspective transforms re-run
from the checkpointed parameters, without the evidence consts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from homan_tpu_torch.fit import model as M


def state_to_dict(state: M.HomanState) -> Dict[str, np.ndarray]:
    """Checkpoint payload: every state field as a host numpy array."""
    return {k: v.detach().cpu().numpy() for k, v in vars(state).items()
            if v is not None}


def state_from_dict(d: Dict[str, np.ndarray], device=None) -> M.HomanState:
    """The state of a checkpoint payload, on `device` (default the CPU).
    Checkpoints without cams_hand (from before the ortho mode) get zeros."""
    d = dict(d)
    if "cams_hand" not in d:
        d["cams_hand"] = np.zeros(
            (np.asarray(d["rotations_hand"]).shape[0], 3), np.float32)
    return M.HomanState(**{k: torch.as_tensor(np.asarray(v), device=device)
                           for k, v in d.items()})


def post_process(state: M.HomanState, mano_params_by_side: Dict,
                 verts_object_og, cfg: M.HomanConfig,
                 verts_hand_og=None) -> Dict:
    """verts_object (B, Vo, 3), verts_hand (B*H, 778, 3) and joints_hand
    (B*H, 21, 3) of a state, on the state's device, without gradient.

    verts_hand_og: (B*H, 778, 3) local-frame hand verts, needed when
    cfg.optimize_mano is False (the rigid path poses the stored verts
    instead of running MANO).
    """
    def t(x):
        return None if x is None else torch.as_tensor(x).to(
            state.translations_object.device)

    consts_min = M.HomanConsts(
        verts_object_og=t(verts_object_og), faces_object=None,
        verts_hand_og=t(verts_hand_og), faces_hand=None,
        ref_verts2d_hand=None, ref_mask_object=None, keep_mask_object=None,
        ref_mask_hand=None, keep_mask_hand=None, camintr_rois_object=None,
        camintr_rois_hand=None, camintr=None,
        mano_params_by_side=mano_params_by_side,
        masks_object=None, masks_hand=None)
    with torch.no_grad():
        verts_object, _ = M.get_verts_object(state, consts_min)
        verts_hand, _ = M.get_verts_hand(state, consts_min, cfg)
        joints_hand = M.get_joints_hand(state, consts_min, cfg)
    return {"verts_object": verts_object, "verts_hand": verts_hand,
            "joints_hand": joints_hand}
