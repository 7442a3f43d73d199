"""Converters from the reference implementation's (hassony2/homan)
artifacts into the port's evidence formats (homan_tpu/frontend/adapters.py).

The reference records three kinds of per-clip artifacts:
  * per-frame person_parameters dicts from its FrankMocap post-processing:
    hands concatenated along dim 0, torch tensors, a "hand_side" list;
  * per-box PointRend annotations: {bbox, class_id, full_mask, score,
    square_bbox, crop_mask};
  * indep_fit.pkl stage checkpoints: {person_parameters (per-frame list),
    object_parameters (per-frame list), obj_verts_can, obj_faces,
    super2d_img_path}.

These converters turn them into (a) CachedEvidence frame records that
`fit_video --evidence_root` replays, and (b) an independent-fit payload that
cli/fit_video.py build_joint_inputs takes as it is. Every output holds
numpy arrays only: records written here replay in the JAX package too.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from homan_tpu_torch.frontend.evidence import save_frame_evidence


def _np(x):
    """numpy view of an array, a torch tensor (on any device) or a
    number."""
    if hasattr(x, "detach"):
        x = x.detach()
    if hasattr(x, "cpu"):
        x = x.cpu()
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(x)


def _norm_side(side: str) -> str:
    side = str(side)
    return side if side.endswith("_hand") else f"{side}_hand"


def convert_person_parameters(frame_params: Dict):
    """Reference per-frame person_parameters -> per-side evidence.

    frame_params: hands stacked along dim 0; "hand_side" (or "label") is a
    list of side names. Returns (estimates {side: est}, hand_masks {side:
    (H, W)}, hand_bboxes {side: (4,) xyxy}) in the HandPoseProvider layout
    (frontend/evidence.py).
    """
    sides_raw = frame_params.get("hand_side", frame_params.get("label"))
    if isinstance(sides_raw, str):
        sides_raw = [sides_raw]
    sides = [_norm_side(s) for s in sides_raw]
    estimates, hand_masks, hand_bboxes = {}, {}, {}
    keys = ("verts", "verts2d", "rotations", "translations", "mano_pca_pose",
            "mano_rot", "mano_trans", "mano_betas", "cams")
    for h, side in enumerate(sides):
        est = {}
        for k in keys:
            if k in frame_params:
                est[k] = _np(frame_params[k])[h].astype(np.float32)
        if "translations" in est and est["translations"].ndim == 1:
            est["translations"] = est["translations"][None]
        estimates[side] = est
        if "masks" in frame_params:
            hand_masks[side] = _np(frame_params["masks"])[h]
        if "bboxes" in frame_params:
            hand_bboxes[side] = _np(frame_params["bboxes"])[h].astype(
                np.float32)
    return estimates, hand_masks, hand_bboxes


def convert_pointrend_annotations(annotations: Sequence[Dict],
                                  hand_class: int = 0) -> List[Dict]:
    """PointRend per-box dicts -> CachedEvidence mask entries
    ({"full_mask", "score", "class_id"}).

    The reference queries hands with the COCO person class (0), so hand
    annotations carry class_id 0; objects are queried with their most
    likely class and carry that COCO id. Here class_id == hand_class
    becomes a hand (0), any other id the object (-1).
    """
    out = []
    for a in annotations:
        class_id = int(_np(a["class_id"])) if "class_id" in a else hand_class
        out.append({
            "full_mask": _np(a["full_mask"]).astype(bool),
            "score": float(_np(a["score"])) if "score" in a else 1.0,
            "class_id": 0 if class_id == hand_class else -1,
        })
    return out


def record_cached_evidence(root: str, frame_key: str,
                           person_params: Optional[Dict] = None,
                           object_full_mask: Optional[np.ndarray] = None,
                           object_score: float = 1.0,
                           extra_mask_annotations: Sequence[Dict] = ()):
    """Write one frame's reference artifacts as a CachedEvidence record.

    Hand masks (person_params["masks"]) are stored with class_id 0 and
    their hand_side, in side order; the object mask with class_id -1; any
    extra PointRend annotations are appended converted. Returns (masks,
    estimates) as written.
    """
    estimates, hand_masks, _ = (convert_person_parameters(person_params)
                                if person_params else ({}, {}, {}))
    masks: List[Dict] = [{"full_mask": np.asarray(m).astype(bool),
                          "score": 1.0, "class_id": 0, "hand_side": side}
                         for side, m in hand_masks.items()]
    if object_full_mask is not None:
        masks.append({"full_mask": np.asarray(object_full_mask).astype(bool),
                      "score": object_score, "class_id": -1})
    masks.extend(convert_pointrend_annotations(extra_mask_annotations))
    save_frame_evidence(root, frame_key, masks, estimates)
    return masks, estimates


def convert_indep_fit(indep: Dict) -> Dict:
    """Reference indep_fit.pkl payload -> the port's independent-fit payload
    (build_joint_inputs takes it as it is, so a reference stage-1
    checkpoint can be resumed).

    The reference keeps person_parameters as a per-frame list with the hands
    concatenated along dim 0: concatenating the frames gives the interleaved
    [h1_t1, h2_t1, h1_t2, ...] rows that build_joint_inputs expects.
    """
    person_frames = indep["person_parameters"]
    first = person_frames[0]
    sides_raw = first.get("hand_side", first.get("label"))
    if isinstance(sides_raw, str):
        sides_raw = [sides_raw]
    hand_sides = [_norm_side(s).replace("_hand", "") for s in sides_raw]

    keys = ["verts", "verts2d", "rotations", "translations",
            "mano_pca_pose", "mano_rot", "mano_trans", "mano_betas",
            "target_masks", "K_roi", "masks", "bboxes"]
    person_parameters = {}
    for k in keys:
        if k in first:
            person_parameters[k] = np.concatenate(
                [_np(f[k]).astype(np.float32) for f in person_frames])
    person_parameters["hand_sides"] = hand_sides

    object_parameters = []
    for o in indep["object_parameters"]:
        conv = {k: _np(o[k]).astype(np.float32)
                for k in ("rotations", "translations", "target_masks",
                          "K_roi") if k in o}
        conv["masks"] = (_np(o["masks"]).astype(np.float32)
                         if o.get("masks") is not None else
                         _np(o["full_mask"]).astype(np.float32)
                         if o.get("full_mask") is not None else None)
        if conv.get("target_masks") is not None and \
                conv["target_masks"].ndim == 2:
            conv["target_masks"] = conv["target_masks"][None]
        object_parameters.append(conv)

    obj_verts_can = _np(indep["obj_verts_can"]).astype(np.float32)
    if obj_verts_can.ndim == 3:
        obj_verts_can = obj_verts_can[0]
    obj_faces = _np(indep["obj_faces"])
    if obj_faces.ndim == 3:
        obj_faces = obj_faces[0]
    return {
        "person_parameters": person_parameters,
        "object_parameters": object_parameters,
        "obj_verts_can": obj_verts_can,
        "obj_faces": obj_faces.astype(np.int32),
        "hand_sides": hand_sides,
    }


STATE_KEYS = ("translations_object", "rotations_object", "translations_hand",
              "rotations_hand", "mano_pca_pose", "mano_rot", "mano_trans",
              "mano_betas", "int_scales_object", "int_scales_hand",
              "cams_hand")


def convert_joint_fit_state(state_dict: Dict) -> Dict[str, np.ndarray]:
    """Reference joint_fit.pt state_dict -> the port's checkpoint dict.

    The reference's parameter names match HomanState's fields one to one
    (rotations as rot6d (B, 3, 2)); its buffers (masks, intrinsics, MANO
    tables) are dropped: they are rebuilt from the dataset and the evidence
    on load.
    """
    out = {}
    for k in STATE_KEYS:
        if k in state_dict:
            out[k] = _np(state_dict[k]).astype(np.float32)
    for k in ("int_scales_object", "int_scales_hand"):
        if k in out:
            out[k] = out[k].reshape(-1)[:1]
    return out
