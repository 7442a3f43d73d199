"""Per-frame 2D and 3D evidence assembly behind pluggable detector backends
(homan_tpu/frontend/evidence.py).

The detectors (a FrankMocap-style hand regressor, a PointRend-style
segmenter, a 100DOH-style hand-object detector) are evidence providers
behind two small protocols, with interchangeable implementations:

  * CachedEvidence — replays detections recorded to disk (the production
    path: the detectors run offline or elsewhere);
  * callables the user supplies with the same signatures;
  * GT synthesis for tests and benchmarks (frontend/gtevidence.py).

The assembled per-frame outputs keep the reference's dict layouts
(person_parameters, obj_mask_infos), so the fitting stages do not depend on
where the evidence came from. Everything here is host numpy: records and
their assembly hold numpy arrays only (stack_person_parameters keeps only
numpy values).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from homan_tpu_torch.core import bbox as bbox_ops
from homan_tpu_torch.frontend import masks as mask_lib

logger = logging.getLogger(__name__)

REND_SIZE = mask_lib.REND_SIZE
BBOX_EXPANSION_FACTOR = 0.3
MEMO_FRAMES = 128  # frame records CachedEvidence keeps unpickled


class MaskProvider(Protocol):
    """Instance masks for given boxes (the PointRend contract)."""

    def masks_from_bboxes(self, image: np.ndarray, boxes_xyxy: np.ndarray,
                          class_ids: Sequence[int]) -> List[Dict]:
        """Returns per box: {"full_mask" (H, W) bool, "score" float}."""
        ...


class HandPoseProvider(Protocol):
    """MANO estimates for hand crops (the FrankMocap contract)."""

    def regress(self, image: np.ndarray, hand_bboxes: Dict[str, np.ndarray]
                ) -> Dict[str, Dict]:
        """Returns per side: {"verts" (778, 3), "verts2d" (778, 2),
        "mano_pca_pose" (P,), "mano_rot" (3,), "mano_betas" (10,),
        "mano_trans" (3,), "rotations" (3, 3), "translations" (1, 3),
        "cams" (3,)}."""
        ...


@dataclasses.dataclass
class CachedEvidence:
    """Replays per-frame evidence recorded by `save_frame_evidence`.

    Mask queries dispatch on class: entries recorded with "class_id" == -1
    answer object queries (class_ids == [-1]); every other entry answers
    hand queries, in the order recorded. Entries without "class_id" are
    returned for every query (older records).
    """
    root: str
    _memo: Dict = dataclasses.field(default_factory=dict, repr=False)

    def _load(self, frame_key: str) -> Dict:
        # A clip's assembly reads each record about five times (tight boxes
        # of object and hands; get_frame_infos: the estimates, the hand
        # masks, the object mask): the unpickled records are kept, the
        # oldest dropped first past MEMO_FRAMES (records hold
        # full-resolution masks).
        if frame_key not in self._memo:
            if len(self._memo) >= MEMO_FRAMES:
                self._memo.pop(next(iter(self._memo)))
            with open(os.path.join(self.root, f"{frame_key}.pkl"),
                      "rb") as f:
                self._memo[frame_key] = pickle.load(f)
        return self._memo[frame_key]

    def masks_from_bboxes(self, frame_key, boxes_xyxy, class_ids):
        masks = self._load(frame_key)["masks"]
        if not masks or "class_id" not in masks[0]:
            return masks
        want_object = bool(class_ids) and class_ids[0] == -1
        return [m for m in masks if (m["class_id"] == -1) == want_object]

    def regress(self, frame_key, hand_bboxes):
        return self._load(frame_key)["hands"]


def save_frame_evidence(root: str, frame_key: str, masks: List[Dict],
                        hands: Dict[str, Dict]):
    """Record one frame's evidence as {root}/{frame_key}.pkl. `masks`
    entries should carry "class_id" (-1 the object, 0 a hand) so replay
    can split the queries."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"{frame_key}.pkl"), "wb") as f:
        pickle.dump({"masks": masks, "hands": hands}, f)


def square_bbox_with_expansion(bbox_xyxy: np.ndarray,
                               expansion: float = BBOX_EXPANSION_FACTOR
                               ) -> np.ndarray:
    """Square xywh crop box around a detection."""
    return bbox_ops.make_bbox_square(bbox_ops.bbox_xy_to_wh(bbox_xyxy),
                                     bbox_expansion=expansion)


def build_object_mask_info(full_mask: np.ndarray, bbox_xyxy: np.ndarray,
                           occluder_masks: Optional[np.ndarray],
                           rend_size: int = REND_SIZE) -> Dict:
    """Object evidence for one frame.

    full_mask (H, W) object instance mask; bbox_xyxy (4,) tight object box;
    occluder_masks (N, H, W) hand masks occluding the object, or None.
    Returns bbox (xywh), square_bbox (xywh), full_mask, crop_mask (R, R) and
    target_crop_mask in {-1, 0, 1}.
    """
    full_mask = np.asarray(full_mask, np.float32)
    bbox_wh = bbox_ops.bbox_xy_to_wh(np.asarray(bbox_xyxy, np.float32))
    square = square_bbox_with_expansion(np.asarray(bbox_xyxy, np.float32))
    square_xyxy = bbox_ops.bbox_wh_to_xy(square)
    crop = mask_lib.crop_and_resize(full_mask[None], square_xyxy[None],
                                    rend_size)[0] >= 0.5
    if occluder_masks is not None and len(occluder_masks):
        target = mask_lib.add_occlusions(
            [crop.astype(np.float32)], np.asarray(occluder_masks, np.float32),
            [square])[0]
    else:
        target = crop.astype(np.float32)
    return {
        "bbox": bbox_wh,
        "square_bbox": square,
        "full_mask": full_mask,
        "crop_mask": crop,
        "target_crop_mask": target,
    }


def process_hand_estimates(estimates: Dict[str, Dict],
                           hand_masks: Dict[str, np.ndarray],
                           hand_bboxes: Dict[str, np.ndarray]) -> List[Dict]:
    """One frame's person_parameters in the reference layout: one entry per
    present hand side, LEFT before RIGHT (the reference's fixed order; a
    per-frame sort by box would reorder the interleaved hand rows whenever
    the hands cross). A side needs both an estimate and a box: records may
    hold more hands than the clip tracks, and those are skipped."""
    sides = [s for s in ("left_hand", "right_hand")
             if s in estimates and hand_bboxes.get(s) is not None]
    out = []
    for side in sides:
        est = dict(estimates[side])
        est["hand_side"] = side.replace("_hand", "")
        est["bboxes"] = np.asarray(hand_bboxes[side], np.float32)
        if side in hand_masks and hand_masks[side] is not None:
            est["masks"] = np.asarray(hand_masks[side], np.float32)
        out.append(est)
    return out


def process_body_estimates(body_estimates: Optional[List[Dict]],
                           bboxes_xyxy: np.ndarray,
                           image_size: int = 640,
                           masks: Optional[np.ndarray] = None) -> Dict:
    """The body-mocap variant of the assembly.

    Rescales each person's weak-perspective camera from its 224-pixel crop
    to the detection box, sorts people left to right by box x, and resizes
    person masks to the square image frame for the ordinal-depth loss.

    body_estimates: per person {pred_vertices_smpl (V, 3), faces (F, 3),
    pred_camera (3,) in the 224 crop, bbox_scale_ratio, global_cams (3,)},
    or None (boxes only); bboxes_xyxy (N, 4); masks (N, H, W) or None.
    Returns person_parameters: bboxes (and cams, local_cams, verts, faces
    with estimates, masks with masks), all sorted.
    """
    bboxes_xyxy = np.asarray(bboxes_xyxy, np.float32)
    inds = np.argsort(bboxes_xyxy[:, 0])
    out: Dict = {"bboxes": bboxes_xyxy[inds]}
    if body_estimates is not None:
        verts = np.stack([np.asarray(p["pred_vertices_smpl"], np.float32)
                          for p in body_estimates])
        faces = np.asarray(body_estimates[0]["faces"], np.int32)[None]
        max_dim = np.max(bbox_ops.bbox_xy_to_wh(bboxes_xyxy)[:, 2:], axis=1)
        local_cams, global_cams = [], []
        for b, pred in zip(max_dim, body_estimates):
            local_cam = np.asarray(pred["pred_camera"], np.float32).copy()
            scale_o2n = float(pred["bbox_scale_ratio"]) * b / 224.0
            local_cam[0] /= scale_o2n
            local_cam[1:] /= local_cam[:1]
            local_cams.append(local_cam)
            global_cams.append(np.asarray(pred["global_cams"], np.float32))
        out.update(
            cams=np.stack(global_cams)[inds],
            local_cams=np.stack(local_cams)[inds],
            verts=verts[inds],
            faces=faces,
        )
    if masks is not None:
        full = np.tile(np.asarray([[0, 0, image_size, image_size]],
                                  np.float32), (len(bboxes_xyxy), 1))
        resized = mask_lib.crop_and_resize(
            np.asarray(masks, np.float32), full, image_size)
        out["masks"] = resized[inds]
    return out


def get_frame_infos(images: Sequence[np.ndarray],
                    hand_provider,
                    mask_provider,
                    hand_bboxes: Dict[str, Optional[np.ndarray]],
                    obj_bboxes: np.ndarray,
                    camintr: np.ndarray,
                    image_size: int = 640,
                    rend_size: int = REND_SIZE,
                    frame_keys: Optional[Sequence[str]] = None):
    """Collect a clip's per-frame evidence.

    images: frame_nb RGB frames; CachedEvidence providers get frame_keys
    instead. hand_bboxes: side -> (4,) box or (frame_nb, 4) boxes, or None
    when the side is absent. obj_bboxes (frame_nb, 4) xyxy; camintr
    (frame_nb, 3, 3) pixel intrinsics.
    Returns (person_parameters per frame, obj_mask_infos per frame).
    """
    cached = isinstance(hand_provider, CachedEvidence)
    person_params_frames = []
    obj_infos_frames = []

    def frame_box(b, i):
        b = np.asarray(b, np.float32)
        return b[i] if b.ndim == 2 else b

    for i, image in enumerate(images):
        key = frame_keys[i] if frame_keys is not None else str(i)
        handle = key if cached else image

        present = {s: frame_box(b, i) for s, b in hand_bboxes.items()
                   if b is not None}
        hand_estimates = hand_provider.regress(handle, present)

        # Hand masks, for the occlusion-aware object targets.
        hand_boxes_xyxy = np.stack(
            [bbox_ops.bbox_wh_to_xy(np.asarray(b, np.float32))
             for b in present.values()]) if present else np.zeros((0, 4))
        hand_mask_dicts = mask_provider.masks_from_bboxes(
            handle, hand_boxes_xyxy, [0] * len(present)) if present else []
        # Masks pair with sides by their "hand_side" tags; by position only
        # when the counts match (a short list zipped by position would give
        # the right hand's mask to the left side).
        if hand_mask_dicts and all("hand_side" in m
                                   for m in hand_mask_dicts):
            hand_masks = {m["hand_side"]: m["full_mask"]
                          for m in hand_mask_dicts
                          if m["hand_side"] in present}
        elif len(hand_mask_dicts) == len(present):
            hand_masks = {s: m["full_mask"] for s, m in
                          zip(present.keys(), hand_mask_dicts)}
        else:
            logger.warning(
                "frame %s: %d hand masks for %d tracked hands and no "
                "hand_side tags: masks skipped for this frame",
                key, len(hand_mask_dicts), len(present))
            hand_masks = {}
        # A side with no mask this frame gets an all-zero (no-evidence)
        # mask, so the frames' masks stack.
        if hand_masks and len(hand_masks) < len(present):
            shape = next(iter(hand_masks.values())).shape
            for s in present:
                hand_masks.setdefault(s, np.zeros(shape, bool))

        obj_mask_dicts = mask_provider.masks_from_bboxes(
            handle, np.asarray(obj_bboxes[i])[None], [-1])
        occluders = (np.stack([np.asarray(m, np.float32)
                               for m in hand_masks.values()])
                     if hand_masks else None)
        obj_info = build_object_mask_info(
            obj_mask_dicts[0]["full_mask"], obj_bboxes[i], occluders,
            rend_size)
        obj_infos_frames.append(obj_info)
        person_params_frames.append(process_hand_estimates(
            hand_estimates, hand_masks, present))
    return person_params_frames, obj_infos_frames


def stack_person_parameters(frames: Sequence[List[Dict]]) -> Dict:
    """Per-frame hand lists -> one dict of per-hand rows in the interleaved
    [h1_t1, h2_t1, h1_t2, ...] layout of the joint fit, plus "hand_sides".
    Only numpy values are stacked."""
    hand_nb = len(frames[0])
    keys = [k for k, v in frames[0][0].items()
            if isinstance(v, np.ndarray)]
    rows = []
    for frame in frames:
        assert len(frame) == hand_nb, "hand count must be constant in a clip"
        rows.extend(frame)
    stacked = {k: np.stack([np.asarray(r[k], np.float32) for r in rows])
               for k in keys}
    stacked["hand_sides"] = [frames[0][h]["hand_side"]
                             for h in range(hand_nb)]
    return stacked
