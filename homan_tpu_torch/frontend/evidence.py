"""Per-frame object evidence (the stage-B part of
homan_tpu/frontend/evidence.py:103-142): the square crop box around a
detection and the occlusion-aware target crop mask."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from homan_tpu_torch.core import bbox as bbox_ops
from homan_tpu_torch.frontend import masks as mask_lib

REND_SIZE = mask_lib.REND_SIZE
BBOX_EXPANSION_FACTOR = 0.3


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
