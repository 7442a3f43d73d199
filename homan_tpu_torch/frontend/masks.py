"""Mask crops and occlusion-aware targets (homan_tpu/frontend/masks.py).

`crop_and_resize` is the numpy ROIAlign-style bilinear crop of the JAX
package, the same float32 arithmetic in the same order, so its results are
bit-equal; `crop_and_resize_dev` is the same crop in torch on the device.
Target convention: -1 = occluded/ignore, 0 = background, 1 = foreground.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from homan_tpu_torch.core import bbox as bbox_ops
from homan_tpu_torch.core import camera as cam

REND_SIZE = 256  # evidence resolution


def crop_and_resize(masks: np.ndarray, boxes_xyxy: np.ndarray,
                    size: int) -> np.ndarray:
    """Bilinear crop+resize of masks (N, H, W) to (N, size, size), sampled
    at bin centres, zero outside the image (JAX masks.py:24). The bilinear
    weights promote to float64 (float32 coordinates less int64 corners), as
    in the JAX package."""
    masks = np.asarray(masks, np.float32)
    boxes = np.asarray(boxes_xyxy, np.float32)
    n, h, w = masks.shape
    steps = (np.arange(size, dtype=np.float32) + 0.5) / size
    xs = boxes[:, 0:1] + steps[None] * (boxes[:, 2:3] - boxes[:, 0:1]) - 0.5
    ys = boxes[:, 1:2] + steps[None] * (boxes[:, 3:4] - boxes[:, 1:2]) - 0.5
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx = xs - x0  # (n, size)
    fy = ys - y0
    idx = np.arange(n)[:, None, None]

    def take(yy, xx):
        inb = (((yy >= 0) & (yy < h))[:, :, None]
               & ((xx >= 0) & (xx < w))[:, None, :])
        yc = np.clip(yy, 0, h - 1)
        xc = np.clip(xx, 0, w - 1)
        return masks[idx, yc[:, :, None], xc[:, None, :]] * inb

    return ((1 - fy)[:, :, None] * ((1 - fx)[:, None] * take(y0, x0)
                                    + fx[:, None] * take(y0, x0 + 1))
            + fy[:, :, None] * ((1 - fx)[:, None] * take(y0 + 1, x0)
                                + fx[:, None] * take(y0 + 1, x0 + 1)))


def crop_and_resize_dev(masks: torch.Tensor, boxes_xyxy: torch.Tensor,
                        size: int) -> torch.Tensor:
    """`crop_and_resize` in torch, on the masks' device (JAX masks.py:67):
    masks (N, H, W), boxes (N, 4) -> (N, size, size) float32."""
    masks = masks.to(torch.float32)
    boxes = boxes_xyxy.to(torch.float32)
    n, h, w = masks.shape
    dev = masks.device
    steps = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    xs = boxes[:, 0:1] + steps[None] * (boxes[:, 2:3] - boxes[:, 0:1]) - 0.5
    ys = boxes[:, 1:2] + steps[None] * (boxes[:, 3:4] - boxes[:, 1:2]) - 0.5
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    fx = xs - x0
    fy = ys - y0
    idx = torch.arange(n, device=dev)[:, None, None]

    def take(yy, xx):
        inb = (((yy >= 0) & (yy < h))[:, :, None]
               & ((xx >= 0) & (xx < w))[:, None, :])
        yc = torch.clamp(yy, 0, h - 1)
        xc = torch.clamp(xx, 0, w - 1)
        return masks[idx, yc[:, :, None], xc[:, None, :]] * inb

    return ((1 - fy)[:, :, None] * ((1 - fx)[:, None] * take(y0, x0)
                                    + fx[:, None] * take(y0, x0 + 1))
            + fy[:, :, None] * ((1 - fx)[:, None] * take(y0 + 1, x0)
                                + fx[:, None] * take(y0 + 1, x0 + 1)))


def add_occlusions(masks: Sequence[np.ndarray], occluder_mask: np.ndarray,
                   mask_bboxes: Sequence[np.ndarray]):
    """Mark occluder pixels as -1 in ROI object masks (JAX masks.py:106).

    masks: list of (R, R) bool crop masks; occluder_mask (B, H, W) one-hot
    occluder masks; mask_bboxes: list of (4,) square xywh boxes, one per
    crop.
    """
    out = []
    occ = np.asarray(occluder_mask, np.float32)
    for mask, box in zip(masks, mask_bboxes):
        box_xyxy = bbox_ops.bbox_wh_to_xy(np.asarray(box, np.float32))
        occl = crop_and_resize(occ, np.tile(box_xyxy, (occ.shape[0], 1)),
                               mask.shape[0]) >= 0.5
        with_occ = np.asarray(mask, np.float32).copy()
        with_occ[occl.sum(0) > 0] = -1
        with_occ[np.asarray(mask, bool)] = 1
        out.append(with_occ)
    return out


def add_target_hand_occlusions(person_parameters: Dict,
                               object_parameters: Dict,
                               K: np.ndarray,
                               square_expand: float = 0.0,
                               rend_size: int = REND_SIZE) -> Dict:
    """Per-hand occlusion-aware target masks and ROI intrinsics (JAX
    masks.py:129), host numpy.

    person_parameters: {"bboxes" (B, 4) xyxy, "masks" (B, H, W)}, updated in
    place with target_masks (B, R, R) in {-1, 0, 1} (object pixels -1),
    K_roi (B, 3, 3) normalized to the crop, and square_bboxes (B, 4) xyxy.
    object_parameters: {"full_mask" (H, W), or (B, H, W) one per row}.
    K: (3, 3) pixel intrinsics of the full image, or (B, 3, 3) one per row.
    """
    person_masks = np.asarray(person_parameters["masks"], np.float32)
    tight = np.asarray(person_parameters["bboxes"], np.float32)
    b = tight.shape[0]
    square = bbox_ops.bbox_wh_to_xy(
        bbox_ops.make_bbox_square(bbox_ops.bbox_xy_to_wh(tight),
                                  bbox_expansion=square_expand))
    target = crop_and_resize(person_masks, square, rend_size)
    target = (target >= 0.5).astype(np.float32)
    obj_full = np.asarray(object_parameters["full_mask"], np.float32)
    if obj_full.ndim == 2:
        obj_full = np.tile(obj_full[None], (b, 1, 1))
    obj_crops = crop_and_resize(obj_full, square, rend_size) >= 0.5
    target[obj_crops] = -1

    K = np.asarray(K, np.float32)
    K_b = np.tile(K[None], (b, 1, 1)) if K.ndim == 2 else K
    K_roi = cam.get_K_crop_resize_np(K_b, square, rend_size)
    K_roi[:, :2] = K_roi[:, :2] / rend_size  # normalized rendering space

    person_parameters["target_masks"] = target
    person_parameters["K_roi"] = K_roi
    person_parameters["square_bboxes"] = square
    return person_parameters
