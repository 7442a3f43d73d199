"""Bounding-box algebra in numpy (homan_tpu/core/bbox.py): xyxy <-> xywh,
the square expansion of a box, clamping to the image, overlap tests and
IoU."""
from __future__ import annotations

import numpy as np


def bbox_xy_to_wh(bbox):
    """xyxy -> xywh. Accepts (..., 4) arrays, lists or tuples."""
    bbox = np.asarray(bbox, dtype=np.float64)
    out = bbox.copy()
    out[..., 2] = bbox[..., 2] - bbox[..., 0]
    out[..., 3] = bbox[..., 3] - bbox[..., 1]
    return out


def bbox_wh_to_xy(bbox):
    """xywh -> xyxy."""
    bbox = np.asarray(bbox, dtype=np.float64)
    out = bbox.copy()
    out[..., 2] = bbox[..., 0] + bbox[..., 2]
    out[..., 3] = bbox[..., 1] + bbox[..., 3]
    return out


def make_bbox_square(bbox, bbox_expansion: float = 0.0):
    """xywh box -> square xywh box around the same center, side
    max(w, h) * (1 + bbox_expansion)."""
    bbox = np.asarray(bbox, dtype=np.float64)
    original_shape = bbox.shape
    bbox = bbox.reshape(-1, 4)
    center = np.stack(
        (bbox[:, 0] + bbox[:, 2] / 2, bbox[:, 1] + bbox[:, 3] / 2), axis=1)
    b = np.maximum(bbox[:, 2], bbox[:, 3])[:, None] * (1 + bbox_expansion)
    square = np.hstack((center - b / 2, b, b))
    return square.reshape(original_shape)


def make_bbox_valid(bbox, w, h, bbox_mode: str = "wh"):
    """Clamp a box to the image extent [0, 0, w, h]."""
    if bbox_mode == "wh":
        bbox = bbox_wh_to_xy(bbox)
    bbox = np.asarray(bbox, dtype=np.float64)
    clamped = np.stack([
        np.clip(bbox[..., 0], 0, w),
        np.clip(bbox[..., 1], 0, h),
        np.clip(bbox[..., 2], 0, w),
        np.clip(bbox[..., 3], 0, h),
    ], axis=-1)
    if bbox_mode == "wh":
        clamped = bbox_xy_to_wh(clamped)
    return clamped


def check_overlap(bbox1, bbox2) -> bool:
    """True if xyxy boxes (or (z1, z2) intervals) overlap."""
    if bbox1[0] > bbox2[2] or bbox2[0] > bbox1[2]:
        return False
    if len(bbox1) > 2:
        if bbox1[1] > bbox2[3] or bbox2[1] > bbox1[3]:
            return False
    return True


def compute_area(bbox):
    return (bbox[..., 2] - bbox[..., 0]) * (bbox[..., 3] - bbox[..., 1])


def compute_iou(bbox1, bbox2):
    """IoU of two xyxy boxes (numpy arrays)."""
    a1 = compute_area(bbox1)
    a2 = compute_area(bbox2)
    lt0 = np.maximum(bbox1[..., 0], bbox2[..., 0])
    lt1 = np.maximum(bbox1[..., 1], bbox2[..., 1])
    rb0 = np.minimum(bbox1[..., 2], bbox2[..., 2])
    rb1 = np.minimum(bbox1[..., 3], bbox2[..., 3])
    w = np.clip(rb0 - lt0, 0, None)
    h = np.clip(rb1 - lt1, 0, None)
    inter = w * h
    return inter / (a1 + a2 - inter)
