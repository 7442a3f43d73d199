"""Bounding-box algebra in numpy (the stage-B part of homan_tpu/core/bbox.py
:12-44): xyxy <-> xywh and the square expansion of a box."""
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
