"""Greedy assignment of segmentation masks to rendered hand instances
(homan_tpu/frontend/assign.py): the IoU of every rendered hand silhouette
with every detected human mask, best pairs matched first; a hand left
unmatched gets an empty mask (no ordinal-depth evidence). Host numpy, once
per clip before the fit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def assign_human_masks(person_silhouettes: np.ndarray,
                       masks_human: Optional[np.ndarray],
                       min_overlap: float = 0.5) -> np.ndarray:
    """person_silhouettes (N_h, H, W) rendered hand silhouettes (bool);
    masks_human (N_m, H, W) detected human or hand masks (bool), or None.
    Returns (N_h, H, W) float32: each hand's assigned mask, zeros where no
    mask overlaps it by `min_overlap` IoU."""
    sils = np.asarray(person_silhouettes, bool)
    out = np.zeros(sils.shape, np.float32)
    if masks_human is None or len(masks_human) == 0:
        return out
    masks = np.asarray(masks_human, bool)
    inter = (masks[None, :] & sils[:, None]).sum((2, 3)).astype(np.float64)
    union = (masks[None, :] | sils[:, None]).sum((2, 3)).astype(np.float64)
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)  # (N_h, N_m)
    order = np.dstack(np.unravel_index(np.argsort(-iou.ravel()),
                                       iou.shape))[0]
    used_h, used_m = set(), set()
    for hi, mi in order:
        if hi in used_h or mi in used_m:
            continue
        if iou[hi, mi] < min_overlap:
            break
        out[hi] = masks[mi]
        used_h.add(int(hi))
        used_m.add(int(mi))
    return out


# COCO class names: index = detectron2 class id + 1 (background first).
COCO_CLASS_NAMES = [
    "BG", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]
