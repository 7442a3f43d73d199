"""Mask crops and occlusion-aware targets (the stage-B part of
homan_tpu/frontend/masks.py).

`crop_and_resize` is the numpy ROIAlign-style bilinear crop of the JAX
package, the same float32 arithmetic in the same order, so its results are
bit-equal; `crop_and_resize_dev` is the same crop in torch on the device.
Target convention: -1 = occluded/ignore, 0 = background, 1 = foreground.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from homan_tpu_torch.core import bbox as bbox_ops

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
