"""Small visualization helpers: mask borders, clip labels, detection panels
(homan_tpu/viz/extras.py, whole).

Equivalents of homan/viz/maskviz.py, cliputils.py, vizframeinfo.py and the
GT-vs-pred scatter grids (viz_gtpred_points.py). Numpy and scipy, with cv2
for text and boxes and matplotlib for the scatter grid: where those are not
installed, the functions that need them raise ImportError naming
themselves. The fit driver calls none of them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _require(module: str, func: str):
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise ImportError(f"{func} needs {module}, which is not "
                          "installed") from exc


def mask_border(mask: np.ndarray, thickness: int = 2) -> np.ndarray:
    """Boolean border of a mask (homan/viz/maskviz.py:7-31 role)."""
    m = np.asarray(mask, bool)
    from scipy.ndimage import binary_dilation, binary_erosion
    grown = binary_dilation(m, iterations=thickness)
    shrunk = binary_erosion(m, iterations=thickness)
    return grown & ~shrunk


def overlay_mask(image: np.ndarray, mask: np.ndarray,
                 color=(255, 64, 64), alpha: float = 0.45,
                 border: bool = True) -> np.ndarray:
    """Tint mask pixels + draw a hard border on an image."""
    img = np.asarray(image).copy()
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    m = np.asarray(mask, bool)
    col = np.asarray(color, np.float64)
    img[m] = (img[m] * (1 - alpha) + col * alpha).astype(np.uint8)
    if border:
        img[mask_border(m)] = color
    return img


def add_clip_text(frames: Sequence[np.ndarray], text: str,
                  color=(255, 255, 255)) -> np.ndarray:
    """Stamp a label on each frame (homan/viz/cliputils.py:6-18)."""
    cv2 = _require("cv2", "add_clip_text")
    out = []
    for f in frames:
        f = np.ascontiguousarray(f)
        cv2.putText(f, text, (6, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                    cv2.LINE_AA)
        out.append(f)
    return np.stack(out)


def draw_bbox(image: np.ndarray, bbox_xyxy, color=(0, 255, 0),
              label: str = "") -> np.ndarray:
    cv2 = _require("cv2", "draw_bbox")
    img = np.ascontiguousarray(np.asarray(image))
    x1, y1, x2, y2 = [int(v) for v in bbox_xyxy]
    cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
    if label:
        cv2.putText(img, label, (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1, cv2.LINE_AA)
    return img


def frame_detection_panel(image: np.ndarray,
                          hand_bboxes: Optional[Dict] = None,
                          obj_bbox=None,
                          hand_masks: Optional[Dict] = None,
                          obj_mask=None) -> np.ndarray:
    """Per-frame detection/mask overview (homan/viz/vizframeinfo.py:12-65)."""
    img = np.asarray(image).copy()
    if obj_mask is not None:
        img = overlay_mask(img, obj_mask, color=(255, 200, 40))
    if hand_masks:
        for side, m in hand_masks.items():
            if m is not None:
                img = overlay_mask(img, m, color=(90, 130, 255))
    if obj_bbox is not None:
        img = draw_bbox(img, obj_bbox, (255, 160, 0), "object")
    if hand_bboxes:
        for side, b in hand_bboxes.items():
            if b is not None:
                img = draw_bbox(img, b, (60, 110, 255), side)
    return img


def gtpred_point_grid(images: Sequence[np.ndarray],
                      pred_points2d: Sequence[np.ndarray],
                      gt_points2d: Optional[Sequence[np.ndarray]],
                      save_path: str):
    """GT-vs-pred projected point scatter grid
    (homan/viz/viz_gtpred_points.py:7-42)."""
    matplotlib = _require("matplotlib", "gtpred_point_grid")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    n = len(images)
    fig, axes = plt.subplots(1, n, figsize=(2.4 * n, 2.6), squeeze=False)
    for i in range(n):
        ax = axes[0][i]
        ax.axis("off")
        if images[i] is not None:
            ax.imshow(images[i])
        p = np.asarray(pred_points2d[i])
        ax.scatter(p[:, 0], p[:, 1], s=1, alpha=0.4, c="tab:red",
                   label="pred")
        if gt_points2d is not None:
            g = np.asarray(gt_points2d[i])
            ax.scatter(g[:, 0], g[:, 1], s=1, alpha=0.4, c="tab:green",
                       label="gt")
    axes[0][0].legend(fontsize=6, loc="lower right")
    fig.tight_layout()
    fig.savefig(save_path, dpi=90)
    plt.close(fig)
    return save_path


def html_video_embed(video_path: str, height: int = 240) -> str:
    """Inline HTML video tag (homan/viz/colabutils.py:9-20 role)."""
    return (f'<video height="{height}" controls loop autoplay muted>'
            f'<source src="{video_path}"></video>')
