"""Evidence rendered from ground-truth geometry (the stage-B part of
homan_tpu/frontend/gtevidence.py): full-image object masks and their boxes.
"""
from __future__ import annotations

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.frontend import masks as mask_lib
from homan_tpu_torch.render.rasterizer import (RasterSettings, as_topology,
                                               rasterize_soft)


def render_full_mask(verts, topo, K_px, image_size: int,
                     device=None) -> np.ndarray:
    """(B, S, S) bool full-image masks of meshes `verts` (B, V, 3) under
    pixel intrinsics K_px (B, 3, 3) (JAX gtevidence.py:24).

    One forward-only render at min(image_size, 256)^2, tile 64, 128 edge
    slots a tile, thresholded at 0.5 and upsampled on the device to
    image_size^2; one transfer to the host.
    """
    device = resolve_device(device)
    Kn = np.asarray(K_px, np.float64).copy()
    Kn[:, :2] = Kn[:, :2] / image_size
    settings = RasterSettings(image_size=min(image_size, 256),
                              edges_per_tile=128)
    with torch.no_grad():
        sil = rasterize_soft(
            torch.as_tensor(np.asarray(verts, np.float32), device=device),
            as_topology(topo, device=device),
            torch.as_tensor(Kn, dtype=torch.float32, device=device),
            settings)["sil"]
        masks = sil > 0.5
        if settings.image_size != image_size:
            S0 = settings.image_size
            full = torch.tensor([[0, 0, S0, S0]], dtype=torch.float32,
                                device=device).expand(masks.shape[0], 4)
            masks = mask_lib.crop_and_resize_dev(
                masks.to(torch.float32), full, image_size) >= 0.5
    return masks.cpu().numpy()


def mask_to_bbox(mask: np.ndarray) -> np.ndarray:
    """Tight xyxy box (4,) of a mask's nonzero pixels; [0, 0, 1, 1] when
    the mask is empty."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                    np.float32)
