"""Projection and rigid placement (counterpart of homan_tpu/core/camera.py).

Intrinsics are pinhole K = [[fx,0,cx],[0,fy,cy],[0,0,1]]; "normalized" K
(`orig_size=1`) maps the image to [0, 1]^2. The `*_det` outputs carry no
gradient to the mesh geometry (`.detach()` where JAX uses stop_gradient), so
interaction terms only steer the rigid transform.
"""
from __future__ import annotations

import numpy as np
import torch


def batch_proj2d(verts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) camera-space points, (B, 3, 3) K -> (B, V, 2) image coords."""
    proj = verts @ K.transpose(1, 2)
    return proj[..., :2] / torch.clamp(proj[..., 2:3], min=1e-9)


def project_points(verts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Like batch_proj2d but (B, V, 3) (u, v, z) with z the camera depth."""
    return torch.cat([batch_proj2d(verts, K), verts[..., 2:3]], dim=-1)


def compute_transformation_persp(meshes, translations, rotations=None,
                                 intrinsic_scales=None):
    """scale -> rotate (row vectors, v @ R) -> translate.

    meshes (V, 3) or (B, V, 3); translations (B, 1, 3); rotations (B, 3, 3);
    intrinsic_scales (B,), (1,) or None. Returns (verts, verts_det).
    """
    B = translations.shape[0]
    if meshes.dim() == 2:
        meshes = meshes[None].expand((B,) + tuple(meshes.shape))
    if rotations is None:
        rotations = torch.eye(3, dtype=meshes.dtype,
                              device=meshes.device).expand(B, 3, 3)
    if intrinsic_scales is None:
        intrinsic_scales = torch.ones(B, dtype=meshes.dtype,
                                      device=meshes.device)
    scales = intrinsic_scales.reshape(-1, 1, 1)
    meshes_scaled = scales * meshes
    verts = meshes_scaled @ rotations + translations
    verts_det = meshes_scaled.detach() @ rotations + translations
    return verts, verts_det


def weakcam_to_persp_trans(weak_cams_px, K_px, focal_scale: float = 1.0):
    """(B, 3) pixel weak-perspective [s, tx, ty] -> (B, 3) translation."""
    fx = K_px[:, 0, 0] * focal_scale
    fy = K_px[:, 1, 1] * focal_scale
    cx, cy = K_px[:, 0, 2], K_px[:, 1, 2]
    s = weak_cams_px[:, 0]
    tz = fx / torch.clamp(s, min=1e-9)
    tx = (weak_cams_px[:, 1] - cx) * tz / fx
    ty = (weak_cams_px[:, 2] - cy) * tz / fy
    return torch.stack([tx, ty, tz], dim=-1)


def compute_transformation_ortho(meshes, cams, rotations=None,
                                 intrinsic_scales=None, K=None,
                                 image_size: int = 640):
    """HMR-style scaled-orthographic camera -> 3D placement (verts, det)."""
    B = cams.shape[0]
    if meshes.dim() == 2:
        meshes = meshes[None].expand((B,) + tuple(meshes.shape))
    if rotations is None:
        rotations = torch.eye(3, dtype=meshes.dtype,
                              device=meshes.device).expand(B, 3, 3)
    if intrinsic_scales is None:
        intrinsic_scales = torch.ones(B, dtype=meshes.dtype,
                                      device=meshes.device)
    persp_scale = cams[:, :1] / 2 * image_size
    persp_trans = (cams[:, 1:] + 1.0 / cams[:, :1]) * persp_scale
    weak_px = torch.cat([persp_scale, persp_trans], dim=1)
    K_px = None
    if K is not None:
        K_px = torch.cat([K[:, :2] * image_size, K[:, 2:]], dim=1)
    trans = weakcam_to_persp_trans(weak_px, K_px)[:, None, :]
    verts_rot = meshes @ rotations
    verts_rot_det = meshes.detach() @ rotations
    scales = intrinsic_scales.reshape(-1, 1, 1)
    return scales * (verts_rot + trans), scales * (verts_rot_det + trans)


def normalize_K(K: torch.Tensor, size) -> torch.Tensor:
    """Divide the first two rows of K by the image size."""
    K = torch.as_tensor(K, dtype=torch.float32)
    scale = torch.ones((3, 1), dtype=K.dtype, device=K.device)
    scale[:2, 0] = 1.0 / size
    return K * scale


def get_K_crop_resize_np(K, boxes_xyxy, target_size: int):
    """Pixel intrinsics (N, 3, 3) of crops `boxes_xyxy` (N, 4) resized to
    target_size^2, in numpy for the host-side evidence
    (homan_tpu/core/camera.py:166)."""
    K = np.asarray(K, np.float32).copy()
    boxes = np.asarray(boxes_xyxy, np.float32)
    sx = target_size / np.maximum(boxes[:, 2] - boxes[:, 0], 1e-9)
    sy = target_size / np.maximum(boxes[:, 3] - boxes[:, 1], 1e-9)
    out = np.zeros(boxes.shape[:1] + (3, 3), np.float32)
    out[:, 0, 0] = K[:, 0, 0] * sx
    out[:, 0, 1] = K[:, 0, 1] * sx
    out[:, 0, 2] = (K[:, 0, 2] - boxes[:, 0]) * sx
    out[:, 1, 1] = K[:, 1, 1] * sy
    out[:, 1, 2] = (K[:, 1, 2] - boxes[:, 1]) * sy
    out[:, 2, 2] = 1.0
    return out


def get_K_crop_resize(K: torch.Tensor, boxes_xyxy: torch.Tensor,
                      target_size: int) -> torch.Tensor:
    """Pixel intrinsics (B, 3, 3) valid inside the crops `boxes_xyxy`
    (B, 4) resized to target_size^2 (homan_tpu/core/camera.py:139); the
    tensor twin of get_K_crop_resize_np."""
    x1, y1, x2, y2 = boxes_xyxy.unbind(-1)
    sx = target_size / torch.clamp(x2 - x1, min=1e-9)
    sy = target_size / torch.clamp(y2 - y1, min=1e-9)
    fx = K[:, 0, 0] * sx
    fy = K[:, 1, 1] * sy
    cx = (K[:, 0, 2] - x1) * sx
    cy = (K[:, 1, 2] - y1) * sy
    skew = K[:, 0, 1] * sx
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, skew, cx], dim=-1),
                        torch.stack([zeros, fy, cy], dim=-1),
                        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def compute_K_roi(upper_left, b, img_size, focal_length: float = 1.0,
                  device=None) -> torch.Tensor:
    """Normalized intrinsics (1, 3, 3) of a square ROI crop with upper-left
    corner `upper_left` and side `b` (homan/utils/camera.py:39-56)."""
    x1, y1 = upper_left
    f = focal_length * img_size / b
    px = (img_size / 2 - x1) / b
    py = (img_size / 2 - y1) / b
    return torch.tensor([[[f, 0, px], [0, f, py], [0, 0, 1]]],
                        dtype=torch.float32, device=device)


def local_to_global_cam(bboxes: torch.Tensor, cams: torch.Tensor,
                        L: float) -> torch.Tensor:
    """Weak-perspective cameras (N, 3) relative to the xyxy boxes (N, 4) ->
    relative to the full image of longest side L (camera.py:9-36)."""
    from homan_tpu_torch.core import bbox as bbox_ops
    square = bbox_ops.make_bbox_square(
        bbox_ops.bbox_xy_to_wh(bboxes.detach().cpu().numpy()))
    square = torch.as_tensor(square, dtype=cams.dtype, device=cams.device)
    x, y, b = square[:, 0], square[:, 1], square[:, 2]
    s_crop = b * cams[:, 0] / 2
    t_crop = cams[:, 1:] + 1.0 / cams[:, 0:1]
    s_og = s_crop / L
    t_og = t_crop + torch.stack([x, y], dim=-1) / s_crop[:, None]
    s = s_og * 2
    t = t_og - 0.5 / s_og[:, None]
    return torch.cat([s[:, None], t], dim=1)
