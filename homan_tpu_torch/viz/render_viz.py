"""Scene visualization on the hard rasterizer (homan_tpu/viz/render_viz.py).

Frontal and top-down overlay renders of a fit (homan/visualize.py:44-128,
homan/homan.py:546-613), turntables, and the image and video writers. Every
render goes through render/rasterizer.py rasterize_hard on the caller's
device, one path on the CPU and the card alike; the host renderer
native.raster_phong is not a branch here.

Face budget: rasterize_hard keeps the first `faces_per_tile` faces of a
tile by index. The JAX module renders with min(2048, F + 64) at tile 64
and drops faces wherever a tile's demand exceeds that; here every render is
sized from its measured demand (rasterizer.hard_face_settings), and a
caller's `budgets` list receives each render's tile, Kf and demand.

Writers: the JAX formats where their libraries import (cv2 for webm and
mp4, PIL for gif, matplotlib for the labelled grid). Where one
is missing, the writer still writes a file the user can open with numpy
and the standard library alone, and logs its name: the grid as a PNG
without labels (`write_png`), a video as an animated PNG `<stem>.apng`
beside the requested name (`write_apng`).
"""
from __future__ import annotations

import importlib
import logging
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core import meshes as mesh_lib
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.render.rasterizer import (RasterSettings,
                                               hard_face_settings,
                                               rasterize_hard)

logger = logging.getLogger(__name__)


def _import_optional(name: str):
    """The module `name`, or None when it does not import."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def rotate_in_place(verts: np.ndarray, axis=(1.0, 0.0, 0.0),
                    angle_deg: float = 90.0) -> np.ndarray:
    """Rotate a scene about its centroid (top-down views,
    homan/visualize.py:92-104)."""
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(np.deg2rad(angle_deg) * np.asarray(axis))
    R = R.as_matrix().astype(np.float32)
    center = verts.reshape(-1, 3).mean(0)
    return (verts - center) @ R.T + center


def composite(render_rgb: np.ndarray, render_sil: np.ndarray,
              image: Optional[np.ndarray]) -> np.ndarray:
    """Overlay a render onto an image via its silhouette
    (homan/utils/nmr_renderer.py:220-244 role)."""
    if image is None:
        return (np.clip(render_rgb, 0, 1) * 255).astype(np.uint8)
    img = np.asarray(image, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.shape[:2] != render_rgb.shape[:2]:
        img = resize_image(img, render_rgb.shape[0])
    mask = render_sil[..., None].astype(np.float32)
    out = render_rgb * mask + img * (1 - mask)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) in [0, 1] -> (size, size, 3) in [0, 1], PIL's resize.
    Frames exist only where a dataset read them, with PIL."""
    from PIL import Image
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(pil.resize((size, size))) / 255.0


def render_scene(verts_list: Sequence[np.ndarray],
                 faces_list: Sequence[np.ndarray],
                 color_names: Sequence[str],
                 K,
                 image_size: int = 256,
                 images: Optional[Sequence[np.ndarray]] = None,
                 rotate: bool = False,
                 max_in_batch: int = 10,
                 device=None,
                 budgets: Optional[list] = None) -> List[np.ndarray]:
    """Flat-colored scene render over a clip, composited onto frames.

    Args:
      verts_list: per part (B, V_i, 3); faces_list: per part (F_i, 3).
      K: (B, 3, 3) normalized intrinsics.
      device: where rasterize_hard runs (default `cuda`).
      budgets: a list that receives, per render of up to max_in_batch
        frames, {"tile_px", "faces_per_tile", "face_demand" by tile,
        "faces"}.
    Returns list of (S, S, 3) uint8 frames.
    """
    device = resolve_device(device)
    B = verts_list[0].shape[0]
    verts_np = [np.asarray(v, np.float32) for v in verts_list]
    scene_verts = np.concatenate(verts_np, axis=1)
    if rotate:
        scene_verts = np.stack([rotate_in_place(v) for v in scene_verts])
    faces_packed, colors = mesh_lib.get_faces_and_textures(
        [v[:1] for v in verts_np], faces_list, color_names)
    # Faces index one frame's concatenated vertex buffer.
    K_np = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K,
                      np.float32)
    faces = torch.as_tensor(faces_packed[0], dtype=torch.int64, device=device)
    colors_t = torch.as_tensor(colors[0], dtype=torch.float32, device=device)
    frames = []
    for start in range(0, B, max_in_batch):
        sl = slice(start, min(start + max_in_batch, B))
        v = torch.as_tensor(scene_verts[sl], device=device)
        k = torch.as_tensor(K_np[sl], device=device)
        settings, demand = hard_face_settings(
            v, faces, k, RasterSettings(image_size=image_size))
        if budgets is not None:
            budgets.append({"tile_px": settings.tile_px,
                            "faces_per_tile": settings.faces_per_tile,
                            "face_demand": demand,
                            "faces": int(faces.shape[0])})
        out = rasterize_hard(v, faces, k, colors_t, settings)
        rgb = out["rgb"].cpu().numpy()
        sil = out["sil"].cpu().numpy()
        for i in range(rgb.shape[0]):
            img = images[start + i] if images is not None else None
            frames.append(composite(rgb[i], sil[i], img))
    return frames


def visualize_hand_object(state: M.HomanState, consts: M.HomanConsts,
                          cfg: M.HomanConfig,
                          images: Optional[Sequence[np.ndarray]] = None,
                          viz_len: int = 10,
                          image_size: int = 256,
                          verts_hand_gt=None,
                          verts_object_gt=None,
                          gt_only: bool = False,
                          budgets: Optional[list] = None):
    """(frontal, top_down) overlay renders (homan/visualize.py:44-128), on
    the device the state lies on."""
    device = consts.camintr.device
    with torch.no_grad():
        verts_object, _ = M.get_verts_object(state, consts)
        verts_hand, _ = M.get_verts_hand(state, consts, cfg)
    verts_object = verts_object.cpu().numpy()
    verts_hand = verts_hand.cpu().numpy()
    B = min(viz_len, verts_object.shape[0])
    obj_faces = consts.faces_object.faces.cpu().numpy()
    hand_faces = consts.faces_hand.faces.cpu().numpy()

    parts, faces, colors = [], [], []
    if not gt_only:
        parts.append(verts_object[:B])
        faces.append(obj_faces)
        colors.append("gold")
        for h in range(cfg.hand_nb):
            parts.append(verts_hand[h::cfg.hand_nb][:B])
            faces.append(hand_faces)
            colors.append("grey")
    if verts_object_gt is not None:
        parts.append(np.asarray(verts_object_gt)[:B])
        faces.append(obj_faces)
        colors.append("green")
    if verts_hand_gt is not None:
        gt = np.asarray(verts_hand_gt).reshape(-1, 778, 3)
        for h in range(cfg.hand_nb):
            parts.append(gt[h::cfg.hand_nb][:B])
            faces.append(hand_faces)
            colors.append("blue")

    K = consts.camintr[:B]
    frontal = render_scene(parts, faces, colors, K, image_size,
                           images=images[:B] if images is not None else None,
                           device=device, budgets=budgets)
    top_down = render_scene(parts, faces, colors, K, image_size, rotate=True,
                            device=device, budgets=budgets)
    return frontal, top_down


def turntable_frames(verts_list: Sequence[np.ndarray],
                     faces_list: Sequence[np.ndarray],
                     color_names: Sequence[str],
                     K,
                     n_steps: int = 24,
                     image_size: int = 256,
                     axis=(0.0, 1.0, 0.0),
                     device=None) -> List[np.ndarray]:
    """360-degree turntable of one frame's scene (homan/viz/renderot.py
    rot_render role)."""
    frames = []
    for i in range(n_steps):
        angle = 360.0 * i / n_steps
        rotated = [np.stack([rotate_in_place(v, axis=axis, angle_deg=angle)
                             for v in np.asarray(part[:1])])
                   for part in verts_list]
        frames += render_scene(rotated, faces_list, color_names, K[:1],
                               image_size, device=device)
    return frames


# -- writers on numpy and the standard library --------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _rgb_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    return np.ascontiguousarray(img)


def _idat_payload(img: np.ndarray) -> bytes:
    """Scanlines of filter type 0, deflated."""
    h = img.shape[0]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)
    return zlib.compress(raw.tobytes(), 6)


def _ihdr(h: int, w: int) -> bytes:
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))


def write_png(img, path: str) -> str:
    """(H, W, 3) uint8 (or floats in [0, 1]) as an 8-bit RGB PNG."""
    img = _rgb_u8(img)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _ihdr(*img.shape[:2])
                + _chunk(b"IDAT", _idat_payload(img)) + _chunk(b"IEND", b""))
    return path


def write_apng(frames: Sequence[np.ndarray], path: str, fps: int = 24) -> str:
    """Frames of one size as an animated PNG that loops forever (acTL, one
    fcTL a frame; the first frame in IDAT, the rest in fdAT)."""
    frames = [_rgb_u8(f) for f in frames]
    if not frames:
        raise ValueError("write_apng needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("write_apng needs frames of one size")
    parts = [_PNG_SIGNATURE, _ihdr(h, w),
             _chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, f in enumerate(frames):
        parts.append(_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, 1, max(1, int(fps)), 0, 0)))
        seq += 1
        data = _idat_payload(f)
        if i == 0:
            parts.append(_chunk(b"IDAT", data))
        else:
            parts.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    parts.append(_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
    return path


def read_apng(path: str) -> List[np.ndarray]:
    """The frames of a PNG or APNG written by write_png / write_apng (8-bit
    RGB, filter type 0), as (H, W, 3) uint8 arrays."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, w, h = len(_PNG_SIGNATURE), 0, 0
    frames, cur, animated = [], [], False
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not 8-bit RGB")
        elif tag == b"acTL":
            animated = True
        elif tag == b"fcTL" and cur:
            frames.append(b"".join(cur))
            cur = []
        elif tag == b"IDAT":
            cur.append(body)
        elif tag == b"fdAT":
            cur.append(body[4:])
        elif tag == b"IEND":
            break
    if cur:
        frames.append(b"".join(cur))
    out = []
    for payload in frames:
        raw = np.frombuffer(zlib.decompress(payload), np.uint8)
        raw = raw.reshape(h, 1 + 3 * w)
        if raw[:, 0].any():
            raise ValueError(f"{path}: scanline filters other than 0")
        out.append(raw[:, 1:].reshape(h, w, 3).copy())
    return out if animated else out[:1]


def make_video(frames: Sequence[np.ndarray], path: str, fps: int = 24) -> str:
    """mp4/webm/gif writer (libyana np2vid + homan/eval/evalviz.py:7-47).
    Returns the path written: `path`, or `<stem>.apng` beside it where the
    format's library (cv2, or PIL for gif) is missing."""
    frames = [np.asarray(f) for f in frames]
    if path.endswith(".gif"):
        pil = _import_optional("PIL.Image")
        if pil is not None:
            imgs = [pil.fromarray(f) for f in frames]
            imgs[0].save(path, save_all=True, append_images=imgs[1:],
                         duration=int(1000 / fps), loop=0)
            return path
        missing = "PIL"
    else:
        cv2 = _import_optional("cv2")
        if cv2 is not None:
            h, w = frames[0].shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*("vp80" if path.endswith(
                ".webm") else "mp4v"))
            writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
            for f in frames:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            writer.release()
            return path
        missing = "cv2"
    out = os.path.splitext(path)[0] + ".apng"
    write_apng(frames, out, fps)
    logger.info("%s is not installed: wrote %s instead of %s", missing, out,
                path)
    return out


def grid_image(rows: Dict[str, Sequence[np.ndarray]]) -> np.ndarray:
    """The rows of images composed into one (H, W, 3) uint8 picture, each
    cell as large as the largest image, white where a row is short or a
    cell is None."""
    cells = [[_rgb_u8(im) if im is not None else None for im in imgs]
             for imgs in rows.values()]
    ims = [im for row in cells for im in row if im is not None]
    ch = max(im.shape[0] for im in ims)
    cw = max(im.shape[1] for im in ims)
    ncols = max(len(r) for r in cells)
    out = np.full((len(cells) * ch, ncols * cw, 3), 255, np.uint8)
    for r, row in enumerate(cells):
        for c, im in enumerate(row):
            if im is not None:
                out[r * ch:r * ch + im.shape[0],
                    c * cw:c * cw + im.shape[1]] = im
    return out


def save_image_grid(rows: Dict[str, Sequence[np.ndarray]], path: str) -> str:
    """Labelled grid of image rows (homan/viz/viz_gtpred_points.py role).
    Where matplotlib is missing, the rows without labels as a PNG
    (grid_image, write_png). Returns the path written."""
    matplotlib = _import_optional("matplotlib")
    if matplotlib is None:
        write_png(grid_image(rows), path)
        logger.info("matplotlib is not installed: wrote %s without row "
                    "labels", path)
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    nrows = len(rows)
    ncols = max(len(v) for v in rows.values())
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(2.2 * ncols, 2.4 * nrows), squeeze=False)
    for r, (name, imgs) in enumerate(rows.items()):
        for c in range(ncols):
            ax = axes[r][c]
            ax.axis("off")
            if c < len(imgs) and imgs[c] is not None:
                ax.imshow(imgs[c])
            if c == 0:
                ax.set_title(name, fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path
