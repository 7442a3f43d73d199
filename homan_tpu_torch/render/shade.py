"""Tile shading of the soft silhouette: CUDA kernel pair + plain versions.

Replaces the TPU kernel `_shade_fwd_kernel` (homan_tpu/render/pallas_shade.py
:86, called through `shade_tiles_pallas` :224 / `_shade_fwd` :237) and its
XLA backward `_shade_bwd_vjp` (:281). The kernels live in csrc/shade.cu and
are built by homan_tpu_torch/_build.py.

  forward:  winding(p) = anchor(p) + sum_k sign_k * [segment k crosses the
            +x ray of p inside (px, x1]]
            d2(p) = min over silhouette-relevant k of dist^2(p, segment_k),
            capped at cap2, plus the argmin k* and its residual geometry
            (rx, ry, tc)
            sil(p) = sigmoid(sign(winding) * d2 / sigma)
  backward: only k*(p) receives gradient: with base = +-gcot*sil(1-sil)/sigma,
            d/da = -2 base (1 - tc) r and d/db = -2 base tc r, summed per
            slot over the pixels that picked it (seg_pack rows 0-3; rows
            4-7 and the anchors get none).

Dispatch is by device: a CPU tensor runs the plain PyTorch version below, a
CUDA tensor launches the kernel (or raises). `shade_fwd_launches` and
`shade_bwd_launches` count kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

# Launch counts of the CUDA kernels (the plain versions do not count).
shade_fwd_launches = 0
shade_bwd_launches = 0

# Pixels per CUDA block; also the backward's partial-sum chunk.
BLOCK_PIXELS = 256
# Per pixel and valid slot, the forward kernel's fp32 arithmetic, compare
# and select operations (winding pass 18, distance pass 44; csrc/shade.cu).
FWD_OPS_PER_PIXEL_SLOT = 62
# Per pixel, the backward's contribution math (base, wa, wb, 4 products).
BWD_OPS_PER_PIXEL = 14


class ShadeStatic(NamedTuple):
    tile_px: int
    image_size: int
    g: int          # tiles per row
    sigma: float
    cap2: float     # distance cap (bin margin squared)
    ke: int         # edge slots per tile


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------
def _pixel_coords(static: ShadeStatic, T: int, device):
    """px, py (1, T, tp, tp) pixel centres and x1 (1, T, 1, 1) tile right
    edges, with the kernel's float32 expression order."""
    tp, S, g = static.tile_px, static.image_size, static.g
    t = torch.arange(T, device=device)
    gx = (t % g).to(torch.float32)[None, :, None, None]
    gy = (t // g).to(torch.float32)[None, :, None, None]
    ar = torch.arange(tp, device=device, dtype=torch.float32)
    ix = ar[None, None, None, :]
    iy = ar[None, None, :, None]
    inv_s = torch.tensor(1.0 / S, dtype=torch.float32, device=device)
    px = (gx * tp + ix + 0.5) * inv_s
    py = (gy * tp + iy + 0.5) * inv_s
    x1 = (gx + 1.0) * tp * inv_s
    return px, py, x1


def shade_fwd_plain(seg_pack, anchors, static: ShadeStatic,
                    want_residuals: bool = True):
    """Loop over slots; every temporary is (B, T, tp, tp)."""
    B, T = seg_pack.shape[:2]
    dev = seg_pack.device
    px, py, x1 = _pixel_coords(static, T, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    one = torch.ones((), **f32)
    zero = torch.zeros((), **f32)
    cap2 = torch.tensor(static.cap2, **f32)
    seg = seg_pack[..., None, None]  # (B, T, 8, ke, 1, 1)

    winding = anchors.clone()
    for k in range(static.ke):
        ax, ay, bx, by, sgn = (seg[:, :, r, k] for r in range(5))
        dy = by - ay
        dy_safe = torch.where(dy.abs() > 1e-12, dy, one)
        spans = (ay <= py) != (by <= py)
        tt = (py - ay) / dy_safe
        xi = ax + tt * (bx - ax)
        cross = spans & (xi > px) & (xi <= x1)
        winding = winding + torch.where(cross, sgn, zero)
    covered = winding.abs() > 0.5

    shape = winding.shape
    d2min = torch.full(shape, static.cap2, **f32)
    amin = torch.full(shape, -1, dtype=torch.int32, device=dev)
    rxm = torch.zeros(shape, **f32)
    rym = torch.zeros(shape, **f32)
    tcm = torch.zeros(shape, **f32)
    for k in range(static.ke):
        ax, ay, bx, by = (seg[:, :, r, k] for r in range(4))
        flipk = seg[:, :, 6, k]
        ex = bx - ax
        ey = by - ay
        denom = torch.clamp(ex * ex + ey * ey, min=1e-12)
        tc = torch.clamp(((px - ax) * ex + (py - ay) * ey) / denom, 0.0, 1.0)
        dx = px - (ax + tc * ex)
        dyp = py - (ay + tc * ey)
        d2 = dx * dx + dyp * dyp
        cross2d = ex * (py - ay) - ey * (px - ax)
        w_other = winding - flipk * torch.sign(cross2d)
        rel = (w_other.abs() < 0.5) | (cross2d == 0.0) | ~covered
        d2 = torch.where(rel, d2, cap2)
        better = d2 < d2min
        d2min = torch.where(better, d2, d2min)
        if want_residuals:
            amin = torch.where(better, torch.full_like(amin, k), amin)
            rxm = torch.where(better, dx, rxm)
            rym = torch.where(better, dyp, rym)
            tcm = torch.where(better, tc, tcm)
    signed = torch.where(covered, d2min, -d2min)
    sil = torch.sigmoid(signed / torch.tensor(static.sigma, **f32))
    if not want_residuals:
        return (sil,)
    return sil, amin, rxm, rym, tcm


def _bwd_contrib(sil, rx, ry, tc, gcot, sigma: float):
    """(B, T, tp, tp, 4) per-pixel endpoint gradients of the argmin slot."""
    covered = sil >= 0.5
    base = gcot * sil * (1.0 - sil) / torch.tensor(
        sigma, dtype=torch.float32, device=sil.device)
    base = torch.where(covered, base, -base)
    wa = -2.0 * base * (1.0 - tc)
    wb = -2.0 * base * tc
    return torch.stack([wa * rx, wa * ry, wb * rx, wb * ry], dim=-1)


def shade_bwd_plain(residuals, gcot, static: ShadeStatic):
    """Per slot, the sum over the pixels whose argmin is that slot."""
    sil, amin, rx, ry, tc = residuals
    B, T = sil.shape[:2]
    contrib = _bwd_contrib(sil, rx, ry, tc, gcot, static.sigma)
    gseg = torch.zeros((B, T, 8, static.ke), dtype=torch.float32,
                       device=sil.device)
    for k in range(static.ke):
        mask = (amin == k)[..., None]
        gseg[:, :, :4, k] = torch.where(mask, contrib, 0.0).sum(dim=(2, 3))
    return gseg


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def _lib():
    from homan_tpu_torch import _build
    lib = _build.load("shade")
    if lib.shade_fwd.argtypes is None:
        lib.shade_fwd.argtypes = [_PTR] * 7 + [_INT] * 6 + [_FLT] * 3 + [_PTR]
        lib.shade_fwd.restype = ctypes.c_int
        lib.shade_bwd.argtypes = [_PTR] * 8 + [_INT] * 5 + [_FLT, _PTR]
        lib.shade_bwd.restype = ctypes.c_int
    return lib


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels' wrappers take CPU or CUDA "
                         f"tensors, got {x.device}")


def shade_fwd(seg_pack, anchors, static: ShadeStatic,
              want_residuals: bool = True):
    """(sil,) or (sil, amin, rx, ry, tc), each (B, T, tp, tp)."""
    if seg_pack.device.type == "cpu":
        return shade_fwd_plain(seg_pack, anchors, static, want_residuals)
    _require_cuda(seg_pack)
    global shade_fwd_launches
    B, T = seg_pack.shape[:2]
    tp, ke = static.tile_px, static.ke
    dev = seg_pack.device
    _check("seg_pack", seg_pack, (B, T, 8, ke), torch.float32, dev)
    _check("anchors", anchors, (B, T, tp, tp), torch.float32, dev)
    px_shape = (B, T, tp, tp)
    sil = torch.empty(px_shape, dtype=torch.float32, device=dev)
    if want_residuals:
        amin = torch.empty(px_shape, dtype=torch.int32, device=dev)
        rx, ry, tc = (torch.empty_like(sil) for _ in range(3))
        ptrs = [amin.data_ptr(), rx.data_ptr(), ry.data_ptr(), tc.data_ptr()]
    else:
        ptrs = [None] * 4
    if B * T == 0:
        return (sil, amin, rx, ry, tc) if want_residuals else (sil,)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shade_fwd(seg_pack.data_ptr(), anchors.data_ptr(),
                           sil.data_ptr(), *ptrs, B, T, static.g, tp, ke,
                           int(want_residuals), 1.0 / static.image_size,
                           static.sigma, static.cap2, stream)
    if rc != 0:
        raise RuntimeError(f"shade_fwd kernel launch failed: CUDA error {rc}")
    shade_fwd_launches += 1
    return (sil, amin, rx, ry, tc) if want_residuals else (sil,)


def shade_bwd(residuals, gcot, static: ShadeStatic):
    """gseg (B, T, 8, Ke) from the forward's residuals and sil's cotangent."""
    sil = residuals[0]
    if sil.device.type == "cpu":
        return shade_bwd_plain(residuals, gcot, static)
    _require_cuda(sil)
    global shade_bwd_launches
    B, T = sil.shape[:2]
    tp, ke = static.tile_px, static.ke
    dev = sil.device
    px_shape = (B, T, tp, tp)
    names = ("sil", "amin", "rx", "ry", "tc")
    for name, x in zip(names, residuals):
        dt = torch.int32 if name == "amin" else torch.float32
        _check(name, x, px_shape, dt, dev)
    _check("gcot", gcot, px_shape, torch.float32, dev)
    n_chunks = -(-tp * tp // BLOCK_PIXELS)
    gseg = torch.empty((B, T, 8, ke), dtype=torch.float32, device=dev)
    if B * T == 0:
        return gseg
    partial = torch.empty((B, T, n_chunks, 4, ke), dtype=torch.float32,
                          device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shade_bwd(*(x.data_ptr() for x in residuals),
                           gcot.data_ptr(), partial.data_ptr(),
                           gseg.data_ptr(), B, T, tp, ke, n_chunks,
                           static.sigma, stream)
    if rc != 0:
        raise RuntimeError(f"shade_bwd kernel launch failed: CUDA error {rc}")
    shade_bwd_launches += 1
    return gseg


class _ShadeTiles(torch.autograd.Function):
    """sil = shade(seg_pack, anchors) with the analytic argmin backward."""

    @staticmethod
    def forward(ctx, seg_pack, anchors, static):
        sil, amin, rx, ry, tc = shade_fwd(seg_pack, anchors, static,
                                          want_residuals=True)
        ctx.static = static
        ctx.save_for_backward(sil, amin, rx, ry, tc)
        return sil

    @staticmethod
    def backward(ctx, gcot):
        gseg = shade_bwd(ctx.saved_tensors, gcot.contiguous(), ctx.static)
        return gseg, None, None


def shade_tiles(seg_pack, anchors, static: ShadeStatic):
    """(B, T, tp, tp) soft silhouette tiles.

    Callers that need no gradient (evidence renders) take the forward-only
    mode, which writes sil alone, as `shade_tiles_pallas` does.
    """
    seg_pack = seg_pack.contiguous()
    anchors = anchors.contiguous()
    if torch.is_grad_enabled() and seg_pack.requires_grad:
        return _ShadeTiles.apply(seg_pack, anchors, static)
    return shade_fwd(seg_pack, anchors, static, want_residuals=False)[0]
