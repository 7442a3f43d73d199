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
CUDA tensor launches the kernel (or raises). `shade_fwd_launches`,
`shade_fwd_only_launches` and `shade_bwd_launches` count kernel launches
only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from homan_tpu_torch.utils_profiling import physical

# Launch counts of the CUDA kernels (the plain versions do not count);
# shade_fwd_only_launches counts the forward's launches in its forward-only
# mode, which shade_fwd_launches includes.
shade_fwd_launches = 0
shade_fwd_only_launches = 0
shade_bwd_launches = 0

# Pixels per strip of the backward (csrc/shade.cu kStripPx): one block of
# its first launch, whose compact list of slot sums the second adds in
# strip order; a smaller tile is one strip.
BWD_STRIP_PIXELS = 1024
# Adjacent pixels of one row per thread of the forward (csrc/shade.cu kPx).
# A tile that is not a multiple of it (or wider than 1024 pixels) runs the
# kernel's ragged instantiation; `fwd_work` counts the other only.
FWD_PIXELS_PER_THREAD = 8
# The forward kernel's fp32 arithmetic, compare and select operations
# (csrc/shade.cu), an FMA counted as two; `fwd_work` counts what they
# apply to. Per (valid slot, row of its tile), the records: py 4, dy and
# dy_safe 4, spans 3, py - ay 1, the divide 1, xi 3, its fold with spans
# and x1 3, |e|^2 and its clamp 4, the reciprocal 1, ex (py - ay) and
# (py - ay) ey 2, and the skip test's terms 17 (the segment's x extent 2,
# the row's gap to its y extent 6, the slack 9). The per-block count of
# valid slots is left out.
FWD_ROW_OPS_PER_ROW_SLOT = 43
# Per (pixel, valid slot): pass 1's compare, select and add.
FWD_WINDING_OPS_PER_PIXEL_SLOT = 3
# Per (pixel group, valid slot), the skip test: the box gap 4, its length
# 5, the comparison with the group's largest d2min 4.
FWD_TEST_OPS_PER_GROUP_SLOT = 13
# Per evaluated (pixel, valid slot), pass 2: px - ax 1, the numerator of
# tc 2, its quotient 1 (the kernel's reciprocal-and-correction sequence is
# one correctly rounded divide), its range guard 2, the clamp 2, dx 3, dyp
# 3, d2 3, cross2d 2, its sign 4, w_other 2, relevance 5, the capped select
# 1, the compare 1 and the argmin's five updates; and per evaluated
# (pixel group, valid slot) the group's new largest d2min 7.
FWD_DIST_OPS_PER_PIXEL_SLOT = 37
FWD_DMAX_OPS_PER_GROUP_SLOT = 7
# The largest Ke the forward takes (csrc/shade.cu kMaxForwardSmem /
# kRecordBytes): its records of one row, 64 bytes a slot, in 200 KiB of
# shared memory. The wrapper raises above it (the kernel returns -1).
FWD_MAX_KE = 200 * 1024 // 64
# Per pixel, the backward's contribution math (base, wa, wb, 4 products).
BWD_OPS_PER_PIXEL = 14


def bwd_list_floats(ke: int) -> int:
    """Floats of one strip's compact list in the backward's scratch
    (csrc/shade.cu list_floats): the count, padded to 4, then up to
    min(Ke, BWD_STRIP_PIXELS) slots, padded to a multiple of 4, and as many
    float4 sums."""
    cap = min(ke, BWD_STRIP_PIXELS)
    return 4 + -(-cap // 4) * 4 + 4 * cap


def fwd_work_ops(work: dict) -> int:
    """The forward kernel's operations for the counts of `fwd_work`."""
    return (FWD_ROW_OPS_PER_ROW_SLOT * work["row_slots"]
            + FWD_WINDING_OPS_PER_PIXEL_SLOT * work["pixel_slots"]
            + FWD_TEST_OPS_PER_GROUP_SLOT * work["group_slots"]
            + (FWD_PIXELS_PER_THREAD * FWD_DIST_OPS_PER_PIXEL_SLOT
               + FWD_DMAX_OPS_PER_GROUP_SLOT)
            * work["evaluated_group_slots"])


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


def winding_plain(seg_pack, anchors, static: ShadeStatic):
    """The forward's pass 1: winding (B, T, tp, tp) = anchor + the oriented
    crossings of each pixel's +x ray inside (px, x1]."""
    T = seg_pack.shape[1]
    dev = seg_pack.device
    px, py, x1 = _pixel_coords(static, T, dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
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
    return winding


def _slot_d2(seg, k, px, py, winding, covered, cap2):
    """Pass 2 for slot k: the capped distance^2 of every pixel to segment
    k (cap2 where the segment is not silhouette-relevant) and the residual
    geometry (dx, dyp, tc)."""
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
    return torch.where(rel, d2, cap2), dx, dyp, tc


def shade_fwd_plain(seg_pack, anchors, static: ShadeStatic,
                    want_residuals: bool = True):
    """Loop over slots; every temporary is (B, T, tp, tp)."""
    T = seg_pack.shape[1]
    dev = seg_pack.device
    px, py, _ = _pixel_coords(static, T, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cap2 = torch.tensor(static.cap2, **f32)
    seg = seg_pack[..., None, None]  # (B, T, 8, ke, 1, 1)

    winding = winding_plain(seg_pack, anchors, static)
    covered = winding.abs() > 0.5

    shape = winding.shape
    d2min = torch.full(shape, static.cap2, **f32)
    amin = torch.full(shape, -1, dtype=torch.int32, device=dev)
    rxm = torch.zeros(shape, **f32)
    rym = torch.zeros(shape, **f32)
    tcm = torch.zeros(shape, **f32)
    for k in range(static.ke):
        d2, dx, dyp, tc = _slot_d2(seg, k, px, py, winding, covered, cap2)
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


def fwd_work(seg_pack, anchors, static: ShadeStatic) -> dict:
    """What the forward kernel works on these inputs, counted by replaying
    its order of work: (row, valid slot) records, (pixel, valid slot) pass-1
    steps, (pixel group, valid slot) skip tests, and the (pixel group,
    valid slot) pairs whose pass-2 distances it evaluates. A pixel group is
    one thread's FWD_PIXELS_PER_THREAD adjacent pixels of a row; it skips a
    slot when the gap between its pixels' box and the segment's box, less
    a slack, exceeds the square root of the largest d2min of its pixels (the
    kernel's float32 expressions, so the count is exact)."""
    B, T = seg_pack.shape[:2]
    tp, npx = static.tile_px, FWD_PIXELS_PER_THREAD
    if tp % npx or tp > 128 * npx:
        raise ValueError(f"fwd_work replays the kernel's instantiation for "
                         f"tiles of a multiple of {npx} pixels up to "
                         f"{128 * npx}, got {tp}")
    dev = seg_pack.device
    px, py, _ = _pixel_coords(static, T, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cap2 = torch.tensor(static.cap2, **f32)
    seg = seg_pack[..., None, None]
    n_e = (seg_pack[:, :, 5] > 0.5).sum(-1)  # (B, T)
    n_valid = int(n_e.sum())
    winding = winding_plain(seg_pack, anchors, static)
    covered = winding.abs() > 0.5
    d2min = torch.full(winding.shape, static.cap2, **f32)
    px_first, px_last = px[..., ::npx], px[..., npx - 1::npx]
    evaluated = 0
    for k in range(static.ke):
        live = (k < n_e)[..., None, None]
        if not bool(live.any()):
            break
        ax, ay, bx, by = (seg[:, :, r, k] for r in range(4))
        big = torch.maximum(torch.maximum(ax.abs(), bx.abs()),
                            torch.maximum(ay.abs(), by.abs()))
        slack = (big + 2.0) * 2.0 ** -18
        ygap = torch.clamp(torch.maximum(torch.minimum(ay, by) - py,
                                         py - torch.maximum(ay, by)), min=0)
        gap = torch.clamp(torch.maximum(torch.minimum(ax, bx) - px_last,
                                        px_first - torch.maximum(ax, bx)),
                          min=0)
        lo = torch.sqrt(gap * gap + ygap * ygap) - slack
        dmax = d2min.reshape(B, T, tp, tp // npx, npx).amax(-1)
        skip = (lo > 0) & (lo * lo > dmax * (1.0 + 2.0 ** -18))
        evaluated += int((live & ~skip).sum())
        d2 = _slot_d2(seg, k, px, py, winding, covered, cap2)[0]
        d2min = torch.where(live & (d2 < d2min), d2, d2min)
    return {"row_slots": n_valid * tp, "pixel_slots": n_valid * tp * tp,
            "group_slots": n_valid * tp * (tp // npx),
            "evaluated_group_slots": evaluated}


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
    global shade_fwd_launches, shade_fwd_only_launches
    B, T = seg_pack.shape[:2]
    tp, ke = static.tile_px, static.ke
    dev = seg_pack.device
    _check("seg_pack", seg_pack, (B, T, 8, ke), torch.float32, dev)
    _check("anchors", anchors, (B, T, tp, tp), torch.float32, dev)
    if anchors.data_ptr() % 16:  # the kernel reads anchors as float4
        anchors = anchors.clone()
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
    if not want_residuals:
        shade_fwd_only_launches += 1
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
    gseg = torch.empty((B, T, 8, ke), dtype=torch.float32, device=dev)
    if B * T == 0:
        return gseg
    n_strips = -(-tp * tp // BWD_STRIP_PIXELS)
    # Each strip's compact list; only its count and entries are written. A
    # tile of one strip writes gseg directly and takes none.
    lists = torch.empty(B * T * n_strips * bwd_list_floats(ke)
                        if n_strips > 1 else 0, dtype=torch.float32,
                        device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shade_bwd(*(x.data_ptr() for x in residuals),
                           gcot.data_ptr(), lists.data_ptr(),
                           gseg.data_ptr(), B, T, tp, ke, n_strips,
                           static.sigma, stream)
    if rc != 0:
        raise RuntimeError(f"shade_bwd kernel launch failed: CUDA error {rc}")
    shade_bwd_launches += 1
    return gseg


def needs_grad(x) -> bool:
    """Whether a kernel's input carries a gradient: grad mode on and x
    requiring it, also under torch.func.vmap, where a batched tensor
    reports requires_grad False and the physical tensor beneath knows."""
    return torch.is_grad_enabled() and physical(x).requires_grad


def fold_batched(in_dims, *tensors):
    """The vmap rule's inputs with the vmapped dim folded into the leading
    batch dim: (C, B, ...) -> (C B, ...); an input without that dim
    (in_dim None) is repeated. Returns (C, folded tensors)."""
    n = next(t.shape[d] for t, d in zip(tensors, in_dims) if d is not None)
    out = []
    for t, d in zip(tensors, in_dims):
        t = (t.movedim(d, 0) if d is not None
             else t[None].expand((n,) + tuple(t.shape)))
        out.append(t.reshape((-1,) + tuple(t.shape[2:])))
    return n, out


def unfold_batched(n, outputs):
    """(C B, ...) -> (C, B, ...) for each output, and their out_dims."""
    outs = tuple(o.reshape((n, -1) + tuple(o.shape[1:])) for o in outputs)
    return outs, (0,) * len(outs)


class _ShadeTiles(torch.autograd.Function):
    """sil = shade(seg_pack, anchors) with the analytic argmin backward.

    Under torch.func.vmap (parallel/clips.py's batched clips) the clip dim
    is folded into the frame dim, so one launch covers every clip."""

    @staticmethod
    def forward(seg_pack, anchors, static):
        return shade_fwd(seg_pack, anchors, static, want_residuals=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.static = inputs[2]
        ctx.save_for_backward(*output)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, gcot, *_):
        gseg = shade_bwd(ctx.saved_tensors, gcot.contiguous(), ctx.static)
        return gseg, None, None

    @staticmethod
    def vmap(info, in_dims, seg_pack, anchors, static):
        n, (seg_pack, anchors) = fold_batched(in_dims[:2], seg_pack, anchors)
        return unfold_batched(n, _ShadeTiles.apply(
            seg_pack.contiguous(), anchors.contiguous(), static))


def shade_tiles(seg_pack, anchors, static: ShadeStatic):
    """(B, T, tp, tp) soft silhouette tiles.

    Callers that need no gradient (evidence renders) take the forward-only
    mode, which writes sil alone, as `shade_tiles_pallas` does.
    """
    seg_pack = seg_pack.contiguous()
    anchors = anchors.contiguous()
    if needs_grad(seg_pack):
        return _ShadeTiles.apply(seg_pack, anchors, static)[0]
    return shade_fwd(seg_pack, anchors, static, want_residuals=False)[0]
