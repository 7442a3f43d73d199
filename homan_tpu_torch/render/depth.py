"""Hard z-buffer depth tiles: CUDA kernel pair + plain versions.

Replaces the TPU kernels `_depth_fwd_kernel` (homan_tpu/render/
pallas_depth.py:56, called through `depth_tiles_pallas` / `_depth_fwd`
:155) and `_depth_bwd_kernel` (:180, called through `_depth_bwd_vjp` :235).
The kernels live in csrc/depth.cu and are built by homan_tpu_torch/_build.py.

Over a triangle, inverse depth is linear in screen space, so the prep
(render/rasterizer.py `depth_prep`) reduces each binned face to its three
sign-folded edge lines and its inverse-depth plane:

  forward:  best(p) = max over valid slots k with e_i,k(p) >= 0 (i = 0..2)
            of invz_k(p) = Az px + Bz py + Cz; a sequential scan with strict
            > from best = 0, so the lowest slot wins a tie and amax = -1
            where the pixel is uncovered (JAX's chunked first-match argmax);
            depth = 1 / max(best, 1e-9) where best > 0, else 0
  backward: only the winning slot k*(p) receives gradient; with coef =
            -gcot * depth^2 (0 where uncovered), rows 9-11 (Az, Bz, Cz) of
            slot k get the sums of (coef px, coef py, coef) over the pixels
            whose amax is k; every other row is 0. The inside test gets no
            gradient (envelope), as a CUDA z-buffer's depth backward.

The forward kernel scans, for each 8 x 8 sub-tile, only the slots that an
exact cull keeps: a slot is dropped where some edge is negative at every
pixel centre of the sub-tile as the kernel rounds it (`cull_keep` replays
the test, `fwd_work` counts the work it leaves); the outputs do not change.

Dispatch is by device: a CPU tensor runs the plain PyTorch version below, a
CUDA tensor launches the kernel (or raises). `depth_fwd_launches` and
`depth_bwd_launches` count kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from homan_tpu_torch.render.shade import (_check, _pixel_coords, _require_cuda,
                                          fold_batched, needs_grad,
                                          unfold_batched)

# Launch counts of the CUDA kernels (the plain versions do not count).
depth_fwd_launches = 0
depth_bwd_launches = 0

# Pixels per chunk of the backward, whose per-chunk sums are added in
# chunk order (csrc/depth.cu kThreads).
BLOCK_PIXELS = 256
# Floats of one chunk's compact list in the backward's scratch: the count,
# padded to 4, then (slot, v0, v1, v2) per distinct slot (kListFloats).
BWD_LIST_FLOATS = 4 + 4 * BLOCK_PIXELS
# The forward's geometry (csrc/depth.cu kSub, kRegion): a block owns a
# FWD_REGION x FWD_REGION region of a tile, a warp an FWD_SUB x FWD_SUB
# sub-tile of it; at the edge of a tile that is not a multiple of
# FWD_REGION, regions and sub-tiles hold only the pixels inside it.
FWD_SUB = 8
FWD_REGION = 16
# Per evaluated (pixel, slot), the forward kernel's fp32 arithmetic and
# compares: four linear forms of 2 products and 2 sums each (16), three
# `>= 0` tests and the `> best` test (4), two selects (csrc/depth.cu).
FWD_OPS_PER_PIXEL_SLOT = 22
# Per (box, slot) cull test, for each of the three edges: a px and b py at
# the box's two x and two y corners (4 products), the four corner values
# (8 sums), their maximum (3), the slack |a| + |b| + |c| times 2^-20 (3),
# its sum with the maximum and the compare (2); and the two ands.
FWD_CULL_OPS_PER_BOX_SLOT = 3 * 20 + 2
# Per pixel, the backward's coef = -gcot*depth*depth (3), its select, and
# coef*px, coef*py (2).
BWD_OPS_PER_PIXEL = 6


class DepthStatic(NamedTuple):
    tile_px: int
    image_size: int
    g: int   # tiles per row
    kf: int  # face slots per tile


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------
def _slot_inside(fp, k, px, py):
    """Slot k of the (B, T, 16, kf, 1, 1) pack at every pixel: inside (all
    three edges >= 0 and the slot valid) and invz, (B, T, tp, tp)."""
    a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz, valid = (
        fp[:, :, r, k] for r in range(13))
    e0 = a0 * px + b0 * py + c0
    e1 = a1 * px + b1 * py + c1
    e2 = a2 * px + b2 * py + c2
    invz = az * px + bz * py + cz
    inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (valid > 0.0)
    return inside, invz


def depth_fwd_plain(face_pack, static: DepthStatic):
    """Sequential scan over the slots; every temporary is (B, T, tp, tp).
    Returns depth (B, T, tp, tp) float32 and amax (B, T, tp, tp) int32."""
    B, T = face_pack.shape[:2]
    tp = static.tile_px
    dev = face_pack.device
    px, py, _ = _pixel_coords(static, T, dev)
    best = torch.zeros((B, T, tp, tp), dtype=torch.float32, device=dev)
    am = torch.full((B, T, tp, tp), -1, dtype=torch.int32, device=dev)
    n_max = int(face_pack[:, :, 12].sum(-1).max()) if B * T else 0
    fp = face_pack[..., None, None]  # (B, T, 16, kf, 1, 1)
    for k in range(min(n_max, static.kf)):
        inside, invz = _slot_inside(fp, k, px, py)
        better = inside & (invz > best)
        best = torch.where(better, invz, best)
        am = torch.where(better, torch.full_like(am, k), am)
    covered = best > 0.0
    depth = torch.where(covered, 1.0 / torch.clamp(best, min=1e-9),
                        torch.zeros((), device=dev))
    amax = torch.where(covered, am, torch.full_like(am, -1))
    return depth, amax


def _check_tile(tp):
    if tp <= 0:
        raise ValueError(f"the depth kernel takes tiles of a positive "
                         f"number of pixels, got {tp}")


def _box_ends(tp: int, side: int):
    """First and last pixel of each side-wide box of a tp-wide tile, the
    last clamped to the tile (as the kernel clamps its ragged edge)."""
    first = torch.arange(0, tp, side)
    return first, (first + side - 1).clamp(max=tp - 1)


def _box_keep(face_pack, static: DepthStatic, side: int):
    """(B, T, n, n, kf) bool, n = ceil(tp / side): the kernel's cull test
    of each slot against each side x side box of pixel centres (clamped to
    the tile), in its float32 expressions: no edge's rounded maximum over
    the box's four corner centres, plus the slack (|a| + |b| + |c|) 2^-20,
    is negative."""
    T = face_pack.shape[1]
    px, py, _ = _pixel_coords(static, T, face_pack.device)
    first, last = (i.to(face_pack.device)
                   for i in _box_ends(static.tile_px, side))
    x0 = px[:, :, 0, first][:, :, None, :, None]  # (1, T, 1, n, 1)
    x1 = px[:, :, 0, last][:, :, None, :, None]
    y0 = py[:, :, first, 0][:, :, :, None, None]  # (1, T, n, 1, 1)
    y1 = py[:, :, last, 0][:, :, :, None, None]
    keep = None
    for i in range(3):
        a, b, c = (face_pack[:, :, 3 * i + j][:, :, None, None, :]
                   for j in range(3))
        m = torch.maximum(
            torch.maximum(a * x0 + b * y0 + c, a * x1 + b * y0 + c),
            torch.maximum(a * x0 + b * y1 + c, a * x1 + b * y1 + c))
        slack = (a.abs() + b.abs() + c.abs()) * 2.0 ** -20
        ok = m + slack >= 0.0
        keep = ok if keep is None else keep & ok
    return keep


def cull_keep(face_pack, static: DepthStatic):
    """(B, T, n, n, kf) bool, n = ceil(tp/FWD_SUB): the valid slots the
    forward kernel scans for each warp's sub-tile (its block's region test,
    then the sub-tile's), and (B, T, m, m, kf), m = ceil(tp/FWD_REGION),
    the region test's survivors among the valid slots."""
    _check_tile(static.tile_px)
    n = -(-static.tile_px // FWD_SUB)
    valid = (face_pack[:, :, 12] > 0.5)[:, :, None, None, :]
    in_region = _box_keep(face_pack, static, FWD_REGION) & valid
    r = FWD_REGION // FWD_SUB
    region_of_sub = in_region.repeat_interleave(r, 2).repeat_interleave(
        r, 3)[:, :, :n, :n]
    keep = _box_keep(face_pack, static, FWD_SUB) & region_of_sub
    return keep, in_region


def _box_counts(tp: int, side: int, inner: int):
    """(n, n) int64, n = ceil(tp / side): the inner-wide boxes (1 for
    pixels) inside the tile in each side-wide box."""
    first, last = _box_ends(tp, side)
    per = -(-(last - first + 1) // inner)
    return per[:, None] * per[None, :]


def fwd_work(face_pack, static: DepthStatic) -> dict:
    """What the forward kernel works on these inputs, counted by replaying
    its cull (`cull_keep`): (region, valid slot) cull tests, (sub-tile
    inside the tile, slot kept by its region) cull tests, (pixel inside
    the tile, slot kept by its sub-tile) evaluations, and the (pixel, valid
    slot) pairs a dense scan evaluates."""
    tp = static.tile_px
    keep, in_region = cull_keep(face_pack, static)
    n_valid = int((face_pack[:, :, 12] > 0.5).sum())
    dev = face_pack.device
    subs = _box_counts(tp, FWD_REGION, FWD_SUB).to(dev)
    pixels = _box_counts(tp, FWD_SUB, 1).to(dev)
    return {"region_tests": n_valid * (-(-tp // FWD_REGION)) ** 2,
            "sub_tests": int((in_region.sum(-1) * subs).sum()),
            "pixel_slots": int((keep.sum(-1) * pixels).sum()),
            "valid_pixel_slots": n_valid * tp * tp}


def fwd_work_ops(work: dict) -> int:
    """The forward kernel's operations for the counts of `fwd_work`."""
    return (FWD_CULL_OPS_PER_BOX_SLOT * (work["region_tests"]
                                         + work["sub_tests"])
            + FWD_OPS_PER_PIXEL_SLOT * work["pixel_slots"])


def depth_bwd_plain(depth, amax, gcot, static: DepthStatic):
    """gpack (B, T, 16, Kf): per slot, the sums over its argmax pixels."""
    B, T = depth.shape[:2]
    kf, P = static.kf, static.tile_px ** 2
    dev = depth.device
    px, py, _ = _pixel_coords(static, T, dev)
    coef = torch.where(depth > 0.0, -gcot * depth * depth,
                       torch.zeros((), device=dev))
    contrib = torch.stack([coef * px, coef * py, coef], dim=2).reshape(
        B, T, 3, P)
    slot = torch.where(amax >= 0, amax, kf).to(torch.int64)
    slot = slot.reshape(B, T, 1, P).expand(B, T, 3, P)
    acc = torch.zeros((B, T, 3, kf + 1), dtype=torch.float32, device=dev)
    acc.scatter_add_(-1, slot, contrib)
    gpack = torch.zeros((B, T, 16, kf), dtype=torch.float32, device=dev)
    gpack[:, :, 9:12] = acc[..., :kf]
    return gpack


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def _lib():
    from homan_tpu_torch import _build
    lib = _build.load("depth")
    if lib.depth_fwd.argtypes is None:
        lib.depth_fwd.argtypes = [_PTR] * 3 + [_INT] * 5 + [_FLT, _PTR]
        lib.depth_fwd.restype = ctypes.c_int
        lib.depth_bwd.argtypes = [_PTR] * 5 + [_INT] * 6 + [_FLT, _PTR]
        lib.depth_bwd.restype = ctypes.c_int
    return lib


def depth_fwd(face_pack, static: DepthStatic):
    """depth (B, T, tp, tp) float32 and amax (B, T, tp, tp) int32."""
    if face_pack.device.type == "cpu":
        return depth_fwd_plain(face_pack, static)
    _require_cuda(face_pack)
    global depth_fwd_launches
    B, T = face_pack.shape[:2]
    tp, kf = static.tile_px, static.kf
    dev = face_pack.device
    _check("face_pack", face_pack, (B, T, 16, kf), torch.float32, dev)
    _check_tile(tp)
    depth = torch.empty((B, T, tp, tp), dtype=torch.float32, device=dev)
    amax = torch.empty((B, T, tp, tp), dtype=torch.int32, device=dev)
    if B * T == 0:
        return depth, amax
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.depth_fwd(face_pack.data_ptr(), depth.data_ptr(),
                           amax.data_ptr(), B, T, static.g, tp, kf,
                           1.0 / static.image_size, stream)
    if rc != 0:
        raise RuntimeError(f"depth_fwd kernel launch failed: CUDA error {rc}")
    depth_fwd_launches += 1
    return depth, amax


def depth_bwd(depth, amax, gcot, static: DepthStatic):
    """gpack (B, T, 16, Kf) from the forward's outputs and depth's
    cotangent."""
    if depth.device.type == "cpu":
        return depth_bwd_plain(depth, amax, gcot, static)
    _require_cuda(depth)
    global depth_bwd_launches
    B, T = depth.shape[:2]
    tp, kf = static.tile_px, static.kf
    dev = depth.device
    px_shape = (B, T, tp, tp)
    _check("depth", depth, px_shape, torch.float32, dev)
    _check("amax", amax, px_shape, torch.int32, dev)
    _check("gcot", gcot, px_shape, torch.float32, dev)
    gpack = torch.empty((B, T, 16, kf), dtype=torch.float32, device=dev)
    if B * T == 0:
        return gpack
    n_chunks = -(-tp * tp // BLOCK_PIXELS)
    # Each chunk's compact list; only its count and entries are written.
    lists = torch.empty(B * T * n_chunks * BWD_LIST_FLOATS,
                        dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.depth_bwd(depth.data_ptr(), amax.data_ptr(),
                           gcot.data_ptr(), lists.data_ptr(),
                           gpack.data_ptr(), B, T, static.g, tp, kf,
                           n_chunks, 1.0 / static.image_size, stream)
    if rc != 0:
        raise RuntimeError(f"depth_bwd kernel launch failed: CUDA error {rc}")
    depth_bwd_launches += 1
    return gpack


class _DepthTiles(torch.autograd.Function):
    """depth = zbuffer(face_pack) with the argmax-slot backward; under
    torch.func.vmap one launch covers every clip (shade.fold_batched)."""

    @staticmethod
    def forward(face_pack, static):
        return depth_fwd(face_pack, static)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.static = inputs[1]
        ctx.save_for_backward(*output)
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, gcot, _):
        depth, amax = ctx.saved_tensors
        return depth_bwd(depth, amax, gcot.contiguous(), ctx.static), None

    @staticmethod
    def vmap(info, in_dims, face_pack, static):
        n, (face_pack,) = fold_batched(in_dims[:1], face_pack)
        return unfold_batched(n, _DepthTiles.apply(face_pack.contiguous(),
                                                   static))


def depth_tiles(face_pack, static: DepthStatic):
    """(B, T, tp, tp) hard z-buffer depth tiles, 0 where uncovered."""
    face_pack = face_pack.contiguous()
    if needs_grad(face_pack):
        return _DepthTiles.apply(face_pack, static)[0]
    return depth_fwd(face_pack, static)[0]
