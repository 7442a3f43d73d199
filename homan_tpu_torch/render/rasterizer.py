"""Tiled soft-silhouette rasterizer, the silhouette half of
homan_tpu/render/rasterizer.py.

    sil(p) = sigmoid( sign(p) * d^2(p, contour edges) / sigma )

sign(p) is the winding number of the projected occluding contour (exact,
hard); d^2 runs over the silhouette-relevant contour edges binned to p's
tile. The binning prep (`shade_prep`, the counterpart of `_pallas_prep`)
packs, per tile, the first `edges_per_tile` overlapping contour edges in
edge-index order plus the winding anchors; on the card its piecewise
constant part is one hand-written CUDA kernel (csrc/prep.cu, which compacts
each frame's contour edges before it sweeps rows and bins tiles). The
shading runs in the hand-written CUDA kernel pair of render/shade.py. The
tensor's device decides the path: CUDA tensors launch the kernels, CPU
tensors run their plain PyTorch versions.

Gradients reach the vertices only through the packed segment endpoints
(rows 0-3 of seg_pack); winding, contour flags and anchors are piecewise
constant and built without a graph.

The depth half (`depth_prep`, `rasterize_depth`; the counterpart of
`_rasterize_depth_pallas`) bins faces the same way, the first
`faces_per_tile` overlapping faces per tile in face-index order, reduces
each to its sign-folded edge lines and its screen-linear inverse depth, and
runs the hard z-buffer kernel pair of render/depth.py.

`rasterize_hard`, the non-differentiable z-buffer of the evidence and viz
renders (flat or Phong shading), has no kernel: it is plain PyTorch on the
same face binning. `auto_edge_settings` and `bump_edge_settings` size the
shade kernels' edge slots from the measured contour-edge demand.
"""
from __future__ import annotations

import ctypes
import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from homan_tpu_torch.render.depth import DepthStatic, depth_tiles
from homan_tpu_torch.render.shade import (FWD_MAX_KE, ShadeStatic, _check,
                                          _require_cuda, fold_batched,
                                          shade_tiles, unfold_batched)
from homan_tpu_torch.utils_profiling import count, span, tally


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    image_size: int = 256
    # Softness of the silhouette band in (normalized distance)^2 units.
    sigma: float = 1e-5
    tile_px: int = 64
    faces_per_tile: int = 256  # depth pass only
    edges_per_tile: int = 64
    znear: float = 1e-4
    # Margin (pixels) around edge bboxes when binning; also the distance cap.
    bin_margin_px: float = 8.0


# (shape, content hash, device) -> MeshTopology, least recently used evicted.
_TOPOLOGY_CACHE: "OrderedDict" = OrderedDict()
_TOPOLOGY_CACHE_CAP = 64


@dataclasses.dataclass
class MeshTopology:
    """Static mesh connectivity: faces + unique edges with adjacent faces."""
    faces: torch.Tensor        # (F, 3) int64
    edges: torch.Tensor        # (E, 2) int64 vertex ids
    edge_faces: torch.Tensor   # (E, 2) int64 adjacent face ids, -1 = boundary
    # True where edges[e] = (u, v) appears as u->v in faces[edge_faces[e, 0]].
    edge_dir_f1: torch.Tensor  # (E,) bool

    @classmethod
    def from_faces(cls, faces, device=None) -> "MeshTopology":
        """Build (host numpy, memoized by content) and place on `device`
        (default: the device of `faces` if it is a tensor, else the CPU)."""
        if device is None:
            device = (faces.device if isinstance(faces, torch.Tensor)
                      else torch.device("cpu"))
        if isinstance(faces, torch.Tensor):
            faces = faces.detach().cpu().numpy()
        f = np.asarray(faces, np.int64)
        key = (f.shape, hash(np.ascontiguousarray(f).tobytes()),
               str(torch.device(device)))
        hit = _TOPOLOGY_CACHE.get(key)
        if hit is not None:
            _TOPOLOGY_CACHE.move_to_end(key)
            return hit
        topo = cls.from_arrays(device=device, **_build_from_faces(f))
        if len(_TOPOLOGY_CACHE) >= _TOPOLOGY_CACHE_CAP:
            _TOPOLOGY_CACHE.popitem(last=False)
        _TOPOLOGY_CACHE[key] = topo
        return topo

    @classmethod
    def from_arrays(cls, faces, edges, edge_faces, edge_dir_f1,
                    device) -> "MeshTopology":
        def t(a, dt):
            return torch.as_tensor(np.array(a), dtype=dt, device=device)
        return cls(faces=t(faces, torch.int64), edges=t(edges, torch.int64),
                   edge_faces=t(edge_faces, torch.int64),
                   edge_dir_f1=t(edge_dir_f1, torch.bool))


def _build_from_faces(f: np.ndarray) -> dict:
    """Unique undirected edges sorted by (u, v); per edge the first two faces
    in face-major (a,b),(b,c),(c,a) order; dir_f1 = whether the edge runs
    u->v in its slot-0 face (homan_tpu/render/rasterizer.py:136-185).
    Degenerate faces stay in `faces` but contribute no edges."""
    good = ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
            & (f[:, 0] != f[:, 2]))
    fg = f[good]
    if fg.size:
        gid = np.nonzero(good)[0]
        dir_edges = np.stack(
            [fg[:, [0, 1]], fg[:, [1, 2]], fg[:, [2, 0]]],
            axis=1).reshape(-1, 2)
        face_of = np.repeat(gid, 3)
        canon = np.sort(dir_edges, axis=1)
        edges, inverse = np.unique(canon, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        order = np.argsort(inverse, kind="stable")
        counts = np.bincount(inverse, minlength=len(edges))
        starts = np.searchsorted(inverse[order], np.arange(len(edges)))
        adj = np.full((len(edges), 2), -1, np.int64)
        adj[:, 0] = face_of[order[starts]]
        second = np.minimum(starts + 1, len(order) - 1)
        adj[:, 1] = np.where(counts > 1, face_of[order[second]], -1)
        first_dir = dir_edges[order[starts]]
        dir_f1 = first_dir[:, 0] < first_dir[:, 1]
    else:
        edges = np.zeros((1, 2), np.int64)
        adj = np.full((1, 2), -1, np.int64)
        dir_f1 = np.zeros(1, bool)
    return {"faces": f, "edges": edges, "edge_faces": adj,
            "edge_dir_f1": dir_f1}


def as_topology(faces_or_topo, device=None) -> MeshTopology:
    if isinstance(faces_or_topo, MeshTopology):
        return faces_or_topo
    return MeshTopology.from_faces(faces_or_topo, device=device)


def project_ndc(verts: torch.Tensor, K: torch.Tensor, eps: float = 1e-9):
    """(B, V, 3) camera-space verts, (B, 3, 3) normalized K -> uv (B, V, 2)
    in image-fraction units and z (B, V)."""
    proj = verts @ K.transpose(1, 2)
    z = verts[..., 2]
    uv = proj[..., :2] / torch.clamp(proj[..., 2:3], min=eps)
    return uv, z


def _edge_fn(p, a, b):
    """Signed parallelogram area of (b - a) x (p - a)."""
    return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))


def _tile_overlap(lo, hi, valid, s: RasterSettings, margin: float):
    """(B, T, N) bbox-tile overlap mask — the binning predicate.

    lo, hi: (B, N, 2) candidate bboxes in normalized coords; valid (B, N).
    """
    S, tp = s.image_size, s.tile_px
    g = S // tp
    lo = lo - margin
    hi = hi + margin
    t_idx = torch.arange(g * g, device=lo.device)
    t_xy = torch.stack([t_idx % g, t_idx // g], dim=-1).to(torch.float32)
    t_lo = t_xy * tp / S
    t_hi = (t_xy + 1) * tp / S
    lo = lo[:, None]
    hi = hi[:, None]
    return ((lo[..., 0] <= t_hi[None, :, None, 0])
            & (hi[..., 0] >= t_lo[None, :, None, 0])
            & (lo[..., 1] <= t_hi[None, :, None, 1])
            & (hi[..., 1] >= t_lo[None, :, None, 1])
            & valid[:, None, :])


def _bin_first(overlap, cap: int):
    """The first `cap` overlapping candidates of each (B, T) row, in index
    order (the tie order of the JAX prep's binary top-k), valid slots as a
    prefix: rank r's candidate is the first index where the running overlap
    count reaches r. Returns idx (B, T, cap), clamped into range, hit
    (B, T, cap) bool, and the inverse map slot_of (B, T, N): candidate n's
    slot in tile t, or `cap` where it was not binned."""
    B, T, N = overlap.shape
    csum = torch.cumsum(overlap.to(torch.int32), dim=-1, dtype=torch.int32)
    ranks = torch.arange(1, cap + 1, device=overlap.device, dtype=torch.int32)
    idx = torch.searchsorted(csum, ranks.expand(B, T, cap).contiguous())
    hit = ranks[None, None, :] <= csum[..., -1:]
    slot_of = torch.where(overlap & (csum <= cap), csum.long() - 1, cap)
    return torch.clamp(idx, max=N - 1), hit, slot_of


class _BinnedRows(torch.autograd.Function):
    """rows (B, N, C) gathered into binned slots (B, T, K, C), zero in the
    empty slots.

    A candidate sits in at most one slot per tile, so the backward is the
    inverse map: a gather of each candidate's slot per tile and a sum over
    tiles. Static shapes, deterministic, and no scatter: the default
    backward of an index gather accumulates every empty slot into the one
    clamped index, which serializes on the card.
    """

    @staticmethod
    def forward(rows, idx, hit, slot_of):
        B, _, C = rows.shape
        out = torch.gather(rows, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        out = out.reshape(idx.shape + (C,))
        return torch.where(hit[..., None], out,
                           torch.zeros((), device=out.device))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[3])

    @staticmethod
    def backward(ctx, grad):
        (slot_of,) = ctx.saved_tensors
        B, T, _, C = grad.shape
        padded = torch.cat([grad, grad.new_zeros(B, T, 1, C)], dim=2)
        per_tile = torch.gather(padded, 2,
                                slot_of[..., None].expand(-1, -1, -1, C))
        return per_tile.sum(1), None, None, None

    @staticmethod
    def vmap(info, in_dims, rows, idx, hit, slot_of):
        n, args = fold_batched(in_dims, rows, idx, hit, slot_of)
        (out,), dims = unfold_batched(n, (_BinnedRows.apply(*args),))
        return out, dims[0]


def _contour_data(uv, z, topo: MeshTopology, s: RasterSettings):
    """Oriented contour segments of the current projection (batched).

    Contour edges: adjacent faces of opposite projected orientation (or a
    mesh boundary). Each is oriented along its slot-0 face's cycle, flipped
    when that face is back-facing. Returns p0, p1 (B, E, 2) with gradient,
    and cross_sign, is_contour, flip (B, E) without.
    """
    with torch.no_grad():
        tri_uv = uv[:, topo.faces]  # (B, F, 3, 2)
        tri_z = z[:, topo.faces]
        area = _edge_fn(tri_uv[..., 0, :], tri_uv[..., 1, :],
                        tri_uv[..., 2, :])
        f_valid = (tri_z > s.znear).all(-1) & (area.abs() > 1e-12)
        front = torch.where(f_valid, torch.sign(area),
                            torch.zeros((), dtype=area.dtype,
                                        device=area.device))
        n_f = front.shape[1]
        front_pad = torch.cat([front, front.new_zeros(front.shape[0], 1)],
                              dim=1)
        ef = topo.edge_faces
        o1 = front_pad[:, torch.where(ef[:, 0] >= 0, ef[:, 0], n_f)]
        o2 = front_pad[:, torch.where(ef[:, 1] >= 0, ef[:, 1], n_f)]
        e_z_ok = (z[:, topo.edges] > s.znear).all(-1)
        is_contour = (o1 != o2) & e_z_ok & ((o1 != 0) | (o2 != 0))
        one = torch.ones((), dtype=uv.dtype, device=uv.device)
        flip = (torch.where(topo.edge_dir_f1, one, -one)[None]
                * torch.where(o1 > 0, one, -one))
    seg = uv[:, topo.edges]  # (B, E, 2, 2)
    p0 = seg[:, :, 0]
    p1 = seg[:, :, 1]
    with torch.no_grad():
        cross_sign = torch.sign(p1[..., 1] - p0[..., 1]) * flip * is_contour
    return p0, p1, cross_sign, is_contour, flip


def shade_prep(verts, topo: MeshTopology, K, settings: RasterSettings):
    """Packed per-tile shade-kernel inputs (homan_tpu/render/rasterizer.py
    `_pallas_prep`).

    Returns seg_pack (B, T, 8, Ke) with rows [p0x, p0y, p1x, p1y, sign,
    valid, flip, 0] (empty slots sit 99 units away), anchors (B, T, tp, tp),
    e_demand (B,) the largest per-tile contour-edge count before the Ke
    truncation, and the kernel's ShadeStatic. A CPU tensor runs the plain
    version (`_shade_prep_plain`); a CUDA tensor the prep kernel
    (csrc/prep.cu), which builds everything without a gradient, bit-equal
    to the plain version on the same inputs. Under
    utils_profiling.tracing() the prep is a `raster.prep` span, and the
    counter `raster.contour_edges` counts the contour edges among the edges
    the anchor sweep and the tile overlap read: on the CPU every edge of
    every frame, on the card the entries of the kernel's contour lists,
    padded to whole warps as its binning reads them.
    """
    with span("raster.prep"):
        if verts.device.type == "cpu":
            return _shade_prep_plain(verts, topo, K, settings)
        return _shade_prep_kernel(verts, topo, K, settings)


def _pack_static(topo: MeshTopology, s: RasterSettings):
    """What defines the pack, for both paths: the bin margin (NDC units)
    and the shade kernel's ShadeStatic (Ke at most the mesh's edges)."""
    S, tp = s.image_size, s.tile_px
    if S % tp:
        raise ValueError("image_size must be a multiple of tile_px")
    margin = s.bin_margin_px / S
    ke = min(s.edges_per_tile, topo.edges.shape[0])
    return margin, ShadeStatic(tp, S, S // tp, s.sigma, margin * margin, ke)


def _shade_prep_plain(verts, topo: MeshTopology, K, settings: RasterSettings):
    """shade_prep in plain PyTorch on any device: the CPU path, and the
    prep kernel's twin on the card."""
    s = settings
    margin, static = _pack_static(topo, s)
    S, tp, g, ke = static.image_size, static.tile_px, static.g, static.ke
    T = g * g
    uv, z = project_ndc(verts, K)
    p0, p1, cross_sign, is_contour, flip = _contour_data(uv, z, topo, s)
    count("raster.contour_edges", is_contour)
    B = p0.shape[0]
    dev = verts.device

    with torch.no_grad():
        # Winding anchors at tile-column right boundaries over ALL
        # contour edges: oriented crossings of the +x ray, one (B, S, E)
        # reduction per tile column.
        ys_all = (torch.arange(S, device=dev, dtype=torch.float32)
                  + 0.5) / S
        y0 = p0[..., 1][:, None, :]
        y1 = p1[..., 1][:, None, :]
        py = ys_all[None, :, None]
        spans = (y0 <= py) != (y1 <= py)
        dy = y1 - y0
        t = (py - y0) / torch.where(dy.abs() > 1e-12, dy,
                                    torch.ones((), device=dev))
        x_int = p0[..., 0][:, None, :] + t * (p1[..., 0] - p0[..., 0])[
            :, None, :]
        zero = torch.zeros((), device=dev)
        contrib = torch.where(spans, cross_sign[:, None, :], zero)
        anchors = torch.stack([
            torch.where(x_int > (gc + 1.0) * tp / S, contrib, zero).sum(-1)
            for gc in range(g)], dim=1)  # (B, g, S)

        overlap = _tile_overlap(torch.minimum(p0, p1),
                                torch.maximum(p0, p1), is_contour, s,
                                margin)  # (B, T, E)
        e_demand = overlap.sum(-1).amax(-1)
        binned = _bin_first(overlap, ke)
        sel_c = _BinnedRows.apply(
            torch.stack([cross_sign, flip * is_contour], dim=-1), *binned)
        hitf = binned[1].to(torch.float32)
        far = 99.0 * (1.0 - hitf)

    # (B, T, ke, 4) endpoints, with gradient
    sel = _BinnedRows.apply(torch.cat([p0, p1], dim=-1), *binned)
    seg_pack = torch.stack(
        [sel[..., 0] + far, sel[..., 1] + far, sel[..., 2] + far,
         sel[..., 3] + far, sel_c[..., 0], hitf, sel_c[..., 1],
         torch.zeros_like(hitf)], dim=-2)  # (B, T, 8, ke)

    with torch.no_grad():
        tile_gx = torch.arange(T, device=dev) % g
        rows = ((torch.arange(T, device=dev) // g)[:, None] * tp
                + torch.arange(tp, device=dev)[None])
        anchor_rows = anchors[:, tile_gx[:, None], rows]  # (B, T, tp)
        anchor_px = anchor_rows[..., None].expand(
            B, T, tp, tp).contiguous()
    return seg_pack, anchor_px, e_demand, static


# Launch count of the prep kernel (the plain version does not count).
prep_launches = 0

# (image_size, tile_px, device) -> the prep kernel's float32 table.
_PREP_TABLES: dict = {}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
_FLT = ctypes.c_float


def _prep_lib():
    from homan_tpu_torch import _build
    lib = _build.load("prep")
    if lib.shade_prep.argtypes is None:
        lib.shade_prep.argtypes = ([_PTR] * 6 + [_I64] * 4 + [_PTR]
                                   + [_INT] * 9 + [_FLT] * 2 + [_PTR] * 11)
        lib.shade_prep.restype = ctypes.c_int
    return lib


def _prep_table(S: int, tp: int, device):
    """The row centres (S), the tile bounds t_lo and t_hi along either axis
    (g each) and the column boundaries (g) the prep kernel compares with,
    computed by the plain version's own float32 expressions on `device`
    (its divisions by S included), once per size."""
    key = (S, tp, str(device))
    table = _PREP_TABLES.get(key)
    if table is None:
        g = S // tp
        ys = (torch.arange(S, device=device, dtype=torch.float32) + 0.5) / S
        t = torch.arange(g, device=device).to(torch.float32)
        xb = torch.tensor([(gc + 1.0) * tp / S for gc in range(g)],
                          dtype=torch.float32, device=device)
        table = torch.cat([ys, t * tp / S, (t + 1) * tp / S, xb])
        _PREP_TABLES[key] = table
    return table


def _prep_launch(uv, verts, faces, edges, edge_faces, edge_dir, fpt, S, tp,
                 ke, znear, margin):
    """Launch the prep kernel. uv (B, V, 2) and verts (B, V, 3) float32;
    each topology tensor shared ((F, 3), (E, 2), (E, 2), (E,)) or with a
    leading topology dim nt, frame b taking topology (b // fpt) % nt.
    Returns anchor_px (B, T, tp, tp), e_demand (B,), idx, hit (B, T, Ke),
    slot_of (B, T, E), pack_c (B, T, 4, Ke) (seg_pack's rows 4-7), far
    (B, T, Ke, 1) and the counter's n_contour, n_read (B,) int32."""
    _require_cuda(uv)
    global prep_launches
    dev = uv.device
    uv = uv.contiguous()
    verts = verts.contiguous()
    B, V = uv.shape[:2]
    _check("uv", uv, (B, V, 2), torch.float32, dev)
    _check("verts", verts, (B, V, 3), torch.float32, dev)
    topo = [t.to(device=dev, dtype=torch.int64).contiguous()
            for t in (faces, edges, edge_faces)]
    topo.append(edge_dir.to(device=dev, dtype=torch.bool).contiguous())
    per_topo = [t.dim() == d + 1 for t, d in zip(topo, (2, 2, 2, 1))]
    nts = {t.shape[0] for t, p in zip(topo, per_topo) if p}
    if len(nts) > 1:
        raise ValueError(f"topology tensors of {sorted(nts)} topologies")
    nt = nts.pop() if nts else 1
    F, E = topo[0].shape[-2], topo[1].shape[-2]
    fpt = max(B // nt, 1) if fpt is None else fpt
    g = S // tp
    T = g * g
    if T * E >= 2 ** 31 or S * S >= 2 ** 31:
        raise ValueError(f"the prep kernel takes T E and S^2 below 2^31, "
                         f"got T {T}, E {E}, S {S}")
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((B, T, tp, tp), **f32), torch.empty((B,), **i64),
           torch.empty((B, T, ke), **i64),
           torch.empty((B, T, ke), dtype=torch.bool, device=dev),
           torch.empty((B, T, E), **i64), torch.empty((B, T, 4, ke), **f32),
           torch.empty((B, T, ke, 1), **f32),
           torch.empty((B,), dtype=torch.int32, device=dev),
           torch.empty((B,), dtype=torch.int32, device=dev))
    if B == 0:
        return out
    anchors = torch.empty((B, g, S), dtype=torch.int32, device=dev)
    table = _prep_table(S, tp, dev)
    strides = [t.stride(0) if p else 0 for t, p in zip(topo, per_topo)]
    lib = _prep_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shade_prep(uv.data_ptr(), verts.data_ptr(),
                            *(t.data_ptr() for t in topo), *strides,
                            table.data_ptr(), B, nt, fpt, V, F, E, S, tp, ke,
                            znear, margin, anchors.data_ptr(),
                            *(o.data_ptr() for o in out), stream)
    if rc == -1:
        raise RuntimeError(f"shade_prep kernel launch failed: {F} faces and "
                           f"{T} tiles leave no room in shared memory")
    if rc != 0:
        raise RuntimeError(f"shade_prep kernel launch failed: CUDA error {rc}")
    prep_launches += 1
    return out


class _PrepKernel(torch.autograd.Function):
    """The prep kernel as an op torch.func.vmap can batch: the vmapped clip
    dim folds into the frame dim, one launch for every clip. A topology
    tensor batched at that level keeps its clip dim (a topology per clip,
    the frames of one clip per topology); one shared by the clips is read
    by all. No gradient."""

    @staticmethod
    def forward(uv, verts, faces, edges, edge_faces, edge_dir, fpt, S, tp,
                ke, znear, margin):
        return _prep_launch(uv, verts, faces, edges, edge_faces, edge_dir,
                            fpt, S, tp, ke, znear, margin)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * 12

    @staticmethod
    def vmap(info, in_dims, uv, verts, faces, edges, edge_faces, edge_dir,
             fpt, *static):
        n = info.batch_size
        frames = []
        for t, d in zip((uv, verts), in_dims[:2]):
            t = t.movedim(d, 0) if d is not None else t[None].expand(
                (n,) + tuple(t.shape))
            frames.append(t)
        topo = (faces, edges, edge_faces, edge_dir)
        if any(d is not None for d in in_dims[2:6]):
            if fpt is not None:
                raise NotImplementedError(
                    "the prep kernel takes topology batched at one vmap "
                    "level")
            fpt = frames[0].shape[1]
            topo = tuple(t if d is None else t.movedim(d, 0)
                         for t, d in zip(topo, in_dims[2:6]))
        uv, verts = (t.reshape((-1,) + tuple(t.shape[2:])) for t in frames)
        return unfold_batched(n, _PrepKernel.apply(uv, verts, *topo, fpt,
                                                   *static))


def _shade_prep_kernel(verts, topo: MeshTopology, K,
                       settings: RasterSettings):
    """shade_prep on the card: the projection and the endpoints' gather
    into their slots carry the gradient as in the plain version; the prep
    kernel gives everything else."""
    _require_cuda(verts)
    s = settings
    margin, static = _pack_static(topo, s)
    uv, _ = project_ndc(verts, K)
    seg = uv[:, topo.edges]  # (B, E, 2, 2)
    with torch.no_grad():
        anchor_px, e_demand, idx, hit, slot_of, pack_c, far, n_c, n_r = \
            _PrepKernel.apply(uv.detach(), verts.detach(), topo.faces,
                              topo.edges, topo.edge_faces, topo.edge_dir_f1,
                              None, static.image_size, static.tile_px,
                              static.ke, s.znear, margin)
        tally("raster.contour_edges", n_c, n_r)
    sel = _BinnedRows.apply(torch.cat([seg[:, :, 0], seg[:, :, 1]], dim=-1),
                            idx, hit, slot_of)  # (B, T, ke, 4)
    seg_pack = torch.cat([(sel + far).transpose(2, 3), pack_c], dim=2)
    return seg_pack, anchor_px, e_demand, static


def rasterize_soft(verts, topology, K,
                   settings: RasterSettings = RasterSettings()):
    """Differentiable soft silhouette.

    verts (B, V, 3) camera space; topology a MeshTopology (or (F, 3) faces);
    K (B, 3, 3) normalized. Returns dict sil (B, S, S), edge_demand (B,)
    and edge_capacity (int).
    """
    topo = as_topology(topology, device=verts.device)
    s = settings
    S, tp = s.image_size, s.tile_px
    g = S // tp
    seg_pack, anchor_px, e_demand, static = shade_prep(verts, topo, K, s)
    sil_tiles = shade_tiles(seg_pack, anchor_px, static)  # (B, T, tp, tp)
    B = verts.shape[0]
    sil = sil_tiles.reshape(B, g, g, tp, tp).permute(0, 1, 3, 2, 4).reshape(
        B, S, S)
    return {"sil": sil, "edge_demand": e_demand, "edge_capacity": static.ke}


def check_edge_budget(verts, topology, K,
                      settings: RasterSettings = RasterSettings()):
    """Host-side diagnostic: contour-edge demand vs edges_per_tile.

    Undersizing is catastrophic (a dropped contour edge corrupts the winding
    region behind it), so call this at fit setup with representative poses.
    Returns max_demand, capacity, overflow, utilization.
    """
    s = settings
    topo = as_topology(topology, device=verts.device)
    margin = s.bin_margin_px / s.image_size
    with torch.no_grad():
        uv, z = project_ndc(verts, K)
        p0, p1, _, is_contour, _ = _contour_data(uv, z, topo, s)
        overlap = _tile_overlap(torch.minimum(p0, p1), torch.maximum(p0, p1),
                                is_contour, s, margin)
        demand = int(overlap.sum(-1).max())
    capacity = min(s.edges_per_tile, int(topo.edges.shape[0]))
    return {
        "max_demand": demand,
        "capacity": capacity,
        "overflow": demand > capacity,
        "utilization": demand / max(capacity, 1),
    }


def _face_data(verts, topo: MeshTopology, K, s: RasterSettings):
    """Projected triangles, their signed areas, and the (B, T, F) tile
    overlap of the valid faces (JAX `_rasterize_depth_pallas` prep)."""
    uv, z = project_ndc(verts, K)
    tri_uv = uv[:, topo.faces]  # (B, F, 3, 2)
    tri_z = z[:, topo.faces]    # (B, F, 3)
    area = _edge_fn(tri_uv[..., 0, :], tri_uv[..., 1, :], tri_uv[..., 2, :])
    with torch.no_grad():
        f_valid = (tri_z > s.znear).all(-1) & (area.abs() > 1e-12)
        overlap = _tile_overlap(tri_uv.amin(2), tri_uv.amax(2), f_valid, s,
                                0.5 / s.image_size)
    return tri_uv, tri_z, area, overlap


def depth_prep(verts, topo: MeshTopology, K, settings: RasterSettings):
    """Packed per-tile depth-kernel inputs (the prep of homan_tpu/render/
    rasterizer.py `_rasterize_depth_pallas`, :686-727).

    Returns face_pack (B, T, 16, Kf) with rows [A0, B0, C0, A1, B1, C1, A2,
    B2, C2, Az, Bz, Cz, valid, 0, 0, 0] (e_i(p) = A_i px + B_i py + C_i, sign
    folded by the face's winding; invz(p) = Az px + Bz py + Cz), valid slots
    as a prefix in face-index order and empty slots zero; f_demand (B,) the
    largest per-tile face count before the Kf truncation; and the kernel's
    DepthStatic. Gradients reach the vertices through rows 0-11.
    """
    s = settings
    S, tp = s.image_size, s.tile_px
    if S % tp:
        raise ValueError("image_size must be a multiple of tile_px")
    g = S // tp
    T = g * g
    F = topo.faces.shape[0]
    kf = min(s.faces_per_tile, F)
    tri_uv, tri_z, area, overlap = _face_data(verts, topo, K, s)
    B = verts.shape[0]
    dev = verts.device
    with torch.no_grad():
        f_demand = overlap.sum(-1).amax(-1)
        idx, hit, slot_of = _bin_first(overlap, kf)

    def line(a, b):
        A = -(b[..., 1] - a[..., 1])
        Bc = b[..., 0] - a[..., 0]
        C = (b[..., 1] - a[..., 1]) * a[..., 0] - (b[..., 0] - a[..., 0]) * a[
            ..., 1]
        return A, Bc, C

    sgn = torch.sign(area)
    rows, bary = [], []
    # e0 opposite v0 (edge v1->v2), e1 (v2->v0), e2 (v0->v1).
    for i, j in ((1, 2), (2, 0), (0, 1)):
        A, Bc, C = line(tri_uv[..., i, :], tri_uv[..., j, :])
        rows += [A * sgn, Bc * sgn, C * sgn]
        bary.append((A, Bc, C))
    one = torch.ones((), dtype=area.dtype, device=dev)
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, one)
    zi = torch.clamp(tri_z, min=1e-6)
    for c in range(3):
        rows.append((bary[0][c] / zi[..., 0] + bary[1][c] / zi[..., 1]
                     + bary[2][c] / zi[..., 2]) * inv_area)
    feat = torch.stack(rows, dim=-1)  # (B, F, 12)
    sel = _BinnedRows.apply(feat, idx, hit, slot_of)  # (B, T, kf, 12)
    face_pack = torch.cat(
        [sel.permute(0, 1, 3, 2), hit.to(torch.float32)[:, :, None, :],
         torch.zeros((B, T, 3, kf), device=dev)], dim=2)
    return face_pack.contiguous(), f_demand, DepthStatic(tp, S, g, kf)


def rasterize_depth(verts, topology, K,
                    settings: RasterSettings = RasterSettings()):
    """Differentiable hard z-buffer depth and coverage (homan_tpu/render/
    rasterizer.py:645).

    Returns dict depth (B, S, S), 0 where uncovered, and covered =
    depth > 0. Faces beyond `faces_per_tile` in a tile are dropped from its
    z-buffer: check_face_budget measures the demand.
    """
    topo = as_topology(topology, device=verts.device)
    s = settings
    S, tp = s.image_size, s.tile_px
    g = S // tp
    face_pack, _, static = depth_prep(verts, topo, K, s)
    depth_t = depth_tiles(face_pack, static)  # (B, T, tp, tp)
    B = verts.shape[0]
    depth = depth_t.reshape(B, g, g, tp, tp).permute(0, 1, 3, 2, 4).reshape(
        B, S, S)
    return {"depth": depth, "covered": depth > 0}


def check_face_budget(verts, topology, K,
                      settings: RasterSettings = RasterSettings()):
    """Host-side diagnostic: per-tile face demand vs faces_per_tile.

    A dropped face leaves a hole or a wrong winner in its tile's z-buffer.
    Returns max_demand, capacity, overflow, utilization.
    """
    topo = as_topology(topology, device=verts.device)
    with torch.no_grad():
        overlap = _face_data(verts, topo, K, settings)[3]
        demand = int(overlap.sum(-1).max())
    capacity = min(settings.faces_per_tile, int(topo.faces.shape[0]))
    return {
        "max_demand": demand,
        "capacity": capacity,
        "overflow": demand > capacity,
        "utilization": demand / max(capacity, 1),
    }


# (tiles x pixels x face slots) elements a chunk of rasterize_hard's
# per-(pixel, slot) temporaries may hold: about ten such float32 or bool
# tensors live at once, so a chunk peaks near 10 x 64 MB.
HARD_CHUNK_ELEMS = 1 << 24


def _tile_pixel_centers(S: int, tp: int, device):
    """(T, P, 2) pixel centres (u, v) of each tile, row-major inside the
    tile, tiles row-major."""
    g = S // tp
    c = (torch.arange(S, dtype=torch.float32, device=device) + 0.5) / S
    t = torch.arange(g * g, device=device)
    p = torch.arange(tp * tp, device=device)
    rows = (t // g)[:, None] * tp + (p // tp)[None]
    cols = (t % g)[:, None] * tp + (p % tp)[None]
    return torch.stack([c[cols], c[rows]], dim=-1)


def _hard_zbuffer(tri_uv, tri_z, idx, hit, pix):
    """Nearest covering face of every pixel, over each tile's binned slots.

    tri_uv (B, F, 3, 2), tri_z (B, F, 3); idx, hit (B, T, Kf) the binned
    faces; pix (T, P, 2). Runs (frame, tile) rows in chunks of at most
    HARD_CHUNK_ELEMS (row x pixel x slot) elements. Returns, per (B, T, P): the
    winning face, whether it covers the pixel, its depth, and its three
    screen-space barycentrics. Ties go to the lowest slot, i.e. the lowest
    face index.
    """
    B, T, kf = idx.shape
    P = pix.shape[1]
    dev = tri_uv.device
    flat_idx = idx.reshape(B * T, kf)
    flat_hit = hit.reshape(B * T, kf)
    step = max(1, HARD_CHUNK_ELEMS // max(P * kf, 1))
    out = {k: [] for k in ("face", "covered", "z", "w")}
    for r0 in range(0, B * T, step):
        rows = torch.arange(r0, min(r0 + step, B * T), device=dev)
        bi, ti = rows // T, rows % T
        fidx = flat_idx[rows]                          # (R, Kf)
        tuv = tri_uv[bi[:, None], fidx]                # (R, Kf, 3, 2)
        tz = tri_z[bi[:, None], fidx]                  # (R, Kf, 3)
        p = pix[ti][:, :, None, :]                     # (R, P, 1, 2)
        a, b, c = (tuv[:, None, :, i, :] for i in range(3))
        e0, e1, e2 = _edge_fn(p, b, c), _edge_fn(p, c, a), _edge_fn(p, a, b)
        inside = ((((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                   | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
                  & flat_hit[rows][:, None, :])
        ar = _edge_fn(a, b, c)
        one = torch.ones((), dtype=ar.dtype, device=dev)
        denom = torch.where(ar.abs() > 1e-12, ar, one)
        w0, w1, w2 = e0 / denom, e1 / denom, e2 / denom
        tzc = torch.clamp(tz, min=1e-6)[:, None]       # (R, 1, Kf, 3)
        inv_z = w0 / tzc[..., 0] + w1 / tzc[..., 1] + w2 / tzc[..., 2]
        z_pix = 1.0 / torch.clamp(inv_z, min=1e-6)
        z_buf = torch.where(inside, z_pix, torch.full((), 1e6, device=dev))
        best = torch.argmin(z_buf, dim=-1, keepdim=True)  # first minimum
        out["face"].append(torch.gather(fidx[:, None, :].expand(-1, P, -1),
                                        2, best)[..., 0])
        out["covered"].append(torch.gather(inside, 2, best)[..., 0])
        out["z"].append(torch.gather(z_buf, 2, best)[..., 0])
        out["w"].append(torch.stack(
            [torch.gather(w, 2, best)[..., 0] for w in (w0, w1, w2)], -1))
    return {k: torch.cat(v).reshape((B, T, P) + v[0].shape[2:])
            for k, v in out.items()}


def rasterize_hard(verts, topology, K, face_colors=None,
                   settings: RasterSettings = RasterSettings(),
                   background: float = 1.0,
                   light_dir=(0.57735, 0.57735, -0.57735),
                   ambient: float = 0.55, diffuse: float = 0.45,
                   shading: str = "phong", specular: float = 0.2,
                   shininess: float = 32.0):
    """Hard z-buffer rasterization for evidence and visualization, without
    gradient (homan_tpu/render/rasterizer.py:766).

    Faces are binned as the depth renders bin them: the first
    `faces_per_tile` overlapping faces of a tile by index, with a half-pixel
    margin. A dropped face leaves a hole or a wrong winner in its tile, so
    size the budget from the demand (`hard_face_settings`). Once Kf covers
    every tile's demand the output does not depend on the tile: each pixel
    takes the nearest covering face, the lowest index on ties.

    shading="phong" interpolates area-weighted vertex normals with
    perspective-correct barycentrics and adds a Blinn-Phong highlight;
    "flat" keeps per-face two-sided Lambertian shading.

    verts (B, V, 3) camera space; topology a MeshTopology or (F, 3) faces;
    K (B, 3, 3) normalized; face_colors (F, 3), white if None. The
    (tiles x pixels x Kf) temporaries run in chunks of HARD_CHUNK_ELEMS.
    Returns dict rgb (B, S, S, 3), depth (B, S, S), sil (B, S, S) bool.
    """
    if shading not in ("phong", "flat"):
        raise ValueError(f"shading must be 'phong' or 'flat', got {shading}")
    s = settings
    S, tp = s.image_size, s.tile_px
    if S % tp:
        raise ValueError("image_size must be a multiple of tile_px")
    g = S // tp
    dev = verts.device
    topo = as_topology(topology, device=dev)
    faces = topo.faces
    F = faces.shape[0]
    B = verts.shape[0]
    with torch.no_grad():
        verts = verts.to(torch.float32)
        if face_colors is None:
            face_colors = torch.ones((F, 3), dtype=torch.float32, device=dev)
        face_colors = torch.as_tensor(face_colors, dtype=torch.float32,
                                      device=dev)
        light = torch.tensor(light_dir, dtype=torch.float32, device=dev)
        light = light / torch.linalg.vector_norm(light)
        tri_uv, tri_z, _, overlap = _face_data(verts, topo, K, s)
        idx, hit, _ = _bin_first(overlap, min(s.faces_per_tile, F))
        zb = _hard_zbuffer(tri_uv, tri_z, idx, hit,
                           _tile_pixel_centers(S, tp, dev))
        face, covered = zb["face"], zb["covered"]      # (B, T, P)
        tri_3d = verts[:, faces]                        # (B, F, 3, 3)
        raw_normals = torch.linalg.cross(tri_3d[:, :, 1] - tri_3d[:, :, 0],
                                         tri_3d[:, :, 2] - tri_3d[:, :, 0])
        bidx = torch.arange(B, device=dev)[:, None, None]
        fcol = face_colors[face]                        # (B, T, P, 3)
        if shading == "phong":
            # Area-weighted vertex normals: the raw cross product's
            # magnitude (twice the face area) is the weight.
            vnorm = torch.zeros_like(verts)
            for ci in range(3):
                vnorm.index_add_(1, faces[:, ci], raw_normals)
            vnorm = vnorm / torch.clamp(torch.linalg.vector_norm(
                vnorm, dim=-1, keepdim=True), min=1e-9)
            f_v = faces[face]                           # (B, T, P, 3)
            tz_b = tri_z[bidx, face]                    # (B, T, P, 3)
            bar = zb["w"] / torch.clamp(tz_b, min=1e-6)
            bar = bar / torch.clamp(bar.sum(-1, keepdim=True), min=1e-9)
            n_pix = torch.einsum("btpc,btpcd->btpd", bar,
                                 vnorm[bidx[..., None], f_v])
            n_pix = n_pix / torch.clamp(torch.linalg.vector_norm(
                n_pix, dim=-1, keepdim=True), min=1e-9)
            p3d = torch.einsum("btpc,btpcd->btpd", bar,
                               verts[bidx[..., None], f_v])
            view = -p3d / torch.clamp(torch.linalg.vector_norm(
                p3d, dim=-1, keepdim=True), min=1e-9)
            half = light + view
            half = half / torch.clamp(torch.linalg.vector_norm(
                half, dim=-1, keepdim=True), min=1e-9)
            lam = ambient + diffuse * (n_pix @ light).abs()
            spec = specular * (n_pix * half).sum(-1).abs() ** shininess
            rgb = torch.clamp(fcol * lam[..., None] + spec[..., None],
                              0.0, 1.0)
        else:
            normals = raw_normals / torch.clamp(torch.linalg.vector_norm(
                raw_normals, dim=-1, keepdim=True), min=1e-9)
            shade = ambient + diffuse * (normals @ light).abs()  # (B, F)
            rgb = fcol * shade[bidx, face][..., None]
        rgb = torch.where(covered[..., None], rgb,
                          torch.full((), background, device=dev))
        depth = torch.where(covered, zb["z"], torch.zeros((), device=dev))

        def untile(x):
            lead = x.shape[3:]
            x = x.reshape((B, g, g, tp, tp) + lead)
            return x.transpose(2, 3).reshape((B, S, S) + lead)

        return {"rgb": untile(rgb), "depth": untile(depth),
                "sil": untile(covered)}


# Tiles rasterize_hard may take for a render when its budget is sized
# (the tile-halving floor of auto_edge_settings is 16).
HARD_TILES = (64, 32, 16)


def hard_face_settings(verts, topology, K,
                       settings: RasterSettings = RasterSettings()):
    """rasterize_hard's settings for fixed poses: faces_per_tile is the
    measured per-tile face demand (the largest over the batch, no headroom,
    at least 1), at the tile of HARD_TILES (those dividing image_size) that
    makes tiles x pixels x demand, the size of the render's (pixel, slot)
    temporaries, smallest; the first such tile on ties.

    Returns (settings, {tile_px: demand}).
    """
    topo = as_topology(topology, device=verts.device)
    S = settings.image_size
    demand = {}
    for tp in HARD_TILES:
        if S % tp == 0:
            st = dataclasses.replace(settings, tile_px=tp,
                                     faces_per_tile=1 << 30)
            demand[tp] = check_face_budget(verts, topo, K,
                                           st)["max_demand"]
    if not demand:
        raise ValueError(f"no tile of {HARD_TILES} divides image_size {S}")
    tp = min(demand, key=lambda t: ((S // t) ** 2 * t * t * demand[t],
                                    HARD_TILES.index(t)))
    return (dataclasses.replace(settings, tile_px=tp,
                                faces_per_tile=max(demand[tp], 1)), demand)


EDGE_BUCKETS = (48, 64, 96, 128, 192, 256, 384, 512)
# The card's edge-slot ceiling is FWD_MAX_KE at every tile_px
# (homan_tpu/render/rasterizer.py:947 holds the TPU's VMEM table, which the
# card does not share). The forward keeps four float4 records per (slot,
# row) of its row block in shared memory and halves the block's rows until
# they fit kMaxForwardSmem (render/csrc/shade.cu:135, 200 KiB): at one row
# that is 200 KiB / 64 B = 3,200 slots at any tile. The backward caps its
# warp and strip lists at 128 and 1,024 slots and adds the tile's lists in
# windows of 2,048 slots, so it takes any Ke. Every bucket is under that
# ceiling, so the largest bucket is the only cap: a demand above it halves
# the tile.
assert max(EDGE_BUCKETS) <= FWD_MAX_KE


def auto_edge_settings(verts, topology, K,
                       settings: RasterSettings = RasterSettings(),
                       safety: float = 1.3,
                       buckets=EDGE_BUCKETS) -> RasterSettings:
    """Size edges_per_tile (and, if needed, tile_px) to the measured
    contour-edge demand (homan_tpu/render/rasterizer.py:952).

    Measures the per-tile demand at the given poses (check_edge_budget, the
    renderer's own binning predicate) and returns `settings` with
    edges_per_tile the smallest bucket covering demand x safety; keeps
    `settings` unchanged when they already cover it. When no bucket covers
    it, halves tile_px and measures again; raises RuntimeError when tile_px
    16 still overflows (a dropped contour edge corrupts the winding region,
    so this is never a warning). The JAX package also halves the tile when
    the bucket passes its TPU VMEM table; every bucket fits the card.
    """
    s = settings
    topo = as_topology(topology, device=verts.device)
    n_edges = int(topo.edges.shape[0])
    while True:
        demand = check_edge_budget(verts, topo, K, s)["max_demand"]
        need = min(int(np.ceil(demand * safety)), n_edges)
        if min(s.edges_per_tile, n_edges) >= need:
            return s
        feasible = [b for b in buckets if need <= b]
        if feasible:
            return dataclasses.replace(s, edges_per_tile=feasible[0])
        if s.tile_px <= 16 or s.tile_px // 2 > s.image_size:
            raise RuntimeError(
                f"edge budget unsatisfiable: demand {demand} (need {need} "
                f"with {safety}x headroom) exceeds the largest bucket "
                f"{buckets[-1]} at tile_px={s.tile_px}; the mesh is too "
                f"dense for exact contour binning at image_size="
                f"{s.image_size}: decimate the mesh or lower rend_size")
        s = dataclasses.replace(s, tile_px=s.tile_px // 2)


def bump_edge_settings(settings: RasterSettings, demand: int,
                       safety: float = 1.3,
                       buckets=EDGE_BUCKETS) -> RasterSettings:
    """The next settings covering a demand measured mid-fit
    (homan_tpu/render/rasterizer.py:1012): the smallest bucket above the
    current edges_per_tile covering demand x safety, halving tile_px when
    there is none (a smaller tile meets a subset of the edges, so the
    demand stays an upper bound). Raises RuntimeError
    when tile_px 16 cannot cover it."""
    s = settings
    need = int(np.ceil(demand * safety))
    while True:
        feasible = [b for b in buckets
                    if need <= b and b > s.edges_per_tile]
        if feasible:
            return dataclasses.replace(s, edges_per_tile=feasible[0])
        if s.tile_px <= 16 or s.tile_px // 2 > s.image_size:
            raise RuntimeError(
                f"edge budget unsatisfiable mid-fit: measured demand "
                f"{demand} (need {need} with {safety}x headroom) exceeds "
                f"the largest bucket {buckets[-1]} at tile_px={s.tile_px}; "
                f"decimate the mesh or lower rend_size")
        s = dataclasses.replace(s, tile_px=s.tile_px // 2)
