"""The soft silhouette, computed per pixel over every contour edge.

    sil(p) = sigmoid(sign(p) * d2(p) / sigma)

sign(p) is + where the winding number of the projected occluding contour
around p is nonzero (p is covered) and - elsewhere; d2(p) is the squared
distance from p to the nearest silhouette-relevant contour edge, capped at
cap2 = (bin margin / image size)^2. An edge is relevant at p unless p lies
inside the silhouette and the region across that edge is covered as well
(an inner contour). Contour edges are the edges whose two faces face
opposite ways in the projection, or mesh boundaries; each is oriented along
its first face's cycle, flipped where that face faces away.

No tiles, no edge slots: every contour edge is held against every pixel,
in blocks of frames and rows. Gradients reach the vertices only through
the nearest edge's endpoints, by the closest-point rule (the closest
point's parameter along the edge is held fixed, as its derivative
contributes nothing); winding and relevance are piecewise constant.
"""
from __future__ import annotations

import torch

from portbench.reference.geometry import project

# Elements per temporary of the per-pixel passes.
BLOCK_ELEMS = 1 << 25


def _gather_rows(x, idx):
    """x (N, M, ...) gathered along dim 1 by idx (N, K) -> (N, K, ...)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape[0], -1)
    view = flat.reshape(flat.shape + (1,) * (x.dim() - 2)).expand(
        flat.shape + x.shape[2:])
    return torch.gather(x, 1, view).reshape(shape)


def contour_edges(uv, z, topo, znear: float):
    """Contour edges of each frame's projection.

    uv (N, V, 2), z (N, V); topo: faces (N, F, 3), edges (N, E, 2),
    edge_faces (N, E, 2), edge_dir (N, E). Returns (idx (N, K) the contour
    edges in edge order, valid (N, K), p0, p1 (N, K, 2) with gradient,
    cross_sign and flip (N, K)) with K the most contour edges of a frame."""
    with torch.no_grad():
        tri = _gather_rows(uv, topo["faces"])  # (N, F, 3, 2)
        tz = _gather_rows(z, topo["faces"])
        a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
        # Twice the signed area, (c - b) x (a - b): HOMan's edge function.
        area = ((c[..., 0] - b[..., 0]) * (a[..., 1] - b[..., 1])
                - (c[..., 1] - b[..., 1]) * (a[..., 0] - b[..., 0]))
        ok = (tz > znear).all(-1) & (area.abs() > 1e-12)
        front = torch.where(ok, torch.sign(area), torch.zeros_like(area))
        front = torch.cat([front, front.new_zeros(front.shape[0], 1)], 1)
        n_f = topo["faces"].shape[1]
        ef = topo["edge_faces"]
        o1 = torch.gather(front, 1, torch.where(ef[..., 0] >= 0, ef[..., 0],
                                                n_f))
        o2 = torch.gather(front, 1, torch.where(ef[..., 1] >= 0, ef[..., 1],
                                                n_f))
        ez = _gather_rows(z, topo["edges"])
        is_c = (o1 != o2) & (ez > znear).all(-1) & ((o1 != 0) | (o2 != 0))
        one = torch.ones((), device=uv.device)
        flip = (torch.where(topo["edge_dir"], one, -one)
                * torch.where(o1 > 0, one, -one))
        count = is_c.sum(1)
        k = max(int(count.max()), 1)
        # Contour edges first, in edge order.
        order = torch.sort((~is_c).to(torch.int8), dim=1, stable=True)[1]
        idx = order[:, :k]
        valid = torch.arange(k, device=uv.device)[None] < count[:, None]
    seg = _gather_rows(uv, _gather_rows(topo["edges"], idx))  # (N,K,2,2)
    p0, p1 = seg[:, :, 0], seg[:, :, 1]
    with torch.no_grad():
        flip_k = torch.where(valid, torch.gather(flip, 1, idx),
                             torch.zeros((), device=uv.device))
        cross = torch.sign(p1[..., 1] - p0[..., 1]) * flip_k
    return valid, p0, p1, cross, flip_k


def _pixel_axis(S: int, device):
    return (torch.arange(S, device=device, dtype=torch.float32) + 0.5) / S


def _crossings(p0, p1, py):
    """x of each edge at rows py (R,), and whether the edge spans the row:
    (n, R, K) each."""
    y0, y1 = p0[..., 1][:, None], p1[..., 1][:, None]
    yy = py[None, :, None]
    spans = (y0 <= yy) != (y1 <= yy)
    dy = y1 - y0
    t = (yy - y0) / torch.where(dy.abs() > 1e-12, dy,
                                torch.ones((), device=py.device))
    x = p0[..., 0][:, None] + t * (p1[..., 0] - p0[..., 0])[:, None]
    return x, spans


def _blocks(N: int, S: int, K: int):
    """(frames, rows) slices whose (frames, rows, S, K) temporaries hold
    about BLOCK_ELEMS elements: several whole frames, or one frame in
    bands of rows."""
    per_frame = S * S * max(K, 1)
    if per_frame <= BLOCK_ELEMS:
        nb = BLOCK_ELEMS // per_frame
        for n0 in range(0, N, nb):
            yield slice(n0, min(N, n0 + nb)), slice(0, S)
    else:
        rows = max(1, BLOCK_ELEMS // (S * max(K, 1)))
        for n in range(N):
            for r0 in range(0, S, rows):
                yield slice(n, n + 1), slice(r0, min(S, r0 + rows))


def winding(p0, p1, cross, S: int):
    """Winding number (N, S, S) of the oriented contour around each pixel
    centre: the signed crossings of its +x ray."""
    N, K = cross.shape
    ax_ = _pixel_axis(S, p0.device)
    out = torch.empty((N, S, S), device=p0.device)
    zero = torch.zeros((), device=p0.device)
    for fs, rs in _blocks(N, S, K):
        x, spans = _crossings(p0[fs], p1[fs], ax_[rs])  # (n, R, K)
        hit = spans[:, :, None] & (x[:, :, None] > ax_[None, None, :, None])
        out[fs, rs] = torch.where(hit, cross[fs][:, None, None],
                                  zero).sum(-1)
    return out


def nearest_edge(p0, p1, valid, flip, wind, S: int, cap2: float):
    """Per pixel the capped squared distance to the nearest relevant
    contour edge and its index (first in edge order; -1 where none is
    nearer than cap2): (N, S, S) each, no gradient."""
    N, K = flip.shape
    dev = p0.device
    ax_ = _pixel_axis(S, dev)
    d2min = torch.empty((N, S, S), device=dev)
    amin = torch.empty((N, S, S), dtype=torch.int64, device=dev)
    cap = torch.tensor(cap2, device=dev)
    for fs, rs in _blocks(N, S, K):
        e = lambda t: t[fs][:, None, None]  # noqa: E731  (n, 1, 1, K)
        ax, ay = e(p0[..., 0]), e(p0[..., 1])
        ex, ey = e(p1[..., 0]) - ax, e(p1[..., 1]) - ay
        denom = torch.clamp(ex * ex + ey * ey, min=1e-12)
        py = ax_[rs][None, :, None, None]
        px = ax_[None, None, :, None]
        w = wind[fs, rs][..., None]
        covered = w.abs() > 0.5
        tc = torch.clamp(((px - ax) * ex + (py - ay) * ey) / denom, 0.0,
                         1.0)
        dx = px - (ax + tc * ex)
        dy = py - (ay + tc * ey)
        d2 = dx * dx + dy * dy
        c2 = ex * (py - ay) - ey * (px - ax)
        w_other = w - e(flip) * torch.sign(c2)
        rel = (w_other.abs() < 0.5) | (c2 == 0.0) | ~covered
        m, i = torch.where(rel & e(valid), d2, cap).min(-1)
        d2min[fs, rs] = m
        amin[fs, rs] = torch.where(m < cap2, i, -1)
    return d2min, amin


def soft_silhouette(verts, K, topo, S: int, sigma: float, cap2: float,
                    znear: float = 1e-4):
    """sil (N, S, S) of meshes verts (N, V, 3) seen through normalized K
    (N, 3, 3); differentiable in verts."""
    uv, z = project(verts, K)
    valid, p0, p1, cross, flip = contour_edges(uv, z, topo, znear)
    with torch.no_grad():
        wind = winding(p0.detach(), p1.detach(), cross, S)
        _, amin = nearest_edge(p0.detach(), p1.detach(), valid, flip, wind,
                               S, cap2)
    N = verts.shape[0]
    ax_ = _pixel_axis(S, verts.device)
    picked = amin >= 0
    i = torch.clamp(amin, min=0).reshape(N, -1)
    a = _gather_rows(p0, i).reshape(N, S, S, 2)
    b = _gather_rows(p1, i).reshape(N, S, S, 2)
    px, py = ax_[None, None, :], ax_[None, :, None]
    ex, ey = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    with torch.no_grad():
        tc = torch.clamp(((px - a[..., 0]) * ex + (py - a[..., 1]) * ey)
                         / torch.clamp(ex * ex + ey * ey, min=1e-12),
                         0.0, 1.0)
    dx = px - (a[..., 0] + tc * ex)
    dy = py - (a[..., 1] + tc * ey)
    d2 = torch.where(picked, dx * dx + dy * dy,
                     torch.tensor(cap2, device=verts.device))
    covered = wind.abs() > 0.5
    return torch.sigmoid(torch.where(covered, d2, -d2) / sigma)


def coverage(verts, K, topo, S: int, znear: float = 1e-4):
    """Covered pixels (N, S, S) bool: the hard silhouette."""
    with torch.no_grad():
        uv, z = project(verts, K)
        _, p0, p1, cross, _ = contour_edges(uv, z, topo, znear)
        return winding(p0, p1, cross, S).abs() > 0.5


def edge_demand(verts, K, topo, S: int, tile_px: int, margin_px: float,
                znear: float = 1e-4):
    """The most contour edges whose box, grown by the bin margin, overlaps
    one tile of one frame: what a tile's edge slots must hold."""
    with torch.no_grad():
        uv, z = project(verts, K)
        valid, p0, p1, _, _ = contour_edges(uv, z, topo, znear)
        m = margin_px / S
        lo = torch.minimum(p0, p1) - m
        hi = torch.maximum(p0, p1) + m
        g = S // tile_px
        t = torch.arange(g, device=verts.device, dtype=torch.float32)
        t_lo, t_hi = t * tile_px / S, (t + 1) * tile_px / S
        in_x = ((lo[..., 0, None] <= t_hi) & (hi[..., 0, None] >= t_lo))
        in_y = ((lo[..., 1, None] <= t_hi) & (hi[..., 1, None] >= t_lo))
        hit = (in_y[..., :, None] & in_x[..., None, :]
               & valid[..., None, None])  # (N, K, gy, gx)
        return int(hit.sum(1).max())
