"""Interior-SDF grids and their trilinear sampling.

phi at a cell centre of a G^3 grid over [-1, 1]^3 is the distance to the
mesh surface where the centre lies inside the mesh (an odd number of the
mesh's triangles cross its +z ray), else 0. Each mesh is first brought into
the box by its own bounding box, grown by 20%.

Computed per column: the crossing test of each (column, triangle) gives the
heights at which the column's +z ray leaves or enters the mesh, which
decide every cell of the column at once; the distance is computed only at
the inside centres, against every triangle, in blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# (point, triangle) pairs per block of the distance pass.
BLOCK_PAIRS = 1 << 24


def _dot(u, v):
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def _cross(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def point_triangle_dist2(p, a, b, c, eps: float = 1e-12):
    """Squared distance from points p to triangles (a, b, c), broadcast:
    the plane distance where the projection falls inside the triangle,
    else the nearest of the three edges."""
    def seg(s, e):
        se = e - s
        t = torch.clamp(_dot(p - s, se) / torch.clamp(_dot(se, se), min=eps),
                        0.0, 1.0)
        d = p - (s + t[..., None] * se)
        return _dot(d, d)

    edge = torch.minimum(seg(a, b), torch.minimum(seg(b, c), seg(c, a)))
    n = _cross(b - a, c - a)
    nn_raw = _dot(n, n)
    nn = torch.clamp(nn_raw, min=eps)
    h = _dot(p - a, n)
    q = p - h[..., None] * n / nn[..., None]
    inside = ((_dot(_cross(b - q, c - q), n) >= 0)
              & (_dot(_cross(c - q, a - q), n) >= 0)
              & (_dot(_cross(a - q, b - q), n) >= 0) & (nn_raw > eps))
    return torch.where(inside, h * h / nn, edge)


def grid_axis(G: int, device):
    return -1.0 + (2.0 * torch.arange(G, dtype=torch.float32, device=device)
                   + 1.0) / G


def inside_cells(tri, G: int):
    """(M, G, G, G) bool: cell [i, j, k] at (x_i, y_j, z_k) is inside the
    mesh of triangles tri (M, F, 3, 3)."""
    dev = tri.device
    ax = grid_axis(G, dev)
    M = tri.shape[0]
    out = torch.empty((M, G, G, G), dtype=torch.bool, device=dev)
    px = ax[:, None, None]  # x_i (G, 1, 1) -> column (i, j)
    py = ax[None, :, None]
    block = max(1, BLOCK_PAIRS // (G * G * tri.shape[1]))
    for m0 in range(0, M, block):
        t = tri[m0:m0 + block, None, None]  # (m, 1, 1, F, 3, 3)
        a, b, c = t[..., 0, :], t[..., 1, :], t[..., 2, :]

        def edge(p0, p1):
            return ((p1[..., 0] - p0[..., 0]) * (py - p0[..., 1])
                    - (p1[..., 1] - p0[..., 1]) * (px - p0[..., 0]))

        e0, e1, e2 = edge(a, b), edge(b, c), edge(c, a)
        inside_xy = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                     | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
        area2 = e0 + e1 + e2
        ok = inside_xy & (area2.abs() > 1e-12)
        denom = torch.where(area2.abs() > 1e-12, area2,
                            torch.ones((), device=dev))
        z = (e1 / denom * a[..., 2] + e2 / denom * b[..., 2]
             + e0 / denom * c[..., 2])
        zc = torch.where(ok, z, torch.tensor(-float("inf"), device=dev))
        n_max = max(int(ok.sum(-1).max()), 1)
        top = zc.topk(n_max, dim=-1)[0]  # (m, G, G, n) crossing heights
        above = (top[..., None, :] > ax[:, None]).sum(-1)  # (m, G, G, G)
        out[m0:m0 + block] = (above % 2) == 1
    return out


def corner_cells(coords, G: int):
    """(M, G^3) bool: the cells whose values a trilinear sample at coords
    (M, N, 3) in [-1, 1] reads (its 8 corners, by the sampler's
    align_corners=False convention), linear index i G^2 + j G + k."""
    M, N = coords.shape[:2]
    u = ((coords.detach() + 1.0) * G - 1.0) / 2.0
    lo = torch.floor(u).long()
    need = torch.zeros((M, G ** 3), dtype=torch.bool, device=coords.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = torch.clamp(lo + torch.tensor([dx, dy, dz],
                                                  device=lo.device), 0, G - 1)
                need.scatter_(1, c[..., 0] * G * G + c[..., 1] * G
                              + c[..., 2], True)
    return need


def triangles(verts, faces):
    """(M, F, 3, 3) corners of the meshes verts (M, V, 3) with faces
    (F, 3) shared or (M, F, 3) per mesh."""
    if faces.dim() == 2:
        faces = faces[None].expand(verts.shape[0], -1, -1)
    M, Fn = faces.shape[:2]
    idx = faces.reshape(M, -1, 1).expand(-1, -1, 3)
    return torch.gather(verts, 1, idx).reshape(M, Fn, 3, 3)


def voxelize(verts, faces, G: int, at=None):
    """Interior SDF (M, G, G, G) of meshes verts (M, V, 3) already in
    [-1, 1]^3, faces (F, 3) shared or (M, F, 3) per mesh, and the inside
    cells (M, G, G, G). With `at` (M, N, 3), the distance is computed only
    at the inside cells that trilinear samples at those points read, and
    the other cells hold 0: the samples there are the same."""
    dev = verts.device
    tri = triangles(verts, faces)
    M, Fn = tri.shape[:2]
    inside = inside_cells(tri, G)
    phi = torch.zeros((M, G * G * G), device=dev)
    ax = grid_axis(G, dev)
    todo = inside.reshape(M, -1)
    if at is not None:
        todo = todo & corner_cells(at, G)
    where = todo.nonzero()  # (P, 2): mesh, cell
    block = max(1, BLOCK_PAIRS // Fn)
    for p0 in range(0, where.shape[0], block):
        m, cell = where[p0:p0 + block].unbind(-1)
        p = torch.stack([ax[cell // (G * G)], ax[(cell // G) % G],
                         ax[cell % G]], -1)[:, None]  # (P, 1, 3)
        t = tri[m]  # (P, F, 3, 3)
        d2 = point_triangle_dist2(p, t[..., 0, :], t[..., 1, :],
                                  t[..., 2, :]).amin(-1)
        phi[m, cell] = torch.sqrt(torch.clamp(d2, min=1e-20))
    return phi.reshape(M, G, G, G), inside


def unit_box(verts, pad: float = 0.2):
    """Centre (M, 1, 3) and half-extent (M, 1, 1) of each mesh's bounding
    box, grown by `pad`; no gradient."""
    v = verts.detach()
    lo, hi = v.amin(1, keepdim=True), v.amax(1, keepdim=True)
    return (lo + hi) / 2, ((hi - lo) * (1 + pad) * 0.5).amax(-1,
                                                              keepdim=True)


def sample(phi, coords):
    """Trilinear samples (M, N) of phi (M, G, G, G), indexed [x, y, z], at
    coords (M, N, 3) in [-1, 1] (cell centres at -1 + (2i + 1)/G; 0
    outside); differentiable in coords."""
    vol = phi.permute(0, 3, 2, 1)[:, None]
    out = F.grid_sample(vol, coords[:, :, None, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, 0, :, 0, 0]
