"""Mesh -> interior SDF voxelization and trilinear sampling (counterpart of
homan_tpu/interactions/sdf.py).

  * `voxelize_interior_sdf`: a G^3 grid of phi(x) = dist(x, surface) where x
    is inside the mesh, else 0 (the reference clamps its voxelizer's output
    to >= 0, scenesdf.py:121). Inside is +z ray-crossing parity. This is the
    plain PyTorch version of the voxelizer kernel (interactions/voxelize.py),
    computed in slabs of points.
  * `grid_sample_3d`: differentiable trilinear lookup with align_corners=
    False and zero padding, torch's grid_sample on the transpose of the JAX
    package's [i, j, k] <-> (x, y, z) layout.
  * `interior_sdf_at_points`: the exact interior SDF at query points only
    (the "direct" mode), a dense no-grad sweep for the winning face followed
    by a differentiable recompute on it.
  * the scene losses: per-mesh grids built once without gradient, sampled at
    the other meshes' vertices (gradient through the trilinear weights).

`build_scene_sdfs` dispatches by device: CUDA tensors run the voxelizer
kernel, CPU tensors its plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Grid points per slab of the plain voxelizer: bounds its (points x faces)
# temporaries to a few tens of MB per term at 1.5k faces.
SLAB_POINTS = 2048


def _dot(u, v):
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[
        ..., 2]


def _cross(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)


def _point_triangle_dist2(p, a, b, c, eps: float = 1e-12):
    """Squared distance from points to triangles: p (N, 1, 3) and a, b, c
    (1, F, 3), or any broadcasting shapes -> (N, F).

    The closest point is the projection onto the triangle's plane when its
    barycentrics are all nonnegative, else the closest point of the three
    edges. Degenerate (zero-area) triangles take the edge branch.
    """
    def seg_d2(s, e):
        se = e - s
        t = torch.clamp(_dot(p - s, se) / torch.clamp(_dot(se, se), min=eps),
                        0.0, 1.0)
        d = p - (s + t[..., None] * se)
        return _dot(d, d)

    edge_d2 = torch.minimum(seg_d2(a, b),
                            torch.minimum(seg_d2(b, c), seg_d2(c, a)))
    n = _cross(b - a, c - a)
    nn_raw = _dot(n, n)
    nn = torch.clamp(nn_raw, min=eps)
    dist_plane = _dot(p - a, n)  # signed * |n|
    proj = p - dist_plane[..., None] * n / nn[..., None]
    w0 = _dot(_cross(b - proj, c - proj), n)
    w1 = _dot(_cross(c - proj, a - proj), n)
    w2 = _dot(_cross(a - proj, b - proj), n)
    inside_face = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (nn_raw > eps)
    plane_d2 = dist_plane * dist_plane / nn
    return torch.where(inside_face, plane_d2, edge_d2)


def _ray_z_crossings(p, a, b, c, eps: float = 1e-12):
    """Parity of +z ray crossings: p (N, 1, 3); a, b, c (1, F, 3) -> (N,)
    bool."""
    def edge(p0, p1):
        return ((p1[..., 0] - p0[..., 0]) * (p[..., 1] - p0[..., 1])
                - (p1[..., 1] - p0[..., 1]) * (p[..., 0] - p0[..., 0]))

    e0, e1, e2 = edge(a, b), edge(b, c), edge(c, a)
    inside_xy = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                 | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
    area2 = e0 + e1 + e2  # 2 * signed area
    nondegen = area2.abs() > eps
    denom = torch.where(nondegen, area2, torch.ones((), device=p.device))
    b0 = e1 / denom  # weight of vertex a (opposite edge bc)
    b1 = e2 / denom
    b2 = e0 / denom
    z_tri = b0 * a[..., 2] + b1 * b[..., 2] + b2 * c[..., 2]
    crossing = inside_xy & nondegen & (z_tri > p[..., 2])
    return (crossing.sum(-1) % 2) == 1


def grid_points(grid_size: int, device=None):
    """(G^3, 3) cell centres -1 + (2i + 1)/G, linear index (ix, iy, iz)
    with iz fastest."""
    g = grid_size
    axis = -1.0 + (2.0 * torch.arange(g, dtype=torch.float32, device=device)
                   + 1.0) / g
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def voxelize_interior_sdf(verts, faces, grid_size: int = 32,
                          chunk: int = SLAB_POINTS):
    """Interior-clamped SDF on a G^3 grid over [-1, 1]^3.

    verts (B, V, 3), already normalized into [-1, 1]^3; faces (F, 3).
    Returns phi (B, G, G, G), phi[i, j, k] the interior distance at the cell
    centre (x_i, y_j, z_k). No gradient.
    """
    g = grid_size
    faces = torch.as_tensor(faces, device=verts.device).long()
    points = grid_points(g, verts.device)
    out = []
    with torch.no_grad():
        for v in verts:
            tri = v[faces]  # (F, 3, 3)
            a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
            slabs = []
            for pts in torch.split(points, chunk):
                p = pts[:, None, :]
                d2 = _point_triangle_dist2(p, a, b, c).amin(-1)
                inside = _ray_z_crossings(p, a, b, c)
                slabs.append(torch.where(
                    inside, torch.sqrt(torch.clamp(d2, min=1e-20)),
                    torch.zeros((), device=verts.device)))
            out.append(torch.cat(slabs).reshape(g, g, g))
    return torch.stack(out)


def grid_sample_3d(phi, coords):
    """Trilinear sampling, torch grid_sample semantics (align_corners=False,
    zero padding), on phi (B, G, G, G) indexed [i, j, k] <-> (x, y, z), the
    transpose of torch's [D, H, W] layout. coords (B, N, 3) in [-1, 1].
    Returns (B, N); 0 outside the box; differentiable w.r.t. coords."""
    vol = phi.permute(0, 3, 2, 1)[:, None]  # (B, 1, z, y, x)
    out = F.grid_sample(vol, coords[:, :, None, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, 0, :, 0, 0]


def normalize_to_unit_box(verts, scale_factor: float = 0.2):
    """Per-sample bbox centre and padded half-extent, no gradient
    (scenesdf.py:96-117): scale = max half-extent * (1 + scale_factor).
    Returns (centre (B, 1, 3), scale (B, 1, 1))."""
    v = verts.detach()
    lo = v.amin(dim=1, keepdim=True)
    hi = v.amax(dim=1, keepdim=True)
    center = (lo + hi) / 2
    scale = ((hi - lo) * (1 + scale_factor) * 0.5).amax(dim=-1, keepdim=True)
    return center, scale


def interior_sdf_at_points(query, verts, faces):
    """The exact interior SDF at query points (B, N, 3): dist to the surface
    of the mesh (B, V, 3) + faces (F, 3) where inside, else 0.

    The dense (N, F) sweep runs without gradient; only its argmin face and
    the inside bit survive. The distance is then recomputed with gradient on
    that one face per query: the same value, and the same gradient w.r.t.
    the query (the argmin is locally constant). The mesh gets no gradient.
    """
    verts = verts.detach()
    faces = torch.as_tensor(faces, device=verts.device).long()
    out = []
    for q, v in zip(query, verts):
        tri = v[faces]  # (F, 3, 3)
        a, b, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
        p = q[:, None, :]
        with torch.no_grad():
            pd = p.detach()
            idx = torch.argmin(_point_triangle_dist2(pd, a, b, c), dim=-1)
            inside = _ray_z_crossings(pd, a, b, c)
        tb = tri[idx]  # (N, 3, 3)
        d2 = _point_triangle_dist2(p, tb[:, None, 0], tb[:, None, 1],
                                   tb[:, None, 2])[:, 0]
        out.append(torch.where(inside, torch.sqrt(torch.clamp(d2, min=1e-20)),
                               torch.zeros((), device=q.device)))
    return torch.stack(out)


def sdf_scene_loss_direct(verts_list, faces_list, scale_factor: float = 0.2):
    """Grid-free pairwise penetration through interior_sdf_at_points, with
    the grid mode's normalization (each pair's depths over mesh i's box
    scale). Returns (loss, {"dist_values": {(i, j): (B, V_j)} in world
    units})."""
    n = len(verts_list)
    if n != len(faces_list):
        raise ValueError("one face array per mesh")
    dev = verts_list[0].device
    if n == 1:
        return torch.zeros((), device=dev), {"sdfs": [], "dist_values": {}}
    scales = [normalize_to_unit_box(v, scale_factor)[1] for v in verts_list]
    loss = torch.zeros((), device=dev)
    dist_values = {}
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            vals = interior_sdf_at_points(verts_list[j], verts_list[i],
                                          faces_list[i])
            dist_values[(i, j)] = vals
            loss = loss + (vals / scales[i][..., 0]).sum()
    return loss, {"sdfs": [], "dist_values": dist_values}


def build_scene_sdfs(verts_list, faces_list, grid_size: int = 32,
                     scale_factor: float = 0.2):
    """Voxelize each mesh once into a normalized interior SDF grid, without
    gradient, so every term of a step can share the grids. The parity test
    and the unsigned distances are winding-invariant.

    Returns {"centers": [(B, 1, 3)], "scales": [(B, 1, 1)],
             "phis": [(B, G, G, G)]}.
    """
    from homan_tpu_torch.interactions import voxelize as vox
    centers, scales, phis = [], [], []
    for verts, faces in zip(verts_list, faces_list):
        center, scale = normalize_to_unit_box(verts, scale_factor)
        local = ((verts - center) / scale).detach()
        phi = vox.voxelize(local, faces, grid_size)
        centers.append(center)
        scales.append(scale)
        phis.append(torch.clamp(phi, min=0.0).detach())
    return {"centers": centers, "scales": scales, "phis": phis}


def sample_scene_sdf(grids, i: int, verts):
    """Mesh i's interior SDF at world-space verts (B, N, 3), in world units
    (0 outside); differentiable w.r.t. verts through the trilinear
    weights."""
    local = (verts - grids["centers"][i]) / grids["scales"][i]
    vals = grid_sample_3d(grids["phis"][i], local)
    return vals * grids["scales"][i][..., 0]


def sdf_penetration_from_grids(verts_list, grids):
    """Pairwise penetration over prebuilt grids (scenesdf.py:125-148): for
    every ordered pair (i, j), mesh i's SDF sampled at mesh j's verts."""
    n = len(verts_list)
    loss = torch.zeros((), device=verts_list[0].device)
    dist_values = {}
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            vals = sample_scene_sdf(grids, i, verts_list[j])
            dist_values[(i, j)] = vals
            loss = loss + (vals / grids["scales"][i][..., 0]).sum()
    return loss, dist_values


def sdf_scene_loss(verts_list, faces_list, grid_size: int = 32,
                   scale_factor: float = 0.2):
    """Pairwise SDF penetration loss (SDFSceneLoss.forward, scenesdf.py:
    77-148): build_scene_sdfs + sdf_penetration_from_grids. Returns (loss,
    {"sdfs": [(B, G, G, G)], "dist_values": {(i, j): (B, V_j)}})."""
    n = len(verts_list)
    if n != len(faces_list):
        raise ValueError("one face array per mesh")
    if n == 1:
        return (torch.zeros((), device=verts_list[0].device),
                {"sdfs": [], "dist_values": {}})
    grids = build_scene_sdfs(verts_list, faces_list, grid_size, scale_factor)
    loss, dist_values = sdf_penetration_from_grids(verts_list, grids)
    return loss, {"sdfs": grids["phis"], "dist_values": dist_values}
