"""Triangle-intersection collision loss, `collision_mode="tritri"`
(homan_tpu/interactions/intersect.py:33-191).

The reference's optional collision branch (homan/lossutils.py:66-104) finds
interpenetrating triangle pairs with a CUDA BVH, detection under
`torch.no_grad()`, and penalizes them with a conical distance field
(`DistanceFieldPenetrationLoss(sigma=0.5, point2plane=1)`). The JAX package
replaces the tree by a dense, AABB-prefiltered Moller test over every
cross-entity pair; this module keeps its expressions: the eps thresholds,
the first-index argmax of |line direction| and the branchless interval.

The JAX module reaches no Pallas kernel (it is XLA), so this stays plain
PyTorch. Where the JAX module maps a frame at a time (`lax.map`), this one
runs every frame and hand at once: the pair tensors carry the leading batch
dims, and the object's faces are taken in chunks so that one pair tensor
holds at most PAIR_CHUNK (batch x hand faces x object faces) elements.

Detection runs under torch.no_grad(); the penalty (squared point-to-plane
depths of each intersecting pair's vertices behind the other's plane,
times sigma) keeps its gradient.
"""
from __future__ import annotations

import torch

# Elements of one (batch..., Na, Nb_chunk) pair tensor. About twenty such
# float32 tensors (some with a trailing 3) live at once in a chunk, so a
# chunk peaks near 20 x 3 x 4 B x PAIR_CHUNK = 4 GB at the cap; the
# interaction fit's 10 frames x 1,554 closed-hand faces x 1,280 object
# faces (19.9M pairs) run in two chunks.
PAIR_CHUNK = 1 << 24


def _tri_planes(tris: torch.Tensor):
    """Unit normals + plane offsets for (..., 3, 3) triangles."""
    n = torch.linalg.cross(tris[..., 1, :] - tris[..., 0, :],
                           tris[..., 2, :] - tris[..., 0, :], dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    d = -(n * tris[..., 0, :]).sum(-1)
    return n, d


def _dot3(n, v):
    """n . v over the last axis in float32, as fma(n2, v2, fma(n1, v1,
    n0 v0)): the arithmetic of the JAX package's dot on the CPU. Each fused
    step runs in float64, where the float32 product is exact, and rounds
    once to float32. Elementwise, so a pair's value does not depend on the
    shapes around it or on the device: a batched matmul's summation order
    does, and a distance within rounding of the eps thresholds then flips
    a pair between chunkings."""
    acc = (n[..., 0] * v[..., 0]).double()
    for k in (1, 2):
        acc = (n[..., k].double() * v[..., k].double() + acc).float().double()
    return acc.float()


def _plane_dists(na, da, nb, db, tri_a, tri_b):
    """dist_b[..., a, b, j] = n_a . v_b,j + d_a and dist_a[..., a, b, j] =
    n_b . v_a,j + d_b, both (..., Na, Nb, 3)."""
    dist_b = _dot3(na[..., :, None, None, :], tri_b[..., None, :, :, :]) \
        + da[..., :, None, None]
    dist_a = _dot3(nb[..., None, :, None, :], tri_a[..., :, None, :, :]) \
        + db[..., None, :, None]
    return dist_a, dist_b


def _interval(proj, dist):
    """Parameter interval where a triangle crosses the planes' line.

    Moller: t = p_i + (p_j - p_i) d_i / (d_i - d_j) on each edge whose
    endpoints straddle the plane; branchless over the three edges. proj,
    dist (..., 3) per vertex."""
    big = 1e30
    lo = hi = None
    for i, j in ((0, 1), (0, 2), (1, 2)):
        di, dj = dist[..., i], dist[..., j]
        pi, pj = proj[..., i], proj[..., j]
        denom = di - dj
        t = pi + (pj - pi) * di / torch.where(denom.abs() > 1e-12, denom,
                                              torch.ones_like(denom))
        cross = (di > 0) != (dj > 0)
        t_lo = torch.where(cross, t, torch.full_like(t, big))
        t_hi = torch.where(cross, t, torch.full_like(t, -big))
        lo = t_lo if lo is None else torch.minimum(lo, t_lo)
        hi = t_hi if hi is None else torch.maximum(hi, t_hi)
    return lo, hi


def _intersect(tri_a, tri_b, na, nb, dist_a, dist_b):
    """The Moller mask from the planes and plane distances."""
    eps = 1e-10
    straddle_b = (dist_b.amax(-1) > eps) & (dist_b.amin(-1) < -eps)
    straddle_a = (dist_a.amax(-1) > eps) & (dist_a.amin(-1) < -eps)
    candidate = straddle_a & straddle_b

    # |line direction| = |n_a x n_b|, per component, and its dominant axis
    # (the first index on ties, as argmax takes it).
    a = na[..., :, None, :]
    b = nb[..., None, :, :]
    lx = (a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]).abs()
    ly = (a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]).abs()
    lz = (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]).abs()
    use_x = (lx >= ly) & (lx >= lz)
    use_y = ~use_x & (ly >= lz)

    def project(tri, expand):
        # (..., Na, Nb, 3 vertices): each vertex's coordinate on the axis.
        c = [expand(tri[..., k]) for k in range(3)]     # (..., Na|1, 1|Nb, 3)
        return torch.where(use_x[..., None], c[0],
                           torch.where(use_y[..., None], c[1], c[2]))

    proj_a = project(tri_a, lambda x: x[..., :, None, :])
    proj_b = project(tri_b, lambda x: x[..., None, :, :])
    lo_a, hi_a = _interval(proj_a, dist_a)
    lo_b, hi_b = _interval(proj_b, dist_b)
    overlap = (torch.minimum(hi_a, hi_b) - torch.maximum(lo_a, lo_b)) > 0
    return candidate & overlap


def tri_tri_intersect(tri_a: torch.Tensor, tri_b: torch.Tensor
                      ) -> torch.Tensor:
    """Pairwise triangle-triangle intersection mask.

    tri_a (..., Na, 3, 3), tri_b (..., Nb, 3, 3) with broadcastable leading
    dims. Returns (..., Na, Nb) bool, True where the (open) triangles
    intersect: each triangle's vertices straddle the other's plane and
    their intervals on the planes' line overlap.
    """
    na, da = _tri_planes(tri_a)
    nb, db = _tri_planes(tri_b)
    dist_a, dist_b = _plane_dists(na, da, nb, db, tri_a, tri_b)
    return _intersect(tri_a, tri_b, na, nb, dist_a, dist_b)


def _aabb_overlap(tri_a, tri_b, margin=0.0):
    """(..., Na, Nb) bool: the triangles' boxes overlap."""
    lo_a, hi_a = tri_a.amin(-2), tri_a.amax(-2)
    lo_b, hi_b = tri_b.amin(-2), tri_b.amax(-2)
    return ((lo_a[..., :, None, :] <= hi_b[..., None, :, :] + margin)
            & (lo_b[..., None, :, :] <= hi_a[..., :, None, :] + margin)
            ).all(-1)


def pair_penetration_loss(tri_a: torch.Tensor, tri_b: torch.Tensor,
                          sigma: float = 0.5,
                          max_pairs: int = PAIR_CHUNK) -> torch.Tensor:
    """Penetration penalty between two triangle soups.

    tri_a (..., Fa, 3, 3), tri_b (..., Fb, 3, 3) camera-space triangles,
    leading dims broadcastable. Returns (...): per batch element, the sum
    over intersecting pairs of the squared point-to-plane depths of each
    triangle's vertices behind the other's plane, times sigma. tri_b's
    faces run in chunks of at most max_pairs pairs.
    """
    batch = torch.broadcast_shapes(tri_a.shape[:-3], tri_b.shape[:-3])
    fa, fb = tri_a.shape[-3], tri_b.shape[-3]
    per_face = max(1, fa * int(torch.Size(batch).numel()))
    step = max(1, max_pairs // per_face)
    na, da = _tri_planes(tri_a)
    total = torch.zeros(batch, dtype=tri_a.dtype, device=tri_a.device)
    for s in range(0, fb, step):
        tb = tri_b[..., s:s + step, :, :]
        nb, db = _tri_planes(tb)
        dist_a, dist_b = _plane_dists(na, da, nb, db, tri_a, tb)
        with torch.no_grad():  # the reference's no_grad BVH pass
            inter = _aabb_overlap(tri_a, tb) & _intersect(
                tri_a, tb, na, nb, dist_a, dist_b)
        pen = (torch.square(torch.clamp(dist_b, max=0.0)).sum(-1)
               + torch.square(torch.clamp(dist_a, max=0.0)).sum(-1))
        total = total + (pen * inter).sum((-2, -1))
    return total * sigma


def compute_collision_loss_tritri(verts_hand: torch.Tensor, hand_faces,
                                  verts_obj: torch.Tensor, obj_faces,
                                  hand_nb: int, sigma: float = 0.5
                                  ) -> torch.Tensor:
    """Clip-level triangle-intersection collision loss.

    verts_hand (B*H, 778, 3) interleaved; hand_faces (Fh, 3) closed fist;
    verts_obj (B, Vo, 3); obj_faces (Fo, 3). Returns the mean over frames
    of each frame's hand-object pairs (and hand-hand with two hands), the
    `loss_collision` contract of homan/lossutils.py:104.
    """
    dev = verts_obj.device
    B = verts_obj.shape[0]
    hand_faces = torch.as_tensor(hand_faces, dtype=torch.int64, device=dev)
    obj_faces = torch.as_tensor(obj_faces, dtype=torch.int64, device=dev)
    vh = verts_hand.reshape(B, hand_nb, verts_hand.shape[1], 3)
    tri_h = vh[:, :, hand_faces]                      # (B, H, Fh, 3, 3)
    tri_o = verts_obj[:, obj_faces][:, None]          # (B, 1, Fo, 3, 3)
    per_frame = pair_penetration_loss(tri_h, tri_o, sigma).sum(1)
    if hand_nb == 2:
        per_frame = per_frame + pair_penetration_loss(
            tri_h[:, 0], tri_h[:, 1], sigma)
    return per_frame.mean()
