"""The work one fit step needs, counted from its inputs.

The three kernels' formulas are frozen copies of the port's, as they stood
when this benchmark was written (homan_tpu_torch/render/shade.py
`fwd_work`, `fwd_work_ops` and its per-element constants, the shade
backward's per-pixel count, interactions/voxelize.py `work_ops`), with the
binning that lays out the shade kernel's inputs (render/rasterizer.py
`shade_prep`, without its gradient). A change to the program cannot move
them; portbench/tests checks that they still equal the port's.

Each count is what these inputs need: every input byte read once, every
output byte written once, and the operations the kernel's algorithm does on
them. The dense float work of the rest of the step (MANO, the rigid
placements and projections, the loss terms, Adam) is counted from shapes
by `dense_ops`, forward and backward, whatever implements it.
"""
from __future__ import annotations

import torch

# --- the shade forward (render/shade.py) ---------------------------------
FWD_PIXELS_PER_THREAD = 8
FWD_ROW_OPS_PER_ROW_SLOT = 43
FWD_WINDING_OPS_PER_PIXEL_SLOT = 3
FWD_TEST_OPS_PER_GROUP_SLOT = 13
FWD_DIST_OPS_PER_PIXEL_SLOT = 37
FWD_DMAX_OPS_PER_GROUP_SLOT = 7
BWD_OPS_PER_PIXEL = 14
# --- the voxelizer (interactions/voxelize.py) -----------------------------
VOX_TF = 128
CROSS_OPS_PER_COLUMN_FACE = 32
DIST_OPS_PER_POINT_FACE = 87


def fwd_work_ops(work: dict) -> int:
    return (FWD_ROW_OPS_PER_ROW_SLOT * work["row_slots"]
            + FWD_WINDING_OPS_PER_PIXEL_SLOT * work["pixel_slots"]
            + FWD_TEST_OPS_PER_GROUP_SLOT * work["group_slots"]
            + (FWD_PIXELS_PER_THREAD * FWD_DIST_OPS_PER_PIXEL_SLOT
               + FWD_DMAX_OPS_PER_GROUP_SLOT)
            * work["evaluated_group_slots"])


def vox_work_ops(n_faces: int, n_inside: int, grid_size: int, batch: int):
    return (CROSS_OPS_PER_COLUMN_FACE * batch * grid_size ** 2 * n_faces
            + DIST_OPS_PER_POINT_FACE * n_inside * n_faces)


def _pixel_coords(tp, S, g, T, device):
    t = torch.arange(T, device=device)
    gx = (t % g).to(torch.float32)[None, :, None, None]
    gy = (t // g).to(torch.float32)[None, :, None, None]
    ar = torch.arange(tp, device=device, dtype=torch.float32)
    inv_s = torch.tensor(1.0 / S, dtype=torch.float32, device=device)
    px = (gx * tp + ar[None, None, None, :] + 0.5) * inv_s
    py = (gy * tp + ar[None, None, :, None] + 0.5) * inv_s
    return px, py, (gx + 1.0) * tp * inv_s


def _winding(seg, anchors, ke, px, py, x1):
    one = torch.ones((), device=seg.device)
    zero = torch.zeros((), device=seg.device)
    w = anchors.clone()
    for k in range(ke):
        ax, ay, bx, by, sgn = (seg[:, :, r, k] for r in range(5))
        dy = by - ay
        spans = (ay <= py) != (by <= py)
        xi = ax + (py - ay) / torch.where(dy.abs() > 1e-12, dy, one) * (
            bx - ax)
        w = w + torch.where(spans & (xi > px) & (xi <= x1), sgn, zero)
    return w


def _slot_d2(seg, k, px, py, winding, covered, cap2):
    ax, ay, bx, by = (seg[:, :, r, k] for r in range(4))
    ex, ey = bx - ax, by - ay
    denom = torch.clamp(ex * ex + ey * ey, min=1e-12)
    tc = torch.clamp(((px - ax) * ex + (py - ay) * ey) / denom, 0.0, 1.0)
    dx = px - (ax + tc * ex)
    dyp = py - (ay + tc * ey)
    cross2d = ex * (py - ay) - ey * (px - ax)
    w_other = winding - seg[:, :, 6, k] * torch.sign(cross2d)
    rel = (w_other.abs() < 0.5) | (cross2d == 0.0) | ~covered
    return torch.where(rel, dx * dx + dyp * dyp, cap2)


def fwd_work(seg_pack, anchors, tp, S, g, cap2, ke) -> dict:
    """The shade forward kernel's work on these packs, replaying its order
    (render/shade.py fwd_work), and the pixels that pick a slot (whose
    residuals the backward reads)."""
    B, T = seg_pack.shape[:2]
    npx = FWD_PIXELS_PER_THREAD
    dev = seg_pack.device
    px, py, x1 = _pixel_coords(tp, S, g, T, dev)
    cap = torch.tensor(cap2, dtype=torch.float32, device=dev)
    seg = seg_pack[..., None, None]
    n_e = (seg_pack[:, :, 5] > 0.5).sum(-1)
    n_valid = int(n_e.sum())
    winding = _winding(seg, anchors, ke, px, py, x1)
    covered = winding.abs() > 0.5
    d2min = torch.full(winding.shape, cap2, dtype=torch.float32, device=dev)
    px_first, px_last = px[..., ::npx], px[..., npx - 1::npx]
    evaluated = 0
    for k in range(ke):
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
        d2 = _slot_d2(seg, k, px, py, winding, covered, cap)
        d2min = torch.where(live & (d2 < d2min), d2, d2min)
    return {"row_slots": n_valid * tp, "pixel_slots": n_valid * tp * tp,
            "group_slots": n_valid * tp * (tp // npx),
            "evaluated_group_slots": evaluated,
            "picked": int((d2min < cap2).sum())}


def shade_packs(verts, K, topo, S, tp, ke, margin_px, znear=1e-4):
    """The shade kernel's inputs for meshes verts (N, V, 3): seg_pack
    (N, T, 8, ke), anchors (N, T, tp, tp), as render/rasterizer.py
    shade_prep lays them out (the first ke overlapping contour edges of
    each tile, in edge order, and the winding at each tile row's right
    end). topo: faces (N, F, 3), edges (N, E, 2), edge_faces (N, E, 2),
    edge_dir (N, E)."""
    from portbench.reference.silhouette import _gather_rows
    g = S // tp
    T = g * g
    dev = verts.device
    margin = margin_px / S
    proj = verts @ K.transpose(-1, -2)
    uv = proj[..., :2] / torch.clamp(proj[..., 2:3], min=1e-9)
    z = verts[..., 2]
    tri = _gather_rows(uv, topo["faces"])
    tz = _gather_rows(z, topo["faces"])
    # (v2 - v1) x (v0 - v1), in the port's order of operations.
    area = ((tri[..., 2, 0] - tri[..., 1, 0]) * (tri[..., 0, 1]
                                                 - tri[..., 1, 1])
            - (tri[..., 2, 1] - tri[..., 1, 1]) * (tri[..., 0, 0]
                                                   - tri[..., 1, 0]))
    ok = (tz > znear).all(-1) & (area.abs() > 1e-12)
    front = torch.where(ok, torch.sign(area), torch.zeros_like(area))
    front = torch.cat([front, front.new_zeros(front.shape[0], 1)], 1)
    n_f = topo["faces"].shape[1]
    ef = topo["edge_faces"]
    o1 = torch.gather(front, 1, torch.where(ef[..., 0] >= 0, ef[..., 0],
                                            n_f))
    o2 = torch.gather(front, 1, torch.where(ef[..., 1] >= 0, ef[..., 1],
                                            n_f))
    is_c = ((o1 != o2) & (_gather_rows(z, topo["edges"]) > znear).all(-1)
            & ((o1 != 0) | (o2 != 0)))
    one = torch.ones((), device=dev)
    flip = (torch.where(topo["edge_dir"], one, -one)
            * torch.where(o1 > 0, one, -one))
    seg = _gather_rows(uv, topo["edges"])
    p0, p1 = seg[:, :, 0], seg[:, :, 1]
    cross = torch.sign(p1[..., 1] - p0[..., 1]) * flip * is_c
    ys = (torch.arange(S, device=dev, dtype=torch.float32) + 0.5) / S
    y0, y1 = p0[..., 1][:, None], p1[..., 1][:, None]
    yy = ys[None, :, None]
    spans = (y0 <= yy) != (y1 <= yy)
    dy = y1 - y0
    t = (yy - y0) / torch.where(dy.abs() > 1e-12, dy, one)
    x_int = p0[..., 0][:, None] + t * (p1[..., 0] - p0[..., 0])[:, None]
    contrib = torch.where(spans, cross[:, None], torch.zeros((), device=dev))
    anchors = torch.stack([
        torch.where(x_int > (c + 1.0) * tp / S, contrib, 0.0).sum(-1)
        for c in range(g)], 1)  # (N, g, S)
    lo = torch.minimum(p0, p1) - margin
    hi = torch.maximum(p0, p1) + margin
    tt = torch.arange(T, device=dev)
    t_xy = torch.stack([tt % g, tt // g], -1).to(torch.float32)
    t_lo, t_hi = t_xy * tp / S, (t_xy + 1) * tp / S
    overlap = ((lo[:, None, :, 0] <= t_hi[None, :, None, 0])
               & (hi[:, None, :, 0] >= t_lo[None, :, None, 0])
               & (lo[:, None, :, 1] <= t_hi[None, :, None, 1])
               & (hi[:, None, :, 1] >= t_lo[None, :, None, 1])
               & is_c[:, None, :])  # (N, T, E)
    N, _, E = overlap.shape
    csum = torch.cumsum(overlap.to(torch.int32), -1, dtype=torch.int32)
    ranks = torch.arange(1, ke + 1, device=dev, dtype=torch.int32)
    idx = torch.clamp(torch.searchsorted(
        csum, ranks.expand(N, T, ke).contiguous()), max=E - 1)
    hit = ranks[None, None] <= csum[..., -1:]
    rows = torch.cat([p0, p1, cross[..., None], (flip * is_c)[..., None]],
                     -1)  # (N, E, 6)
    sel = torch.gather(rows, 1, idx.reshape(N, -1, 1).expand(-1, -1, 6))
    sel = torch.where(hit[..., None], sel.reshape(N, T, ke, 6), 0.0)
    hitf = hit.to(torch.float32)
    far = 99.0 * (1.0 - hitf)
    seg_pack = torch.stack([sel[..., 0] + far, sel[..., 1] + far,
                            sel[..., 2] + far, sel[..., 3] + far,
                            sel[..., 4], hitf, sel[..., 5],
                            torch.zeros_like(hitf)], -2)
    tile_gx = tt % g
    trow = (tt // g)[:, None] * tp + torch.arange(tp, device=dev)[None]
    anchor_px = anchors[:, tile_gx[:, None], trow][..., None].expand(
        N, T, tp, tp).contiguous()
    return seg_pack.contiguous(), anchor_px


def shade_work(verts, K, topo, S, tp, ke, margin_px, frames_per_block=64):
    """Bytes and operations of one shade forward and one shade backward
    launch over all the meshes verts (N, V, 3): ({"bytes", "ops"} each),
    with the counts they come from."""
    g = S // tp
    cap2 = (margin_px / S) ** 2
    acc = {"row_slots": 0, "pixel_slots": 0, "group_slots": 0,
           "evaluated_group_slots": 0, "picked": 0}
    N = verts.shape[0]
    with torch.no_grad():
        for n0 in range(0, N, frames_per_block):
            sl = slice(n0, n0 + frames_per_block)
            seg_pack, anchors = shade_packs(
                verts[sl], K[sl], {k: v[sl] for k, v in topo.items()}, S,
                tp, ke, margin_px)
            w = fwd_work(seg_pack, anchors, tp, S, g, cap2, ke)
            for k in acc:
                acc[k] += w[k]
    px = N * S * S
    seg_bytes = N * g * g * 8 * ke * 4
    return ({"bytes": seg_bytes + px * 4 + px * 20, "ops": fwd_work_ops(acc)},
            {"bytes": px * 4 + acc["picked"] * 20 + seg_bytes,
             "ops": BWD_OPS_PER_PIXEL * acc["picked"]}, acc)


def vox_work(n_meshes: int, n_faces: int, ops: int, G: int):
    """Bytes and operations of one voxelizer launch over n_meshes meshes
    of n_faces triangles (padded to the kernel's 128-triangle tiles), its
    operations `ops` summed over the meshes by vox_work_ops with each
    mesh's valid triangles and inside cells."""
    fpad = -(-n_faces // VOX_TF) * VOX_TF
    return {"bytes": n_meshes * 16 * fpad * 4 + n_meshes * G ** 3 * 4,
            "ops": ops}


# Dense float operations per hand-frame of the MANO chain: PCA to axis-
# angle (16 x 45 x 2 + 45), shape blend shapes (778 x 3 x 10 x 2), joint
# regressor (16 x 778 x 3 x 2), Rodrigues (16 x 60), pose correctives
# (778 x 3 x 135 x 2 + 135), the kinematic chain (15 x 112), skinning
# weights (778 x 16 x 12 x 2) and the skinned vertices (778 x 3 x 3 x 2 +
# 778 x 3 x 2).
MANO_OPS = (16 * 45 * 2 + 45 + 778 * 3 * 10 * 2 + 16 * 778 * 3 * 2
            + 16 * 60 + 778 * 3 * 135 * 2 + 135 + 15 * 112
            + 778 * 16 * 12 * 2 + 778 * 3 * 3 * 2 + 778 * 3 * 2)
# Per vertex: scale, rotate and translate (3 + 3 x 3 x 2 + 3), project
# (3 x 3 x 2 + 2 divides).
PLACE_OPS, PROJECT_OPS = 24, 20
# A backward pass costs about twice its forward.
BACKWARD_FACTOR = 2


def dense_ops(n_frames: int, n_obj_verts: int, n_obj_faces: int,
              n_obj_edges: int, n_pixels: int, mano_passes: int,
              sdf_pairs: int, n_leaves: int) -> int:
    """The dense float work of one step outside the three kernels, forward
    and backward, counted from shapes: the MANO chain (mano_passes per
    hand-frame), placing and projecting both meshes, the contour data (per
    face its signed area, 7; per edge its tests and orientation, 10), the
    silhouette loss (4 a pixel), the vertex terms (about 10 a vertex), the
    contact term's nearest-vertex distances (8 a hand-object vertex pair,
    sdf_pairs of them) and Adam (12 per free parameter)."""
    hand_verts = 778
    per_frame = (mano_passes * MANO_OPS
                 + (hand_verts + n_obj_verts) * (PLACE_OPS + PROJECT_OPS)
                 + 7 * n_obj_faces + 10 * n_obj_edges
                 + 10 * (hand_verts + n_obj_verts))
    fwd = n_frames * per_frame + 4 * n_pixels + 8 * sdf_pairs
    return (1 + BACKWARD_FACTOR) * fwd + 12 * n_leaves
