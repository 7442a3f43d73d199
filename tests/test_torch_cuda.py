"""The CUDA kernels (shade pair, depth pair, voxelizer) against their plain
PyTorch versions, on the card. Marked `cuda`; skipped where torch sees no
CUDA device. The GPU machine has no jax, so this file uses the port alone;
run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from homan_tpu_torch.core import mano as tmano
from homan_tpu_torch.core.meshes import bumpy_potato
from homan_tpu_torch.interactions import sdf as tsdf
from homan_tpu_torch.interactions import voxelize as tvox
from homan_tpu_torch.render import depth as tdepth
from homan_tpu_torch.render import rasterizer as tr
from homan_tpu_torch.render import shade

pytestmark = pytest.mark.cuda


def raster_mesh(mesh, b=2):
    """verts (b, V, 3), faces, K (b, 3, 3): the object or the hand, as in
    tests/test_torch_render.py."""
    if mesh == "object":
        v, f = bumpy_potato(2, 0.25, seed=0)
        offs = np.random.RandomState(0).randn(b, 1, 3).astype(np.float32)
        verts = v[None] + np.array([0, 0, 1.0], np.float32) + offs * 0.03
        K = [[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]
    else:
        p = tmano.synthetic_mano_params(0, device="cpu")
        z = torch.zeros(b, 3)
        out = tmano.mano_forward(p, torch.zeros(b, 10), z, torch.zeros(b, 45))
        verts = out["verts"].numpy() + np.array([0, 0, 0.5], np.float32)
        f = p["faces"].numpy()
        K = [[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]]
    K = np.tile(np.array([K], np.float32), (b, 1, 1))
    return verts.astype(np.float32), f, K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _pack(device, mesh, S, tp, ke):
    verts, faces, K = raster_mesh(mesh)
    topo = tr.MeshTopology.from_faces(faces, device=device)
    settings = tr.RasterSettings(S, tile_px=tp, edges_per_tile=ke)
    with torch.no_grad():
        seg, anc, _, static = tr.shade_prep(
            torch.from_numpy(verts).to(device), topo,
            torch.from_numpy(K).to(device), settings)
    return seg, anc, static


@pytest.mark.parametrize("case", [("object", 64, 32, 96),
                                  ("object", 32, 16, 64),
                                  ("hand", 64, 16, 64),
                                  ("object", 64, 64, 48),
                                  ("object", 256, 128, 96),
                                  ("hand", 128, 16, 48)])
def test_kernels_match_plain(cuda, case):
    seg, anc, static = _pack(cuda, *case)
    n0, m0 = shade.shade_fwd_launches, shade.shade_bwd_launches
    k = shade.shade_fwd(seg, anc, static, want_residuals=True)
    only = shade.shade_fwd(seg, anc, static, want_residuals=False)[0]
    p = shade.shade_fwd_plain(seg, anc, static, True)
    assert shade.shade_fwd_launches == n0 + 2
    torch.testing.assert_close(k[0], p[0], atol=2e-5, rtol=0)
    assert torch.equal(only, k[0])
    same = k[1] == p[1]
    assert same.float().mean().item() >= 0.999
    for a, b in zip(k[2:], p[2:]):
        torch.testing.assert_close(a[same], b[same], atol=1e-6, rtol=0)
    gcot = torch.randn(k[0].shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(0))
    g_k = shade.shade_bwd(k, gcot, static)
    g_p = shade.shade_bwd_plain(p, gcot, static)
    assert shade.shade_bwd_launches == m0 + 1
    scale = g_p.abs().max().item()
    assert scale > 0
    assert (g_k - g_p).abs().max().item() <= 3e-3 * scale
    assert torch.equal(g_k, shade.shade_bwd(k, gcot, static))


# (mesh, image size, tile, edges per tile) at tiles the kernel's float4
# instantiation does not take: not a multiple of 8 (12, 13: scalar loads
# and stores, odd rows) or wider than 1024 (two column segments); 24, a
# multiple of 8 but not of the depth kernel's 16, for comparison.
RAGGED_SHADE_CASES = [("object", 48, 12, 64), ("object", 48, 24, 64),
                      ("hand", 48, 24, 64), ("object", 26, 13, 48),
                      ("object", 1040, 1040, 48)]


@pytest.mark.parametrize("case", RAGGED_SHADE_CASES)
def test_shade_kernels_at_ragged_tiles_match_plain(cuda, case):
    seg, anc, static = _pack(cuda, *case)
    n0, m0 = shade.shade_fwd_launches, shade.shade_bwd_launches
    k = shade.shade_fwd(seg, anc, static, want_residuals=True)
    only = shade.shade_fwd(seg, anc, static, want_residuals=False)[0]
    p = shade.shade_fwd_plain(seg, anc, static, True)
    assert shade.shade_fwd_launches == n0 + 2
    # The same arithmetic per pixel as the plain version: bit-equal.
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert torch.equal(only, k[0])
    assert bool((p[1] >= 0).any())
    gcot = torch.randn(k[0].shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(0))
    g_k = shade.shade_bwd(k, gcot, static)
    g_p = shade.shade_bwd_plain(p, gcot, static)
    assert shade.shade_bwd_launches == m0 + 1
    scale = g_p.abs().max().item()
    assert scale > 0
    assert (g_k - g_p).abs().max().item() <= 3e-3 * scale
    assert torch.equal(g_k, shade.shade_bwd(k, gcot, static))


def adversarial_residuals(device, pattern, tp, ke, b=2, t=4, seed=0):
    """Residuals (sil, amin, rx, ry, tc) and a cotangent, (b, t, tp, tp),
    from a numpy seed, with the argmin slots of `pattern`: "none" (every
    pixel -1), "one" (every pixel on slot ke // 3), "mod" (pixel index mod
    Ke, so every warp sees 32 distinct slots or more) or "last" (slot Ke - 1
    on every other pixel, -1 elsewhere)."""
    rng = np.random.RandomState(seed)
    shape = (b, t, tp, tp)
    idx = np.arange(tp * tp).reshape(tp, tp)
    amin = {"none": np.full(shape, -1),
            "one": np.full(shape, ke // 3),
            "mod": np.broadcast_to(idx % ke, shape),
            "last": np.broadcast_to(np.where(idx % 2 == 0, ke - 1, -1),
                                    shape)}[pattern]
    arrays = (rng.uniform(0, 1, shape), amin.astype(np.int32),
              rng.randn(*shape) * 0.01, rng.randn(*shape) * 0.01,
              rng.uniform(0, 1, shape), rng.randn(*shape))
    out = [torch.from_numpy(np.ascontiguousarray(
        a, np.int32 if a.dtype == np.int32 else np.float32)).to(device)
        for a in arrays]
    return tuple(out[:5]), out[5]


@pytest.mark.parametrize("pattern", ["none", "one", "mod", "last"])
@pytest.mark.parametrize("tp", [16, 24, 128, 200])
@pytest.mark.parametrize("ke", [48, 96, 512, 3000])  # 3000: two windows
def test_shade_backward_on_adversarial_residuals(cuda, pattern, tp, ke):
    res, gcot = adversarial_residuals(cuda, pattern, tp, ke)
    static = shade.ShadeStatic(tp, 2 * tp, 2, 1e-4, 0.01, ke)
    m0 = shade.shade_bwd_launches
    g_k = shade.shade_bwd(res, gcot, static)
    g_p = shade.shade_bwd_plain(res, gcot, static)
    assert shade.shade_bwd_launches == m0 + 1
    scale = g_p.abs().max().item()
    assert (scale > 0) == (pattern != "none")
    assert (g_k - g_p).abs().max().item() <= 3e-3 * scale
    assert torch.equal(g_k, shade.shade_bwd(res, gcot, static))
    assert not bool(g_k[:, :, 4:].any())


def test_rasterize_soft_gradient_on_card_matches_cpu(cuda):
    verts, faces, K = raster_mesh("object")
    settings = tr.RasterSettings(64, tile_px=32, edges_per_tile=96)
    grads, sils = [], []
    for dev in (torch.device("cpu"), cuda):
        v = torch.from_numpy(verts).to(dev).requires_grad_(True)
        out = tr.rasterize_soft(v, tr.MeshTopology.from_faces(faces, dev),
                                torch.from_numpy(K).to(dev), settings)
        (out["sil"] ** 2).sum().backward()
        grads.append(v.grad.cpu().numpy())
        sils.append(out["sil"].detach().cpu().numpy())
    np.testing.assert_allclose(sils[1], sils[0], atol=2e-5)
    scale = np.abs(grads[0]).max()
    assert np.abs(grads[1] - grads[0]).max() <= 3e-3 * scale


def _prep_both(verts, topo, K, settings):
    """The prep kernel's path and the plain version on the same CUDA
    inputs: (seg_pack, anchors, e_demand) of each, and (idx, hit, slot_of)
    of each (the kernel's through `_prep_launch`, the plain version's
    through its own pieces)."""
    s = settings
    S, tp = s.image_size, s.tile_px
    ke = min(s.edges_per_tile, topo.edges.shape[0])
    margin = s.bin_margin_px / S
    n0 = tr.prep_launches
    with torch.no_grad():
        kern = tr.shade_prep(verts, topo, K, s)
        plain = tr._shade_prep_plain(verts, topo, K, s)
        uv, z = tr.project_ndc(verts, K)
        k_bins = tr._prep_launch(uv, verts, topo.faces, topo.edges,
                                 topo.edge_faces, topo.edge_dir_f1, None, S,
                                 tp, ke, s.znear, margin)[2:5]
        p0, p1, _, is_contour, _ = tr._contour_data(uv, z, topo, s)
        overlap = tr._tile_overlap(torch.minimum(p0, p1),
                                   torch.maximum(p0, p1), is_contour, s,
                                   margin)
        p_bins = tr._bin_first(overlap, ke)
    assert tr.prep_launches == n0 + 2
    assert kern[3] == plain[3]
    return kern[:3], plain[:3], k_bins, p_bins


def _assert_prep_equal(verts, topo, K, settings):
    kern, plain, k_bins, p_bins = _prep_both(verts, topo, K, settings)
    for name, a, b in zip(("seg_pack", "anchors", "e_demand", "idx", "hit",
                           "slot_of"), kern + k_bins, plain + p_bins):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    return plain[2]


# (mesh, image size, tile, edges per tile): S 128, 256 and 640, tile 64 and
# one tile; Ke below the demand (the first Ke of each tile binned, the rest
# counted) and above it. Frame 0 has a vertex behind znear, frame 1 no
# contour edge; the flat grid's rows project to horizontal edges. S 120 at
# tile 40: a size that is no power of two (the column boundaries and tile
# bounds round), and a tile width that is no multiple of 4 (anchor_px
# stored a float at a time).
PREP_CASES = [("object", 128, 64, 96), ("object", 256, 64, 8),
              ("object", 640, 64, 96), ("object", 256, 256, 16),
              ("hand", 128, 128, 512), ("hand", 256, 64, 16),
              ("hand", 640, 64, 192), ("flat", 128, 64, 96),
              ("flat", 640, 640, 8), ("object", 120, 40, 96)]


@pytest.mark.parametrize("case", PREP_CASES)
def test_prep_kernel_matches_plain(cuda, case):
    from prep_cases import scene
    kind, S, tp, ke = case
    verts, faces, K = scene(kind)
    topo = tr.MeshTopology.from_faces(faces, device=cuda)
    demand = _assert_prep_equal(verts.to(cuda), topo, K.to(cuda),
                                tr.RasterSettings(S, tile_px=tp,
                                                  edges_per_tile=ke))
    assert int(demand[0]) > 0 and int(demand[1]) == 0
    assert (ke < int(demand.max())) == (ke in (8, 16))


def test_prep_kernel_walks_edges_in_chunks(cuda):
    """A mesh of more edges than one block's shared list holds: the kernel
    walks them in chunks, each chunk's list in turn."""
    from prep_cases import scene
    verts, faces, K = scene("dense")
    topo = tr.MeshTopology.from_faces(faces, device=cuda)
    S, tp = 256, 64
    E, F = topo.edges.shape[0], topo.faces.shape[0]
    assert E > tr._prep_lib().shade_prep_list_cap(E, (S // tp) ** 2, F)
    for ke in (64, 1024):
        _assert_prep_equal(verts.to(cuda), topo, K.to(cuda),
                           tr.RasterSettings(S, tile_px=tp,
                                             edges_per_tile=ke))


def test_prep_kernel_under_vmap_with_per_clip_topology(cuda):
    """As step1_mixed runs it: clips of padded meshes, each its own
    topology, folded into one launch; bit-equal to the plain version under
    vmap and clip by clip, and the counter's contour edges equal."""
    from homan_tpu_torch import utils_profiling as up
    from prep_cases import clip_topologies
    verts, topo, K = clip_topologies()
    verts, K = verts.to(cuda), K.to(cuda)
    topo = tuple(t.to(cuda) for t in topo)
    st = tr.RasterSettings(256, tile_px=64, edges_per_tile=96)

    def run(prep):
        return torch.func.vmap(
            lambda v, *t: prep(v, tr.MeshTopology(*t), K, st)[:3])(verts,
                                                                  *topo)

    n0 = tr.prep_launches
    with up.tracing():
        kern = run(tr.shade_prep)
        counted = up.counters()["raster.contour_edges"]
        plain = run(tr._shade_prep_plain)
        total = up.counters()["raster.contour_edges"]
    assert tr.prep_launches == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    for c in range(verts.shape[0]):
        one = tr._shade_prep_plain(
            verts[c], tr.MeshTopology(*(t[c] for t in topo)), K, st)
        assert all(torch.equal(kern[j][c], one[j]) for j in range(3))
    assert counted[0] == total[0] > 0
    assert counted[0] <= counted[1] < total[1]


def test_rasterize_soft_gradient_equal_on_both_prep_paths(cuda,
                                                          monkeypatch):
    """The gradient of a loss through rasterize_soft, the prep kernel's
    path against the plain prep's on the card: bit-equal."""
    from prep_cases import scene
    verts, faces, K = scene("hand", edge_cases=False)
    topo = tr.MeshTopology.from_faces(faces, device=cuda)
    settings = tr.RasterSettings(128, tile_px=64, edges_per_tile=128)
    grads, sils = [], []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(tr, "shade_prep", tr._shade_prep_plain)
        v = verts.to(cuda).requires_grad_(True)
        out = tr.rasterize_soft(v, topo, K.to(cuda), settings)
        ((out["sil"] - 0.3) ** 2).sum().backward()
        grads.append(v.grad)
        sils.append(out["sil"].detach())
    assert torch.equal(sils[0], sils[1])
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().max().item() > 0


# (mesh, image size, tile, faces per tile), or ("adversarial", image size,
# tile, seed[, faces inside nowhere put first]): the hand at tile 16 holds
# ~1,000 faces per tile, so the kernel's staging passes (128 slots a pass)
# and its warps' compacted lists run over several batches; tile 128
# spreads a tile over 64 blocks, tile 48 over 9; the last case's winners
# sit past slot 2,048, in the backward's second accumulator window.
DEPTH_CASES = [("object", 64, 16, 32), ("object", 128, 64, 1024),
               ("hand", 128, 32, 256), ("hand", 128, 64, 2048),
               ("hand", 32, 16, 2048), ("object", 128, 128, 1024),
               ("adversarial", 32, 16, 0), ("adversarial", 64, 32, 1),
               ("object", 96, 48, 512), ("adversarial", 32, 16, 2, 2000),
               # tiles that are not a multiple of 16: the edge regions and
               # sub-tiles are clamped to the tile
               ("object", 32, 8, 256), ("object", 48, 24, 512),
               ("hand", 96, 24, 640), ("object", 80, 40, 512),
               ("adversarial", 48, 24, 4), ("adversarial", 80, 40, 5)]


def _depth_pack(device, mesh, S, tp, kf, lead=0):
    if mesh == "adversarial":
        from torch_port_common import adversarial_depth_pack
        pack, static = adversarial_depth_pack(tp=tp, seed=kf, lead=lead)
        return pack.to(device), static
    verts, faces, K = raster_mesh(mesh)
    verts[..., 2] -= 0.2 if mesh == "hand" else 0.4
    topo = tr.MeshTopology.from_faces(faces, device=device)
    with torch.no_grad():
        pack, _, static = tr.depth_prep(
            torch.from_numpy(verts).to(device), topo,
            torch.from_numpy(K).to(device),
            tr.RasterSettings(S, tile_px=tp, faces_per_tile=kf))
    return pack, static


@pytest.mark.parametrize("case", DEPTH_CASES)
def test_depth_kernels_match_plain(cuda, case):
    pack, static = _depth_pack(cuda, *case)
    n0, m0 = tdepth.depth_fwd_launches, tdepth.depth_bwd_launches
    k_d, k_a = tdepth.depth_fwd(pack, static)
    p_d, p_a = tdepth.depth_fwd_plain(pack, static)
    assert tdepth.depth_fwd_launches == n0 + 1
    assert bool((p_d > 0).any())
    # The kernel scans each sub-tile's culled slots in the plain version's
    # expressions and order: bit-equal.
    assert torch.equal(k_d, p_d) and torch.equal(k_a, p_a)
    gcot = torch.randn(k_d.shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(0))
    g_k = tdepth.depth_bwd(k_d, k_a, gcot, static)
    g_p = tdepth.depth_bwd_plain(p_d, p_a, gcot, static)
    assert tdepth.depth_bwd_launches == m0 + 1
    scale = g_p.abs().max().item()
    assert scale > 0
    if static.kf > 2048:  # slots in the finalize's second window win
        assert bool(g_p[:, :, 9:12, 2048:].any())
    assert (g_k - g_p).abs().max().item() <= 3e-3 * scale
    assert torch.equal(g_k, tdepth.depth_bwd(k_d, k_a, gcot, static))
    assert not bool(torch.cat([g_k[:, :, :9], g_k[:, :, 12:]], 2).any())
    tp = static.tile_px
    if tp % tdepth.FWD_REGION:  # the replay of the clamped cull keeps
        keep, _ = tdepth.cull_keep(pack, static)  # every inside pixel
        kept = keep.repeat_interleave(tdepth.FWD_SUB, 2).repeat_interleave(
            tdepth.FWD_SUB, 3)[:, :, :tp, :tp]
        px, py, _ = tdepth._pixel_coords(static, pack.shape[1], cuda)
        for k in range(int(pack[:, :, 12].sum(-1).max())):
            inside, invz = tdepth._slot_inside(pack[..., None, None], k,
                                               px, py)
            assert not bool((inside & (invz > 0) & ~kept[..., k]).any())


def test_depth_kernel_refuses_other_tiles(cuda):
    for tp in (0, -16):
        static = tdepth.DepthStatic(tp, 32, 2, 4)
        with pytest.raises(ValueError, match="positive number of pixels"):
            tdepth.depth_fwd(torch.zeros((1, 4, 16, 4), device=cuda),
                             static)


def nested_shells(n=6):
    """n nested closed spheres in the unit box: the central columns cross
    the mesh 2n times."""
    from homan_tpu_torch.core.meshes import icosphere
    vs, fs, off = [], [], 0
    for i in range(n):
        v, f = icosphere(2, 0.95 - 0.13 * i)
        vs.append(np.asarray(v, np.float32))
        fs.append(np.asarray(f, np.int64) + off)
        off += len(v)
    return np.concatenate(vs)[None], np.concatenate(fs)


@pytest.mark.parametrize("mesh,grid", [("object", 16), ("object", 32),
                                       ("hand", 32), ("hand", 16),
                                       ("object", 64), ("hand", 64),
                                       ("shells", 32), ("shells", 64)])
def test_voxelizer_kernel_matches_plain(cuda, mesh, grid):
    if mesh == "shells":
        verts, faces = nested_shells()
        local = torch.from_numpy(verts).to(cuda)
    else:
        verts, faces, _ = raster_mesh(mesh)
        v = torch.from_numpy(verts).to(cuda)
        center, scale = tsdf.normalize_to_unit_box(v)
        local = (v - center) / scale
    f = torch.from_numpy(np.asarray(faces, np.int64)).to(cuda)
    n0 = tvox.voxelize_launches
    k = tvox.voxelize(local, f, grid)
    assert tvox.voxelize_launches == n0 + 1
    p = tsdf.voxelize_interior_sdf(local, f, grid)
    assert bool((p > 0).any())
    assert torch.equal(k > 0, p > 0)
    assert (k - p).abs().max().item() <= 1e-5
    assert torch.equal(k, tvox.voxelize(local, f, grid))  # deterministic
    if mesh == "shells":  # the central column crosses each shell twice
        tri = local[0][f]
        c = grid // 2
        axis = tsdf.grid_points(grid, cuda)[(c * grid + c) * grid][:2]
        assert int(((tri[:, :, :2].amin(1) <= axis)
                    & (tri[:, :, :2].amax(1) >= axis)).all(1).sum()) >= 12


def test_voxelizer_kernel_refuses_other_grids(cuda):
    verts, faces = nested_shells(1)
    pack = tvox.pack_triangles(torch.from_numpy(verts).to(cuda),
                               torch.from_numpy(faces).to(cuda))
    with pytest.raises(ValueError, match="grid sizes"):
        tvox.voxelize_pack(pack, 8)


def _stage_b_clip(frames, image_size, rend, device):
    """bench.py bench_stageb's clip, built by the port: the 1280-face bumpy
    potato turning 0.04 rad a frame about z; masks by render_full_mask,
    evidence by build_object_mask_info at `rend`."""
    from homan_tpu_torch.frontend.evidence import build_object_mask_info
    from homan_tpu_torch.frontend.gtevidence import (mask_to_bbox,
                                                     render_full_mask)
    v, f = bumpy_potato(3, 0.08, seed=0)
    K = np.array([[image_size * 0.9, 0, image_size / 2],
                  [0, image_size * 0.9, image_size / 2], [0, 0, 1.0]],
                 np.float32)
    verts = []
    for t in range(frames):
        a = 0.04 * t
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]], np.float32)
        verts.append(v @ Rz.T + np.array([0.02 + 0.002 * t, -0.01, 0.55],
                                         np.float32))
    masks = render_full_mask(np.stack(verts), f, np.tile(K[None],
                                                         (frames, 1, 1)),
                             image_size, device=device)
    ann = []
    for m in masks:
        info = build_object_mask_info(m, mask_to_bbox(m), None, rend)
        info["full_mask"] = m.astype(np.float32)
        ann.append(info)
    return v, f, ann, [K] * frames


def _stage_b_pack(device, B, S, tp, ke):
    """The shade pack of B initial stage-B candidates of frame 0 (random
    rotations, auto-depth translations) at S^2, tile tp, Ke slots."""
    from homan_tpu_torch.core import geometry as tgeo
    from homan_tpu_torch.fit import poseinit as tpose
    v, f, ann, Ks = _stage_b_clip(1, 512, 256, device)
    _, _, _, K_roi = tpose._frame_evidence(ann[0], Ks[0], 256, device)
    R = tgeo.random_rotations(B, torch.Generator().manual_seed(0),
                              device=device)
    verts = torch.from_numpy(v).to(device)
    r6, trans = tpose._chain_init(verts, R, ann[0]["bbox"],
                                  torch.from_numpy(Ks[0]).to(device))
    with torch.no_grad():
        posed = torch.einsum("vj,cjk->cvk", verts, R) + trans
        seg, anc, _, static = tr.shade_prep(
            posed, tr.MeshTopology.from_faces(f, device=device),
            K_roi.expand(B, 3, 3), tr.RasterSettings(S, tile_px=tp,
                                                     edges_per_tile=ke))
    return seg, anc, static


# Stage B's shade packs (bench.py bench_stageb): the coarse and refinement
# renders at 128^2, one 128-pixel tile, 125 candidates a chunk (and all 500
# in one launch); the rescore's forward-only renders at 256^2, four tiles.
@pytest.mark.parametrize("B,S,ke", [(125, 128, 64), (125, 128, 128),
                                    (500, 128, 128), (125, 256, 128)])
def test_shade_kernels_at_stage_b_packs_match_plain(cuda, B, S, ke):
    seg, anc, static = _stage_b_pack(cuda, B, S, 128, ke)
    k = shade.shade_fwd(seg, anc, static, want_residuals=True)
    only = shade.shade_fwd(seg, anc, static, want_residuals=False)[0]
    p = shade.shade_fwd_plain(seg, anc, static, True)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert torch.equal(only, k[0])
    assert bool((k[0] > 0.5).any())
    if S == 256:  # the rescore renders without a gradient
        return
    gcot = torch.randn(k[0].shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(0))
    g_k = shade.shade_bwd(k, gcot, static)
    g_p = shade.shade_bwd_plain(p, gcot, static)
    scale = g_p.abs().max().item()
    assert scale > 0
    assert (g_k - g_p).abs().max().item() <= 3e-3 * scale
    assert torch.equal(g_k, shade.shade_bwd(k, gcot, static))


def test_stage_b_search_on_card_matches_cpu(cuda):
    """A small search on the card and on the CPU (the plain versions) from
    the same inputs; the rotations are drawn on the CPU either way. Each
    frame's selected pose within 2e-3, best IoU within 1e-3; the card's
    renders go through the kernels."""
    from homan_tpu_torch.fit import poseinit as tpose
    v, f, ann, Ks = _stage_b_clip(3, 128, 64, cuda)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        n0, m0 = shade.shade_fwd_launches, shade.shade_bwd_launches
        out[dev.type] = tpose.find_optimal_poses(
            v, f, ann, Ks, (128, 128), num_initializations=24,
            num_iterations=5, rend_size=64,
            settings=tr.RasterSettings(64, tile_px=32, edges_per_tile=128),
            device=dev)
        launched = (shade.shade_fwd_launches - n0,
                    shade.shade_bwd_launches - m0)
        # 3 frames x 5 steps with a gradient, and 3 final evaluations
        assert launched == ((18, 15) if dev.type == "cuda" else (0, 0))
    for c, g in zip(out["cpu"], out["cuda"]):
        for k in ("rotations", "translations"):
            assert g[k].device.type == "cuda"
            assert (g[k].cpu() - c[k]).abs().max().item() <= 2e-3
    assert abs(out["cuda"][0]["best_iou"] - out["cpu"][0]["best_iou"]) <= 1e-3


@pytest.mark.parametrize("tp", [16, 64, 128])
def test_shade_pair_takes_every_ke_up_to_the_slot_ceiling(cuda, tp):
    """The derivation of the card's edge-slot ceiling: the forward's row
    records of FWD_MAX_KE slots fit its shared memory at one row a block,
    at every tile, and one slot more is refused; the backward takes any
    Ke. The object's pack, its slots padded with empty ones."""
    seg, anc, static = _pack(cuda, "object", 128, tp, 96)
    for ke in (shade.FWD_MAX_KE, shade.FWD_MAX_KE + 1):
        pad = torch.zeros(seg.shape[:3] + (ke - static.ke,), device=cuda)
        pad[:, :, :4] = 99.0  # empty slots sit far away, invalid
        big = torch.cat([seg, pad], -1).contiguous()
        st = static._replace(ke=ke)
        if ke > shade.FWD_MAX_KE:
            with pytest.raises(RuntimeError, match="launch failed"):
                shade.shade_fwd(big, anc, st)
            continue
        k = shade.shade_fwd(big, anc, st, want_residuals=True)
        p = shade.shade_fwd_plain(big, anc, st, True)
        torch.testing.assert_close(k[0], p[0], atol=2e-5, rtol=0)
        assert (k[1] == p[1]).float().mean().item() >= 0.999
        gcot = torch.randn(k[0].shape, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
        g_k = shade.shade_bwd(k, gcot, st)
        g_p = shade.shade_bwd_plain(p, gcot, st)
        assert (g_k - g_p).abs().max().item() <= 3e-3 * g_p.abs().max().item()
        assert not g_k[..., static.ke:].any()


def test_tritri_on_card_matches_cpu(cuda):
    """The tritri collision (plain PyTorch, float64 steps in its plane
    distances) on the card against the CPU: the same intersecting pairs,
    the loss within rtol 1e-5 and its gradient within 1e-4 of its max."""
    from homan_tpu_torch.interactions import intersect
    hand, hf, _ = raster_mesh("hand", b=2)
    v, f = bumpy_potato(2, 0.05, seed=0)
    obj = v[None] + hand.mean(1, keepdims=True)
    out = {}
    for dev in ("cpu", cuda):
        h = torch.from_numpy(hand).to(dev).requires_grad_(True)
        loss = intersect.compute_collision_loss_tritri(
            h, hf, torch.from_numpy(obj).to(dev), f, 1)
        loss.backward()
        tri_h = h.detach()[0][torch.as_tensor(hf, device=dev).long()]
        tri_o = torch.from_numpy(obj[0]).to(dev)[
            torch.as_tensor(f, device=dev).long()]
        out[str(dev)] = (loss.item(), h.grad.cpu().numpy(),
                         intersect.tri_tri_intersect(tri_h, tri_o).cpu())
    (lc, gc, mc), (lg, gg, mg) = out["cpu"], out["cuda"]
    assert lc > 0 and mc.any()
    assert torch.equal(mc, mg)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    assert np.abs(gg - gc).max() <= 1e-4 * np.abs(gc).max()


def test_render_scene_on_card_matches_cpu(cuda):
    """The overlays' renderer on the card against the CPU: uint8 frames
    that differ by more than 1 on at most 0.1% of the pixels."""
    from homan_tpu_torch.viz import render_viz
    hand, hf, K = raster_mesh("hand", b=2)
    v, f = bumpy_potato(2, 0.05, seed=0)
    obj = v[None] + hand.mean(1, keepdims=True) + np.float32([0, 0, 0.05])
    frames = {d: render_viz.render_scene([obj, hand],
                                         [f, hf], ["gold", "grey"], K, 128,
                                         device=d) for d in ("cpu", "cuda")}
    for a, b in zip(frames["cpu"], frames["cuda"]):
        d = np.abs(a.astype(int) - b.astype(int))
        assert (d > 1).any(-1).sum() <= 0.001 * 128 * 128


@pytest.mark.parametrize("grid", [128, 256])
def test_voxelizer_kernel_matches_plain_at_large_grids(cuda, grid):
    """G 128 and 256 (a block then holds a segment of one column) against
    the plain version on an 80-face mesh: the same inside set, phi within
    1e-5, deterministic."""
    v, f = bumpy_potato(1, 0.6, seed=0)
    local = torch.from_numpy(v)[None].to(cuda)
    faces = torch.from_numpy(np.asarray(f, np.int64)).to(cuda)
    n0 = tvox.voxelize_launches
    k = tvox.voxelize(local, faces, grid)
    assert tvox.voxelize_launches == n0 + 1
    p = tsdf.voxelize_interior_sdf(local, faces, grid)
    assert bool((p > 0).any())
    assert torch.equal(k > 0, p > 0)
    assert (k - p).abs().max().item() <= 1e-5
    assert torch.equal(k, tvox.voxelize(local, faces, grid))


@pytest.mark.parametrize("grid", [512, 1024])
def test_voxelizer_kernel_matches_the_box_distance(cuda, grid):
    """G 512 and 1,024 on the 12-face box against its analytic interior
    distance (the plain version would take 10^10 pairs)."""
    from torch_port_common import BOX_SHIFT, shifted_box
    v, f = shifted_box()
    phi = tvox.voxelize(torch.from_numpy(v)[None].to(cuda),
                        torch.from_numpy(np.asarray(f, np.int64)).to(cuda),
                        grid)[0]
    axis = -1.0 + (2.0 * torch.arange(grid, device=cuda,
                                      dtype=torch.float64) + 1.0) / grid
    d = [0.5 - (axis - c).abs() for c in BOX_SHIFT]
    ref = torch.minimum(torch.minimum(d[0][:, None, None],
                                      d[1][None, :, None]),
                        d[2][None, None, :]).clamp(min=0)
    assert torch.equal(phi > 0, ref > 0)
    assert (phi.double() - ref).abs().max().item() <= 1e-5


def test_pad_mesh_kernels_invariant(cuda):
    """pad_mesh leaves the shade kernels' silhouette and the voxelizer's
    phi as they were (tests/test_sharding.py:158,164: 1e-5 and 1e-6)."""
    from homan_tpu_torch.core.meshes import pad_mesh
    v, f = bumpy_potato(2, 0.3, seed=2)
    vp, fp = pad_mesh(v, f, v.shape[0] + 37, f.shape[0] + 53)
    K = torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]],
                     device=cuda)
    settings = tr.RasterSettings(image_size=64, tile_px=16,
                                 edges_per_tile=384)
    shift = torch.tensor([0, 0, 1.0], device=cuda)
    n0 = shade.shade_fwd_launches
    sil, sil_p = (tr.rasterize_soft(
        torch.from_numpy(a).to(cuda)[None] + shift,
        tr.MeshTopology.from_faces(b, device=cuda), K,
        settings)["sil"] for a, b in ((v, f), (vp, fp)))
    assert shade.shade_fwd_launches + shade.shade_fwd_only_launches > n0
    assert (sil_p - sil).abs().max().item() <= 1e-5
    phi, phi_p = (tvox.voxelize(torch.from_numpy(a).to(cuda)[None],
                                torch.from_numpy(b).to(cuda), 32)
                  for a, b in ((v, f), (vp, fp)))
    assert bool((phi > 0).any())
    assert (phi_p - phi).abs().max().item() <= 1e-6


def _clip_scenes(device, n=3, frames=2):
    from homan_tpu_torch.core.mano import ManoLayer
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
    layer = ManoLayer.synthetic(0, device=device)
    obj = bumpy_potato(2, 0.08, seed=0)
    return [make_synthetic_scene(np.eye(3, dtype=np.float32), seed=i,
                                 frame_nb=frames, image_size=64,
                                 rend_size=32, mano_layer=layer,
                                 obj_mesh=obj, device=device)
            for i in range(n)]


def test_fit_clips_batched_launches_once_per_step(cuda):
    """Three clips fit in one set of launches a step: the shade pair
    launches once a step, not once a clip; each clip within 3e-3 of its
    own card fit."""
    from homan_tpu_torch.fit import joint
    from homan_tpu_torch.parallel import clips as par
    scenes = _clip_scenes(cuda)
    states = par.stack_clips([s.init_state for s in scenes])
    consts = par.stack_clips([s.consts for s in scenes])
    n_fwd, n_bwd = shade.shade_fwd_launches, shade.shade_bwd_launches
    final, hist = par.fit_clips_batched(
        states, consts, scenes[0].cfg, num_iterations=4,
        roi_settings=scenes[0].roi_settings, device=cuda)
    assert (shade.shade_fwd_launches - n_fwd,
            shade.shade_bwd_launches - n_bwd) == (4, 4)
    assert hist["loss"].shape == (3, 4)
    for i, s in enumerate(scenes):
        single, h1 = joint.optimize_hand_object(
            s.init_state, s.consts, s.cfg, num_iterations=4,
            roi_settings=s.roi_settings, device=cuda)
        for k in ("translations_object", "mano_pca_pose"):
            a, b = getattr(final, k)[i], getattr(single, k)
            assert (a - b).abs().max().item() <= 3e-3 * max(
                b.abs().max().item(), 1e-6), k


def test_fit_frames_sharded_on_card_matches_unsharded(cuda):
    """Two entries of the one card: the split and the gather run, and the
    fit agrees with the unsharded one within 3e-3."""
    from homan_tpu_torch.fit import joint
    from homan_tpu_torch.parallel import frames as fpar
    s = _clip_scenes(cuda, n=1, frames=4)[0]
    mesh = fpar.make_frame_mesh(devices=[cuda, cuda])
    sharded, hs = fpar.fit_frames_sharded(s.init_state, s.consts, s.cfg,
                                          mesh, num_iterations=4,
                                          roi_settings=s.roi_settings)
    single, h1 = joint.optimize_hand_object(
        s.init_state, s.consts, s.cfg, num_iterations=4,
        roi_settings=s.roi_settings, device=cuda)
    assert torch.allclose(hs["loss"], h1["loss"], rtol=3e-3)
    for k in ("translations_object", "translations_hand", "mano_pca_pose"):
        a, b = getattr(sharded, k), getattr(single, k)
        assert (a - b).abs().max().item() <= 3e-3 * max(
            b.abs().max().item(), 1e-6), k
