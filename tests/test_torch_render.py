"""PyTorch port vs JAX package: topology, shade prep and the shade kernel
pair's plain versions on identical packs (CPU).

The JAX side runs its Pallas shade kernel in interpret mode, as
tests/test_pallas_shade.py does. Bands: forward 2e-5, gradient 3e-3 of the
maximum (the JAX package's own, tests/test_pallas_shade.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.render import pallas_shade as jshade
from homan_tpu.render import rasterizer as jr
from homan_tpu_torch.render import rasterizer as tr
from homan_tpu_torch.render import shade as tshade

from torch_port_common import (CASES, assert_grad_close, raster_case,
                               raster_mesh, t2n, to_numpy)


@pytest.mark.parametrize("mesh", ["object", "hand"])
def test_topology_arrays_equal(mesh):
    faces = raster_mesh(mesh)[1]
    j = to_numpy(jr.MeshTopology.from_faces(faces))
    t = tr.MeshTopology.from_faces(faces, device="cpu")
    for k in ("faces", "edges", "edge_faces", "edge_dir_f1"):
        np.testing.assert_array_equal(t2n(getattr(t, k)), j[k], err_msg=k)
    assert tr.MeshTopology.from_faces(faces, device="cpu") is t  # cached


# Tiles that are not a multiple of the shade kernel's 8-pixel groups, or
# of the depth kernel's 16-pixel regions: the JAX kernel takes any tile
# (homan_tpu/render/pallas_shade.py pix_shape), and so does the port's.
TILE_CASES = [("object", 32, 8, 48), ("object", 48, 24, 64),
              ("hand", 48, 24, 64)]

_jax_prep = jax.jit(lambda v, topo, K, s: jr._pallas_prep(v, topo, K, s)[:3],
                    static_argnums=(3,))
_jax_shade_fwd = jax.jit(jshade._shade_fwd, static_argnums=(2, 3))


@functools.lru_cache(maxsize=None)
def _pallas_fwd(case):
    """JAX prep + interpret-mode Pallas forward of one case, computed once
    per worker process."""
    verts, K, jtopo, _, jset, _ = raster_case(*case)
    jseg, janc, jdem = _jax_prep(jnp.asarray(verts), jtopo, jnp.asarray(K),
                                 jset)
    S, tp = jset.image_size, jset.tile_px
    margin = jset.bin_margin_px / S
    static = (tp, S, S // tp, jset.sigma, margin * margin,
              min(jset.edges_per_tile, int(jtopo.edges.shape[0])))
    outs = _jax_shade_fwd(jseg, janc, static, True)
    # Residuals come in the kernel's lane-dense layout; the port keeps
    # (B, T, tp, tp).
    shape = janc.shape
    return (np.array(jseg), np.array(janc), np.array(jdem), static,
            [np.array(o).reshape(shape) for o in outs], outs)


@pytest.mark.parametrize("case", CASES + TILE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_shade_prep_matches_pallas_prep(case):
    verts, K, jtopo, ttopo, jset, tset = raster_case(*case)
    jseg, janc, jdem, jstatic, _, _ = _pallas_fwd(case)
    tseg, tanc, tdem, tstatic = tr.shade_prep(
        torch.from_numpy(verts), ttopo, torch.from_numpy(K), tset)
    assert tuple(tstatic) == tuple(jstatic)
    tseg = t2n(tseg)
    # Slot order exactly: same valid slots, same orientation and flip rows.
    np.testing.assert_array_equal(tseg[:, :, 4:], jseg[:, :, 4:])
    assert jseg[:, :, 5].sum() > 0
    np.testing.assert_allclose(tseg[:, :, :4], jseg[:, :, :4], atol=1e-6)
    np.testing.assert_array_equal(t2n(tanc), janc)
    np.testing.assert_array_equal(t2n(tdem), jdem)


@pytest.mark.parametrize("case", CASES + TILE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_plain_shade_forward_matches_pallas(case):
    seg, anc, _, static, (jsil, jam, jrx, jry, jtc), _ = _pallas_fwd(case)
    sil, am, rx, ry, tc = (t2n(x) for x in tshade.shade_fwd(
        torch.from_numpy(seg), torch.from_numpy(anc),
        tshade.ShadeStatic(*static)))
    np.testing.assert_allclose(sil, jsil, atol=2e-5)
    same = am == jam
    assert same.mean() >= 0.999, same.mean()
    # Where the argmin differs it is a float tie: the two distances agree.
    d2_t = rx ** 2 + ry ** 2
    d2_j = jrx ** 2 + jry ** 2
    assert np.all(np.abs(d2_t - d2_j)[~same] <= 1e-7)
    for a, b in ((rx, jrx), (ry, jry), (tc, jtc)):
        np.testing.assert_allclose(a[same], b[same], atol=1e-6)
    only = tshade.shade_fwd(torch.from_numpy(seg), torch.from_numpy(anc),
                            tshade.ShadeStatic(*static),
                            want_residuals=False)
    assert len(only) == 1
    np.testing.assert_array_equal(t2n(only[0]), sil)


@pytest.mark.parametrize("case", CASES[:2],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_plain_shade_backward_matches_vjp(case):
    seg, anc, _, static, res, jres = _pallas_fwd(case)
    gcot = np.random.RandomState(5).randn(*res[0].shape).astype(np.float32)
    jg, _ = jshade._shade_bwd_vjp(static, jres, jnp.asarray(gcot))
    tg = tshade.shade_bwd(tuple(torch.from_numpy(r) for r in res),
                          torch.from_numpy(gcot), tshade.ShadeStatic(*static))
    assert_grad_close(t2n(tg), np.asarray(jg), name="gseg")
    assert np.all(t2n(tg)[:, :, 4:] == 0)


def test_check_edge_budget_matches():
    verts, K, jtopo, ttopo, jset, tset = raster_case("hand", 64, 16, 64)
    j = jr.check_edge_budget(jnp.asarray(verts), jtopo, jnp.asarray(K), jset)
    t = tr.check_edge_budget(torch.from_numpy(verts), ttopo,
                             torch.from_numpy(K), tset)
    assert j == t


def test_kernel_wrappers_refuse_other_devices():
    static = tshade.ShadeStatic(16, 32, 2, 1e-5, 0.0625, 8)
    seg = torch.zeros((1, 4, 8, 8), device="meta")
    anc = torch.zeros((1, 4, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tshade.shade_fwd(seg, anc, static)
    res = (anc,) * 5
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tshade.shade_bwd(res, anc, static)


# ---------------------------------------------------------------------------
# The shade forward kernel's order of work, restated on the CPU
# ---------------------------------------------------------------------------
def _winding_by_rows(seg_pack, anchors, static):
    """Pass 1 in the kernel's order of work: per (row, valid slot) the
    crossing x of the row's ray, folded with `spans` and `xi <= x1` into xi
    or -inf, computed once per row; then per pixel one compare and the add
    of the slot's sign, over the tile's first n_e slots."""
    T = seg_pack.shape[1]
    px, py, x1 = tshade._pixel_coords(static, T, seg_pack.device)
    assert py.shape[-1] == 1  # py holds one value per row
    n_e = (seg_pack[:, :, 5] > 0.5).sum(-1)[..., None, None]  # (B, T, 1, 1)
    seg = seg_pack[..., None, None]
    winding = anchors.clone()
    for k in range(static.ke):
        ax, ay, bx, by, sgn = (seg[:, :, r, k] for r in range(5))
        dy = by - ay
        dy_safe = torch.where(dy.abs() > 1e-12, dy, torch.ones(()))
        spans = (ay <= py) != (by <= py)
        xi = ax + (py - ay) / dy_safe * (bx - ax)  # (B, T, tp, 1): per row
        xi = torch.where(spans & (xi <= x1), xi, torch.tensor(-np.inf))
        live = k < n_e
        winding = winding + torch.where(live & (xi > px), sgn,
                                        torch.zeros(()))
    return winding


@pytest.mark.parametrize("case", [("object", 64, 16, 64),
                                  ("hand", 64, 16, 64),
                                  ("object", 64, 32, 96),
                                  ("object", 256, 128, 96)],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_row_crossings_match_plain_winding(case):
    mesh, S, tp, ke = case
    verts, faces, K = raster_mesh(mesh)
    seg, anc, _, static = tr.shade_prep(
        torch.from_numpy(verts), tr.MeshTopology.from_faces(faces, "cpu"),
        torch.from_numpy(K), tr.RasterSettings(S, tile_px=tp,
                                               edges_per_tile=ke))
    ref = tshade.winding_plain(seg, anc, static)
    ours = _winding_by_rows(seg, anc, static)
    assert torch.equal(ours, ref)
    assert bool((ref.abs() > 0.5).any()) and bool((ref.abs() < 0.5).any())


def _skip_count_by_loops(seg, anc, static):
    """The kernel's pass-2 skip decisions, one (row, pixel group, slot) at
    a time with numpy float32 scalars, over the plain version's running
    d2min: the number of (pixel group, slot) pairs it evaluates."""
    f = np.float32
    tp, npx = static.tile_px, tshade.FWD_PIXELS_PER_THREAD
    px, py, _ = tshade._pixel_coords(static, 1, "cpu")
    px, py = t2n(px)[0, 0, 0], t2n(py)[0, 0, :, 0]
    sg = seg[..., None, None]
    wind = tshade.winding_plain(seg, anc, static)
    cap2 = torch.tensor(static.cap2)
    d2s = [t2n(tshade._slot_d2(sg, k, *tshade._pixel_coords(static, 1, "cpu")
                               [:2], wind, wind.abs() > 0.5, cap2)[0])[0, 0]
           for k in range(static.ke)]
    s = t2n(seg)[0, 0]
    n_e = int((s[5] > 0.5).sum())
    d2min = np.full((tp, tp), f(static.cap2), np.float32)
    count = 0
    for k in range(n_e):
        ax, ay, bx, by = (f(v) for v in s[:4, k])
        slack = (max(abs(ax), abs(bx), abs(ay), abs(by)) + f(2)) * f(2 ** -18)
        for r in range(tp):
            ygap = max(min(ay, by) - py[r], py[r] - max(ay, by), f(0))
            for g0 in range(0, tp, npx):
                gap = max(min(ax, bx) - px[g0 + npx - 1],
                          px[g0] - max(ax, bx), f(0))
                lo = np.sqrt(gap * gap + ygap * ygap, dtype=np.float32) - slack
                dmax = d2min[r, g0:g0 + npx].max()
                if not (lo > 0 and lo * lo > dmax * f(1 + 2 ** -18)):
                    count += 1
        d2min = np.where(d2s[k] < d2min, d2s[k], d2min)
    return count


def test_shade_forward_op_count_two_triangles():
    """Two separate triangles in one 16-pixel tile: six contour edges, so
    six valid slots, each worked on 16 rows, 256 pixels and 32 groups of 8
    pixels; the groups that evaluate a slot, counted by loops."""
    verts = np.array([[[-0.3, -0.3, 1.0], [-0.05, -0.3, 1.0],
                       [-0.3, -0.05, 1.0], [0.1, 0.1, 1.2], [0.3, 0.1, 1.2],
                       [0.1, 0.3, 1.2]]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    K = np.array([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]], np.float32)
    seg, anc, _, static = tr.shade_prep(
        torch.from_numpy(verts), tr.MeshTopology.from_faces(faces, "cpu"),
        torch.from_numpy(K), tr.RasterSettings(16, tile_px=16,
                                               edges_per_tile=8,
                                               bin_margin_px=2.0))
    work = tshade.fwd_work(seg, anc, static)
    evaluated = _skip_count_by_loops(seg, anc, static)
    assert work == {"row_slots": 6 * 16, "pixel_slots": 6 * 256,
                    "group_slots": 6 * 32,
                    "evaluated_group_slots": evaluated}
    assert 0 < evaluated < 6 * 32  # some groups skip some slots
    by_hand = (43 * 96 + 3 * 1536 + 13 * 192
               + (8 * 37 + 7) * evaluated)  # records, pass 1, tests, pass 2
    assert tshade.fwd_work_ops(work) == by_hand
