"""PyTorch port vs JAX package: the depth prep, the hard z-buffer kernel
pair's plain versions, rasterize_depth and the ordinal-depth loss (CPU, same
numpy inputs on both sides).

The JAX depth kernels run in interpret mode, as tests/test_rasterizer.py:309
runs them. Bands: prep coefficients 1e-6 of each row's largest value, valid
rows exact; plain forward vs Pallas on one pack: depth 1e-5, coverage and
argmax equal up to ties; backward 3e-3 of the maximum; rasterize_depth vs
the JAX XLA path: coverage equal, depth atol 1e-3 and vertex gradients
5e-3 of the maximum (the JAX package's own band, tests/test_rasterizer.py:
333,345); losses rtol 3e-4, gradients 3e-3 of the maximum.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.fit import losses as JL
from homan_tpu.render import pallas_depth as jdepth
from homan_tpu.render import rasterizer as jr
from homan_tpu_torch.fit import losses as TL
from homan_tpu_torch.render import depth as tdepth
from homan_tpu_torch.render import rasterizer as tr

from torch_port_common import (adversarial_depth_pack, assert_grad_close,
                               depth_scene_pair, overlap_state, port_from_jax,
                               raster_mesh, settings_pair, t2n, to_numpy)

# (mesh, image size, tile, faces per tile): a Kf that overflows the
# per-tile demand and one that holds every face, for each mesh.
DEPTH_CASES = [("object", 64, 16, 32), ("object", 64, 16, 1024),
               ("hand", 128, 32, 128), ("hand", 128, 32, 640)]
# Tiles that are not a multiple of the kernel's 16-pixel regions: the
# JAX kernel takes them (homan_tpu/render/pallas_shade.py pix_shape), and
# so does the port's.
TILE_CASES = [("object", 32, 8, 256), ("object", 48, 24, 512),
              ("hand", 96, 24, 640)]


def _ids(c):
    if c[0] == "adversarial":
        lead = f"-lead{c[4]}" if len(c) > 4 else ""
        return f"{c[0]}-{c[1]}-{c[2]}-seed{c[3]}{lead}"
    return f"{c[0]}-{c[1]}-{c[2]}-kf{c[3]}"


def _settings(S, tp, kf, use_pallas=True):
    from homan_tpu.render import RasterSettings as JS
    return (JS(image_size=S, tile_px=tp, faces_per_tile=kf,
               use_pallas=use_pallas),
            tr.RasterSettings(S, tile_px=tp, faces_per_tile=kf))


def _hand_closer(verts, K):
    """The test hand nearer the camera and under a longer focal length, so
    its faces span pixels: at ~0.4 px per face the JAX package's own two
    depth formulations differ by 5e-3 in the vertex gradient."""
    v = verts.copy()
    v[..., 2] -= 0.2
    K = K.copy()
    K[:, 0, 0] = K[:, 1, 1] = 2.5
    return v, K


@functools.lru_cache(maxsize=None)
def _case(case):
    mesh, S, tp, kf = case
    verts, faces, K = raster_mesh(mesh)
    if mesh == "hand":
        verts, K = _hand_closer(verts, K)
    return verts, faces, K, _settings(S, tp, kf)


@functools.lru_cache(maxsize=None)
def _jax_pack(case):
    """The face pack the JAX Pallas path builds, captured at the kernel
    call (the JAX prep has no entry point of its own)."""
    verts, faces, K, (js, _) = _case(case)
    seen = {}

    def capture(face_pack, static):
        seen["pack"] = np.array(face_pack)
        seen["static"] = static
        B, T = face_pack.shape[:2]
        return jnp.zeros((B, T, static[0], static[0]), jnp.float32)

    with jax.disable_jit(), mock.patch.object(jdepth, "depth_tiles_pallas",
                                              capture):
        jr.rasterize_depth(jnp.asarray(verts), jr.MeshTopology.from_faces(
            faces), jnp.asarray(K), js)
    return seen["pack"], seen["static"]


def _port_pack(case):
    verts, faces, K, (_, ts) = _case(case)
    topo = tr.MeshTopology.from_faces(faces, device="cpu")
    return tr.depth_prep(torch.from_numpy(verts), topo, torch.from_numpy(K),
                         ts)


@pytest.mark.parametrize("case", DEPTH_CASES, ids=_ids)
def test_depth_prep_matches_jax_prep(case):
    jpack, jstatic = _jax_pack(case)
    tpack, demand, static = _port_pack(case)
    tpack = t2n(tpack)
    assert tuple(static) == tuple(jstatic)
    assert tpack.shape == jpack.shape
    valid = jpack[:, :, 12] > 0.5
    np.testing.assert_array_equal(tpack[:, :, 12], jpack[:, :, 12])
    n_valid = valid.sum(-1)
    assert (valid == (np.arange(static.kf) < n_valid[..., None])).all()
    overflow = case[3] in (32, 128)
    assert bool((t2n(demand) > static.kf).any()) == overflow
    if not overflow:
        np.testing.assert_array_equal(t2n(demand), n_valid.max(-1))
    assert valid.any()
    for r in range(12):
        t, j = tpack[:, :, r][valid], jpack[:, :, r][valid]
        scale = np.abs(j).max()
        np.testing.assert_allclose(t, j, atol=1e-6 * scale, rtol=0,
                                   err_msg=f"row {r}")
    # Empty slots hold zeros (the JAX prep fills them with the features of
    # faces that miss the tile; the kernels read only the valid prefix).
    assert not tpack[:, :, :12][np.broadcast_to(
        ~valid[:, :, None], tpack[:, :, :12].shape)].any()
    assert not tpack[:, :, 13:].any()


@functools.lru_cache(maxsize=None)
def _pallas_outputs(case):
    jpack, jstatic = _jax_pack(case)
    depth, amax = jdepth._depth_fwd(jnp.asarray(jpack), jstatic)
    B, T = jpack.shape[:2]
    tp = jstatic[0]
    gcot = np.random.RandomState(0).randn(B, T, tp, tp).astype(np.float32)
    depth = jnp.asarray(depth).reshape(B, T, tp, tp)
    amax = jnp.asarray(amax).reshape(B, T, tp, tp)
    (gpack,) = jdepth._depth_bwd_vjp(jstatic, (depth, amax),
                                     jnp.asarray(gcot))
    return np.array(depth), np.array(amax), gcot, np.array(gpack)


@pytest.mark.parametrize("case", DEPTH_CASES, ids=_ids)
def test_depth_plain_matches_pallas_interpret(case):
    jpack, jstatic = _jax_pack(case)
    static = tdepth.DepthStatic(*jstatic)
    jd, ja, gcot, jg = _pallas_outputs(case)
    n0 = tdepth.depth_fwd_launches, tdepth.depth_bwd_launches
    td, ta = tdepth.depth_fwd(torch.from_numpy(jpack), static)
    td, ta = t2n(td), t2n(ta)
    covered = jd > 0
    np.testing.assert_array_equal(td > 0, covered)
    np.testing.assert_allclose(td, jd, atol=1e-5, rtol=0)
    same = ta == ja
    # Ties: a differing winner won with the same depth.
    np.testing.assert_array_equal(td[~same], jd[~same])
    assert same.mean() >= 0.999
    assert (ta[~covered] == -1).all()

    tg = t2n(tdepth.depth_bwd(torch.from_numpy(jd), torch.from_numpy(ja),
                              torch.from_numpy(gcot), static))
    assert (tdepth.depth_fwd_launches, tdepth.depth_bwd_launches) == n0
    assert not np.delete(tg, [9, 10, 11], axis=2).any()
    if covered.any():
        assert_grad_close(tg, jg, name="gpack")
    else:
        assert not jg.any() and not tg.any()


def _on_an_edge(pack, static, b, t, iy, ix, k, inside):
    """Whether slot k's inside test at pixel (b, t, iy, ix) is decided by
    rounding: `inside`, some edge of the slot is within (|a| + |b| + |c|)
    2^-20 of zero there (the rounding bound of a px + b py + c that the
    kernel's cull uses); not `inside`, every edge that fails does so by no
    more than that."""
    px, py, _ = tdepth._pixel_coords(static, pack.shape[1], pack.device)
    x, y = px[0, t, 0, ix], py[0, t, iy, 0]
    f = pack[b, t, :9, k].reshape(3, 3)
    e = f[:, 0] * x + f[:, 1] * y + f[:, 2]
    slack = f.abs().sum(1) * 2.0 ** -20
    if inside:
        return bool((e.abs() <= slack).any())
    return bool(((e >= 0) | (-e <= slack)).all())


@pytest.mark.parametrize("case", TILE_CASES, ids=_ids)
def test_depth_plain_matches_pallas_interpret_at_ragged_tiles(case):
    """Tiles that are not a multiple of 16, in the bands of the test above.
    Where the winners differ and the depths do not tie, the pixel lies on a
    shared edge: the JAX package's CPU path evaluates the edge lines with
    fused multiply-adds, the port never does, and the two sides put such a
    pixel into different faces (the hand at tile 24 has one)."""
    jpack, jstatic = _jax_pack(case)
    static = tdepth.DepthStatic(*jstatic)
    assert static.tile_px % tdepth.FWD_REGION
    jd, ja, gcot, jg = _pallas_outputs(case)
    pack = torch.from_numpy(jpack)
    td, ta = (t2n(x) for x in tdepth.depth_fwd(pack, static))
    covered = jd > 0
    np.testing.assert_array_equal(td > 0, covered)
    np.testing.assert_allclose(td, jd, atol=1e-5, rtol=0)
    same = ta == ja
    assert same.mean() >= 0.999
    assert (ta[~covered] == -1).all()
    for b, t, iy, ix in np.argwhere(~same):
        assert (td[b, t, iy, ix] == jd[b, t, iy, ix]
                or _on_an_edge(pack, static, b, t, iy, ix,
                               ja[b, t, iy, ix], inside=False)
                or _on_an_edge(pack, static, b, t, iy, ix,
                               ta[b, t, iy, ix], inside=True))
    tg = t2n(tdepth.depth_bwd(torch.from_numpy(jd), torch.from_numpy(ja),
                              torch.from_numpy(gcot), static))
    assert_grad_close(tg, jg, name="gpack")


# The kernel's cull (replayed on the host by depth.cull_keep) on the JAX
# prep's packs above and on hand-built adversarial packs at tiles 16, 32
# and 48 (tests/torch_port_common.py adversarial_depth_pack: axis-aligned
# edges through pixel centres, slivers, faces touching a sub-tile only at a
# corner centre, equal-invz ties; the last case puts 2,000 faces that are
# inside nowhere first, so the winners sit past slot 2,048), and at tiles
# 8, 24 and 40, whose edge regions the kernel clamps.
CULL_CASES = DEPTH_CASES + TILE_CASES + [
    ("adversarial", 32, 16, 0), ("adversarial", 64, 32, 1),
    ("adversarial", 96, 48, 3), ("adversarial", 32, 16, 2, 2000),
    ("adversarial", 48, 24, 4), ("adversarial", 80, 40, 5)]


def _cull_pack(case):
    if case[0] == "adversarial":
        return adversarial_depth_pack(tp=case[2], seed=case[3],
                                      lead=case[4] if len(case) > 4 else 0)
    jpack, jstatic = _jax_pack(case)
    return torch.from_numpy(jpack), tdepth.DepthStatic(*jstatic)


@pytest.mark.parametrize("case", CULL_CASES, ids=_ids)
def test_depth_cull_is_conservative(case):
    """Every (pixel, slot) the plain forward finds inside with invz > 0
    survives its sub-tile's cull, so the culled scan (the kernel's order of
    work) gives bit-identical depth and amax; and the cull drops work."""
    pack, static = _cull_pack(case)
    keep, in_region = tdepth.cull_keep(pack, static)
    B, T = pack.shape[:2]
    tp = static.tile_px
    n = -(-tp // tdepth.FWD_SUB)
    assert keep.shape == (B, T, n, n, static.kf)
    px, py, _ = tdepth._pixel_coords(static, T, pack.device)
    fp = pack[..., None, None]
    sub = tdepth.FWD_SUB
    n_inside = 0
    best = torch.zeros((B, T, static.tile_px, static.tile_px))
    am = torch.full(best.shape, -1, dtype=torch.int32)
    for k in range(int(pack[:, :, 12].sum(-1).max())):
        inside, invz = tdepth._slot_inside(fp, k, px, py)
        hit = inside & (invz > 0)
        n_inside += int(hit.sum())
        kept = keep[..., k].repeat_interleave(sub, 2).repeat_interleave(
            sub, 3)[:, :, :tp, :tp]
        assert not bool((hit & ~kept).any()), (
            f"slot {k}: culled where it is inside")
        # The kernel's scan: each pixel sees only its sub-tile's survivors.
        better = inside & kept & (invz > best)
        best = torch.where(better, invz, best)
        am = torch.where(better, torch.full_like(am, k), am)
    assert n_inside > 0
    depth, amax = tdepth.depth_fwd_plain(pack, static)
    assert torch.equal(best > 0, depth > 0)
    assert torch.equal(torch.where(best > 0, 1.0 / best.clamp(min=1e-9), 0.0),
                       depth)
    assert torch.equal(torch.where(best > 0, am, -1), amax)
    work = tdepth.fwd_work(pack, static)
    assert n_inside <= work["pixel_slots"] < work["valid_pixel_slots"]


@pytest.mark.parametrize("tp", (16, 32, 48, 64, 96, 128, 8, 24, 40, 12))
def test_depth_fwd_work_of_a_face_covering_the_tile_is_dense(tp):
    """Faces that cover the whole tile survive every cull: the work counts
    every (pixel, valid slot) pair, as the dense count does."""
    n_faces, kf = 3, 5
    static = tdepth.DepthStatic(tp, 2 * tp, 2, kf)
    pack = torch.zeros((1, 4, 16, kf))
    # e0 = px + 1, e1 = py + 1, e2 = 3 - px - py: positive on [0, 1]^2.
    face = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0, 1.0, -1.0, -1.0, 3.0,
                         0.0, 0.0, 1.0, 1.0])
    pack[:, :, :13, :n_faces] = face[:, None]
    work = tdepth.fwd_work(pack, static)
    n_valid = 4 * n_faces
    n_reg, n_sub = -(-tp // tdepth.FWD_REGION), -(-tp // tdepth.FWD_SUB)
    assert work == {"region_tests": n_valid * n_reg ** 2,
                    "sub_tests": n_valid * n_sub ** 2,
                    "pixel_slots": n_valid * tp * tp,
                    "valid_pixel_slots": n_valid * tp * tp}
    assert tdepth.fwd_work_ops(work) == (
        tdepth.FWD_CULL_OPS_PER_BOX_SLOT * (work["region_tests"]
                                            + work["sub_tests"])
        + tdepth.FWD_OPS_PER_PIXEL_SLOT * n_valid * tp * tp)
    depth, amax = tdepth.depth_fwd_plain(pack, static)
    assert bool((depth == 1.0).all()) and bool((amax == 0).all())


def test_depth_cull_refuses_tiles_the_kernel_does_not_take():
    """The kernel takes every tile of at least one pixel: the replay of
    its cull refuses only the others, and at tiles that are not a multiple
    of its regions it gives ceil(tp / side) boxes a side."""
    for tp in (0, -16):
        static = tdepth.DepthStatic(tp, 32, 2, 4)
        with pytest.raises(ValueError, match="positive number of pixels"):
            tdepth.cull_keep(torch.zeros((1, 4, 16, 4)), static)
    for tp in (8, 24, 40, 9):
        static = tdepth.DepthStatic(tp, 2 * tp, 2, 4)
        keep, in_region = tdepth.cull_keep(torch.zeros((1, 4, 16, 4)),
                                           static)
        n_sub, n_reg = -(-tp // tdepth.FWD_SUB), -(-tp // tdepth.FWD_REGION)
        assert keep.shape == (1, 4, n_sub, n_sub, 4)
        assert in_region.shape == (1, 4, n_reg, n_reg, 4)
        assert not bool(keep.any())  # no valid slot


def _xla_settings(case):
    js, ts = _case(case)[3]
    return dataclasses.replace(js, use_pallas=False), ts


@pytest.mark.parametrize("case", DEPTH_CASES, ids=_ids)
def test_rasterize_depth_matches_jax_xla_path(case):
    verts, faces, K, _ = _case(case)
    js, ts = _xla_settings(case)
    jtopo = jr.MeshTopology.from_faces(faces)
    S = ts.image_size
    w = np.linspace(0.5, 1.5, S).astype(np.float32)

    def jloss(v):
        d = jr.rasterize_depth(v, jtopo, jnp.asarray(K), js)["depth"]
        return (d * (d > 0) * w).sum()

    jout = jr.rasterize_depth(jnp.asarray(verts), jtopo, jnp.asarray(K), js)
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(verts)))
    tv = torch.from_numpy(verts).requires_grad_(True)
    tout = tr.rasterize_depth(tv, tr.MeshTopology.from_faces(faces, "cpu"),
                              torch.from_numpy(K), ts)
    d = tout["depth"]
    (d * (d > 0) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t2n(tout["covered"]),
                                  np.asarray(jout["covered"]))
    np.testing.assert_allclose(t2n(d), np.asarray(jout["depth"]), atol=1e-3)
    if np.abs(jgrad).max() > 0:
        assert_grad_close(t2n(tv.grad), jgrad, rel=5e-3, name="d/dverts")
    else:
        assert not t2n(tv.grad).any()


@pytest.mark.parametrize("case", DEPTH_CASES, ids=_ids)
def test_check_face_budget(case):
    verts, faces, K, (_, ts) = _case(case)
    topo = tr.MeshTopology.from_faces(faces, device="cpu")
    out = tr.check_face_budget(torch.from_numpy(verts), topo,
                               torch.from_numpy(K), ts)
    _, demand, static = _port_pack(case)
    assert out["max_demand"] == int(demand.max())
    assert out["capacity"] == static.kf
    assert out["overflow"] == (out["max_demand"] > static.kf)


def test_ordinal_depth_loss_values_and_gradients():
    rng = np.random.RandomState(7)
    B, N, S = 2, 3, 16
    masks = rng.rand(B, N, S, S) > 0.5
    sils = [rng.rand(B, S, S) > 0.3 for _ in range(N)]
    depths = [rng.uniform(0.4, 2.0, (B, S, S)).astype(np.float32)
              for _ in range(N)]

    def jloss(*ds):
        return JL.compute_ordinal_depth_loss(
            jnp.asarray(masks), [jnp.asarray(s) for s in sils],
            list(ds))["loss_depth"]

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *[jnp.asarray(d) for d in depths])
    td = [torch.from_numpy(d).requires_grad_(True) for d in depths]
    tval = TL.compute_ordinal_depth_loss(
        torch.from_numpy(masks), [torch.from_numpy(s) for s in sils],
        td)["loss_depth"]
    tval.backward()
    assert float(jval) > 0
    np.testing.assert_allclose(tval.item(), float(jval), rtol=3e-4)
    for t, j in zip(td, jgrads):
        assert_grad_close(t2n(t.grad), np.asarray(j), name="d/ddepth")
    # No covered pair: zero loss, not a division by zero.
    empty = TL.compute_ordinal_depth_loss(
        torch.from_numpy(masks), [torch.zeros(B, S, S, dtype=torch.bool)] * N,
        td)["loss_depth"]
    assert empty.item() == 0.0


@functools.lru_cache(maxsize=None)
def _jax_depth_losses(kf):
    js, _ = depth_scene_pair()
    state = overlap_state(js)
    jroi, _ = settings_pair(64, 32, 48)
    jfull, _ = _settings(128, 32, kf, use_pallas=False)
    lw = dict(JL.DEFAULT_LW, lw_depth=1.0)

    def total(s):
        ld, md = JL.compute_all_losses(s, js.consts, js.cfg, lw,
                                       roi_settings=jroi,
                                       full_settings=jfull)
        return JL.weighted_sum(ld, lw), (ld, md)

    (_, (jl, jm)), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
        state)
    return jl, jm, to_numpy(jg)


@pytest.mark.parametrize("kf", [64, 2048])
def test_compute_all_losses_with_depth(kf):
    """The depth branch of compute_all_losses against the JAX package's,
    through the XLA depth path the JAX fit takes off the TPU (the kernel
    formulation is held to the Pallas kernels above), at a Kf that drops
    faces and at one that keeps them all: values and per-leaf gradients."""
    js, ts = depth_scene_pair()
    np.testing.assert_array_equal(t2n(ts.consts.masks_object),
                                  np.asarray(js.consts.masks_object))
    hand_mismatch = (t2n(ts.consts.masks_hand)
                     != np.asarray(js.consts.masks_hand)).mean()
    assert hand_mismatch < 1e-3
    jl, jm, jg = _jax_depth_losses(kf)
    js_state = overlap_state(js)
    state, consts, cfg = port_from_jax(
        dataclasses.replace(js, init_state=js_state))
    state = state.map(lambda x: x.clone().requires_grad_(True))
    _, troi = settings_pair(64, 32, 48)
    _, tfull = _settings(128, 32, kf)
    lw = dict(TL.DEFAULT_LW, lw_depth=1.0)
    tl, tm = TL.compute_all_losses(state, consts, cfg, lw, roi_settings=troi,
                                   full_settings=tfull)
    # (jit returns its dicts with sorted keys)
    assert set(tl) == set(jl) and list(tl)[-1] == "loss_depth"
    assert float(jl["loss_depth"]) > 0
    # At the ground-truth hand the keypoint metric is 0 up to rounding (in
    # pixels).
    for ours, theirs, atol in ((tl, jl, 1e-7), (tm, jm, 1e-5)):
        for k in theirs:
            np.testing.assert_allclose(float(ours[k].detach()),
                                       float(np.asarray(theirs[k])),
                                       rtol=3e-4, atol=atol, err_msg=k)
    TL.weighted_sum(tl, lw).backward()
    for name, g in jg.items():
        t = getattr(state, name).grad
        t = np.zeros_like(g) if t is None else t2n(t)
        if not np.any(g):
            assert not np.any(t), name
            continue
        assert_grad_close(t, g, name=name)
