"""PyTorch port vs JAX package: the pieces of stage B (CPU, same inputs).

Bands: rotations from the same uniforms 1e-6; translation inits 1e-5;
`_maxpool_edges` and `reference_edge_edt` 1e-5; loss terms rtol 3e-4 and
their vertex gradient 3e-3 of its maximum (the JAX kernel in Pallas
interpret mode); `_fit_candidates` step-0 totals rtol 3e-4, the first 10
`loss_min` rtol 3e-3, final rotations (as matrices) and translations atol
2e-3 for the candidates that converge (final IoU >= 0.9 on the JAX side;
the others drift apart from arithmetic order alone); IoUs within one
pixel's flip; tie order of the survivor and winner selection exact.
Whole searches are in tests/test_torch_poseinit_search.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.core import geometry as jgeo
from homan_tpu.fit import poseinit as JP
from homan_tpu.render import RasterSettings as JS
from homan_tpu.render import rasterize_soft as jrasterize
from homan_tpu.render.rasterizer import MeshTopology as JT
from homan_tpu_torch.core import geometry as tgeo
from homan_tpu_torch.core.meshes import bumpy_potato
from homan_tpu_torch.fit import poseinit as TP
from homan_tpu_torch.render import RasterSettings as TS
from homan_tpu_torch.render.rasterizer import MeshTopology as TT

from torch_port_common import assert_grad_close, settings_pair, t2n

S, TILE, KE = 64, 32, 96
K_ROI = np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]], np.float32)


def test_random_rotations_match_jax():
    key = jax.random.PRNGKey(0)
    n = 64
    u = np.array(jax.random.uniform(key, (3, n)))
    np.testing.assert_allclose(t2n(tgeo.arvo_rotations(torch.from_numpy(u))),
                               np.asarray(jgeo.random_rotations(key, n)),
                               atol=1e-6, rtol=0)
    k1, k2, k3 = jax.random.split(key, 3)
    angles = np.stack([
        np.asarray(jax.random.uniform(k1, (n,), minval=0.0,
                                      maxval=2 * jnp.pi)),
        np.asarray(jax.random.uniform(k2, (n,), minval=-jnp.pi / 6,
                                      maxval=jnp.pi / 6)),
        np.asarray(jax.random.uniform(k3, (n,), minval=-jnp.pi / 12,
                                      maxval=jnp.pi / 12))], axis=-1)
    np.testing.assert_allclose(
        t2n(tgeo.euler_angles_to_matrix(torch.from_numpy(angles), "YXZ")),
        np.asarray(jgeo.random_rotations(key, n, upright=True)),
        atol=1e-6, rtol=0)
    for upright in (False, True):
        R = tgeo.random_rotations(n, torch.Generator().manual_seed(3),
                                  upright=upright, device="cpu")
        assert torch.equal(R, tgeo.random_rotations(
            n, torch.Generator().manual_seed(3), upright=upright))
        eye = torch.eye(3).expand(n, 3, 3)
        torch.testing.assert_close(R @ R.transpose(1, 2), eye, atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(torch.linalg.det(R), torch.ones(n),
                                   atol=1e-5, rtol=0)


def test_translation_inits_match_jax():
    v, _ = bumpy_potato(2, 0.1, seed=1)
    R = np.asarray(jgeo.random_rotations(jax.random.PRNGKey(2), 6))
    rotated = np.einsum("vj,cjk->cvk", v, R).astype(np.float32)
    bbox = np.array([90.0, 100.0, 60.0, 50.0], np.float32)
    K = np.array([[200.0, 0, 128], [0, 210, 120], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(
        t2n(TP.tco_init_from_boxes_autodepth(bbox, torch.from_numpy(rotated),
                                             K)),
        np.asarray(JP.tco_init_from_boxes_autodepth(bbox, rotated, K)),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        t2n(TP.compute_optimal_translation(bbox, torch.from_numpy(rotated),
                                           f=1.0, img_size=256)),
        np.asarray(JP.compute_optimal_translation(bbox, rotated, f=1.0,
                                                  img_size=256)),
        atol=1e-5, rtol=0)


def test_edge_edt_and_maxpool_match_jax():
    rng = np.random.RandomState(0)
    sil = rng.uniform(0, 1, (3, 20, 24)).astype(np.float32)
    sil[0] = sil[0] > 0.5
    np.testing.assert_allclose(
        t2n(TP._maxpool_edges(torch.from_numpy(sil))),
        np.asarray(JP._maxpool_edges(jnp.asarray(sil))), atol=1e-5, rtol=0)
    mask = np.zeros((40, 36), np.float32)
    mask[10:20, 12:24] = 1.0
    mask[25:33, 3:9] = -1.0  # occluded pixels are not foreground
    mask[30:34, 20:30] = 1.0
    ours = TP.reference_edge_edt(mask)
    np.testing.assert_allclose(ours, JP.reference_edge_edt(mask), atol=1e-5,
                               rtol=0)
    assert ours[9, 12] == 0.0 and ours[0, 35] > 0


def _scene(C, seed=0):
    """Mesh, target and keep masks at S^2 from a ground-truth pose, and C
    candidates: the ground truth turned by growing random angles (the first
    ones converge, the last ones may not), every third from a shifted
    translation, one pushed partly off screen."""
    from scipy.spatial.transform import Rotation
    v, f = bumpy_potato(1, 0.09, seed=5)
    gt_R = np.asarray(jgeo.random_rotations(jax.random.PRNGKey(3), 1))[0]
    gt_t = np.array([0.0, 0.0, 0.5], np.float32)
    js = JS(S, tile_px=TILE, edges_per_tile=KE)
    sil = jrasterize(jnp.asarray(v @ gt_R + gt_t)[None], JT.from_faces(f),
                     jnp.asarray(K_ROI)[None], js)["sil"]
    target = (np.asarray(sil)[0] > 0.5).astype(np.float32)
    keep = np.ones_like(target)
    keep[:8, :20] = 0.0
    rng = np.random.RandomState(seed)
    aa = rng.randn(C, 3) * np.linspace(0.05, 0.8, C)[:, None]
    R0 = np.stack([gt_R @ Rotation.from_rotvec(a).as_matrix()
                   for a in aa]).astype(np.float32)
    t0 = gt_t + rng.randn(C, 1, 3).astype(np.float32) * 0.01
    t0[::3, 0, :2] += 0.02
    t0[-1, 0, 0] += 0.3
    return v, f, target, keep, R0, t0.astype(np.float32)


@pytest.mark.parametrize("lw_chamfer", [0.0, 1.0])
def test_candidate_loss_terms_match_jax(lw_chamfer):
    C = 12
    v, f, target, keep, R0, t0 = _scene(C)
    edt = JP.reference_edge_edt(target).astype(np.float32)
    js, ts = settings_pair(S, TILE, KE)
    verts = (np.einsum("vj,cjk->cvk", v, R0) + t0).astype(np.float32)
    Kb = np.tile(K_ROI[None], (C, 1, 1))

    def jtotal(vv):
        t = JP.candidate_loss_terms(vv, JT.from_faces(f), target, keep, edt,
                                    Kb, js, lw_chamfer=lw_chamfer)
        return (t["mask"] + t["chamfer"]
                + 1e5 * (t["off_xy"] + t["off_z"])).sum(), t

    (_, jt), jg = jax.value_and_grad(jtotal, has_aux=True)(jnp.asarray(verts))
    vt = torch.from_numpy(verts).requires_grad_(True)
    tt = TP.candidate_loss_terms(vt, TT.from_faces(f),
                                 torch.from_numpy(target),
                                 torch.from_numpy(keep),
                                 torch.from_numpy(edt),
                                 torch.from_numpy(Kb), ts,
                                 lw_chamfer=lw_chamfer)
    (tt["mask"] + tt["chamfer"]
     + 1e5 * (tt["off_xy"] + tt["off_z"])).sum().backward()
    for k in ("mask", "chamfer", "off_xy", "off_z"):
        np.testing.assert_allclose(t2n(tt[k]), np.asarray(jt[k]), rtol=3e-4,
                                   atol=1e-6, err_msg=k)
    assert float(tt["off_xy"][-1].detach()) > 0 and (lw_chamfer == 0) == (
        not bool(tt["chamfer"].any()))
    np.testing.assert_allclose(t2n(tt["iou"]), np.asarray(jt["iou"]),
                               atol=1.0 / (target.sum() - 1), rtol=0)
    assert_grad_close(t2n(vt.grad), np.asarray(jg), name="vertex gradient")


def _fit_both(v, f, target, keep, edt, R0, t0, iters, chunk=5):
    js = JS(S, tile_px=TILE, edges_per_tile=KE)
    ts = TS(S, tile_px=TILE, edges_per_tile=KE)
    r6 = R0[..., :2]
    pj, totj, iouj, hj = JP._fit_candidates(
        jnp.asarray(v), JT.from_faces(f), target, keep, edt,
        jnp.asarray(K_ROI), jnp.asarray(r6), jnp.asarray(t0), js,
        num_iterations=iters, candidate_chunk=chunk)
    pt, tott, iout, ht = TP._fit_candidates(
        torch.from_numpy(v), TT.from_faces(f), torch.from_numpy(target),
        torch.from_numpy(keep), torch.from_numpy(edt),
        torch.from_numpy(K_ROI), torch.from_numpy(r6), torch.from_numpy(t0),
        ts, num_iterations=iters, candidate_chunk=chunk)
    return (pj, np.asarray(totj), np.asarray(iouj), hj), (pt, t2n(tott),
                                                         t2n(iout), ht)


def test_fit_candidates_matches_jax():
    """A prime candidate count in chunks of 5 (the last one short)."""
    C = 13
    v, f, target, keep, R0, t0 = _scene(C)
    edt = np.zeros_like(target)
    (_, totj, _, _), (_, tott, _, _) = _fit_both(v, f, target, keep, edt,
                                                 R0, t0, 0)
    np.testing.assert_allclose(tott, totj, rtol=3e-4)
    (pj, _, iouj, hj), (pt, _, iout, ht) = _fit_both(v, f, target, keep, edt,
                                                     R0, t0, 20)
    assert ht["loss_min"].shape == ht["iou_max"].shape == (20,)
    np.testing.assert_allclose(t2n(ht["loss_min"])[:10],
                               np.asarray(hj["loss_min"])[:10], rtol=3e-3)
    inside = iouj >= 0.9
    assert inside.sum() >= C // 2, iouj
    Rj = np.asarray(jgeo.rot6d_to_matrix(pj["rot6d"]))[inside]
    Rt = t2n(tgeo.rot6d_to_matrix(pt["rot6d"]))[inside]
    np.testing.assert_allclose(Rt, Rj, atol=2e-3, rtol=0)
    np.testing.assert_allclose(t2n(pt["trans"])[inside],
                               np.asarray(pj["trans"])[inside], atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(iout[inside], iouj[inside],
                               atol=1.0 / (target.sum() - 1), rtol=0)


def test_prime_candidate_count_chunks_do_not_change_numerics():
    """The JAX package's test_prime_candidate_count_pads_not_degrades on the
    port: chunks of 4 (the last one short) give the chunk-equal-to-C
    result; so do the rescore's chunks of 5."""
    C = 13
    v, f, target, keep, R0, t0 = _scene(C, seed=1)
    ts = TS(32, tile_px=16, edges_per_tile=KE)
    target = target[::2, ::2].copy()
    keep, edt = np.ones_like(target), np.zeros_like(target)
    args = [torch.from_numpy(x) for x in (v,)] + [TT.from_faces(f)] + [
        torch.from_numpy(x) for x in (target, keep, edt, K_ROI,
                                      R0[..., :2].copy(), t0)]
    outs = {}
    for chunk in (C, 4):
        params, total, iou, _ = TP._fit_candidates(
            *args, ts, num_iterations=3, candidate_chunk=chunk)
        assert total.shape == (C,) and iou.shape == (C,)
        outs[chunk] = (params["rot6d"], params["trans"], total)
    for a, b in zip(outs[C], outs[4]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    ev = [torch.from_numpy(x).expand((C,) + x.shape)
          for x in (target, keep, K_ROI)]
    r6, tr = torch.from_numpy(R0[..., :2].copy()), torch.from_numpy(t0)
    full, demand = TP._score_candidates(args[0], args[1], *ev, r6, tr, ts,
                                        candidate_chunk=C)
    ious5, demand5 = TP._score_candidates(args[0], args[1], *ev, r6, tr, ts,
                                          candidate_chunk=5)
    torch.testing.assert_close(ious5, full, rtol=1e-5, atol=1e-6)
    assert demand.shape == () and int(demand5) == int(demand) > 0


def test_score_candidates_matches_jax():
    """Per-candidate evidence against the JAX package's; the same evidence
    grouped (one entry per 4 candidates, chunks across groups) gives the
    same IoUs."""
    C = 12
    v, f, target, keep, R0, t0 = _scene(C)
    targets = np.stack([target, np.roll(target, 2, axis=1), target])
    keeps = np.stack([keep, keep, np.ones_like(keep)])
    Ks = np.tile(K_ROI[None], (3, 1, 1))
    Ks[1, 0, 2] += 0.02
    rep = np.repeat(np.arange(3), 4)
    r6 = R0[..., :2].copy()
    js = JS(S, tile_px=TILE, edges_per_tile=KE)
    ts = TS(S, tile_px=TILE, edges_per_tile=KE)
    theirs = np.asarray(JP._score_candidates(
        jnp.asarray(v), JT.from_faces(f), targets[rep], keeps[rep], Ks[rep],
        jnp.asarray(r6), jnp.asarray(t0), js, candidate_chunk=5))
    topo = TT.from_faces(f)
    ours = TP._score_candidates(
        torch.from_numpy(v), topo, *(torch.from_numpy(x[rep])
                                     for x in (targets, keeps, Ks)),
        torch.from_numpy(r6), torch.from_numpy(t0), ts,
        candidate_chunk=5)[0]
    np.testing.assert_allclose(t2n(ours), theirs,
                               atol=1.0 / (target.sum() - 1), rtol=0)
    grouped = TP._score_candidates(
        torch.from_numpy(v), topo, *(torch.from_numpy(x)
                                     for x in (targets, keeps, Ks)),
        torch.from_numpy(r6), torch.from_numpy(t0), ts, candidate_chunk=5,
        group=4)[0]
    assert torch.equal(grouped, ours)


def test_survivor_and_winner_selection_tie_order():
    """Stable survivor order and the first maximum, as the JAX package
    picks them, on IoUs with ties."""
    c_ious = np.array([0.5, 0.8, 0.5, 0.8, 0.0, 0.8, 0.3, 0.0], np.float32)
    rot6d = np.arange(8 * 6, dtype=np.float32).reshape(8, 3, 2)
    trans = np.arange(8 * 3, dtype=np.float32).reshape(8, 1, 3)
    for k in (3, 5, 8):
        jr6, jt = JP._prune_select(jnp.asarray(c_ious), jnp.asarray(rot6d),
                                   jnp.asarray(trans), k)
        tr6, tt = TP._prune_select(torch.from_numpy(c_ious),
                                   torch.from_numpy(rot6d),
                                   torch.from_numpy(trans), k)
        np.testing.assert_array_equal(t2n(tr6), np.asarray(jr6))
        np.testing.assert_array_equal(t2n(tt), np.asarray(jt))
    ious = np.array([[0.5, 0.9, 0.7, 0.9], [0.9, 0.5, 0.7, 0.5]], np.float32)
    R = np.array(jgeo.random_rotations(jax.random.PRNGKey(4), 8)).reshape(
        2, 4, 3, 3)
    t = np.arange(24, dtype=np.float32).reshape(2, 4, 1, 3)
    v = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    j = JP._select_best(jnp.asarray(R), jnp.asarray(t), jnp.asarray(ious),
                        jnp.asarray(v))
    o = TP._select_best(*(torch.from_numpy(x) for x in (R, t, ious, v)))
    assert int(o[3]) == int(j[3]) == 0
    for a, b in zip(o[:3] + o[4:], j[:3] + j[4:]):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-6, rtol=0)
