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


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
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


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
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
