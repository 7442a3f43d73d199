"""PyTorch port vs JAX package: rasterize_soft forward and vertex gradient
(CPU), at the shape classes of the headline fit and the evidence renders.

The JAX side runs its Pallas shade kernel in interpret mode; the port runs
the kernel pair's plain PyTorch versions under its autograd Function. Bands:
forward 2e-5, gradient 3e-3 of the maximum (tests/test_pallas_shade.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.render import rasterizer as jr
from homan_tpu_torch.render import rasterizer as tr

from torch_port_common import CASES, assert_grad_close, raster_case, t2n


def _target(verts, K, topo, settings, shift):
    sil = jr.rasterize_soft(jnp.asarray(verts + shift), topo, jnp.asarray(K),
                            settings)["sil"]
    return (np.asarray(sil) > 0.5).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_rasterize_soft_forward_and_gradient(case):
    verts, K, jtopo, ttopo, jset, tset = raster_case(*case)
    target = _target(verts, K, jtopo, jset,
                     np.array([0.02, 0, 0], np.float32))

    def jloss(v):
        sil = jr.rasterize_soft(v, jtopo, jnp.asarray(K), jset)["sil"]
        return ((sil - target) ** 2).sum(), sil

    (jl, jsil), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(verts))
    tv = torch.from_numpy(verts).requires_grad_(True)
    out = tr.rasterize_soft(tv, ttopo, torch.from_numpy(K), tset)
    tl = ((out["sil"] - torch.from_numpy(target)) ** 2).sum()
    tl.backward()
    np.testing.assert_allclose(t2n(out["sil"]), np.asarray(jsil), atol=2e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert np.abs(np.asarray(jgrad)).max() > 0
    assert_grad_close(t2n(tv.grad), np.asarray(jgrad), name="dL/dverts")
