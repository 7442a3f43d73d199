"""The voxelizer at every grid size the JAX launcher takes, G 16 to 1,024
(homan_tpu/interactions/pallas_sdf.py:190-191), and the sizes it refuses
(CPU: the plain version; the kernel's own checks at G 128-1,024 are in
tests/test_torch_cuda.py).

Bands: phi within 1e-5 of the reference with the same inside set, as the
kernel is held to its plain version; against the analytic box distance,
the same.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from homan_tpu.interactions import pallas_sdf as jpallas
from homan_tpu.interactions import sdf as jsdf
from homan_tpu_torch.core.meshes import box_mesh, bumpy_potato
from homan_tpu_torch.interactions import sdf as tsdf
from homan_tpu_torch.interactions import voxelize as tvox

from torch_port_common import BOX_SHIFT, box_sdf, shifted_box, t2n


def test_grids_are_the_jax_launchers():
    takes = tuple(g for g in (2 ** k for k in range(12))
                  if g ** 3 % jpallas.PB == 0 and jpallas.PB % g == 0)
    assert tvox.GRIDS == takes == (16, 32, 64, 128, 256, 512, 1024)


@pytest.mark.parametrize("grid", [8, 48, 2048])
def test_other_grids_raise_on_both_sides(grid):
    v, f = bumpy_potato(1, 0.6, seed=0)
    with pytest.raises(ValueError, match="grid sizes"):
        tvox.voxelize(torch.from_numpy(v)[None], torch.from_numpy(f), grid)
    if grid != 2048:  # the JAX launcher asserts (its 1,024-point blocks)
        with pytest.raises(AssertionError):
            jpallas.voxelize_interior_sdf_pallas(
                jnp.asarray(v)[None], jnp.asarray(f), grid_size=grid)


def test_plain_voxelizer_at_128_matches_jax_xla():
    """80 faces at G 128, against the JAX package's XLA path."""
    v, f = bumpy_potato(1, 0.6, seed=0)
    ref = np.asarray(jsdf.voxelize_interior_sdf(
        jnp.asarray(v)[None], jnp.asarray(f), grid_size=128))
    ours = t2n(tvox.voxelize(torch.from_numpy(v)[None],
                             torch.from_numpy(f.astype(np.int64)), 128))
    assert ours.shape == ref.shape == (1, 128, 128, 128)
    assert (ref > 0).sum() > 10000
    np.testing.assert_array_equal(ours > 0, ref > 0)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("grid", [16, 64, 128])
def test_plain_voxelizer_matches_the_box_distance(grid):
    v, f = shifted_box()
    ours = t2n(tvox.voxelize(torch.from_numpy(v)[None],
                             torch.from_numpy(f.astype(np.int64)), grid))
    ref = box_sdf(grid, shift=BOX_SHIFT)
    np.testing.assert_array_equal(ours > 0, ref > 0)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_centred_box_diagonal_columns_read_outside():
    """The degeneracy BOX_SHIFT avoids, in both packages: at the centred
    box the columns on the caps' diagonal (ix == iy) are outside."""
    v, f = box_mesh()
    ours = t2n(tsdf.voxelize_interior_sdf(
        torch.from_numpy(v)[None], torch.from_numpy(f.astype(np.int64)), 16))
    ref = np.asarray(jsdf.voxelize_interior_sdf(
        jnp.asarray(v)[None], jnp.asarray(f), grid_size=16))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    inside = box_sdf(16) > 0
    diag = np.zeros_like(inside)
    idx = np.arange(16)
    diag[0, idx, idx, :] = True
    np.testing.assert_array_equal(ours > 0, inside & ~diag)
