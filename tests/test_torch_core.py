"""PyTorch port vs JAX package: meshes, rotations, cameras, MANO (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.core import camera as jcam
from homan_tpu.core import geometry as jgeo
from homan_tpu.core import mano as jmano
from homan_tpu.core import meshes as jmeshes
from homan_tpu_torch.core import camera as tcam
from homan_tpu_torch.core import geometry as tgeo
from homan_tpu_torch.core import mano as tmano
from homan_tpu_torch.core import meshes as tmeshes

from torch_port_common import t2n


@pytest.mark.parametrize("subdiv", [2, 3])
def test_bumpy_potato_bit_identical(subdiv):
    jv, jf = jmeshes.bumpy_potato(subdiv, 0.08, seed=0)
    tv, tf = tmeshes.bumpy_potato(subdiv, 0.08, seed=0)
    assert jv.dtype == tv.dtype and jf.dtype == tf.dtype
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jf, tf)


def test_synthetic_mano_params_bit_identical():
    jp = jmano.synthetic_mano_params(0)
    tp = tmano.synthetic_mano_params(0, device="cpu")
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), t2n(tp[k]),
                                      err_msg=k)


def test_mirror_params_match():
    jp = jmano.mirror_mano_params(jmano.synthetic_mano_params(1))
    tp = tmano.mirror_mano_params(tmano.synthetic_mano_params(1, "cpu"))
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), t2n(tp[k]),
                                      err_msg=k)


def test_rot6d_and_rodrigues_match():
    rng = np.random.RandomState(0)
    r6 = rng.randn(7, 3, 2).astype(np.float32)
    np.testing.assert_allclose(
        t2n(tgeo.rot6d_to_matrix(torch.from_numpy(r6))),
        np.asarray(jgeo.rot6d_to_matrix(jnp.asarray(r6))), atol=1e-6)
    aa = rng.randn(5, 16, 3).astype(np.float32)
    aa[0, 0] = 0.0  # the clamped-norm branch
    np.testing.assert_allclose(
        t2n(tgeo.rodrigues(torch.from_numpy(aa))),
        np.asarray(jgeo.rodrigues(jnp.asarray(aa))), atol=1e-6)
    R = t2n(tgeo.rot6d_to_matrix(torch.from_numpy(r6)))
    np.testing.assert_array_equal(
        t2n(tgeo.matrix_to_rot6d(torch.from_numpy(R))), R[..., :2])


def test_transformation_and_projection_match():
    rng = np.random.RandomState(1)
    B = 3
    mesh = rng.randn(50, 3).astype(np.float32) * 0.05
    trans = (rng.randn(B, 1, 3) * 0.02 + [0, 0, 0.6]).astype(np.float32)
    r6 = rng.randn(B, 3, 2).astype(np.float32)
    scale = np.array([1.3], np.float32)
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    jR = jgeo.rot6d_to_matrix(jnp.asarray(r6))
    jv, jd = jcam.compute_transformation_persp(
        jnp.asarray(mesh), jnp.asarray(trans), jR, jnp.asarray(scale))
    tR = tgeo.rot6d_to_matrix(torch.from_numpy(r6))
    tv, td = tcam.compute_transformation_persp(
        torch.from_numpy(mesh), torch.from_numpy(trans), tR,
        torch.from_numpy(scale))
    np.testing.assert_allclose(t2n(tv), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(t2n(td), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(
        t2n(tcam.batch_proj2d(tv, torch.from_numpy(K))),
        np.asarray(jcam.batch_proj2d(jv, jnp.asarray(K))), atol=1e-6)
    np.testing.assert_array_equal(
        t2n(tcam.normalize_K(torch.from_numpy(K[0] * 128), 128)),
        np.asarray(jcam.normalize_K(jnp.asarray(K[0] * 128), 128)))


def test_det_twin_blocks_mesh_gradient():
    mesh = torch.randn(10, 3, dtype=torch.float32, requires_grad=True)
    trans = torch.zeros(2, 1, 3, requires_grad=True)
    _, det = tcam.compute_transformation_persp(mesh, trans)
    det.sum().backward()
    assert mesh.grad is None
    assert torch.equal(trans.grad, torch.full((2, 1, 3), 10.0))


def test_transformation_ortho_matches():
    rng = np.random.RandomState(2)
    B = 2
    mesh = rng.randn(B, 20, 3).astype(np.float32) * 0.05
    cams = np.abs(rng.randn(B, 3)).astype(np.float32) + 0.5
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    jv, jd = jcam.compute_transformation_ortho(
        jnp.asarray(mesh), jnp.asarray(cams), K=jnp.asarray(K),
        image_size=128)
    tv, td = tcam.compute_transformation_ortho(
        torch.from_numpy(mesh), torch.from_numpy(cams),
        K=torch.from_numpy(K), image_size=128)
    np.testing.assert_allclose(t2n(tv), np.asarray(jv), rtol=1e-5)
    np.testing.assert_allclose(t2n(td), np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("side", ["right", "left"])
def test_mano_forward_batched_matches(side):
    rng = np.random.RandomState(3)
    B = 4
    pca = (rng.randn(B, 16) * 0.5).astype(np.float32)
    rot = (rng.randn(B, 3) * 0.3).astype(np.float32)
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    jl = jmano.ManoLayer.synthetic(0)
    tl = tmano.ManoLayer.synthetic(0, device="cpu")
    jo = jl.forward_pca(jnp.asarray(pca), jnp.asarray(rot),
                        jnp.asarray(betas), side=side)
    to = tl.forward_pca(torch.from_numpy(pca), torch.from_numpy(rot),
                        torch.from_numpy(betas), side=side)
    np.testing.assert_allclose(t2n(to["hand_aa_pose"]),
                               np.asarray(jo["hand_aa_pose"]), atol=1e-6)
    np.testing.assert_allclose(t2n(to["verts"]), np.asarray(jo["verts"]),
                               atol=1e-5)
    np.testing.assert_allclose(t2n(to["joints"]), np.asarray(jo["joints"]),
                               atol=1e-5)
    np.testing.assert_allclose(
        t2n(tmano.add_tips_and_reorder(to["verts"], to["joints"])),
        np.asarray(jmano.add_tips_and_reorder(jo["verts"], jo["joints"])),
        atol=1e-5)
    np.testing.assert_array_equal(t2n(tl.faces(side)),
                                  np.asarray(jl.faces(side)))
