"""PyTorch port vs JAX package: the library functions no path of the port
calls (bbox, geometry, camera, meshes, MANO, contact), each against its
JAX twin on the same numpy inputs, and the port's profiling helpers (CPU).

Bands: numpy code equal bit for bit; float32 tensor code within 1e-6
(1e-5 for the arccos near 0 and pi of matrix_to_axis_angle).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from homan_tpu.core import bbox as jbbox
from homan_tpu.core import camera as jcam
from homan_tpu.core import geometry as jgeo
from homan_tpu.core import mano as jmano
from homan_tpu.core import meshes as jmeshes
from homan_tpu.interactions import contact as jcontact
from homan_tpu_torch.core import bbox as tbbox
from homan_tpu_torch.core import camera as tcam
from homan_tpu_torch.core import geometry as tgeo
from homan_tpu_torch.core import mano as tmano
from homan_tpu_torch.core import meshes as tmeshes
from homan_tpu_torch.interactions import contact as tcontact
from homan_tpu_torch import utils_profiling as tprof

from torch_port_common import t2n

RNG = np.random.RandomState(0)


def _boxes(n, seed=0):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-20, 100, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(1, 80, (n, 2))], 1)


@pytest.mark.parametrize("mode", ["wh", "xy"])
def test_make_bbox_valid(mode):
    boxes = _boxes(16)
    if mode == "wh":
        boxes = jbbox.bbox_xy_to_wh(boxes)
    np.testing.assert_array_equal(
        tbbox.make_bbox_valid(boxes, 90, 70, bbox_mode=mode),
        jbbox.make_bbox_valid(boxes, 90, 70, bbox_mode=mode))


def test_check_overlap_area_iou():
    a, b = _boxes(32, 1), _boxes(32, 2)
    for x, y in zip(a, b):
        assert tbbox.check_overlap(x, y) == jbbox.check_overlap(x, y)
    assert any(tbbox.check_overlap(x, y) for x, y in zip(a, b))
    assert not all(tbbox.check_overlap(x, y) for x, y in zip(a, b))
    np.testing.assert_array_equal(tbbox.compute_area(a),
                                  jbbox.compute_area(a))
    np.testing.assert_array_equal(tbbox.compute_iou(a, b),
                                  jbbox.compute_iou(a, b))


def _rotations(n, seed=0):
    rng = np.random.RandomState(seed)
    aa = rng.randn(n, 3)
    aa *= rng.uniform(0, np.pi, (n, 1)) / np.linalg.norm(aa, axis=1,
                                                          keepdims=True)
    aa[:3] *= [[0.0], [1e-7], [1e-3]]  # identity and the small-angle series
    return aa.astype(np.float32)


def test_matrix_to_axis_angle():
    R = np.array(jgeo.rodrigues(jnp.asarray(_rotations(64))))
    ours = t2n(tgeo.matrix_to_axis_angle(torch.from_numpy(R)))
    np.testing.assert_allclose(ours, np.asarray(
        jgeo.matrix_to_axis_angle(jnp.asarray(R))), atol=1e-5)
    # and it inverts rodrigues away from pi
    np.testing.assert_allclose(ours[3:], _rotations(64)[3:], atol=1e-3)


@pytest.mark.parametrize("flip_y", [True, False])
def test_center_vertices(flip_y):
    v, f = tmeshes.bumpy_potato(1, 0.3, seed=1)
    jv, jf = jgeo.center_vertices(jnp.asarray(v + 0.2), jnp.asarray(f),
                                  flip_y=flip_y)
    tv, tf = tgeo.center_vertices(torch.from_numpy(v + 0.2),
                                  torch.from_numpy(f.astype(np.int64)),
                                  flip_y=flip_y)
    np.testing.assert_allclose(t2n(tv), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(t2n(tf), np.asarray(jf))


@pytest.mark.parametrize("shift", [0.0, 0.05, -0.4, 0.4])
def test_compute_dist_z(shift):
    a = RNG.randn(30, 3).astype(np.float32) * 0.1
    b = a[::-1].copy() * 0.5 + np.array([0, 0, shift], np.float32)
    j = float(jgeo.compute_dist_z(jnp.asarray(a), jnp.asarray(b)))
    t = float(tgeo.compute_dist_z(torch.from_numpy(a), torch.from_numpy(b)))
    assert t == pytest.approx(j, abs=1e-7)
    assert (t == 0.0) == (abs(shift) < 0.1)


def test_combine_verts():
    parts = [RNG.randn(2, n, 3).astype(np.float32) for n in (5, 7)]
    parts.append(RNG.randn(2 * 4, 3).astype(np.float32))  # (B V) rows
    j = jgeo.combine_verts([jnp.asarray(p) for p in parts])
    t = tgeo.combine_verts([torch.from_numpy(p) for p in parts])
    np.testing.assert_array_equal(t2n(t), np.asarray(j))


def test_project_points():
    v = (RNG.randn(3, 50, 3) * 0.1 + [0, 0, 0.6]).astype(np.float32)
    K = np.tile(np.array([[500, 0, 320], [0, 480, 240], [0, 0, 1]],
                         np.float32), (3, 1, 1))
    j = jcam.project_points(jnp.asarray(v), jnp.asarray(K))
    t = tcam.project_points(torch.from_numpy(v), torch.from_numpy(K))
    np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=1e-6)


def test_get_K_crop_resize():
    K = np.tile(np.array([[500, 2, 320], [0, 480, 240], [0, 0, 1]],
                         np.float32), (4, 1, 1))
    boxes = _boxes(4, 3).astype(np.float32)
    j = np.asarray(jcam.get_K_crop_resize(jnp.asarray(K), jnp.asarray(boxes),
                                          256))
    t = t2n(tcam.get_K_crop_resize(torch.from_numpy(K),
                                   torch.from_numpy(boxes), 256))
    np.testing.assert_allclose(t, j, rtol=1e-6)
    np.testing.assert_allclose(t, tcam.get_K_crop_resize_np(K, boxes, 256),
                               rtol=1e-6)


def test_compute_K_roi():
    for ul, b, size in (((10.0, 20.0), 64.0, 640), ((-5.5, 3.0), 200.0, 480)):
        np.testing.assert_allclose(
            t2n(tcam.compute_K_roi(ul, b, size, device="cpu")),
            np.asarray(jcam.compute_K_roi(ul, b, size)), rtol=1e-6)


def test_local_to_global_cam():
    boxes = _boxes(6, 4).astype(np.float32)
    cams = np.stack([RNG.uniform(0.5, 2, 6), RNG.randn(6) * 0.1,
                     RNG.randn(6) * 0.1], 1).astype(np.float32)
    j = jcam.local_to_global_cam(jnp.asarray(boxes), jnp.asarray(cams), 640.0)
    t = tcam.local_to_global_cam(torch.from_numpy(boxes),
                                 torch.from_numpy(cams), 640.0)
    np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("box_mesh", ()), ("box_mesh", ((0.3, 0.5, 0.7),)),
    ("cylinder_mesh", ()), ("cylinder_mesh", (0.2, 0.6, 9))])
def test_procedural_meshes(name, args):
    jv, jf = getattr(jmeshes, name)(*args)
    tv, tf = getattr(tmeshes, name)(*args)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype


@pytest.mark.parametrize("target", [2000, 300, 80, 10])
def test_decimate(target):
    v, f = tmeshes.bumpy_potato(3, 0.08, seed=2)
    jv, jf = jmeshes.decimate(v, f, target)
    tv, tf = tmeshes.decimate(v, f, target)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_pad_mesh():
    v, f = tmeshes.bumpy_potato(1, 0.3, seed=2)
    jv, jf = jmeshes.pad_mesh(v, f, v.shape[0] + 9, f.shape[0] + 11)
    tv, tf = tmeshes.pad_mesh(v, f, v.shape[0] + 9, f.shape[0] + 11)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("is_left", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_axis_angle_to_pca(is_left, flat):
    jparams = jmano.synthetic_mano_params(0)
    tparams = tmano.synthetic_mano_params(0, device="cpu")
    aa = (RNG.randn(5, 45) * 0.3).astype(np.float32)
    j = jmano.axis_angle_to_pca(jparams, jnp.asarray(aa), ncomps=12,
                                is_left=is_left, flat_hand_mean=flat)
    t = tmano.axis_angle_to_pca(tparams, torch.from_numpy(aa), ncomps=12,
                                is_left=is_left, flat_hand_mean=flat)
    np.testing.assert_allclose(t2n(t), np.asarray(j), atol=1e-6)
    # the full basis inverts pca_to_axis_angle
    pca = tmano.axis_angle_to_pca(tparams, torch.from_numpy(aa), ncomps=45,
                                  is_left=is_left, flat_hand_mean=flat)
    back = tmano.pca_to_axis_angle(tparams, pca, is_left=is_left,
                                   flat_hand_mean=flat)
    np.testing.assert_allclose(t2n(back), aa, atol=1e-5)


def test_thresh_contact_iou():
    gt = RNG.uniform(0, 12, (4, 100)).astype(np.float32)
    pred = gt + RNG.randn(4, 100).astype(np.float32) * 2
    pred[3] = 50.0  # an empty prediction at every threshold
    ji, ja = jcontact.thresh_contact_iou(jnp.asarray(gt), jnp.asarray(pred))
    ti, ta = tcontact.thresh_contact_iou(torch.from_numpy(gt),
                                         torch.from_numpy(pred))
    np.testing.assert_allclose(t2n(ti), np.asarray(ji), atol=1e-6)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)


def test_measure_duty_cycle_on_the_cpu(tmp_path):
    """On the CPU the window holds no device event: wall time only, and
    the Chrome trace is written where asked."""
    x = torch.randn(64, 64)
    stats = tprof.measure_duty_cycle(lambda: x @ x, log_dir=str(tmp_path))
    assert set(stats) == {"wall_s"} and stats["wall_s"] > 0
    assert (tmp_path / "trace.json").exists()
    with tprof.profile_trace() as prof:
        x @ x
    assert tprof.parse_trace_device_time(prof) is None


def test_measure_duty_cycle_raises_on_profiler_failure(monkeypatch):
    """Unlike the JAX package's, a failing profiler raises: a wall time is
    not reported as a duty cycle."""
    import contextlib

    @contextlib.contextmanager
    def broken(log_dir=None):
        raise RuntimeError("profiler unavailable")
        yield

    monkeypatch.setattr(tprof, "profile_trace", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        tprof.measure_duty_cycle(lambda: None)
