"""PyTorch port vs JAX package: the synthetic scene and the stage-C fit
(CPU, same inputs on both sides).

Bands (tests/test_jointopt_parity.py:300-339): losses at iteration 0 within
rtol 3e-4, the first 10 totals within rtol 3e-3, the final translations
within atol 2e-3 and the final rotations, compared as matrices (the rot6d
null space drifts apart), within atol 2e-3. The interaction and
ordinal-depth fits run a few steps on two frames: every step's total within
rtol 3e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

from homan_tpu.core import geometry as jgeo
from homan_tpu.fit import joint as JJ
from homan_tpu_torch.core import geometry as tgeo
from homan_tpu_torch.fit import joint as TJ

from homan_tpu_torch import convert
from torch_port_common import (depth_scene_pair, overlap_state, port_from_jax,
                               scene_pair, settings_pair, t2n, to_numpy)

ITERS = 25


def test_make_synthetic_scene_consts_equal():
    js, ts = scene_pair()
    jc = to_numpy(js.consts)
    for k in ("ref_mask_object", "keep_mask_object", "ref_mask_hand",
              "keep_mask_hand", "camintr", "camintr_rois_object",
              "camintr_rois_hand", "masks_object", "masks_hand",
              "verts_object_og"):
        np.testing.assert_array_equal(t2n(getattr(ts.consts, k)), jc[k],
                                      err_msg=k)
    assert jc["ref_mask_object"].sum() > 0 and jc["ref_mask_hand"].sum() > 0
    # MANO sums run in another order: float32 rounding only.
    np.testing.assert_allclose(t2n(ts.consts.verts_hand_og),
                               jc["verts_hand_og"], atol=1e-6)
    np.testing.assert_allclose(t2n(ts.consts.ref_verts2d_hand),
                               jc["ref_verts2d_hand"], atol=1e-4)
    for name in ("faces_object", "faces_hand"):
        for k in ("faces", "edges", "edge_faces", "edge_dir_f1"):
            np.testing.assert_array_equal(
                t2n(getattr(getattr(ts.consts, name), k)), jc[name][k])
    for k, v in to_numpy(js.init_state).items():
        np.testing.assert_allclose(t2n(getattr(ts.init_state, k)), v,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(t2n(ts.gt_verts_object),
                               np.asarray(js.gt_verts_object), atol=1e-6)


def test_make_synthetic_scene_full_masks_and_closed_faces():
    js, ts = depth_scene_pair()
    np.testing.assert_array_equal(t2n(ts.closed_hand_faces),
                                  np.asarray(js.closed_hand_faces))
    for k in ("masks_object", "masks_hand"):
        ours, theirs = t2n(getattr(ts.consts, k)), np.asarray(
            getattr(js.consts, k))
        assert ours.shape == theirs.shape == (2, 128, 128)
        assert theirs.sum() > 100
        # Soft silhouettes thresholded at 0.5: rounding may flip a pixel
        # on the boundary.
        assert (ours != theirs).mean() < 1e-3, k


def test_convert_carries_closed_faces():
    js, _ = scene_pair()
    faces = convert.faces_from_numpy(js.closed_hand_faces, "cpu")
    assert faces.dtype == torch.int64
    np.testing.assert_array_equal(t2n(faces), np.asarray(js.closed_hand_faces))


def test_optimize_hand_object_parity():
    js, _ = scene_pair()
    jset, tset = settings_pair(64, 32, 48)
    jf, jh = JJ.optimize_hand_object(js.init_state, js.consts, js.cfg,
                                     num_iterations=ITERS, roi_settings=jset)
    state, consts, cfg = port_from_jax(js)
    tf, th = TJ.optimize_hand_object(state, consts, cfg,
                                     num_iterations=ITERS, roi_settings=tset,
                                     device="cpu")
    assert set(th) == set(jh)
    for k in jh:
        assert th[k].shape == (ITERS,), k
        np.testing.assert_allclose(float(th[k][0]), float(jh[k][0]),
                                   rtol=3e-4, atol=1e-7, err_msg=f"iter0 {k}")
    np.testing.assert_allclose(t2n(th["loss"][:10]),
                               np.asarray(jh["loss"][:10]), rtol=3e-3)
    assert float(th["loss"][-1]) < 0.5 * float(th["loss"][0])
    for k in ("translations_object", "translations_hand"):
        np.testing.assert_allclose(t2n(getattr(tf, k)),
                                   np.asarray(getattr(jf, k)), atol=2e-3,
                                   err_msg=k)
    for k in ("rotations_object", "rotations_hand"):
        np.testing.assert_allclose(
            t2n(tgeo.rot6d_to_matrix(getattr(tf, k))),
            np.asarray(jgeo.rot6d_to_matrix(getattr(jf, k))), atol=2e-3,
            err_msg=k)
    # Frozen fields stay put.
    np.testing.assert_array_equal(t2n(tf.mano_rot), t2n(state.mano_rot))
    np.testing.assert_array_equal(t2n(tf.int_scales_hand),
                                  t2n(state.int_scales_hand))


@pytest.mark.parametrize("viz_step", [2, 3, 10])
def test_raster_schedule_and_viz_hook(viz_step):
    _, ts = scene_pair()
    _, s1 = settings_pair(64, 32, 48)
    _, s2 = settings_pair(64, 16, 48)
    schedule = [(4, s1), (3, s2)]
    seen = []
    _, hist = TJ.optimize_hand_object(
        ts.init_state, ts.consts, ts.cfg, raster_schedule=schedule,
        viz_step=viz_step, viz_callback=lambda n, s: seen.append(n),
        device="cpu")
    assert hist["loss"].shape == (7,)
    # The JAX package's chunking rule gives the callback points.
    expected, done = [], 0
    for iters, _ in schedule:
        for chunk in JJ._phase_chunks(iters, viz_step, with_viz=True):
            done += chunk
            if done < 7:
                expected.append(done)
    assert seen == expected


def _short_fit_parity(js, cfg, lw, iters, **kw):
    """A few steps of both fits from the JAX scene's data; every step's
    total within rtol 3e-3, iteration 0 per term within rtol 3e-4."""
    jset, tset = settings_pair(64, 32, 48)
    jcfg = dataclasses.replace(js.cfg, **cfg)
    jf, jh = JJ.optimize_hand_object(
        js.init_state, js.consts, jcfg, loss_weights=lw,
        num_iterations=iters, closed_hand_faces=js.closed_hand_faces,
        roi_settings=jset)
    state, consts, tcfg = port_from_jax(js)
    tcfg = dataclasses.replace(tcfg, **cfg)
    tf, th = TJ.optimize_hand_object(
        state, consts, tcfg, loss_weights=lw, num_iterations=iters,
        closed_hand_faces=convert.faces_from_numpy(js.closed_hand_faces,
                                                   "cpu"),
        roi_settings=tset, device="cpu", **kw)
    assert set(th) == set(jh)
    for k in jh:
        # Metrics are in pixels: 0 at a ground-truth hand up to rounding.
        atol = 1e-7 if k.startswith("loss") else 1e-5
        np.testing.assert_allclose(float(th[k][0]), float(jh[k][0]),
                                   rtol=3e-4, atol=atol, err_msg=f"iter0 {k}")
    np.testing.assert_allclose(t2n(th["loss"]), np.asarray(jh["loss"]),
                               rtol=3e-3)
    assert float(th["loss"][-1]) < float(th["loss"][0])
    return th


@pytest.mark.parametrize("sdf_mode,iters", [("grid", 2), ("direct", 10)])
def test_interaction_fit_parity(sdf_mode, iters):
    """The reference's step-2 recipe (collision 1e-3, contact 1) in both SDF
    modes; grid mode voxelizes both meshes every step."""
    js, _ = scene_pair()
    th = _short_fit_parity(js, {"sdf_mode": sdf_mode},
                           {"lw_collision": 1e-3, "lw_contact": 1.0}, iters)
    assert float(th["loss_contact"][0]) > 0


def test_ordinal_depth_fit_parity():
    """lw_depth 1 from a pose where the object overlaps the hand; the JAX
    fit's full-image default (faces_per_tile 256, which drops faces here)
    is what full_settings=None reproduces."""
    js, _ = depth_scene_pair()
    js = dataclasses.replace(js, init_state=overlap_state(js))
    th = _short_fit_parity(js, {}, {"lw_depth": 1.0}, 5)
    assert float(th["loss_depth"][0]) > 0
