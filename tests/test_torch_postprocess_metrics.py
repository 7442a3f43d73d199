"""PyTorch port vs JAX package: the GT path's hand alignment and targets,
postprocess, the point and interaction metrics, and the stage timers (CPU,
same inputs).

Bands: targets, square boxes and interpolation exact; K_roi, Procrustes
and the object-vertex getter 1e-6; post_process and the point, aligned and
interaction metrics 1e-5 (the interaction metrics voxelize the object:
the plain version of the voxelizer kernel here).
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.eval import pointmetrics as jpm
from homan_tpu.fit import model as JM
from homan_tpu.fit import postprocess as jpp
from homan_tpu.frontend import gtevidence as jgt
from homan_tpu.frontend import masks as jmasks
from homan_tpu_torch.eval import pointmetrics as tpm
from homan_tpu_torch.fit import model as TM
from homan_tpu_torch.fit import postprocess as tpp
from homan_tpu_torch.frontend import gtevidence as tgt
from homan_tpu_torch.frontend import masks as tmasks
from homan_tpu_torch.utils_profiling import StageTimers

from torch_port_common import port_from_jax, scene_pair, t2n, to_numpy


def test_procrustes_rigid_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.randn(50, 3).astype(np.float32)
    a = rng.randn(3)
    R = np.linalg.qr(rng.randn(3, 3))[0]
    R *= np.sign(np.linalg.det(R))
    dst = (src @ R + a + 0.001 * rng.randn(50, 3)).astype(np.float32)
    tR, tt = tgt.procrustes_rigid(src, dst)
    jR, jt = jgt.procrustes_rigid(src, dst)
    np.testing.assert_allclose(tR, jR, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt, jt, atol=1e-6, rtol=0)
    np.testing.assert_allclose(src @ tR + tt, dst, atol=0.01)


@pytest.mark.parametrize("per_row", [False, True])
def test_add_target_hand_occlusions_matches_jax(per_row):
    rng = np.random.RandomState(1)
    B, H, W = 3, 96, 128
    yy, xx = np.mgrid[:H, :W]
    hands = np.stack([((xx - 40 - 10 * i) ** 2 + (yy - 50) ** 2 < 400)
                      for i in range(B)]).astype(np.float32)
    obj = ((xx - 60) ** 2 / 900 + (yy - 45) ** 2 / 300 < 1).astype(
        np.float32)
    boxes = np.stack([tgt.mask_to_bbox(m) for m in hands])
    K = np.array([[110.0, 0, 64], [0, 110, 48], [0, 0, 1]], np.float32)
    if per_row:
        obj = np.stack([np.roll(obj, i, axis=1) for i in range(B)])
        K = np.tile(K[None], (B, 1, 1)) + rng.rand(B, 3, 3).astype(
            np.float32) * np.array([[1, 0, 1], [0, 1, 1], [0, 0, 0]],
                                   np.float32)
    kw = dict(square_expand=0.1, rend_size=32)
    ours = tmasks.add_target_hand_occlusions(
        {"bboxes": boxes, "masks": hands}, {"full_mask": obj}, K, **kw)
    theirs = jmasks.add_target_hand_occlusions(
        {"bboxes": boxes, "masks": hands}, {"full_mask": obj}, K, **kw)
    np.testing.assert_array_equal(ours["target_masks"],
                                  theirs["target_masks"])
    assert {-1.0, 0.0, 1.0} <= set(np.unique(ours["target_masks"]))
    np.testing.assert_array_equal(ours["square_bboxes"],
                                  theirs["square_bboxes"])
    np.testing.assert_allclose(ours["K_roi"], np.asarray(theirs["K_roi"]),
                               atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def fitted():
    """The shared synthetic scene at its ground truth (the fit's state) and
    its initial state, both packages."""
    js, _ = scene_pair()
    state, consts, cfg = port_from_jax(js)
    gt = TM.HomanState(**{k: torch.as_tensor(np.asarray(v)) for k, v in
                          to_numpy(js.gt_state).items()})
    return js, state, gt, consts, cfg


def test_state_dicts_round_trip(fitted):
    js, state, _, _, _ = fitted
    d = tpp.state_to_dict(state)
    assert all(isinstance(v, np.ndarray) for v in d.values())
    assert set(d) == set(jpp.state_to_dict(js.init_state))
    back = tpp.state_from_dict(d)
    for k, v in vars(back).items():
        assert torch.equal(v, getattr(state, k)), k
    d.pop("cams_hand")
    old = tpp.state_from_dict(d)
    assert old.cams_hand.shape == (state.rotations_hand.shape[0], 3)
    assert not old.cams_hand.any()


@pytest.mark.parametrize("optimize_mano", [True, False])
def test_post_process_matches_jax(fitted, optimize_mano):
    js, state, _, consts, cfg = fitted
    cfg = dataclasses.replace(cfg, optimize_mano=optimize_mano)
    jcfg = dataclasses.replace(js.cfg, optimize_mano=optimize_mano)
    ours = tpp.post_process(state, consts.mano_params_by_side,
                            consts.verts_object_og, cfg,
                            verts_hand_og=consts.verts_hand_og)
    theirs = jpp.post_process(js.init_state, js.consts.mano_params_by_side,
                              js.consts.verts_object_og, jcfg,
                              verts_hand_og=js.consts.verts_hand_og)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(t2n(ours[k]), np.asarray(theirs[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_get_verts_object_parts_matches_jax(fitted):
    js, state, _, consts, _ = fitted
    ours, _ = TM.get_verts_object_parts(
        state.rotations_object, state.translations_object,
        state.int_scales_object, consts.verts_object_og)
    s = js.init_state
    theirs, _ = JM.get_verts_object_parts(
        s.rotations_object, s.translations_object, s.int_scales_object,
        js.consts.verts_object_og)
    np.testing.assert_allclose(t2n(ours), np.asarray(theirs), atol=1e-6,
                               rtol=0)
    same, _ = TM.get_verts_object(state, consts)
    assert torch.equal(same, ours)


def _metric_inputs(fitted):
    """(gt, prediction) pairs of hand and object vertices: the scene's
    ground truth against its initial state."""
    js, state, gt, consts, cfg = fitted
    pred = tpp.post_process(state, consts.mano_params_by_side,
                            consts.verts_object_og, cfg)
    true = tpp.post_process(gt, consts.mano_params_by_side,
                            consts.verts_object_og, cfg)
    return true, pred, consts


def _close(ours, theirs):
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64),
                                   np.asarray(theirs[k], np.float64),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_point_and_align_metrics_match_jax(fitted):
    true, pred, _ = _metric_inputs(fitted)
    j = {k: jnp.asarray(t2n(v)) for k, v in true.items()}
    p = {k: jnp.asarray(t2n(v)) for k, v in pred.items()}
    for key in ("verts_object", "verts_hand"):
        _close(tpm.get_point_metrics(true[key], pred[key]),
               jpm.get_point_metrics(j[key], p[key]))
    ours = tpm.get_align_metrics(true["verts_hand"], pred["verts_hand"],
                                 true["verts_object"], pred["verts_object"])
    _close(ours, jpm.get_align_metrics(j["verts_hand"], p["verts_hand"],
                                       j["verts_object"], p["verts_object"]))
    assert len(ours["hand_mean_aligned"]) == true["verts_hand"].shape[0]
    for f in (tpm.chamfer_distance, tpm.add_s, tpm.verts_dists):
        assert float(f(true["verts_object"], true["verts_object"]).max()) \
            < 1e-4


def test_inter_metrics_match_jax(fitted):
    _, pred, consts = _metric_inputs(fitted)
    js = fitted[0]
    vh = pred["verts_hand"].reshape(pred["verts_object"].shape[0], -1, 3)
    # Push the hand into the object so some frames penetrate.
    vh = vh + (pred["verts_object"].mean(1, keepdim=True)
               - vh.mean(1, keepdim=True)) * 0.8
    ours = tpm.get_inter_metrics(vh, pred["verts_object"], consts.faces_hand,
                                 consts.faces_object)
    theirs = jpm.get_inter_metrics(
        jnp.asarray(t2n(vh)), jnp.asarray(t2n(pred["verts_object"])),
        js.consts.faces_hand, js.consts.faces_object)
    _close({"pen_depths": ours["pen_depths"]},
           {"pen_depths": theirs["pen_depths"]})
    assert ours["has_contact"] == theirs["has_contact"]
    assert any(ours["has_contact"]) and max(ours["pen_depths"]) > 0
    faces = t2n(consts.faces_object.faces)
    again = tpm.get_inter_metrics(vh, pred["verts_object"], None, faces)
    assert again == ours


def test_interpolate_sequence_matches_jax():
    frames = np.array([0, 4, 10])
    vals = np.random.RandomState(2).randn(3, 2, 3)
    full = np.arange(12)
    np.testing.assert_array_equal(
        tpm.interpolate_sequence(frames, vals, full),
        jpm.interpolate_sequence(frames, vals, full))


def test_stage_timers_accumulate_and_report():
    timers = StageTimers()
    for _ in range(2):
        with timers.time("a"):
            time.sleep(0.01)
    with timers.time("b", sync=True):
        pass
    assert timers.counts == {"a": 2, "b": 1}
    assert timers.totals["a"] >= 0.02
    lines = timers.report().splitlines()
    assert lines[0].startswith("a ") and "x2" in lines[0]
    assert lines[1].startswith("b ")
