"""PyTorch port vs JAX package: the fit_video driver on cached detections
(--evidence_root), end to end on a synthetic HO-3D clip (CPU, same inputs).

The evidence tree is recorded once by the port's adapters
(chip_smoke.write_evidence_tree: the instance render's hand and object
masks cut to HO-3D's 480 x 640 frame, FrankMocap-layout hand estimates with
2 px of seeded noise on the 2D points). Both drivers replay it once per
module (3 frames, 24 stage-B candidates, 5 stage-B and 5 joint steps,
rend_size 64), each from its own folder: the JAX driver through its
get_dataset patched to the JAX HO3D dataset on the same tree, with its own
index cache. The port draws the JAX package's candidate rotations.

Bands: the assembled evidence equal (host numpy on both sides), K_roi
1e-6; stage-B poses atol 2e-3 and best IoU 1e-3 (the short-schedule band
of tests/test_torch_poseinit_search.py); the joint state within 3e-3 of
each array's maximum and every loss history within 1e-3 of its maximum
(stage B's differences carried through five joint steps).
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from homan_tpu.cli import fit_video as JF
from homan_tpu.core.mano import ManoLayer as JMano
from homan_tpu.data.ho3d import HO3D as JHO3D
from homan_tpu.frontend import cachedfit as jcf
from homan_tpu_torch.cli import fit_video as TF
from homan_tpu_torch.core.mano import ManoLayer as TMano
from homan_tpu_torch.data.ho3d import HO3D as THO3D
from homan_tpu_torch.frontend import cachedfit as tcf

from torch_port_common import (ho3d_kwargs, ho3d_tree, host_tree,
                               inject_jax_rotations)

CLIP = ["--frame_nb", "3", "--chunk_step", "1"]
ARGV = CLIP + ["--num_initializations", "24", "--num_obj_iterations", "5",
               "--num_joint_iterations", "5", "--rend_size", "64",
               "--prewarm", "0", "--viz_step", "0"]


def _load(folder):
    sample = os.path.join(folder, "samples", "00000000")
    with open(os.path.join(sample, "indep_fit.pkl"), "rb") as f:
        indep = host_tree(pickle.load(f))
    ck = np.load(os.path.join(sample, "joint_fit.npz"))
    with open(os.path.join(sample, "results.pkl"), "rb") as f:
        res = pickle.load(f)
    return indep, {k: ck[k] for k in ck.files}, res


def _jax_dataset(tree, cache):
    kw = dict(ho3d_kwargs(tree), cache_folder=cache)
    return JHO3D(frame_nb=3, chunk_step=1, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The evidence tree and both drivers on it: (jax outputs, port outputs,
    port summary, tree)."""
    import chip_smoke
    tree = ho3d_tree(tmp_path_factory.mktemp("ho3d_cached"), frames=6)
    jax_dir = str(tmp_path_factory.mktemp("ho3d_cached_jax"))
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(tree)
        chip_smoke.write_evidence_tree("ev", CLIP, device="cpu")
        ev = os.path.join(tree, "ev")
        inject_jax_rotations(mp)
        port = TF.main(TF.get_args(ARGV + ["--evidence_root", ev,
                                           "--result_root", "port"]),
                       device="cpu")

        mp.chdir(jax_dir)
        mp.setenv("HOMAN_TPU_DISABLE_PREWARM", "1")
        ds = _jax_dataset(tree, os.path.join(jax_dir, "cache"))
        import homan_tpu.data.factory as jfactory
        mp.setattr(jfactory, "get_dataset", lambda name, **kw: (ds, 640))

        def no_viz(*a, **k):
            raise RuntimeError("viz is not compared")

        from homan_tpu.viz import render_viz
        mp.setattr(render_viz, "visualize_hand_object", no_viz)
        JF.main(JF.get_args(ARGV + [
            "--evidence_root", ev, "--result_root", "jax", "--mano_root",
            os.path.join(tree, "extra_data", "mano")]))
        assert os.path.isdir(os.path.join(jax_dir, "cache"))
    finally:
        mp.undo()
    return (_load(os.path.join(jax_dir, "jax")),
            _load(os.path.join(tree, "port")), port, tree)


def test_cached_driver_writes_its_files_and_budgets(runs):
    import chip_smoke
    _, (indep, state, res), summary, _ = runs
    assert set(res) == {"opts", "metrics", "losses", "budgets"}
    b = summary[0]["budgets"]
    assert set(b) == {"stage_b", "stage_c"}  # no instance render here
    assert b["stage_b"]["edge_demand"] <= b["stage_b"]["edge_capacity"]
    assert [a["excess"] <= 0 for a in b["stage_c"]["attempts"]] == [True]
    assert "stageAB_evidence_poseinit" in summary[0]["timers"]
    for k, v in list(state.items()) + list(res["metrics"].items()):
        assert np.isfinite(np.asarray(v, np.float64)).all(), k
    pp = indep["person_parameters"]
    assert pp["masks"].shape == (3, 480, 640)
    assert indep["object_parameters"][0]["masks"].shape == (480, 640)
    assert all(isinstance(x, np.ndarray) for k, x in pp.items()
               if k != "hand_sides")
    expect = chip_smoke.driver_launches(TF.get_args(ARGV), b)
    assert expect["shade_fwd"] >= 5 and expect["voxelize"] == 2


def test_cached_evidence_matches_jax(runs):
    (ji, _, _), (ti, _, _), _, _ = runs
    jp, tp = ji["person_parameters"], ti["person_parameters"]
    for k in ("masks", "bboxes", "target_masks", "verts", "verts2d",
              "rotations", "translations", "mano_pca_pose", "mano_rot",
              "mano_trans", "mano_betas", "cams"):
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    np.testing.assert_allclose(tp["K_roi"], jp["K_roi"], atol=1e-6, rtol=0)
    assert ti["hand_sides"] == ji["hand_sides"] == tp["hand_sides"] == [
        "right"]
    np.testing.assert_array_equal(ti["obj_faces"], ji["obj_faces"])
    for jo, to in zip(ji["object_parameters"], ti["object_parameters"]):
        for k in ("masks", "full_mask", "target_masks"):
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        np.testing.assert_allclose(to["K_roi"], jo["K_roi"], atol=1e-6,
                                   rtol=0)
        for k in ("rotations", "translations", "verts_trans"):
            np.testing.assert_allclose(to[k], jo[k], atol=2e-3, rtol=0,
                                       err_msg=k)
        assert abs(to["best_iou"] - float(jo["best_iou"])) <= 1e-3


def test_cached_driver_fit_and_losses_match_jax(runs):
    (_, js, jres), (_, ts, tres), _, _ = runs
    assert set(ts) == set(js)
    for k in js:
        scale = max(np.abs(js[k]).max(), 1e-12)
        err = np.abs(ts[k] - js[k]).max() / scale
        assert err <= 3e-3, (k, err)
    assert set(tres["losses"]) == set(jres["losses"])
    for k, v in jres["losses"].items():
        v = np.asarray(v, np.float64)
        np.testing.assert_allclose(np.asarray(tres["losses"][k]), v,
                                   atol=1e-3 * max(np.abs(v).max(), 1e-12),
                                   rtol=0, err_msg=k)
    assert set(tres["metrics"]) == set(jres["metrics"])


def test_prepare_independent_fit_cached_matches_jax(runs, tmp_path,
                                                    monkeypatch):
    """Stages A and B alone on the 480 x 640 evidence, each package's
    function on its own dataset's clip, at 5 steps a frame."""
    *_, tree = runs
    args = TF.get_args(ARGV)
    ev = os.path.join(tree, "ev")
    inject_jax_rotations(monkeypatch)
    monkeypatch.setenv("HOMAN_TPU_DISABLE_PREWARM", "1")
    mano = os.path.join(tree, "extra_data", "mano")
    ta = THO3D(frame_nb=3, chunk_step=1, device="cpu",
               **dict(ho3d_kwargs(tree), cache_folder=str(tmp_path / "t")))[0]
    ja = _jax_dataset(tree, str(tmp_path / "j"))[0]
    ours = tcf.prepare_independent_fit_cached(
        ta, args, TMano.from_folder(mano, device="cpu"), 640, rend_size=64,
        evidence_root=ev, device="cpu")
    theirs = host_tree(jcf.prepare_independent_fit_cached(
        ja, args, JMano.from_folder(mano), 640, rend_size=64,
        evidence_root=ev))
    assert tcf.frame_key(ta["seq_idx"], 7) == jcf.frame_key(ja["seq_idx"], 7)
    for k in ("masks", "target_masks", "bboxes", "verts2d"):
        np.testing.assert_array_equal(ours["person_parameters"][k],
                                      theirs["person_parameters"][k])
    for jo, to in zip(theirs["object_parameters"],
                      ours["object_parameters"]):
        np.testing.assert_array_equal(to["target_masks"], jo["target_masks"])
        for k in ("rotations", "translations"):
            np.testing.assert_allclose(to[k], jo[k], atol=2e-3, rtol=0)
        assert abs(to["best_iou"] - float(jo["best_iou"])) <= 1e-3
        assert to["masks"].shape == (480, 640)
    sb = ours["budgets"]["stage_b"]
    assert sb["edge_demand"] <= sb["edge_capacity"] and sb["attempts"] == 1


def test_driver_needs_gt_masks_or_evidence_root(runs, monkeypatch):
    *_, tree = runs
    monkeypatch.chdir(tree)
    with pytest.raises(SystemExit, match="need --gt_masks 1 or "
                       "--evidence_root"):
        TF.main(TF.get_args(ARGV + ["--result_root", "neither"]),
                device="cpu")
