"""PyTorch port vs JAX package: the fit_video driver on GT-mask evidence,
end to end on a synthetic HO-3D clip (CPU, same inputs).

Both drivers run once per module on the same tree (3 frames, 24 stage-B
candidates, 5 stage-B and 5 joint steps, rend_size 64). The port draws the
JAX package's candidate rotations (its `random_rotations` patched). The JAX
instance render is given the face budget the port measured at its tile 64
(its default 256 drops faces at this scene, tests/test_torch_hard.py); at
this size stage B's and stage C's edge budgets are the defaults on both
sides (the port's sizing keeps them, which the test checks).

Bands: instance masks and the targets equal; stage-B poses atol 2e-3 (the
short-schedule band of tests/test_torch_poseinit_search.py); hand evidence
atol 1e-5 (MANO in each framework), their boxes and 2D points 1e-3
pixels, K_roi 1e-6 (the hand's relative: its box moves with MANO); the whole driver's joint
state atol 2e-3 and its metrics rtol 2e-3 (stage B's differences carried
through five joint steps). Chained parts, each on the JAX driver's own
outputs: stage C atol 1e-4 after 5 steps, post_process 1e-5, the metrics
rtol 1e-5 (atol 1e-7).
"""
import functools
import os
import pickle
import types

import jax
import numpy as np
import pytest
import torch

from homan_tpu.cli import fit_video as JF
from homan_tpu.frontend import gtevidence as jgt
from homan_tpu.render import rasterizer as jr
from homan_tpu_torch.cli import fit_video as TF
from homan_tpu_torch.core.mano import ManoLayer
from homan_tpu_torch.fit import joint, postprocess
from homan_tpu_torch.frontend import gtevidence as tgt

from torch_port_common import ho3d_tree, host_tree, inject_jax_rotations

ARGV = ["--gt_masks", "1", "--frame_nb", "3", "--chunk_step", "1",
        "--num_initializations", "24", "--num_obj_iterations", "5",
        "--num_joint_iterations", "5", "--rend_size", "64", "--prewarm", "0",
        "--viz_step", "0"]


def _load(folder):
    sample = os.path.join(folder, "samples", "00000000")
    with open(os.path.join(sample, "indep_fit.pkl"), "rb") as f:
        indep = host_tree(pickle.load(f))
    ck = np.load(os.path.join(sample, "joint_fit.npz"))
    with open(os.path.join(sample, "results.pkl"), "rb") as f:
        res = pickle.load(f)
    with open(os.path.join(folder, "results.pkl"), "rb") as f:
        agg = pickle.load(f)
    return indep, {k: ck[k] for k in ck.files}, res, agg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers on one tree: (jax outputs, port outputs, port summary,
    tree). The JAX driver runs from a sibling folder that links the tree's
    data, so each driver builds its own frame-index cache (data/cache,
    relative to the working folder)."""
    tree = ho3d_tree(tmp_path_factory.mktemp("ho3d_driver"), frames=6)
    jax_cwd = str(tmp_path_factory.mktemp("ho3d_driver_jax"))
    for name in ("local_data", "extra_data"):
        os.symlink(os.path.join(tree, name), os.path.join(jax_cwd, name))
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(tree)
        mp.setenv("HOMAN_TPU_DISABLE_PREWARM", "1")
        inject_jax_rotations(mp)
        port = TF.main(TF.get_args(ARGV + ["--result_root", "port"]),
                       device="cpu")
        kf = port[0]["budgets"]["instance_masks"]["face_demand"][64]
        mp.setattr(jgt, "RasterSettings", functools.partial(
            jr.RasterSettings, faces_per_tile=kf))

        def no_viz(*a, **k):
            raise RuntimeError("viz is not compared")

        from homan_tpu.viz import render_viz
        mp.setattr(render_viz, "visualize_hand_object", no_viz)
        mp.chdir(jax_cwd)
        JF.main(JF.get_args(ARGV + ["--result_root",
                                    os.path.join(tree, "jax")]))
        assert os.path.exists(os.path.join(jax_cwd, "data", "cache"))
    finally:
        mp.undo()
    return (_load(os.path.join(tree, "jax")),
            _load(os.path.join(tree, "port")), port, tree)


def test_driver_writes_its_files_and_budgets(runs):
    _, (indep, state, res, agg), summary, _ = runs
    assert set(res) == {"opts", "metrics", "losses", "budgets"}
    b = summary[0]["budgets"]
    assert b["instance_masks"]["faces_per_tile"] == b["instance_masks"][
        "face_demand"][b["instance_masks"]["tile_px"]]
    assert b["instance_masks"]["face_demand"][64] > 256
    assert (b["stage_b"]["tile_px"], b["stage_b"]["edges_per_tile"]) == (
        64, 64)
    assert b["stage_b"]["edge_demand"] <= b["stage_b"]["edge_capacity"]
    assert b["stage_c"]["sized"] == {"tile_px": 64, "edges_per_tile": 64}
    assert [a["excess"] <= 0 for a in b["stage_c"]["attempts"]] == [True]
    for k, v in state.items():
        assert isinstance(v, np.ndarray) and np.isfinite(v).all(), k
    for k, v in res["metrics"].items():
        assert np.isfinite(np.asarray(v, np.float64)).all(), k
    assert agg["metrics"].keys() == res["metrics"].keys()
    assert all(isinstance(x, np.ndarray) for x in
               indep["person_parameters"].values())


def test_driver_evidence_matches_jax(runs):
    (ji, _, _, _), (ti, _, _, _), _, _ = runs
    jp, tp = ji["person_parameters"], ti["person_parameters"]
    np.testing.assert_array_equal(tp["masks"], jp["masks"])
    np.testing.assert_array_equal(tp["target_masks"], jp["target_masks"])
    # The GT hand box is the extent of MANO's projected vertices.
    np.testing.assert_allclose(tp["bboxes"], jp["bboxes"], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(tp["K_roi"], jp["K_roi"], atol=1e-6,
                               rtol=1e-6)
    for k in ("verts", "rotations", "translations", "mano_pca_pose",
              "mano_rot", "mano_trans", "mano_betas"):
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(tp["verts2d"], jp["verts2d"], atol=1e-3,
                               rtol=0)
    assert ti["hand_sides"] == ji["hand_sides"] == ["right"]
    np.testing.assert_array_equal(ti["obj_faces"], ji["obj_faces"])
    for jo, to in zip(ji["object_parameters"], ti["object_parameters"]):
        np.testing.assert_array_equal(to["masks"], jo["masks"])
        np.testing.assert_array_equal(to["target_masks"], jo["target_masks"])
        np.testing.assert_allclose(to["K_roi"], jo["K_roi"], atol=1e-6,
                                   rtol=0)
        for k in ("rotations", "translations", "verts_trans"):
            np.testing.assert_allclose(to[k], jo[k], atol=2e-3, rtol=0,
                                       err_msg=k)
        assert abs(to["best_iou"] - float(jo["best_iou"])) <= 1e-3


def test_driver_fit_and_metrics_match_jax(runs):
    (_, js, jr_, _), (_, ts, tr_, _), _, _ = runs
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=2e-3, rtol=0,
                                   err_msg=k)
    assert set(tr_["metrics"]) == set(jr_["metrics"])
    for k, v in jr_["metrics"].items():
        np.testing.assert_allclose(np.asarray(tr_["metrics"][k], np.float64),
                                   np.asarray(v, np.float64), rtol=2e-3,
                                   atol=1e-6, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_chain_inputs(tree):
    """The JAX driver's indep payload, the port's stage-C inputs built from
    it, and the JAX driver's final state."""
    with open(os.path.join(tree, "jax", "samples", "00000000",
                           "indep_fit.pkl"), "rb") as f:
        indep = host_tree(pickle.load(f))
    mano = ManoLayer.from_folder(os.path.join(tree, "extra_data", "mano"),
                                 device="cpu")
    from homan_tpu_torch.data.ho3d import HO3D
    cwd = os.getcwd()
    try:
        os.chdir(tree)
        annots = HO3D(frame_nb=3, chunk_step=1, device="cpu")[0]
    finally:
        os.chdir(cwd)
    K = np.asarray(annots["camera"]["K"], np.float64).copy()
    K[:, :2] /= 640
    inputs = TF.build_joint_inputs(
        indep["person_parameters"], indep["object_parameters"],
        indep["obj_verts_can"], indep["obj_faces"], K, indep["hand_sides"],
        mano, 640, 64, (640, 640), device="cpu")
    return inputs, annots


def test_stage_c_on_the_jax_evidence_matches_jax(runs):
    (_, js, _, _), _, _, tree = runs
    (state, consts, cfg), _ = _jax_chain_inputs(tree)
    args = TF.get_args(ARGV)
    lw = {k: v for k, v in vars(args).items() if k.startswith("lw_")}
    lw.pop("lw_smooth")
    final, hist = joint.optimize_hand_object(
        state, consts, cfg, loss_weights=lw, num_iterations=5, device="cpu")
    ours = postprocess.state_to_dict(final)
    for k in js:
        np.testing.assert_allclose(ours[k], js[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert float(hist["edge_budget_excess"].max()) <= 0


def test_metrics_on_the_jax_fit_match_jax(runs):
    (_, js, jres, _), _, _, tree = runs
    (state, consts, cfg), annots = _jax_chain_inputs(tree)
    final = postprocess.state_from_dict(js, device="cpu")
    ours = TF._sample_metrics(annots, state, final, consts, cfg, "cpu")
    ours.update({f"final_{k}": [v[-1]] for k, v in jres["losses"].items()})
    assert set(ours) == set(jres["metrics"])
    for k, v in jres["metrics"].items():
        np.testing.assert_allclose(np.asarray(ours[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_only_missing_skips_and_resume_refits_from_the_checkpoint(runs):
    _, (_, state, _, _), _, tree = runs
    cwd = os.getcwd()
    try:
        os.chdir(tree)
        assert TF.main(TF.get_args(ARGV + ["--result_root", "port",
                                           "--only_missing", "1"]),
                       device="cpu") == []
        out = TF.main(TF.get_args(ARGV + [
            "--result_root", "resumed", "--resume", "port",
            "--num_joint_iterations", "1"]), device="cpu")
    finally:
        os.chdir(cwd)
    assert "stageAB_evidence_poseinit" not in out[0]["timers"]
    assert not os.path.exists(os.path.join(
        tree, "resumed", "samples", "00000000", "indep_fit.pkl"))
    resumed = np.load(os.path.join(tree, "resumed", "samples", "00000000",
                                   "joint_fit.npz"))
    # One more step from the checkpoint moves it, but only a step's worth.
    moved = np.abs(resumed["translations_object"]
                   - state["translations_object"]).max()
    assert 0 < moved < 0.05


@pytest.mark.parametrize("flag,item", [
    pytest.param(["--frames_sharded", "1"], "item 19", id="flag1-item 19"),
    pytest.param(["--collision_mode", "tritri"], "item 17",
                 id="flag2-item 17")])
def test_unported_flags_raise_naming_their_item(flag, item, runs, caplog):
    """Both flags once refused are ported; nothing raises any more.
    --collision_mode tritri (item 17) runs in tests/test_torch_intersect.py.
    --frames_sharded 1 (item 19) on one device logs the JAX driver's
    warning and fits unsharded: the same joint state as the module's run."""
    args = TF.get_args(ARGV + flag)
    if item == "item 17":
        assert args.collision_mode == "tritri"
        return
    _, (_, state, _, _), _, tree = runs
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(tree)
        inject_jax_rotations(mp)
        with caplog.at_level("WARNING"):
            TF.main(TF.get_args(ARGV + flag + ["--result_root", "sharded"]),
                    device="cpu")
    finally:
        mp.undo()
    assert "don't split over the available devices" in caplog.text
    sharded = np.load(os.path.join(tree, "sharded", "samples", "00000000",
                                   "joint_fit.npz"))
    for k, v in state.items():
        np.testing.assert_array_equal(sharded[k], v, err_msg=k)


def test_flags_and_defaults_match_jax():
    ours, theirs = vars(TF.get_args([])), vars(JF.get_args([]))
    assert ours == theirs
    assert (ours["num_initializations"], ours["num_obj_iterations"],
            ours["num_joint_iterations"], ours["rend_size"]) == (500, 50,
                                                                 201, 256)


def test_edge_overflow_mid_fit_is_recovered_by_the_ladder(runs, monkeypatch):
    """A stage-C fit whose edge budget overflows (Ke 8 from the sizing) is
    discarded and fitted again at the bumped budget; the kept fit has no
    excess."""
    _, _, _, tree = runs
    import homan_tpu_torch.render.rasterizer as R
    monkeypatch.setattr(TF, "auto_edge_settings", lambda *a, **k:
                        R.RasterSettings(64, edges_per_tile=8))
    monkeypatch.chdir(tree)
    out = TF.main(TF.get_args(ARGV + ["--result_root", "ladder", "--resume",
                                      "port", "--resume_indep"]),
                  device="cpu")
    attempts = out[0]["budgets"]["stage_c"]["attempts"]
    assert len(attempts) == 2 and attempts[0]["edges_per_tile"] == 8
    assert attempts[0]["excess"] > 0 >= attempts[1]["excess"]
    assert attempts[1]["edges_per_tile"] == R.bump_edge_settings(
        R.RasterSettings(64, edges_per_tile=8),
        int(attempts[0]["excess"]) + 8).edges_per_tile
    with open(os.path.join(tree, "ladder", "samples", "00000000",
                           "results.pkl"), "rb") as f:
        assert max(pickle.load(f)["losses"]["edge_budget_excess"]) <= 0


def test_stage_b_search_is_rerun_when_its_renders_overflow(runs,
                                                           monkeypatch):
    """search_object_poses with an edge budget below the search's demand
    (Ke 8) searches again at the bumped budget and reports it."""
    _, (ti, _, _, _), _, tree = runs
    import homan_tpu_torch.render.rasterizer as R
    from homan_tpu_torch.fit import poseinit
    monkeypatch.setattr(poseinit, "search_edge_settings",
                        lambda *a, **k: (R.RasterSettings(
                            64, edges_per_tile=8), {}))
    inject_jax_rotations(monkeypatch)
    ann = []
    from homan_tpu_torch.frontend.evidence import build_object_mask_info
    for o in ti["object_parameters"]:
        info = build_object_mask_info(o["masks"], tgt.mask_to_bbox(
            o["masks"]), None, 64)
        ann.append(info)
    args = types.SimpleNamespace(num_initializations=8, num_obj_iterations=2,
                                 seed=0)
    found, budget = tgt.search_object_poses(
        ti["obj_verts_can"], ti["obj_faces"], ann,
        [np.array([[614.0, 0, 320], [0, 614, 240], [0, 0, 1]])] * len(ann),
        640, args, 64, torch.device("cpu"))
    assert budget["attempts"] == 2 and budget["edges_per_tile"] > 8
    assert budget["edge_demand"] <= budget["edge_capacity"]
    assert len(found) == len(ann) and found[0]["edge_demand"] > 8
