"""PyTorch port vs JAX package: the HO-3D evaluation (cli/eval_ho3d.py) and
the HTML report (eval/report.py), on the CPU.

The fabricated two-sequence tree of tests/test_cli_track_eval_report.py:79
(chunked fits of a linear motion, one seen and one unseen sequence), here
with the ground truth moved off the fit by a seeded offset so every metric
is non-zero, goes through both packages' evaluate_results. Bands: the
summary and every per-frame metric within 1e-5 relative; pred.json equal
after its own 4-decimal rounding but where a value sits within float
rounding of a rounding boundary (at most 1e-4 apart); the report HTML
byte-equal.
"""
import argparse
import json
import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.cli import eval_ho3d as JE
from homan_tpu.core.mano import ManoLayer as JManoLayer
from homan_tpu.core.meshes import bumpy_potato
from homan_tpu.eval import report as jreport
from homan_tpu.fit import model as JM
from homan_tpu.fit import postprocess as jpost
from homan_tpu_torch.cli import eval_ho3d as TE
from homan_tpu_torch.core.mano import ManoLayer as TManoLayer
from homan_tpu_torch.eval import report as treport

import torch_port_common  # noqa: F401  (thread cap)

FULL_T = 6  # full sequence length; chunks cover frames {0, 2, 3, 5}
CHUNKS = [("SM1", [0, 2]), ("SM1", [3, 5]), ("AP10", [0, 2]),
          ("AP10", [3, 5])]


def _full_state(seed):
    """Linear per-frame motion: chunk -> full-rate interpolation is
    exact."""
    rng = np.random.RandomState(seed)
    t0, dt = rng.randn(3) * 0.02, rng.randn(3) * 0.01
    tt = np.arange(FULL_T)[:, None]
    return JM.init_state(
        JM.HomanConfig(hand_sides=("right",)),
        translations_object=(np.array([[0, 0, 0.5]]) + t0 + tt * dt
                             )[:, None],
        rotations_object=np.tile(np.eye(3), (FULL_T, 1, 1)),
        translations_hand=(np.array([[0.1, 0, 0.5]]) - t0 + tt * dt)[:, None],
        rotations_hand=np.tile(np.eye(3), (FULL_T, 1, 1)),
        mano_pca_pose=np.zeros((FULL_T, 16)),
        mano_rot=np.zeros((FULL_T, 3)),
        mano_trans=np.zeros((FULL_T, 3)),
        mano_betas=np.zeros((FULL_T, 10)))


class FakeDataset:
    """The HO3D interface evaluate_results reads, over the fabricated fits;
    its ground truth is the fit moved by a seeded per-frame offset."""
    image_size = 64

    def __init__(self, fits, v, f, seqs, K=np.eye(3, dtype=np.float32)):
        self.fits, self.v, self.f, self.K = fits, v, f, K
        self.vid_rows = [{"seq_idx": s, "frame_ids": list(range(FULL_T)),
                          "frame_nb": FULL_T} for s in seqs]
        rng = np.random.RandomState(7)
        self.offsets = {s: rng.randn(FULL_T, 1, 3).astype(np.float32) * 0.01
                        for s in seqs}

    def __getitem__(self, idx):
        seq, fids = CHUNKS[idx]
        return {"seq_idx": seq, "frame_idxs": fids,
                "hands": [{"label": "right_hand"}],
                "objects": [{"canverts3d": self.v, "faces": self.f}],
                "camera": {"K": np.tile(self.K[None], (len(fids), 1, 1))}}

    def get_obj_verts_trans(self, seq, fid):
        return (np.asarray(self.fits[seq]["verts_object"])[fid]
                + self.offsets[seq][fid])

    def get_obj_verts_can(self, seq, fid):
        return self.v, self.f

    def get_joints3d(self, seq, fid):
        return (np.asarray(self.fits[seq]["joints_hand"])[fid]
                + self.offsets[seq][fid])


@pytest.fixture(scope="module")
def fabricated(tmp_path_factory):
    """The samples tree (chunked joint_fit.npz files) and its dataset."""
    root = tmp_path_factory.mktemp("eval_tree")
    layer = JManoLayer.synthetic(0)
    v, f = bumpy_potato(1, 0.08, seed=0)
    cfg = JM.HomanConfig(hand_sides=("right",))
    seqs = {"SM1": _full_state(0), "AP10": _full_state(1)}
    fits = {s: jpost.post_process(st, {"right": layer.params["right"]},
                                  jnp.asarray(v), cfg)
            for s, st in seqs.items()}
    for i, (seq, fids) in enumerate(CHUNKS):
        st = seqs[seq]
        sliced = JM.HomanState(**{
            k: np.asarray(val) if np.asarray(val).shape[0] == 1
            else np.asarray(val)[np.asarray(fids)]
            for k, val in vars(st).items()})
        sdir = root / "samples" / f"{i:08d}"
        sdir.mkdir(parents=True)
        np.savez(sdir / "joint_fit.npz", **jpost.state_to_dict(sliced))
        with open(sdir / "results.pkl", "wb") as fh:
            pickle.dump({"metrics": {"obj_dist": [0.01 * (i + 1)]},
                         "losses": {"loss": [1.0, 0.5, 0.25 + i]}}, fh)
    return str(root), FakeDataset(fits, v, f, list(seqs))


def _evaluate(fabricated, tmp_path, **kw):
    """Both packages' evaluate_results on copies of the tree: (JAX summary,
    JAX root, port summary, port root)."""
    src, ds = fabricated
    roots = {}
    for name in ("jax", "port"):
        roots[name] = str(tmp_path / name)
        shutil.copytree(src, roots[name])
    js = JE.evaluate_results(roots["jax"], ds, JManoLayer.synthetic(0),
                             boundary_idx=FULL_T, **kw)
    ts = TE.evaluate_results(roots["port"], ds,
                             TManoLayer.synthetic(0, device="cpu"),
                             boundary_idx=FULL_T, device="cpu", **kw)
    return js, roots["jax"], ts, roots["port"]


def _metrics(root):
    with open(os.path.join(root, "eval_metrics.pkl"), "rb") as fh:
        return pickle.load(fh)


def test_evaluate_results_matches_jax(fabricated, tmp_path):
    js, jroot, ts, troot = _evaluate(fabricated, tmp_path, dump_codalab=True,
                                     report=True)
    assert set(ts) == set(js)
    assert {"obj_dist_seen", "obj_dist_unseen", "pen_depths",
            "has_contact", "hand_root"} <= set(ts)
    for k in js:
        assert np.isfinite(ts[k]), k
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)
    assert js["obj_dist"] > 1e-3 and js["hand_root"] > 1e-3
    jm, tm = _metrics(jroot), _metrics(troot)
    for agg in ("median", "max"):
        for k in jm[agg]:
            np.testing.assert_allclose(tm[agg][k], jm[agg][k], rtol=1e-5,
                                       err_msg=f"{agg} {k}")
    for k in jm["all"]:
        assert len(tm["all"][k]) == len(jm["all"][k]), k
        np.testing.assert_allclose(np.asarray(tm["all"][k], np.float64),
                                   np.asarray(jm["all"][k], np.float64),
                                   rtol=1e-5, atol=1e-12, err_msg=k)
    assert len(tm["all"]["obj_dist_seen"]) == FULL_T
    assert len(tm["all"]["obj_dist_unseen"]) == FULL_T
    # pred.json: one entry per full-rate frame, HO-3D's joint order.
    with open(os.path.join(jroot, "pred.json")) as fh:
        jp = json.load(fh)
    with open(os.path.join(troot, "pred.json")) as fh:
        tp = json.load(fh)
    assert len(tp[0]) == len(tp[1]) == 2 * FULL_T
    assert np.asarray(tp[0][0]).shape == (21, 3)
    assert np.asarray(tp[1][0]).shape == (778, 3)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1.0001e-4)
    exact = np.mean([np.array_equal(np.asarray(a), np.asarray(b))
                     for part_t, part_j in zip(tp, jp)
                     for a, b in zip(part_t, part_j)])
    print(f"pred.json entries equal after rounding: {exact:.3f}")
    assert os.path.exists(os.path.join(troot, "pred.zip"))
    for name in ("report.html", "eval_report.html"):
        with open(os.path.join(jroot, name)) as fh:
            jt = fh.read()
        with open(os.path.join(troot, name)) as fh:
            tt = fh.read()
        assert tt.replace(troot, jroot) != "" and len(tt) > 100
        if name == "report.html":  # its title holds the root
            tt = tt.replace(troot, jroot)
        assert name == "eval_report.html" or tt == jt


def test_evaluate_results_renders_videos(fabricated, tmp_path, monkeypatch):
    """render_videos (one sequence): a turntable a display_freq frames and
    a clip video per sequence, in the card's format where cv2 is missing;
    the HTML links the files written."""
    from homan_tpu_torch.viz import render_viz
    monkeypatch.setattr(render_viz, "_import_optional", lambda name: None)
    src, ds = fabricated
    # A camera that frames the scene (the identity K of the fabricated
    # dataset shrinks it into one pixel, where every tile's demand is the
    # whole scene).
    ds = FakeDataset(ds.fits, ds.v, ds.f, [r["seq_idx"] for r in
                                           ds.vid_rows],
                     K=np.array([[64.0, 0, 32], [0, 64, 32], [0, 0, 1]],
                                np.float32))
    root = str(tmp_path / "port")
    shutil.copytree(src, root)
    TE.evaluate_results(root, ds, TManoLayer.synthetic(0, device="cpu"),
                        report=True, render_videos=True, boundary_idx=FULL_T,
                        sequences=["SM1"], device="cpu")
    vids = os.path.join(root, "test_vids")
    for seq in ("SM1",):
        clip = render_viz.read_apng(os.path.join(vids, f"seq_{seq}.apng"))
        assert len(clip) == FULL_T and clip[0].shape == (128, 128, 3)
        rot = render_viz.read_apng(os.path.join(vids,
                                                f"rot_{seq}_000000.apng"))
        assert len(rot) == 12
    with open(os.path.join(root, "eval_report.html")) as fh:
        assert "seq_SM1.apng" in fh.read()


def test_eval_skips_unfitted_sequence_but_counts_frames(tmp_path):
    """An official sequence with no fits still advances the seen/unseen
    counter (the boundary is an absolute frame index), as in the JAX
    package's test."""
    from homan_tpu_torch.fit import model as TM
    from homan_tpu_torch.fit import postprocess as tpost
    layer = TManoLayer.synthetic(0, device="cpu")
    v, f = bumpy_potato(1, 0.08, seed=0)
    T = 2
    cfg = TM.HomanConfig(hand_sides=("right",))
    state = TM.init_state(
        cfg,
        translations_object=np.tile([[0, 0, 0.5]], (T, 1))[:, None],
        rotations_object=np.tile(np.eye(3), (T, 1, 1)),
        translations_hand=np.tile([[0.1, 0, 0.5]], (T, 1))[:, None],
        rotations_hand=np.tile(np.eye(3), (T, 1, 1)),
        mano_pca_pose=np.zeros((T, 16)), mano_rot=np.zeros((T, 3)),
        mano_trans=np.zeros((T, 3)), mano_betas=np.zeros((T, 10)),
        device="cpu")
    fit = tpost.post_process(state, {"right": layer.params["right"]},
                             torch.as_tensor(v), cfg)
    sdir = tmp_path / "samples" / "00000000"
    sdir.mkdir(parents=True)
    np.savez(sdir / "joint_fit.npz", **tpost.state_to_dict(state))

    class Dataset:
        image_size = 64
        vid_rows = [{"seq_idx": "MPM10", "frame_ids": [0, 1],
                     "frame_nb": 2},
                    {"seq_idx": "SM1", "frame_ids": list(range(6)),
                     "frame_nb": 6}]

        def __getitem__(self, idx):
            return {"seq_idx": "MPM10", "frame_idxs": [0, 1],
                    "hands": [{"label": "right_hand"}],
                    "objects": [{"canverts3d": v, "faces": f}],
                    "camera": {"K": np.tile(np.eye(3, dtype=np.float32)[None],
                                            (2, 1, 1))}}

        def get_obj_verts_trans(self, seq, fid):
            return fit["verts_object"].numpy()[fid]

        def get_obj_verts_can(self, seq, fid):
            return v, f

        def get_joints3d(self, seq, fid):
            return fit["joints_hand"].numpy()[fid]

    # boundary at 7: SM1's 6 skipped frames + MPM10 frame 0 are seen,
    # MPM10 frame 1 unseen, only if the counter advances over SM1.
    summary = TE.evaluate_results(str(tmp_path), Dataset(), layer,
                                  report=False, inter_metrics=False,
                                  boundary_idx=7, device="cpu")
    all_metrics = _metrics(str(tmp_path))["all"]
    assert len(all_metrics["obj_dist_seen"]) == 1
    assert len(all_metrics["obj_dist_unseen"]) == 1
    assert summary["obj_dist"] < 1e-5


def test_eval_resolves_chunk_schedule_from_fit_opts(tmp_path):
    """frame_nb and chunk_step come from the fit run's results.pkl where
    the flags are unset; explicit flags win; the reference defaults apply
    when nothing is recorded (evalho3drecons.py:26,38)."""
    root = tmp_path / "res"
    root.mkdir()
    with open(root / "results.pkl", "wb") as f:
        pickle.dump({"opts": {"chunk_step": 4, "frame_nb": 30}}, f)
    for mod in (TE, JE):
        ns = argparse.Namespace(results_root=str(root), chunk_step=None,
                                frame_nb=None)
        mod._resolve_fit_options(ns)
        assert (ns.chunk_step, ns.frame_nb) == (4, 30)
        ns2 = argparse.Namespace(results_root=str(root), chunk_step=2,
                                 frame_nb=None)
        mod._resolve_fit_options(ns2)
        assert (ns2.chunk_step, ns2.frame_nb) == (2, 30)
        ns3 = argparse.Namespace(results_root=str(tmp_path), chunk_step=None,
                                 frame_nb=None)
        mod._resolve_fit_options(ns3)
        assert (ns3.chunk_step, ns3.frame_nb) == (1, 10)
    assert vars(TE.get_args(["--root", str(root)])) == vars(
        JE.get_args(["--root", str(root)]))


def test_codalab_joint_order_is_the_exact_inverse():
    from homan_tpu_torch.core.mano import JOINT_REORDER
    reorder = np.asarray(JOINT_REORDER)
    np.testing.assert_array_equal(reorder[TE.UNORDER_IDXS], np.arange(21))
    np.testing.assert_array_equal(TE.UNORDER_IDXS, JE.UNORDER_IDXS)
    np.testing.assert_array_equal(TE.CAMEXTR3, JE.CAMEXTR3)


def test_report_html_is_byte_equal(fabricated, tmp_path):
    src, _ = fabricated
    root = str(tmp_path / "tree")
    shutil.copytree(src, root)
    open(os.path.join(root, "samples", "00000001", "final_points.png"),
         "wb").close()
    a = open(treport.make_exp_html(root, os.path.join(root, "t.html"))).read()
    b = open(jreport.make_exp_html(root, os.path.join(root, "j.html"))).read()
    assert a == b and "final_points.png" in a and "<svg" in a
    rows = {"clip": ["a.webm", "b.png"], "x<y": ["c.mp4"]}
    a = open(treport.html_grid(rows, str(tmp_path / "t_grid.html"))).read()
    b = open(jreport.html_grid(rows, str(tmp_path / "j_grid.html"))).read()
    assert a == b
    for name, lr, err in (("expA", 0.01, 0.02), ("expB", 0.001, 0.01)):
        r = tmp_path / name
        r.mkdir()
        assert treport.dump({"lr": lr, "same_opt": 1},
                            {"verts_dists_hand": [err, err * 2]},
                            str(r / "results.pkl")) == jreport.dump(
            {"lr": lr, "same_opt": 1}, {"verts_dists_hand": [err, err * 2]},
            str(r / "results_j.pkl"))
    exps = [str(tmp_path / "expA"), str(tmp_path / "expB"), root]
    a = open(treport.compare_experiments(exps, str(tmp_path / "t.html"),
                                         "verts_dists_hand")).read()
    b = open(jreport.compare_experiments(exps, str(tmp_path / "j.html"),
                                         "verts_dists_hand")).read()
    assert a == b and a.index("expB") < a.index("expA")
    assert treport.parse_experiment(root) == jreport.parse_experiment(root)


def test_eval_main_scores_a_port_driver_tree(tmp_path, monkeypatch):
    """python -m homan_tpu_torch.cli.eval_ho3d on a results tree the port's
    fit_video wrote: the chunk schedule from the fit's results.pkl, one
    pred.json entry per full-rate frame, every summary metric finite."""
    from homan_tpu_torch.cli import fit_video as TF
    from homan_tpu_torch.viz import render_viz
    from torch_port_common import ho3d_tree
    tree = ho3d_tree(tmp_path, frames=6, obj_subdiv=1)
    monkeypatch.chdir(tree)
    monkeypatch.setattr(render_viz, "visualize_hand_object",
                        lambda *a, **k: ([], []))
    TF.main(TF.get_args([
        "--gt_masks", "1", "--frame_nb", "3", "--chunk_step", "2",
        "--num_initializations", "4", "--num_obj_iterations", "1",
        "--num_joint_iterations", "2", "--viz_step", "0", "--rend_size",
        "64", "--result_root", "res"]), device="cpu")
    args = TE.get_args(["--results_root", "res", "--split", "val",
                        "--dump_codalab", "--report"])
    assert (args.frame_nb, args.chunk_step) == (3, 2)
    summary = TE.main(args, device="cpu")
    assert summary and all(np.isfinite(v) for v in summary.values())
    with open("res/pred.json") as fh:
        joints, verts = json.load(fh)
    assert len(joints) == len(verts) == 6
    assert os.path.exists("res/eval_report.html")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.main(args)
