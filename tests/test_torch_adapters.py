"""PyTorch port vs JAX package: the reference-artifact adapters
(frontend/adapters.py), mask assignment (frontend/assign.py) and the
results-tree converter (cli/convert_reference.py). Host numpy on both
sides: every output is held exactly (tolerance 0).

Record trees cross the packages: a tree written by the JAX package's
record_cached_evidence replays in the port, and one written by the port's
replays in the JAX package, with the same assembled evidence.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from homan_tpu.cli import convert_reference as jcr
from homan_tpu.frontend import adapters as ja
from homan_tpu.frontend import assign as jas
from homan_tpu.frontend import evidence as je
from homan_tpu_torch.cli import convert_reference as tcr
from homan_tpu_torch.cli import fit_video as TF
from homan_tpu_torch.frontend import adapters as ta
from homan_tpu_torch.frontend import assign as tas
from homan_tpu_torch.frontend import evidence as te

from torch_port_common import assert_same_tree as _assert_same


def reference_person_params(n_hands=2, seed=0, h=48, w=64, as_torch=True):
    """One frame in the reference's FrankMocap layout: hands stacked on
    dim 0, torch tensors, a hand_side list."""
    rng = np.random.RandomState(seed)
    d = {
        "bboxes": (rng.rand(n_hands, 4) * 40).astype(np.float32),
        "cams": rng.randn(n_hands, 3).astype(np.float32),
        "verts": rng.randn(n_hands, 778, 3).astype(np.float32),
        "verts2d": (rng.rand(n_hands, 778, 2) * 40).astype(np.float32),
        "rotations": np.tile(np.eye(3, dtype=np.float32), (n_hands, 1, 1)),
        "translations": rng.randn(n_hands, 1, 3).astype(np.float32),
        "mano_pca_pose": rng.randn(n_hands, 16).astype(np.float32),
        "mano_rot": rng.randn(n_hands, 3).astype(np.float32),
        "mano_trans": np.zeros((n_hands, 3), np.float32),
        "mano_betas": rng.randn(n_hands, 10).astype(np.float32),
        "masks": rng.rand(n_hands, h, w) > 0.8,
        "hand_side": ["left_hand", "right_hand"][2 - n_hands:],
    }
    if as_torch:
        d = {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, list)
             else v for k, v in d.items()}
    return d


@pytest.mark.parametrize("n_hands,as_torch", [(1, True), (2, True),
                                              (2, False)])
def test_convert_person_parameters_matches_jax(n_hands, as_torch):
    ref = reference_person_params(n_hands, as_torch=as_torch)
    ours = ta.convert_person_parameters(ref)
    _assert_same(ours, ja.convert_person_parameters(ref))
    est = ours[0]
    assert list(est) == ["left_hand", "right_hand"][2 - n_hands:]
    assert all(isinstance(v, np.ndarray) for e in est.values()
               for v in e.values())
    assert est["right_hand"]["translations"].shape == (1, 3)
    # A bare side name ("right") and a 1-d translation are normalized.
    one = {"hand_side": "right", "translations": np.ones((1, 3))}
    _assert_same(ta.convert_person_parameters(one),
                 ja.convert_person_parameters(one))


def test_convert_pointrend_annotations_matches_jax():
    rng = np.random.RandomState(0)
    annots = [{"class_id": c, "full_mask": rng.rand(16, 24) > 0.5,
               "score": s} for c, s in ((39, 0.97), (-1, 0.88), (0, 0.5))]
    annots.append({"full_mask": torch.ones(16, 24)})  # no class, no score
    annots.append({"class_id": torch.tensor(0), "score": torch.tensor(0.25),
                   "full_mask": torch.zeros(16, 24)})
    ours = ta.convert_pointrend_annotations(annots)
    _assert_same(ours, ja.convert_pointrend_annotations(annots))
    assert [a["class_id"] for a in ours] == [-1, -1, 0, 0, 0]


def _record_clip(mod, root, T=3):
    """A clip of records written by one package's adapters, from the same
    reference-layout inputs (two hands, an object mask, an extra PointRend
    annotation)."""
    for t in range(T):
        rng = np.random.RandomState(10 + t)
        obj = np.zeros((48, 64), bool)
        obj[10:30, 20 + t:44 + t] = True
        extra = [{"class_id": 0, "full_mask": rng.rand(48, 64) > 0.9,
                  "score": 0.4}] if t == 1 else []
        out = mod.record_cached_evidence(
            root, f"clip_{t:06d}", reference_person_params(2, seed=t), obj,
            object_score=0.93, extra_mask_annotations=extra)
    return out


def test_record_cached_evidence_matches_jax(tmp_path):
    outs = [_record_clip(mod, str(tmp_path / name))
            for mod, name in ((ja, "jax"), (ta, "port"))]
    _assert_same(outs[1], outs[0])
    for t in range(3):
        loaded = []
        for name in ("jax", "port"):
            with open(tmp_path / name / f"clip_{t:06d}.pkl", "rb") as fh:
                loaded.append(pickle.load(fh))
        _assert_same(loaded[1], loaded[0])
    masks = outs[1][0]
    assert [(m["class_id"], m.get("hand_side")) for m in masks] == [
        (0, "left_hand"), (0, "right_hand"), (-1, None)]


def test_record_trees_replay_across_the_packages(tmp_path):
    """A tree written by each package, replayed by both: the same evidence
    four ways."""
    for mod, name in ((ja, "jax"), (ta, "port")):
        _record_clip(mod, str(tmp_path / name))
    T = 3
    keys = [f"clip_{t:06d}" for t in range(T)]
    boxes = {s: np.array([[8.0, 6, 30, 28]] * T, np.float32)
             for s in ("left_hand", "right_hand")}
    obj_boxes = np.array([[20.0, 10, 44, 30]] * T, np.float32)
    K = np.tile(np.array([[[60.0, 0, 32], [0, 60, 24], [0, 0, 1]]]),
                (T, 1, 1))
    outs = {}
    for writer in ("jax", "port"):
        for reader, mod in (("jax", je), ("port", te)):
            cache = mod.CachedEvidence(str(tmp_path / writer))
            outs[writer, reader] = mod.get_frame_infos(
                [None] * T, cache, cache, boxes, obj_boxes, K,
                image_size=64, rend_size=32, frame_keys=keys)
    ref = outs["jax", "jax"]
    for k, v in outs.items():
        _assert_same(v, ref, path=str(k))
    assert ref[0][0][0]["masks"].shape == (48, 64)


def _reference_indep(T=2, R=64, n_hands=1):
    from homan_tpu_torch.core.meshes import bumpy_potato
    v, f = bumpy_potato(1, 0.08, seed=0)
    person_frames = []
    for t in range(T):
        p = reference_person_params(n_hands, seed=t, h=64, w=64)
        p["target_masks"] = torch.from_numpy(
            np.random.RandomState(t).rand(n_hands, R, R).astype(np.float32))
        p["K_roi"] = torch.eye(3)[None].repeat(n_hands, 1, 1)
        person_frames.append(p)
    objects = [{"rotations": torch.eye(3)[None],
                "translations": torch.tensor([[[0.0, 0.0, 0.5 + 0.01 * t]]]),
                "target_masks": torch.from_numpy(np.random.RandomState(
                    9 + t).rand(R, R).astype(np.float32)),
                "K_roi": torch.eye(3)[None],
                "masks": torch.zeros(64, 64)} for t in range(T)]
    objects[-1]["masks"] = None
    objects[-1]["full_mask"] = torch.ones(64, 64)
    return {"person_parameters": person_frames,
            "object_parameters": objects,
            "obj_verts_can": torch.from_numpy(v)[None],
            "obj_faces": torch.from_numpy(f),
            "super2d_img_path": "unused.png"}


def _reference_state(T=2):
    g = torch.Generator().manual_seed(0)
    return {"translations_object": torch.rand(T, 1, 3, generator=g)
            + torch.tensor([0, 0, 1.0]),
            "rotations_object": torch.eye(3)[:, :2].repeat(T, 1, 1),
            "translations_hand": torch.rand(T, 1, 3, generator=g),
            "rotations_hand": torch.eye(3)[:, :2].repeat(T, 1, 1),
            "mano_pca_pose": torch.zeros(T, 16),
            "mano_rot": torch.zeros(T, 3),
            "mano_trans": torch.zeros(T, 3),
            "mano_betas": torch.zeros(T, 10),
            "int_scales_object": torch.ones(1, 1),
            "int_scales_hand": torch.ones(1),
            "verts_object_og": torch.zeros(5, 3)}  # a buffer: dropped


@pytest.mark.parametrize("n_hands", [1, 2])
def test_convert_indep_fit_matches_jax(n_hands):
    ref = _reference_indep(n_hands=n_hands)
    ours = ta.convert_indep_fit(ref)
    _assert_same(ours, ja.convert_indep_fit(ref))
    assert ours["hand_sides"] == ["left", "right"][2 - n_hands:]
    assert ours["person_parameters"]["verts"].shape == (2 * n_hands, 778, 3)
    assert ours["object_parameters"][-1]["masks"].shape == (64, 64)


def test_convert_joint_fit_state_matches_jax():
    sd = _reference_state()
    ours = ta.convert_joint_fit_state(sd)
    _assert_same(ours, ja.convert_joint_fit_state(sd))
    assert "verts_object_og" not in ours
    assert ours["int_scales_object"].shape == (1,)
    assert ta.STATE_KEYS == ja.STATE_KEYS


@pytest.mark.parametrize("case", ["greedy", "below_overlap", "none",
                                  "more_masks"])
def test_assign_human_masks_matches_jax(case):
    rng = np.random.RandomState(4)
    sils = np.zeros((3, 24, 32), bool)
    for i, (y, x) in enumerate(((2, 2), (8, 14), (14, 4))):
        sils[i, y:y + 8, x:x + 10] = True
    if case == "none":
        masks = None
    else:
        masks = np.roll(sils, 1, axis=2)[[2, 0, 1]]
        if case == "below_overlap":
            masks = np.roll(masks, 5, axis=1)
        if case == "more_masks":
            masks = np.concatenate([masks, rng.rand(2, 24, 32) > 0.5])
    ours = tas.assign_human_masks(sils, masks, min_overlap=0.5)
    _assert_same(ours, jas.assign_human_masks(sils, masks, min_overlap=0.5))
    if case in ("greedy", "more_masks"):
        np.testing.assert_array_equal(ours, np.roll(sils, 1, axis=2))
    assert tas.COCO_CLASS_NAMES == jas.COCO_CLASS_NAMES


def _reference_tree(src, T=2):
    sdir = src / "samples" / "00000000"
    sdir.mkdir(parents=True)
    with open(sdir / "indep_fit.pkl", "wb") as fh:
        pickle.dump(_reference_indep(T), fh)
    torch.save({"state_dict": _reference_state(T)}, sdir / "joint_fit.pt")
    (src / "samples" / "00000001").mkdir()  # an empty sample folder


def test_convert_reference_matches_jax_and_resumes_in_the_port(
        tmp_path, monkeypatch):
    """Both converters on one reference results tree give the same files;
    the port's fit_video --resume then continues the converted fit."""
    src = tmp_path / "ref_results"
    _reference_tree(src)
    names = [mod.main(mod.get_args(["--src", str(src), "--dst",
                                    str(tmp_path / dst)]))
             for mod, dst in ((tcr, "port"), (jcr, "jax"))]
    assert names[0] == ["00000000", "00000001"]
    assert jcr.convert_tree(str(src), str(tmp_path / "jax")) == names[0]
    sample = os.path.join("samples", "00000000")
    loaded = []
    for dst in ("jax", "port"):
        with open(tmp_path / dst / sample / "indep_fit.pkl", "rb") as fh:
            indep = pickle.load(fh)
        ck = np.load(tmp_path / dst / sample / "joint_fit.npz")
        loaded.append((indep, {k: ck[k] for k in ck.files}))
    _assert_same(loaded[1], loaded[0])
    assert not os.listdir(tmp_path / "port" / "samples" / "00000001")

    T = 2
    from homan_tpu_torch.core.meshes import bumpy_potato
    v, f = bumpy_potato(1, 0.08, seed=0)

    class Clip:
        def __len__(self):
            return 1

        def __getitem__(self, idx):
            return {"seq_idx": "ref", "frame_idxs": list(range(T)),
                    "images": [None] * T,
                    "hands": [{"label": "left_hand"}],
                    "objects": [{"canverts3d": v, "faces": f}],
                    "camera": {"K": np.tile(np.eye(3)[None], (T, 1, 1))
                               * 64},
                    "setup": {"left_hand": 1, "objects": 1}}

    monkeypatch.setattr(TF, "get_dataset", lambda name, **kw: (Clip(), 64))
    out = TF.main(TF.get_args([
        "--resume", str(tmp_path / "port"), "--frame_nb", str(T),
        "--data_step", "1", "--num_joint_iterations", "2", "--rend_size",
        "64", "--result_root", str(tmp_path / "resumed"), "--mano_root",
        str(tmp_path / "no_mano")]), device="cpu")
    assert [o["sample"] for o in out] == [0]
    assert np.isfinite(out[0]["final_loss"])
    resumed = np.load(tmp_path / "resumed" / sample / "joint_fit.npz")
    start = loaded[1][1]["translations_object"]
    moved = np.abs(resumed["translations_object"] - start).max()
    assert 0 < moved < 0.05
