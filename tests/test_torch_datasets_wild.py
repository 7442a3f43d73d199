"""PyTorch port vs JAX package: the in-the-wild datasets and their tracking
(data/core50.py, data/hoa.py, data/epic.py, data/factory.py,
tracking/kalman.py, tracking/sequences.py, cli/track_dataset.py). Host
numpy on both sides: every output is held exactly (tolerance 0).

Each package builds its dataset index in a cache folder of its own. HOA
detection files pickle each package's own dataclasses, so each side reads a
file written with its own classes from the same values. Last, the port's
driver fits a CORe50 clip and an EPIC clip with --evidence_root through its
own get_dataset, where the JAX factory raises TypeError.
"""
import os
import pickle

import numpy as np
import pandas as pd
import pytest

from homan_tpu.cli import track_dataset as jtd
from homan_tpu.data import core50 as jc50
from homan_tpu.data import epic as jep
from homan_tpu.data import factory as jfactory
from homan_tpu.data import hoa as jhoa
from homan_tpu.tracking import kalman as jk
from homan_tpu.tracking import sequences as jseq
from homan_tpu_torch.cli import fit_video as TF
from homan_tpu_torch.cli import track_dataset as ttd
from homan_tpu_torch.data import core50 as tc50
from homan_tpu_torch.data import epic as tep
from homan_tpu_torch.data import factory as tfactory
from homan_tpu_torch.data import hoa as thoa
from homan_tpu_torch.tracking import kalman as tk
from homan_tpu_torch.tracking import sequences as tseq

from torch_port_common import assert_same_tree

SMALL_FIT = ["--data_step", "1", "--num_initializations", "8",
             "--num_obj_iterations", "2", "--num_joint_iterations", "3",
             "--rend_size", "64"]


def _track(T=12, seed=0, gaps=(3, 4, 9)):
    rng = np.random.RandomState(seed)
    boxes = np.cumsum(rng.randn(T, 4), 0) + [10, 20, 50, 60]
    boxes[list(gaps)] = np.nan
    return boxes


@pytest.mark.parametrize("order", [0, 1])
def test_kalman_matches_jax(order):
    boxes = _track()
    for fn in ("track_sequence_boxes", "interpolate_missing"):
        assert_same_tree(getattr(tk, fn)(boxes), getattr(jk, fn)(boxes))
    assert_same_tree(tk.track_boxes(boxes, order), jk.track_boxes(boxes,
                                                                  order))
    assert_same_tree(tk.rtsmooth(boxes, order, q=0.5, r=2.0),
                     jk.rtsmooth(boxes, order, q=0.5, r=2.0))
    col = boxes[:, 0]
    assert_same_tree(tk.kalman_rts_1d(col, order),
                     jk.kalman_rts_1d(col, order))
    empty = np.full(5, np.nan)
    assert_same_tree(tk.kalman_rts_1d(empty), jk.kalman_rts_1d(empty))
    filled = tk.interpolate_missing(boxes)
    assert not np.isnan(filled).any()
    for dets, setup in (({"right_hand": [1]}, {"right_hand": 1,
                                               "objects": 1}),
                        ({}, {"right_hand": 1}),
                        ({"left_hand": []}, {"left_hand": 1})):
        assert tk.check_setup(dets, setup) == jk.check_setup(dets, setup)
    with pytest.raises(ValueError):
        tk.kalman_rts_1d(col, order=2)


def test_track_sequence_matches_jax():
    rng = np.random.RandomState(1)
    images = [(rng.rand(24, 32, 3) * 255).astype(np.uint8) for _ in range(6)]
    track = _track(6, gaps=(2,))

    def detector(image):
        i = int(image[0, 0, 0]) % 6
        return {"right_hand": None if np.isnan(track[i]).any() else
                track[i], "objects": track[i] + 5}

    for im_i, im in enumerate(images):
        im[0, 0, 0] = im_i
    setup = {"right_hand": 1, "objects": 1}
    ours = tseq.track_sequence(images, detector, setup, image_size=32)
    assert_same_tree(ours, jseq.track_sequence(images, detector, setup,
                                               image_size=32))
    assert set(ours) == {"right_hand", "objects"}
    assert_same_tree(tseq.get_image(images[0], 40),
                     jseq.get_image(images[0], 40))
    with pytest.raises(ValueError, match="never detected"):
        tseq.track_sequence(images, lambda im: {"right_hand": None},
                            {"right_hand": 1})


# ---- CORe50 --------------------------------------------------------------

def _core50_tree(root, sessions=(("s2", "o31", "R"), ("s1", "o6", "L")),
                 T=4, annots=True):
    """A CORe50 tree: the 350 x 350 images and, optionally, the .mat
    annotations (crop box, side, 2D roots, root depths)."""
    from PIL import Image
    from scipy.io import savemat
    for s, o, side in sessions:
        img_dir = os.path.join(root, "core50_350x350", s, o)
        os.makedirs(img_dir)
        for i in range(T):
            Image.new("RGB", (350, 350)).save(
                os.path.join(img_dir, f"C_{s[1:]:0>2}_{o[1:]}_{i:03d}.png"))
        if not annots:
            continue
        annot_dir = os.path.join(root, "core50_350x350_Annot", s, o)
        os.makedirs(annot_dir)
        for i in range(T):
            x = 110.0 + 4 * i
            savemat(os.path.join(
                annot_dir, f"CropAnnot_{s[1:]:0>2}_{o[1:]}_{i:03d}.mat"),
                {"annot": {
                    "hand": {"root2d": np.array([[180.0 + i, 170.0]]),
                             "root_depth_png": np.uint8(200 - i),
                             "side": side},
                    "object": {"root2d": np.array([[175.0, 175.0 - i]]),
                               "root_depth_png": np.uint8(190)},
                    "crop": np.array([[x, 120.0, x + 120, 240.0]])}})
    return root


@pytest.mark.parametrize("annots", [True, False])
def test_core50_index_and_items_match_jax(tmp_path, annots):
    root = _core50_tree(str(tmp_path / "core50"), annots=annots)
    registry = {"o6": str(tmp_path / "o6.obj")}
    from homan_tpu_torch.core.meshes import bumpy_potato, save_obj
    save_obj(registry["o6"], *bumpy_potato(1, 1.0, seed=2))
    kw = dict(root=root, frame_nb=3, chunk_step=1, load_img=False,
              model_registry=registry)
    for mode in ("chunk", "vid"):
        jd = jc50.Core50(mode=mode, cache_folder=str(tmp_path / "jc"), **kw)
        td = tc50.Core50(mode=mode, cache_folder=str(tmp_path / "tc"), **kw)
        assert_same_tree(td.vid_rows, jd.vid_rows)
        assert_same_tree(td.annotations, jd.annotations)
        assert_same_tree(td.chunks, jd.chunks)
        assert len(td) == len(jd) >= 2
        for i in range(len(td)):
            assert_same_tree(td[i], jd[i])
    # The index comes back from the port's own cache, unchanged.
    assert os.path.exists(tmp_path / "tc" / "core50_all.pkl")
    again = tc50.Core50(mode="vid", cache_folder=str(tmp_path / "tc"), **kw)
    assert_same_tree(again.chunks, td.chunks)
    a = td[0]
    sides = {c["session"]: c["hand_side"] for c in td.vid_rows}
    # The .mat side wins over the session table (s2 is a left session).
    assert sides == ({"s1": "left", "s2": "right"} if annots else
                     {"s1": "right", "s2": "left"})
    assert a["camera"]["K"].shape == (len(a["frame_idxs"]), 3, 3)
    assert ("bbox" in a["hands"][0]) == annots
    assert_same_tree(tc50.load_models(registry), jc50.load_models(registry))
    if annots:
        mat = os.path.join(root, "core50_350x350_Annot", "s2", "o31",
                           "CropAnnot_02_31_001.mat")
        assert_same_tree(tc50.load_mat_annot(mat), jc50.load_mat_annot(mat))


def test_core50_tracked_boxes_match_jax(tmp_path):
    root = _core50_tree(str(tmp_path / "core50"), sessions=(
        ("s2", "o31", "R"),), annots=False)
    boxes = {("s2", "o31"): {"left_hand": _track(4, gaps=()),
                             "objects": _track(4, seed=3, gaps=())}}
    path = str(tmp_path / "boxes.pkl")
    with open(path, "wb") as fh:
        pickle.dump(boxes, fh)
    kw = dict(root=root, frame_nb=3, chunk_step=1, load_img=False,
              track=False, boxes_path=path)
    jd = jc50.Core50(cache_folder=str(tmp_path / "jc"), **kw)
    td = tc50.Core50(cache_folder=str(tmp_path / "tc"), **kw)
    assert_same_tree(td[0], jd[0])
    np.testing.assert_array_equal(td[0]["hands"][0]["bbox"],
                                  boxes[("s2", "o31")]["left_hand"][
                                      td.chunks[0]["frame_idxs"]].astype(
                                          np.float32))


def test_track_dataset_matches_jax(tmp_path):
    root = _core50_tree(str(tmp_path / "core50"))
    saved = []
    for mod, dmod, name in ((jtd, jc50, "j"), (ttd, tc50, "t")):
        ds = dmod.Core50(root=root, mode="vid", frame_nb=-1, load_img=False,
                         cache_folder=str(tmp_path / f"{name}c"))
        args = mod.get_args(["--dataset", "core50", "--split", "all",
                             "--save_root", str(tmp_path / name)])
        path = mod.main(args, dataset=ds)
        with open(path, "rb") as fh:
            saved.append(pickle.load(fh))
        assert len(ds) == 2
    assert_same_tree(saved[1], saved[0])
    assert set(saved[1]) == {"s1_o6", "s2_o31"}
    assert saved[1]["s2_o31"]["right_hand"].shape == (4, 4)


# ---- HOA and EPIC ---------------------------------------------------------

def _hoa_values(n=31):
    """Per frame: (hands [(box, score, state, side, offset)], objects [(box,
    score)]) in normalized coordinates."""
    out = []
    for fi in range(n):
        x = 0.3 + 0.002 * fi
        hands = [((x, 0.3, x + 0.25, 0.7), 0.9, 3, 1, (0.01, 0.02))]
        if fi % 5:  # a left hand most frames, two detections some frames
            hands.append(((0.1, 0.35, 0.25, 0.6), 0.6 + 0.01 * fi, 0, 0,
                          (0.0, 0.0)))
        objects = [((x - 0.1, 0.35, x + 0.1, 0.6), 0.8)]
        if fi % 3 == 0:
            objects.append(((0.5, 0.5, 0.6, 0.6), 0.85))
        out.append((hands, objects))
    return out


def _write_hoa(mod, path, video="P01_01"):
    """A video's detections pickled with `mod`'s own dataclasses."""
    dets = [mod.FrameDetections(
        video_id=video, frame_number=fi,
        hands=[mod.HandDetection(bbox=mod.BBox(*b), score=s,
                                 state=mod.HandState(st),
                                 side=mod.HandSide(sd),
                                 object_offset=mod.FloatVector(*off))
               for b, s, st, sd, off in hands],
        objects=[mod.ObjectDetection(bbox=mod.BBox(*b), score=s)
                 for b, s in objects])
        for fi, (hands, objects) in enumerate(_hoa_values())]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(dets, fh)


def test_hoa_to_dataframe_matches_jax(tmp_path):
    frames = []
    for mod, name in ((jhoa, "j"), (thoa, "t")):
        path = str(tmp_path / name / "P01_01.pkl")
        _write_hoa(mod, path)
        dets = mod.load_video_hoa(path)
        assert isinstance(dets[0], mod.FrameDetections)
        frames.append(mod.detections_to_dataframe(dets, 256, 456))
    pd.testing.assert_frame_equal(frames[1], frames[0], check_exact=True)
    assert len(frames[1]) == 31 + 24 + 31 + 11
    scaled = thoa.BBox(0.1, 0.2, 0.3, 0.4).scale(10, 100)
    assert (scaled.width, scaled.height) + scaled.center == pytest.approx(
        (2.0, 20.0, 2.0, 30.0))
    with pytest.raises(ValueError, match="pb2"):
        path = str(tmp_path / "bytes.pkl")
        with open(path, "wb") as fh:
            pickle.dump([b"\x00"], fh)
        thoa.load_video_hoa(path)


def _epic_annotations(path):
    pd.DataFrame([
        {"video_id": "P01_01", "noun": "cup", "verb": "take",
         "start_frame": 0, "stop_frame": 30},
        {"video_id": "P01_01", "noun": "cup", "verb": "wash",
         "start_frame": 0, "stop_frame": 30},       # verb filtered out
        {"video_id": "P01_01", "noun": "can", "verb": "open",
         "start_frame": 4, "stop_frame": 9},        # too short
        {"video_id": "P01_01", "noun": "plate", "verb": "put",
         "start_frame": 2, "stop_frame": 28},
    ]).to_pickle(path)


def test_epic_clips_and_tracks_match_jax(tmp_path):
    ann = str(tmp_path / "EPIC_100_train.pkl")
    _epic_annotations(ann)
    items = []
    for mod, hmod, name in ((jep, jhoa, "j"), (tep, thoa, "t")):
        _write_hoa(hmod, str(tmp_path / name / "hoa" / "P01_01.pkl"))
        ds = mod.Epic(annotations_path=ann, hoa_root=str(tmp_path / name /
                                                         "hoa"),
                      frames_root=str(tmp_path / "noframes"),
                      nouns=("cup", "can", "plate"), frame_nb=4,
                      frame_step=2, cache_folder=str(tmp_path / name / "c"),
                      load_img=False)
        items.append((ds.clips, [ds[i] for i in range(len(ds))],
                      ds.get_camintr()))
    assert_same_tree(items[1], items[0])
    clips, samples, _ = items[1]
    assert [(c["noun"], c["start"]) for c in clips] == [("cup", 0),
                                                       ("plate", 2)]
    assert [h["label"] for h in samples[0]["hands"]] == ["left_hand",
                                                        "right_hand"]
    df = thoa.detections_to_dataframe(thoa.load_video_hoa(str(
        tmp_path / "t" / "hoa" / "P01_01.pkl")), tep.VIDEO_H, tep.VIDEO_W)
    tracks = tep.track_clip_boxes(df, 2, 20)
    assert_same_tree(tracks, jep.track_clip_boxes(df, 2, 20))
    assert_same_tree(tep.square_roi_for_clip(tracks),
                     jep.square_roi_for_clip(tracks))
    models = [mod.load_epic_models() for mod in (jep, tep)]
    assert_same_tree(models[1], models[0])


# ---- The factory and the port's driver on CORe50 and EPIC ------------------

def test_jax_factory_raises_where_the_port_returns_the_dataset(
        tmp_path, monkeypatch):
    """The JAX driver passes mano_root to every dataset, and its factory
    hands it on to CORe50 and EPIC, which take none: TypeError. The port's
    factory gives it to HO-3D alone. Likewise the JAX track_dataset passes
    mode to EPIC, which takes none."""
    root = _core50_tree(str(tmp_path / "core50"), sessions=(
        ("s2", "o31", "R"),))
    kw = dict(split="val", frame_nb=3, box_mode="gt", chunk_step=1,
              mano_root="extra_data/mano")
    for name, extra in (("core50", {"root": root}), ("epic", {})):
        extra["cache_folder"] = str(tmp_path / ("c_" + name))
        with pytest.raises(TypeError, match="mano_root"):
            jfactory.get_dataset(name, **kw, **extra)
        ds, size = tfactory.get_dataset(name, device="cpu", **kw, **extra)
        assert size == {"core50": 350, "epic": 640}[name]
        assert len(ds) == {"core50": 2, "epic": 0}[name]
    monkeypatch.chdir(tmp_path)  # EPIC's default folders: no clips here
    argv = ["--dataset", "epic", "--save_root", "boxes"]
    with pytest.raises(TypeError, match="mode"):
        jtd.main(jtd.get_args(argv))
    path = ttd.main(ttd.get_args(argv))  # no clip: nothing to write
    assert path.endswith("boxes_epic_val.pkl") and not os.path.exists(path)


def _record_clip_evidence(annots, image_size, frame_hw, root, seed=0):
    """Cached evidence for a dataset clip, rendered by the port: a plausible
    object in front of the camera and the synthetic hand beside it."""
    import torch
    from homan_tpu_torch.core import mano as mano_lib
    from homan_tpu_torch.frontend.adapters import record_cached_evidence
    from homan_tpu_torch.frontend.cachedfit import frame_key
    from homan_tpu_torch.frontend.gtevidence import (mask_to_bbox,
                                                     procrustes_rigid,
                                                     render_full_mask)
    layer = mano_lib.ManoLayer.synthetic(0, device="cpu")
    with torch.no_grad():
        z = torch.zeros((1, 48))
        rest = mano_lib.mano_forward(layer.params["right"], z[:, :10],
                                     z[:, :3], z[:, 3:])["verts"][0].numpy()
    T = len(annots["frame_idxs"])
    K = np.asarray(annots["camera"]["K"], np.float64)
    obj = annots["objects"][0]["canverts3d"][0]
    obj_verts = np.stack([obj + np.array([0.0, 0.0, 0.38 + 0.004 * t],
                                         np.float32) for t in range(T)])
    hand_verts = np.stack([rest + np.array([0.05, 0.0, 0.4], np.float32)]
                          * T)
    obj_m = render_full_mask(obj_verts, annots["objects"][0]["faces"][0], K,
                             image_size, device="cpu")[:, :frame_hw[0],
                                                       :frame_hw[1]]
    hand_m = render_full_mask(hand_verts, layer.faces("right").numpy(), K,
                              image_size, device="cpu")[:, :frame_hw[0],
                                                        :frame_hw[1]]
    rng = np.random.RandomState(seed)
    for t, fid in enumerate(annots["frame_idxs"]):
        hv = hand_verts[t]
        proj = hv @ K[t].astype(np.float32).T
        uv = proj[:, :2] / proj[:, 2:] + rng.randn(778, 2)
        R, tr = procrustes_rigid(rest, hv)
        record_cached_evidence(root, frame_key(annots["seq_idx"], fid), {
            "bboxes": mask_to_bbox(hand_m[t])[None],
            "verts": hv[None], "verts2d": uv.astype(np.float32)[None],
            "rotations": R[None], "translations": tr[None, None],
            "mano_pca_pose": np.zeros((1, 16), np.float32),
            "mano_rot": np.zeros((1, 3), np.float32),
            "mano_trans": np.zeros((1, 3), np.float32),
            "mano_betas": np.zeros((1, 10), np.float32),
            "masks": hand_m[t][None], "hand_side": ["right_hand"]},
            obj_m[t])


def _check_fit(root):
    sample = os.path.join(root, "samples", "00000000")
    for name in ("indep_fit.pkl", "joint_fit.npz", "results.pkl"):
        assert os.path.exists(os.path.join(sample, name)), name
    with open(os.path.join(sample, "results.pkl"), "rb") as fh:
        res = pickle.load(fh)
    for k, v in list(res["losses"].items()) + list(res["metrics"].items()):
        assert np.isfinite(np.asarray(v, np.float64)).all(), k
    assert set(res["budgets"]) == {"stage_b", "stage_c"}
    return res


@pytest.mark.parametrize("dataset", ["core50", "epic"])
def test_port_driver_fits_a_wild_clip_from_cached_evidence(
        tmp_path, monkeypatch, dataset):
    """`fit_video --dataset core50|epic --evidence_root` on the port, from
    the datasets' default folders: the clip, its evidence and the fit."""
    monkeypatch.chdir(tmp_path)
    data = os.path.join("local_data", "datasets")
    # The exemplar meshes both datasets look for in the ShapeNet dump
    # (CORe50's o6, EPIC's cup), as small meshes: the interaction metrics'
    # voxelizer runs its plain version on the CPU.
    from homan_tpu_torch.core.meshes import bumpy_potato, save_obj
    for name in (tc50.OBJECT_MODELS["o6"]["path"],
                 tep.EPIC_MODELS["cup"]["paths"][0]):
        os.makedirs(os.path.join(data, "shapenetmodels"), exist_ok=True)
        save_obj(os.path.join(data, "shapenetmodels", name),
                 *bumpy_potato(1, 1.0, seed=3))
    if dataset == "core50":
        _core50_tree(os.path.join(data, "core50"), sessions=(
            ("s1", "o6", "R"),), T=3)
        argv = ["--frame_nb", "3", "--chunk_step", "1"]
    else:
        os.makedirs(os.path.join(data, "epic"))
        _epic_annotations(os.path.join(data, "epic", "EPIC_100_train.pkl"))
        _write_hoa(thoa, os.path.join(data, "epic", "hoa", "P01_01.pkl"))
        argv = ["--frame_nb", "3"]
    args = TF.get_args(["--dataset", dataset, "--evidence_root", "ev",
                        "--result_root", "res"] + argv + SMALL_FIT)
    ds, size = tfactory.get_dataset(dataset, split=args.split,
                                    frame_nb=3, chunk_step=1)
    annots = ds[0]
    frame_hw = (350, 350) if dataset == "core50" else (tep.VIDEO_H,
                                                       tep.VIDEO_W)
    _record_clip_evidence(annots, frame_hw[1], frame_hw, "ev")
    out = TF.main(args, device="cpu")
    assert [o["sample"] for o in out] == [0]
    res = _check_fit("res")
    with open(os.path.join("res", "samples", "00000000", "indep_fit.pkl"),
              "rb") as fh:
        indep = pickle.load(fh)
    assert indep["hand_sides"] == ["right"]
    assert indep["person_parameters"]["masks"].shape == (3,) + frame_hw
    assert res["budgets"]["stage_b"]["edge_demand"] <= res["budgets"][
        "stage_b"]["edge_capacity"]
