"""PyTorch port vs JAX package: the scene renders, the overlay helpers and
the image writers of viz/, and the driver's overlays (CPU).

The JAX renders run its XLA path (its host renderer switched off, as
tests/test_native.py does), which bins min(2048, F + 64) faces a 64-pixel
tile; the port sizes Kf from the measured demand. Bands: uint8 frames of
the same scene differ by at most 1 (rounding) on all but 0.1% of the
pixels, where an edge's inside test or a float difference of a shading
term moves a value; extras pixel-equal; the PNG and APNG writers read back
(with PIL) to the same pixels.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import homan_tpu.native as jnative
from homan_tpu.core.meshes import icosphere
from homan_tpu.viz import extras as jex
from homan_tpu.viz import render_viz as jrv
from homan_tpu_torch import native
from homan_tpu_torch.viz import extras as tex
from homan_tpu_torch.viz import render_viz as trv

from torch_port_common import port_from_jax, scene_pair

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture
def jax_xla_viz(monkeypatch):
    """The JAX render_scene on its XLA path (rasterize_hard at
    min(2048, F + 64) faces a tile)."""
    monkeypatch.setattr(jnative, "raster_available", lambda: False)
    return jrv


def _differ(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return int((d > 1).any(-1).sum()), int(d.max())


def test_visualize_hand_object_matches_jax(jax_xla_viz):
    """Frontal and top-down overlays of make_synthetic_scene: the port's
    frames against the JAX package's, uint8 pixels that differ counted."""
    js, _ = scene_pair()
    state, consts, cfg = port_from_jax(js)
    budgets = []
    tf, tt = trv.visualize_hand_object(state, consts, cfg, image_size=64,
                                       budgets=budgets)
    jf, jt = jax_xla_viz.visualize_hand_object(js.init_state, js.consts,
                                               js.cfg, image_size=64)
    assert len(tf) == len(jf) == 2 and len(tt) == len(jt) == 2
    for ours, theirs in zip(tf + tt, jf + jt):
        assert ours.shape == theirs.shape == (64, 64, 3)
        assert ours.dtype == np.uint8
        n, worst = _differ(ours, theirs)
        print(f"pixels differing by more than 1: {n} of {64 * 64}, "
              f"max {worst}")
        assert n <= 0.001 * 64 * 64
        assert (ours < 250).any()  # something was drawn
    # Each render's budget covers its demand at its tile.
    assert len(budgets) == 2
    for b in budgets:
        assert b["faces_per_tile"] == b["face_demand"][b["tile_px"]]


def test_render_scene_keeps_the_faces_the_jax_xla_path_drops(jax_xla_viz):
    """A 5,120-face sphere in one 64-pixel tile: its demand exceeds the JAX
    budget of min(2048, F + 64), so the JAX XLA path drops faces (holes);
    the port binds every face and agrees with the host renderer, which
    draws every face."""
    v, f = icosphere(4, 0.1)
    v = (np.asarray(v, np.float32) + np.array([0, 0, 0.5], np.float32))[None]
    K = np.array([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]], np.float32)
    budgets = []
    ours = trv.render_scene([v], [f], ["gold"], K, image_size=64,
                            device="cpu", budgets=budgets)[0]
    demand = budgets[0]["face_demand"][64]
    assert demand > min(2048, f.shape[0] + 64)
    theirs = jax_xla_viz.render_scene([v], [np.asarray(f)], ["gold"], K,
                                      image_size=64)[0]
    colors = np.tile(np.asarray([0.85, 0.7, 0.2], np.float32),
                     (f.shape[0], 1))
    full = native.raster_phong(v[0], f, K[0], colors, image_size=64)
    ref = trv.composite(full["rgb"], full["sil"].astype(np.float32), None)
    n_port, _ = _differ(ours, ref)
    n_jax, _ = _differ(theirs, ref)
    print(f"demand {demand}: pixels off the every-face render: port "
          f"{n_port}, JAX XLA path {n_jax}")
    assert n_port <= 2
    assert n_jax > 100


def test_rotate_composite_and_colors_match_jax():
    rng = np.random.RandomState(0)
    v = rng.randn(2, 30, 3).astype(np.float32)
    np.testing.assert_array_equal(trv.rotate_in_place(v[0]),
                                  jrv.rotate_in_place(v[0]))
    rgb = rng.rand(16, 16, 3).astype(np.float32)
    sil = rng.rand(16, 16) > 0.5
    img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    for image in (None, img, img[:16, :16]):
        np.testing.assert_array_equal(trv.composite(rgb, sil, image),
                                      jrv.composite(rgb, sil, image))
    from homan_tpu.core import meshes as jm
    from homan_tpu_torch.core import meshes as tm
    assert tm.COLORS == jm.COLORS
    faces = [np.array([[0, 1, 2]]), np.array([[0, 2, 1], [1, 2, 0]])]
    parts = [v[:1, :3], v[:1, :4]]
    for a, b in zip(tm.get_faces_and_textures(parts, faces, ["gold", "grey"]),
                    jm.get_faces_and_textures(parts, faces, ["gold", "grey"])):
        np.testing.assert_array_equal(a, b)


def test_extras_are_pixel_equal():
    rng = np.random.RandomState(1)
    img = (rng.rand(40, 50, 3) * 255).astype(np.uint8)
    mask = np.zeros((40, 50), bool)
    mask[10:25, 12:30] = True
    hand = np.zeros((40, 50), bool)
    hand[5:12, 30:45] = True
    np.testing.assert_array_equal(tex.mask_border(mask),
                                  jex.mask_border(mask))
    np.testing.assert_array_equal(tex.overlay_mask(img, mask),
                                  jex.overlay_mask(img, mask))
    # cv2 draws into contiguous inputs in place (both packages): copies.
    np.testing.assert_array_equal(
        tex.add_clip_text([img.copy(), img.copy()], "clip 3"),
        jex.add_clip_text([img.copy(), img.copy()], "clip 3"))
    np.testing.assert_array_equal(
        tex.draw_bbox(img.copy(), [5, 6, 30, 20], label="obj"),
        jex.draw_bbox(img.copy(), [5, 6, 30, 20], label="obj"))
    kw = dict(hand_bboxes={"right": [30, 5, 45, 12]}, obj_bbox=[12, 10, 30,
                                                                 25],
              hand_masks={"right": hand}, obj_mask=mask)
    np.testing.assert_array_equal(
        tex.frame_detection_panel(img.copy(), **kw),
        jex.frame_detection_panel(img.copy(), **kw))
    assert tex.html_video_embed("a.webm") == jex.html_video_embed("a.webm")


def test_gtpred_point_grid_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    imgs = [(rng.rand(32, 32, 3) * 255).astype(np.uint8) for _ in range(2)]
    pts = [rng.rand(20, 2) * 32 for _ in range(2)]
    a = tex.gtpred_point_grid(imgs, pts, pts, str(tmp_path / "t.png"))
    b = jex.gtpred_point_grid(imgs, pts, pts, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(PIL.open(a)),
                                  np.asarray(PIL.open(b)))


def test_extras_without_cv2_raise_naming_the_function(monkeypatch):
    import importlib
    real = importlib.import_module

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *a, **k)

    monkeypatch.setattr(importlib, "import_module", no_cv2)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ImportError, match="add_clip_text needs cv2"):
        tex.add_clip_text([img], "x")
    with pytest.raises(ImportError, match="draw_bbox needs cv2"):
        tex.draw_bbox(img, [0, 0, 4, 4])


def _frames(rng, n=4, h=24, w=40):
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_png_writer_reads_back(tmp_path):
    rng = np.random.RandomState(3)
    img = _frames(rng, 1)[0]
    path = trv.write_png(img, str(tmp_path / "a.png"))
    np.testing.assert_array_equal(np.asarray(PIL.open(path).convert("RGB")),
                                  img)
    np.testing.assert_array_equal(trv.read_apng(path)[0], img)
    # float images in [0, 1] are quantized as the JAX composite does
    f = rng.rand(5, 6, 3).astype(np.float32)
    trv.write_png(f, str(tmp_path / "f.png"))
    np.testing.assert_array_equal(
        np.asarray(PIL.open(str(tmp_path / "f.png")).convert("RGB")),
        (np.clip(f, 0, 1) * 255).astype(np.uint8))


def test_apng_writer_reads_back(tmp_path):
    from PIL import ImageSequence
    rng = np.random.RandomState(4)
    frames = _frames(rng, 5)
    path = trv.write_apng(frames, str(tmp_path / "v.apng"), fps=4)
    im = PIL.open(path)
    assert getattr(im, "n_frames", 1) == 5
    got = [np.asarray(fr.convert("RGB")) for fr in ImageSequence.Iterator(im)]
    assert len(got) == 5
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    assert im.info.get("duration") == 250  # 1/4 s a frame
    ours = trv.read_apng(path)
    assert len(ours) == 5
    for a, b in zip(ours, frames):
        np.testing.assert_array_equal(a, b)


def test_writers_without_their_libraries(tmp_path, monkeypatch):
    """cv2, PIL and matplotlib missing (as on the card's machine): a video
    becomes <stem>.apng beside the requested name, the grid a PNG of the
    rows without labels; the paths written are returned."""
    rng = np.random.RandomState(5)
    frames = _frames(rng, 3)
    monkeypatch.setattr(trv, "_import_optional", lambda name: None)
    for name in ("clip.webm", "clip.mp4", "clip.gif"):
        out = trv.make_video(frames, str(tmp_path / name), fps=8)
        assert out == str(tmp_path / "clip.apng")
        assert not os.path.exists(tmp_path / name)
        got = trv.read_apng(out)
        assert len(got) == 3
        np.testing.assert_array_equal(got[2], frames[2])
    rows = {"a": frames, "b": frames[:2] + [None]}
    out = trv.save_image_grid(rows, str(tmp_path / "grid.png"))
    grid = np.asarray(PIL.open(out).convert("RGB"))
    assert grid.shape == (2 * 24, 3 * 40, 3)
    np.testing.assert_array_equal(grid[24:, 40:80], frames[1])
    assert (grid[24:, 80:] == 255).all()


def test_writers_with_their_libraries_give_the_jax_formats(tmp_path):
    rng = np.random.RandomState(6)
    frames = _frames(rng, 3)
    out = trv.make_video(frames, str(tmp_path / "a.gif"), fps=8)
    assert out.endswith("a.gif") and PIL.open(out).n_frames == 3
    out = trv.save_image_grid({"r": frames}, str(tmp_path / "g.png"))
    jout = jrv.save_image_grid({"r": frames}, str(tmp_path / "jg.png"))
    np.testing.assert_array_equal(np.asarray(PIL.open(out)),
                                  np.asarray(PIL.open(jout)))
    pytest.importorskip("cv2")
    out = trv.make_video(frames, str(tmp_path / "a.mp4"), fps=8)
    assert out.endswith("a.mp4") and os.path.getsize(out) > 0


def test_driver_writes_overlays_in_the_cards_formats(tmp_path, monkeypatch):
    """fit_video with --viz_step on the CPU, the writers' libraries
    missing: final_points.png, final_points.apng and optim_evolution.apng
    next to joint_fit.npz and results.pkl, with the frames the renders
    gave; the timers and the renders' face budgets are reported."""
    from homan_tpu_torch.cli import fit_video as TF
    from torch_port_common import ho3d_tree
    tree = ho3d_tree(tmp_path, frames=4, obj_subdiv=1)
    monkeypatch.chdir(tree)
    monkeypatch.setattr(trv, "_import_optional", lambda name: None)
    out = TF.main(TF.get_args([
        "--gt_masks", "1", "--frame_nb", "2", "--chunk_step", "1",
        "--num_initializations", "4", "--num_obj_iterations", "1",
        "--num_joint_iterations", "4", "--viz_step", "2", "--rend_size",
        "64", "--result_root", "res"]), device="cpu")[0]
    sample = os.path.join("res", "samples", "00000000")
    for name in ("joint_fit.npz", "results.pkl", "final_points.png",
                 "final_points.apng", "optim_evolution.apng"):
        assert os.path.exists(os.path.join(sample, name)), name
    assert sorted(os.path.basename(p) for p in out["viz_files"]) == [
        "final_points.apng", "final_points.png", "optim_evolution.apng"]
    video = trv.read_apng(os.path.join(sample, "final_points.apng"))
    assert len(video) == 2 and video[0].shape == (256, 512, 3)
    # the initial frame, one snapshot (step 2; step 4 ends the fit), the
    # final frame
    evo = trv.read_apng(os.path.join(sample, "optim_evolution.apng"))
    assert len(evo) == 3 and evo[0].shape == (256, 256, 3)
    grid = trv.read_apng(os.path.join(sample, "final_points.png"))[0]
    assert grid.shape == (3 * 256, 2 * 256, 3)
    assert {"viz_step_snapshots", "viz_final"} <= set(out["timers"])
    # one snapshot (frontal, top-down), the final pair, the initial pair
    assert len(out["viz_budgets"]) == 6
    for b in out["viz_budgets"]:
        assert b["faces_per_tile"] == b["face_demand"][b["tile_px"]]
    with open(os.path.join(sample, "results.pkl"), "rb") as f:
        assert set(pickle.load(f)) == {"opts", "metrics", "losses",
                                       "budgets"}


def test_render_scene_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = np.zeros((1, 3, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trv.render_scene([v], [np.array([[0, 1, 2]])], ["gold"],
                         np.eye(3, dtype=np.float32)[None], image_size=64)
