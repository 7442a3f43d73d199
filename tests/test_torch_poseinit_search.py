"""PyTorch port vs JAX package: whole stage-B searches (CPU, same inputs).

Both sides start from the JAX package's candidate rotations: the port's
`random_rotations` is patched to return them. The searches run the bench's
clip at test size (the bumpy potato turning about z, masks rendered by
`render_full_mask`) on the JAX package's default XLA path.

Bands: the same winner, or, where the winners differ, winners whose mean
IoUs tie within 1e-6 on both sides; the selected rotations and translations
atol 2e-3 (the JAX winner's, on both sides); `best_iou` atol 1e-3.

The schedules are short (5 steps a frame, 3 coarse). Each refinement step
turns a difference in arithmetic order into a larger one (the silhouette
band is a fraction of a pixel at 64^2): at 30 steps a frame and 10 coarse,
the JAX package's own XLA and Pallas paths pick different winners on this
clip (best IoU 0.9632 against 0.9606, rotations 0.02 apart), and so do it
and the port. At 5 steps both sides agree to about 1e-5.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from homan_tpu.core import geometry as jgeo
from homan_tpu.fit import poseinit as JP
from homan_tpu.frontend import evidence as jev
from homan_tpu.frontend import gtevidence as jgt
from homan_tpu.render import RasterSettings as JS
from homan_tpu.render.rasterizer import MeshTopology as JT
from homan_tpu_torch.core import geometry as tgeo
from homan_tpu_torch.core.meshes import bumpy_potato
from homan_tpu_torch.fit import poseinit as TP
from homan_tpu_torch.render import RasterSettings as TS

from test_torch_evidence import _clip
from torch_port_common import t2n

C, ITERS, COARSE, PRUNE, CHUNK = 24, 5, 3, 8, 10


@functools.lru_cache(maxsize=None)
def _annotations(frames, image_size, rend):
    """Per-frame object evidence of the clip, as bench.py bench_stageb
    builds it."""
    verts, faces, K = _clip(frames, image_size)
    masks = jgt.render_full_mask(verts, JT.from_faces(faces), K, image_size)
    ann = []
    for t in range(frames):
        info = jev.build_object_mask_info(
            masks[t], jgt.mask_to_bbox(masks[t]), None, rend)
        info["full_mask"] = None
        ann.append(info)
    return ann, list(K)


def _search_both(monkeypatch, frames, image_size, rend, **kw):
    ann, Ks = _annotations(frames, image_size, rend)
    v, f = bumpy_potato(1, 0.08, seed=0)
    n = kw.get("num_initializations", C)
    rots = np.array(jgeo.random_rotations(jax.random.PRNGKey(0), n))
    monkeypatch.setattr(
        tgeo, "random_rotations",
        lambda n_, generator=None, upright=False, device=None:
        torch.from_numpy(rots[:n_]).to(device))
    seen = {}

    def capture(side, fn):
        def wrapped(rot_all, trans_all, ious_all, vertices):
            seen[side] = [np.asarray(x.detach().cpu() if side == "port"
                                     else x)
                          for x in (rot_all, trans_all, ious_all)]
            return fn(rot_all, trans_all, ious_all, vertices)
        return wrapped

    monkeypatch.setattr(JP, "_select_best", capture("jax", JP._select_best))
    monkeypatch.setattr(TP, "_select_best", capture("port", TP._select_best))
    common = dict(num_initializations=C, num_iterations=ITERS,
                  rend_size=rend, seed=0, candidate_chunk=CHUNK)
    common.update(kw)
    j = JP.find_optimal_poses(v, JT.from_faces(f), ann, Ks,
                              (image_size, image_size),
                              settings=JS(rend, tile_px=32,
                                          edges_per_tile=96), **common)
    t = TP.find_optimal_poses(v, f, ann, Ks, (image_size, image_size),
                              settings=TS(rend, tile_px=32,
                                          edges_per_tile=96),
                              device="cpu", **common)
    return j, t, seen


def _check(j, t, seen):
    assert len(j) == len(t)
    mj, mt = seen["jax"][2].mean(0), seen["port"][2].mean(0)
    wj, wt = int(mj.argmax()), int(mt.argmax())
    if wj != wt:
        assert abs(mj[wj] - mj[wt]) <= 1e-6 and abs(mt[wj] - mt[wt]) <= 1e-6
    np.testing.assert_allclose(seen["port"][0][:, wj], seen["jax"][0][:, wj],
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(seen["port"][1][:, wj], seen["jax"][1][:, wj],
                               atol=2e-3, rtol=0)
    assert abs(t[0]["best_iou"] - float(j[0]["best_iou"])) <= 1e-3
    for a, b in zip(j, t):
        assert isinstance(b["best_iou"], float)
        for k, tol in (("rotations", 2e-3), ("translations", 2e-3),
                       ("verts_trans", 2e-3), ("K_roi", 1e-6),
                       ("target_masks", 0.0)):
            if wj == wt:
                np.testing.assert_allclose(t2n(b[k]), np.asarray(a[k]),
                                           atol=tol, rtol=0, err_msg=k)
            assert b[k].shape == np.asarray(a[k]).shape, k


@pytest.mark.parametrize("parallel_frames", [False, True])
def test_search_with_halving_and_rescore_matches_jax(monkeypatch,
                                                     parallel_frames):
    """Successive halving (24 -> 8) and the refinement at 64^2 with the
    full-resolution (128^2) rescore, chained or with frames 1-2 together."""
    j, t, seen = _search_both(monkeypatch, 3, 256, 128, prune_to=PRUNE,
                              coarse_iterations=COARSE, refine_scale=0.5,
                              parallel_frames=parallel_frames)
    assert seen["port"][2].shape == (3, PRUNE)
    _check(j, t, seen)


def test_exact_schedule_matches_jax(monkeypatch):
    """No halving and no low-resolution refinement: every candidate at the
    full 64^2 in every frame."""
    j, t, seen = _search_both(monkeypatch, 2, 128, 64, prune_to=None,
                              refine_scale=1.0, num_initializations=16)
    assert seen["port"][2].shape == (2, 16)
    _check(j, t, seen)


def test_stage_b_deterministic_and_empty_mask_robust():
    """The JAX package's test of the same name on the port: the same seed
    gives the same selected pose; a frame whose detection is empty gives
    finite poses."""
    v, f = bumpy_potato(1, 0.09, seed=3)
    S, img = 32, 64
    K_px = np.array([[img * 0.9, 0, img / 2], [0, img * 0.9, img / 2],
                     [0, 0, 1]], np.float32)
    settings = TS(image_size=S, tile_px=16, faces_per_tile=192,
                  edges_per_tile=128)
    mask = np.zeros((S, S), np.float32)
    mask[8:24, 10:26] = 1.0
    good = {"target_crop_mask": mask, "bbox": np.array([10.0, 8, 16, 16]),
            "square_bbox": np.array([8.0, 6, 20, 20], np.float32),
            "full_mask": None}
    empty = {"target_crop_mask": np.zeros((S, S), np.float32),
             "bbox": np.array([0.0, 0, 1, 1]),
             "square_bbox": np.array([0.0, 0, 2, 2], np.float32),
             "full_mask": None}

    def run():
        return TP.find_optimal_poses(
            v, f, [good, empty], [K_px, K_px], (img, img),
            num_initializations=16, num_iterations=5, rend_size=S,
            settings=settings, seed=3, device="cpu")

    r1, r2 = run(), run()
    for res in (r1, r2):
        assert torch.isfinite(res[0]["rotations"]).all()
        assert torch.isfinite(res[1]["translations"]).all()
    assert torch.equal(r1[0]["rotations"], r2[0]["rotations"])
    assert torch.equal(r1[1]["translations"], r2[1]["translations"])
