"""PyTorch port vs JAX package: the evidence assembly of the cached-detection
path (frontend/evidence.py), host numpy on both sides, so every output is
held exactly (tolerance 0).

The records are written to disk once per case and replayed by each
package's own CachedEvidence: one hand and two, masks tagged with
hand_side, untagged with the full count (paired by position), untagged
and short (skipped, with a warning), tagged with a side missing (filled
with zeros), and older records with no class_id (returned for every
query). Masks are 48 x 64: non-square, as a detector's on a 480 x 640
frame.
"""
import logging
import os
import pickle

import numpy as np
import pytest

from homan_tpu.frontend import evidence as je
from homan_tpu_torch.frontend import evidence as te

from torch_port_common import assert_same_tree as _assert_same

H, W, R = 48, 64, 32
SIDES = ("left_hand", "right_hand")
K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])


def _estimate(rng):
    return {"verts": rng.randn(778, 3).astype(np.float32),
            "verts2d": (rng.rand(778, 2) * 48).astype(np.float32),
            "rotations": np.eye(3, dtype=np.float32),
            "translations": rng.randn(1, 3).astype(np.float32),
            "mano_pca_pose": rng.randn(16).astype(np.float32),
            "mano_rot": rng.randn(3).astype(np.float32),
            "mano_trans": np.zeros(3, np.float32),
            "mano_betas": rng.randn(10).astype(np.float32),
            "cams": rng.randn(3).astype(np.float32)}


def _blob(rng, shape=(H, W)):
    m = np.zeros(shape, bool)
    y, x = rng.randint(4, shape[0] - 16), rng.randint(4, shape[1] - 16)
    m[y:y + rng.randint(6, 14), x:x + rng.randint(6, 14)] = True
    return m


def _write_clip(root, case, T=3, seed=0):
    """Records of a T-frame clip for one case; returns (keys, hand boxes,
    object boxes)."""
    rng = np.random.RandomState(seed)
    n_hands = 1 if case == "one_hand" else 2
    sides = SIDES[-n_hands:]
    keys = []
    for t in range(T):
        hands = {s: _estimate(rng) for s in sides}
        masks = []
        for s in sides:
            m = {"full_mask": _blob(rng), "score": 0.9}
            if case != "legacy":
                m["class_id"] = 0
            if case in ("one_hand", "two_tagged", "side_missing"):
                m["hand_side"] = s
            masks.append(m)
        if case == "side_missing" and t == 1:
            masks = masks[1:]
        if case == "short_untagged":
            masks = masks[:1]
        obj = {"full_mask": _blob(rng), "score": 0.8}
        if case != "legacy":
            obj["class_id"] = -1
            masks.append(obj)
        else:
            masks.insert(0, obj)
        keys.append(f"clip_{t:06d}")
        je.save_frame_evidence(root, keys[-1], masks, hands)
    boxes = {s: np.tile(np.array([[8.0, 6, 30, 28]], np.float32), (T, 1))
             + rng.rand(T, 4).astype(np.float32) for s in sides}
    obj_boxes = np.array([[20.0, 10, 44, 36]] * T, np.float32)
    return keys, boxes, obj_boxes


CASES = ["one_hand", "two_tagged", "two_untagged", "short_untagged",
         "side_missing", "legacy"]


@pytest.mark.parametrize("case", CASES)
def test_get_frame_infos_matches_jax(tmp_path, case, caplog):
    keys, boxes, obj_boxes = _write_clip(str(tmp_path), case)
    T = len(keys)
    outs = []
    for mod in (je, te):
        cache = mod.CachedEvidence(str(tmp_path))
        with caplog.at_level(logging.WARNING):
            outs.append(mod.get_frame_infos(
                [None] * T, cache, cache, boxes, obj_boxes,
                np.tile(K[None], (T, 1, 1)), image_size=W, rend_size=R,
                frame_keys=keys))
    _assert_same(outs[1], outs[0])
    person, obj = outs[1]
    if case in ("short_untagged", "legacy"):
        # Untagged, and not one mask a hand (an older record answers the
        # hand query with the object's mask too): no hand masks.
        assert all("masks" not in h for f in person for h in f)
        assert sum("tracked hands and no hand_side tags" in r.getMessage()
                   for r in caplog.records) == 2 * T
    if case == "side_missing":
        assert not person[1][0]["masks"].any()  # the left side's zeros
    assert [h["hand_side"] for h in person[0]] == [
        s.replace("_hand", "") for s in SIDES[-len(boxes):]]
    if case not in ("short_untagged", "legacy"):
        stacked = [mod.stack_person_parameters(person) for mod in (je, te)]
        _assert_same(stacked[1], stacked[0])
        assert stacked[1]["masks"].shape == (T * len(boxes), H, W)


def test_cached_evidence_class_dispatch_matches_jax(tmp_path):
    keys, _, _ = _write_clip(str(tmp_path), "two_tagged", T=1)
    answers = []
    for mod in (je, te):
        cache = mod.CachedEvidence(str(tmp_path))
        answers.append([cache.masks_from_bboxes(keys[0], None, [0]),
                        cache.masks_from_bboxes(keys[0], None, [-1]),
                        cache.regress(keys[0], None)])
    _assert_same(answers[1], answers[0])
    hand_q, obj_q, _ = answers[1]
    assert [m["class_id"] for m in hand_q] == [0, 0]
    assert [m["class_id"] for m in obj_q] == [-1]


def test_cached_evidence_keeps_the_newest_128_frames(tmp_path):
    for i in range(130):
        te.save_frame_evidence(str(tmp_path), f"k{i}", [], {"i": i})
    memos = []
    for mod in (je, te):
        cache = mod.CachedEvidence(str(tmp_path))
        for i in range(130):
            assert cache.regress(f"k{i}", None) == {"i": i}
        memos.append(list(cache._memo))
    assert memos[1] == memos[0] == [f"k{i}" for i in range(2, 130)]
    assert te.MEMO_FRAMES == 128
    # A kept record is not read from disk again.
    cache = te.CachedEvidence(str(tmp_path))
    cache.regress("k0", None)
    os.remove(os.path.join(str(tmp_path), "k0.pkl"))
    assert cache.regress("k0", None) == {"i": 0}


def test_save_frame_evidence_writes_what_jax_writes(tmp_path):
    rng = np.random.RandomState(3)
    masks = [{"full_mask": _blob(rng), "score": 0.5, "class_id": -1}]
    hands = {"right_hand": _estimate(rng)}
    je.save_frame_evidence(str(tmp_path / "j"), "f", masks, hands)
    te.save_frame_evidence(str(tmp_path / "t"), "f", masks, hands)
    loaded = []
    for d in ("j", "t"):
        with open(tmp_path / d / "f.pkl", "rb") as fh:
            loaded.append(pickle.load(fh))
    _assert_same(loaded[1], loaded[0])


def test_process_hand_estimates_matches_jax():
    """LEFT before RIGHT whatever the dict order; a side needs a box."""
    rng = np.random.RandomState(1)
    est = {"right_hand": _estimate(rng), "left_hand": _estimate(rng)}
    masks = {"right_hand": _blob(rng), "left_hand": None}
    for boxes in ({"right_hand": np.ones(4), "left_hand": np.zeros(4)},
                  {"right_hand": np.ones(4), "left_hand": None},
                  {"right_hand": np.ones(4)}):
        ours = te.process_hand_estimates(est, masks, boxes)
        _assert_same(ours, je.process_hand_estimates(est, masks, boxes))
        assert ours[-1]["hand_side"] == "right"
    assert [h["hand_side"] for h in ours] == ["right"]


@pytest.mark.parametrize("with_estimates", [True, False])
def test_process_body_estimates_matches_jax(with_estimates):
    rng = np.random.RandomState(2)
    n = 3
    boxes = np.array([[300.0, 40, 420, 300], [20, 60, 180, 330],
                      [150, 10, 260, 200]], np.float32)
    body = [{"pred_vertices_smpl": rng.randn(50, 3),
             "faces": rng.randint(0, 50, (20, 3)),
             "pred_camera": rng.rand(3) + 0.5,
             "bbox_scale_ratio": float(rng.rand() + 0.5),
             "global_cams": rng.randn(3)} for _ in range(n)]
    masks = rng.rand(n, 48, 64) > 0.5
    args = (body if with_estimates else None, boxes)
    ours = te.process_body_estimates(*args, image_size=64, masks=masks)
    _assert_same(ours, je.process_body_estimates(*args, image_size=64,
                                                 masks=masks))
    assert ours["bboxes"][0, 0] == 20 and ours["masks"].shape == (n, 64, 64)
