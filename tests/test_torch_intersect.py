"""PyTorch port vs JAX package: the triangle-intersection collision
(`collision_mode="tritri"`, interactions/intersect.py) and its branch of
compute_all_losses (CPU, same numpy inputs).

Bands: intersection masks equal; the loss within rtol 1e-5 and its
gradients within 1e-4 of their maximum (the detection is the same, the
penalty sums in another order); chunking over the object's faces exact up
to summation order (rtol 1e-6); through compute_all_losses iteration 0 per
term rtol 3e-4 and a short joint fit's totals rtol 3e-3, the bands of
tests/test_torch_fit.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.core.meshes import icosphere
from homan_tpu.fit import joint as JJ
from homan_tpu.fit import losses as JL
from homan_tpu.interactions import intersect as JI
from homan_tpu_torch import convert
from homan_tpu_torch.fit import joint as TJ
from homan_tpu_torch.fit import losses as TL
from homan_tpu_torch.interactions import intersect as TI

from torch_port_common import (assert_grad_close, port_from_jax, scene_pair,
                               settings_pair, t2n)

# The sphere pairs of tests/test_intersect.py and two more overlaps.
OFFSETS = ([0.12, 0, 0], [0.5, 0, 0], [0.0, 0, 0], [0.08, 0, 0],
           [0.05, 0.03, 0.01], [0.16, 0.02, -0.03])


@functools.lru_cache(maxsize=None)
def _sphere():
    v, f = icosphere(2, 0.1)
    return np.asarray(v, np.float32)[np.asarray(f)]


def _both(tri_a, tri_b):
    jm = np.asarray(JI.tri_tri_intersect(jnp.asarray(tri_a),
                                         jnp.asarray(tri_b)))
    tm = TI.tri_tri_intersect(torch.from_numpy(tri_a),
                              torch.from_numpy(tri_b)).numpy()
    return jm, tm


def test_tri_tri_intersect_basic():
    a = np.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    cross = np.asarray([[[0.2, 0.2, -0.5], [0.2, 0.2, 0.5], [0.8, 0.8, 0.1]]],
                       np.float32)
    above = cross + np.float32([0, 0, 1.0])
    far = np.asarray([[[5.0, 5, -0.5], [5, 5, 0.5], [6, 6, 0.1]]], np.float32)
    for b, want in ((cross, True), (above, False), (far, False)):
        jm, tm = _both(a, b)
        assert bool(tm[0, 0]) == bool(jm[0, 0]) == want


@pytest.mark.parametrize("offset", OFFSETS, ids=lambda o: str(o))
def test_masks_equal_jax_on_sphere_pairs(offset):
    tri = _sphere()
    other = tri + np.asarray(offset, np.float32)
    jm, tm = _both(tri, other)
    np.testing.assert_array_equal(tm, jm)
    ja = np.asarray(JI._aabb_overlap(jnp.asarray(tri), jnp.asarray(other)))
    ta = TI._aabb_overlap(torch.from_numpy(tri),
                          torch.from_numpy(other)).numpy()
    np.testing.assert_array_equal(ta, ja)


@functools.lru_cache(maxsize=None)
def _hand_object():
    """One frame of the synthetic scene's closed hand and its object pushed
    into it (tests/test_torch_sdf.py's inputs)."""
    js, _ = scene_pair()
    hand = np.array(js.gt_verts_hand)[:1]
    obj = np.array(js.gt_verts_object)[:1]
    obj = obj + (hand.mean(1, keepdims=True) - obj.mean(1, keepdims=True)
                 ) * np.float32(0.7)
    return (hand, obj.astype(np.float32), np.array(js.closed_hand_faces),
            np.array(js.consts.faces_object.faces))


def test_masks_equal_jax_on_the_synthetic_hand_and_object():
    hand, obj, hf, of = _hand_object()
    tri_h, tri_o = hand[0][hf], obj[0][of]
    jm, tm = _both(tri_h, tri_o)
    print(f"intersecting pairs: {int(tm.sum())} of {tm.size}")
    assert tm.sum() > 10
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("offset", OFFSETS[:1] + OFFSETS[3:],
                         ids=lambda o: str(o))
def test_pair_loss_and_gradients_match_jax(offset):
    tri = _sphere()
    other = tri + np.asarray(offset, np.float32)
    jl, (ga, gb) = jax.value_and_grad(JI.pair_penetration_loss,
                                      argnums=(0, 1))(jnp.asarray(tri),
                                                      jnp.asarray(other))
    ta = torch.from_numpy(tri).requires_grad_(True)
    tb = torch.from_numpy(other).requires_grad_(True)
    tl = TI.pair_penetration_loss(ta, tb)
    tl.backward()
    assert float(jl) > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_grad_close(t2n(ta.grad), np.asarray(ga), rel=1e-4, name="d/da")
    assert_grad_close(t2n(tb.grad), np.asarray(gb), rel=1e-4, name="d/db")


def test_chunking_over_object_faces_is_exact():
    """Chunks of the object's faces (max_pairs) sum to the unchunked loss;
    leading frame and hand dims give each frame's loss."""
    tri = _sphere()
    a = torch.from_numpy(np.stack([tri + [0.12, 0, 0], tri + [0.05, 0, 0],
                                   tri + [0.5, 0, 0]]).astype(np.float32))
    b = torch.from_numpy(tri)[None].expand(3, -1, -1, -1)
    whole = TI.pair_penetration_loss(a, b, max_pairs=1 << 30)
    for cap in (1, 5000, 3 * 320 * 7):
        np.testing.assert_allclose(
            TI.pair_penetration_loss(a, b, max_pairs=cap).numpy(),
            whole.numpy(), rtol=1e-6)
    for i in range(3):
        np.testing.assert_allclose(
            float(whole[i]), float(JI.pair_penetration_loss(
                jnp.asarray(a[i].numpy()), jnp.asarray(tri))), rtol=1e-5)
    assert float(whole[2]) == 0.0


@pytest.mark.parametrize("hand_nb", [1, 2])
def test_clip_loss_matches_jax(hand_nb):
    """compute_collision_loss_tritri over frames (and the hand-hand pair
    with two hands), value and gradients."""
    v, f = icosphere(2, 0.1)
    v = np.asarray(v, np.float32)
    rng = np.random.RandomState(hand_nb)
    B = 3
    obj = v[None] + rng.randn(B, 1, 3).astype(np.float32) * 0.02
    hand = (v[None] + np.float32([0.1, 0, 0])
            + rng.randn(B * hand_nb, 1, 3).astype(np.float32) * 0.04)
    jl, (gh, go) = jax.value_and_grad(
        lambda h, o: JI.compute_collision_loss_tritri(
            h, jnp.asarray(f), o, jnp.asarray(f), hand_nb),
        argnums=(0, 1))(jnp.asarray(hand), jnp.asarray(obj))
    th = torch.from_numpy(hand).requires_grad_(True)
    to = torch.from_numpy(obj).requires_grad_(True)
    tl = TI.compute_collision_loss_tritri(th, f, to, f, hand_nb)
    tl.backward()
    assert float(jl) > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_grad_close(t2n(th.grad), np.asarray(gh), rel=1e-4, name="d/dh")
    assert_grad_close(t2n(to.grad), np.asarray(go), rel=1e-4, name="d/do")


def test_hand_object_loss_matches_jax():
    hand, obj, hf, of = _hand_object()
    jl, (gh, go) = jax.value_and_grad(
        lambda h, o: JI.compute_collision_loss_tritri(
            h, jnp.asarray(hf), o, jnp.asarray(of), 1),
        argnums=(0, 1))(jnp.asarray(hand), jnp.asarray(obj))
    th = torch.from_numpy(hand).requires_grad_(True)
    to = torch.from_numpy(obj).requires_grad_(True)
    tl = TI.compute_collision_loss_tritri(th, hf, to, of, 1)
    tl.backward()
    assert float(jl) > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_grad_close(t2n(th.grad), np.asarray(gh), rel=1e-4, name="d/dh")
    assert_grad_close(t2n(to.grad), np.asarray(go), rel=1e-4, name="d/do")


def _lw(**on):
    lw = {k: 0.0 for k in TL.DEFAULT_LW}
    lw.update(on)
    return lw


@pytest.mark.parametrize("lw_contact", [0.0, 1.0])
def test_collision_never_pushes_the_object(lw_contact):
    """With collision (and contact) alone, tritri gives the object's pose
    no gradient from collision: zero with contact off; with contact on,
    the object's gradient is the contact term's alone."""
    js, _ = scene_pair()
    state, consts, cfg = port_from_jax(js)
    cfg = dataclasses.replace(cfg, collision_mode="tritri")
    closed = convert.faces_from_numpy(js.closed_hand_faces, "cpu")

    def grads(lw):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in vars(state).items() if v is not None}
        s = dataclasses.replace(state, **params)
        loss_dict, _ = TL.compute_all_losses(s, consts, cfg, lw,
                                             closed_hand_faces=closed)
        TL.weighted_sum(loss_dict, lw).backward()
        return loss_dict, {k: v.grad for k, v in params.items()}

    loss_dict, g = grads(_lw(lw_collision=1.0, lw_contact=lw_contact))
    assert ("loss_contact" in loss_dict) == (lw_contact > 0)
    if lw_contact == 0:
        for k in ("translations_object", "rotations_object",
                  "int_scales_object"):
            assert g[k] is None or float(g[k].abs().max()) == 0.0, k
    else:
        _, gc = grads(_lw(lw_contact=lw_contact))
        for k in ("translations_object", "rotations_object"):
            torch.testing.assert_close(g[k], gc[k], rtol=1e-6, atol=1e-9)
    assert torch.isfinite(g["translations_hand"]).all()


@pytest.mark.parametrize("lw_contact", [0.0, 1.0])
def test_tritri_terms_match_jax_and_skip_the_voxelizer(lw_contact,
                                                       monkeypatch):
    """compute_all_losses' tritri branch against the JAX package's: the
    same keys in the same order, iteration-0 values; the SDF terms run for
    contact alone, and with lw_contact 0 not at all (so the grid mode
    launches no voxelizer)."""
    js, _ = scene_pair(obj_subdiv=1)
    lw = dict(TL.DEFAULT_LW, lw_collision=1e-3, lw_contact=lw_contact)
    jcfg = dataclasses.replace(js.cfg, collision_mode="tritri")
    jset, tset = settings_pair(64, 32, 48)
    jd, _ = JL.compute_all_losses(js.init_state, js.consts, jcfg, lw,
                                  closed_hand_faces=js.closed_hand_faces,
                                  roi_settings=jset)
    state, consts, cfg = port_from_jax(js)
    cfg = dataclasses.replace(cfg, collision_mode="tritri")
    calls = []
    real = TL.compute_interaction_sdf_terms
    monkeypatch.setattr(TL, "compute_interaction_sdf_terms",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    td, _ = TL.compute_all_losses(
        state, consts, cfg, lw,
        closed_hand_faces=convert.faces_from_numpy(js.closed_hand_faces,
                                                   "cpu"),
        roi_settings=tset)
    assert list(td) == list(jd)
    assert "loss_collision" in td
    assert ("loss_contact" in td) == (lw_contact > 0)
    assert [(k["with_collision"], k["with_contact"]) for k in calls] == (
        [(False, True)] if lw_contact > 0 else [])
    for k in jd:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=3e-4,
                                   atol=1e-9, err_msg=k)


def test_tritri_joint_fit_matches_jax():
    """A few steps of the tritri + contact fit (direct SDF: the plain
    voxelizer of the grid mode takes seconds a call on the CPU), both
    packages from the JAX scene's data (an 80-face object)."""
    js, _ = scene_pair(obj_subdiv=1)
    lw = {"lw_collision": 1e-3, "lw_contact": 1.0}
    mode = {"collision_mode": "tritri", "sdf_mode": "direct"}
    iters = 3
    jset, tset = settings_pair(64, 32, 48)
    jf, jh = JJ.optimize_hand_object(
        js.init_state, js.consts, dataclasses.replace(js.cfg, **mode),
        loss_weights=lw, num_iterations=iters,
        closed_hand_faces=js.closed_hand_faces, roi_settings=jset)
    state, consts, cfg = port_from_jax(js)
    tf, th = TJ.optimize_hand_object(
        state, consts, dataclasses.replace(cfg, **mode), loss_weights=lw,
        num_iterations=iters,
        closed_hand_faces=convert.faces_from_numpy(js.closed_hand_faces,
                                                   "cpu"),
        roi_settings=tset, device="cpu")
    assert set(th) == set(jh)
    assert "loss_collision" in th
    for k in jh:
        atol = 1e-7 if k.startswith("loss") else 1e-5
        np.testing.assert_allclose(float(th[k][0]), float(jh[k][0]),
                                   rtol=3e-4, atol=atol, err_msg=f"iter0 {k}")
    np.testing.assert_allclose(t2n(th["loss"]), np.asarray(jh["loss"]),
                               rtol=3e-3)
    np.testing.assert_allclose(t2n(tf.translations_hand),
                               np.asarray(jf.translations_hand), atol=2e-3)


def test_fit_video_runs_tritri(tmp_path, monkeypatch):
    """fit_video --collision_mode tritri with the collision term on: the
    joint fit's history holds a finite loss_collision; --frames_sharded 1
    runs it unsharded on one device, with the same losses."""
    from homan_tpu_torch.cli import fit_video as TF
    from homan_tpu_torch.viz import render_viz
    from torch_port_common import ho3d_tree
    tree = ho3d_tree(tmp_path, frames=4, obj_subdiv=1)
    monkeypatch.chdir(tree)
    # The overlays are tested in tests/test_torch_viz.py.
    monkeypatch.setattr(render_viz, "visualize_hand_object",
                        lambda *a, **k: ([], []))
    argv = ["--gt_masks", "1", "--frame_nb", "2", "--chunk_step", "1",
            "--num_initializations", "4", "--num_obj_iterations", "1",
            "--num_joint_iterations", "3", "--rend_size", "64",
            "--viz_step", "0", "--collision_mode", "tritri",
            "--lw_collision", "1e-3", "--result_root", "res"]
    TF.main(TF.get_args(argv), device="cpu")
    import pickle
    with open("res/samples/00000000/results.pkl", "rb") as f:
        losses = pickle.load(f)["losses"]
    assert len(losses["loss_collision"]) == 3
    assert np.isfinite(losses["loss_collision"]).all()
    assert "loss_contact" not in losses
    TF.main(TF.get_args(argv + ["--frames_sharded", "1", "--result_root",
                                "sharded"]), device="cpu")
    with open("sharded/samples/00000000/results.pkl", "rb") as f:
        sharded = pickle.load(f)["losses"]
    assert sharded.keys() == losses.keys()
    for k in losses:
        np.testing.assert_array_equal(sharded[k], losses[k], err_msg=k)
