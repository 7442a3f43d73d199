"""PyTorch port vs JAX package: the stage-C loss terms, their metrics and
the gradient of the weighted sum (CPU, same inputs on both sides).

Bands: every term and metric within rtol 3e-4 (the iteration-0 band of
tests/test_jointopt_parity.py), gradients within 3e-3 of their maximum
(tests/test_pallas_shade.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.fit import losses as JL
from homan_tpu.fit import model as JM
from homan_tpu_torch.fit import losses as TL
from homan_tpu_torch.fit import model as TM

from torch_port_common import (assert_grad_close, port_from_jax, scene_pair,
                               settings_pair, t2n, to_numpy)

SETTINGS = settings_pair(64, 32, 48)


@functools.lru_cache(maxsize=None)
def _jax_side():
    """JAX losses, metrics and per-leaf gradients of the weighted sum at the
    scene's initial state, in one compiled program."""
    js, _ = scene_pair()
    jset, _ = SETTINGS
    lw = dict(JL.DEFAULT_LW)

    def total(s):
        ld, md = JL.compute_all_losses(s, js.consts, js.cfg, lw,
                                       roi_settings=jset)
        return JL.weighted_sum(ld, lw), (ld, md)

    (_, (jl, jm)), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
        js.init_state)
    return jl, jm, to_numpy(jg)


def _losses():
    js, _ = scene_pair()
    jl, jm, _ = _jax_side()
    state, consts, cfg = port_from_jax(js)
    tl, tm = TL.compute_all_losses(state, consts, cfg, dict(TL.DEFAULT_LW),
                                   roi_settings=SETTINGS[1])
    return jl, jm, tl, tm


def test_default_lw_is_the_same():
    assert TL.DEFAULT_LW == JL.DEFAULT_LW


def test_compute_all_losses_default_lw():
    jl, jm, tl, tm = _losses()
    assert set(tl) == set(jl)
    # The JAX package's insertion order (homan_tpu/fit/losses.py:379-440),
    # so the weighted sums add up in the same order.
    assert list(tl) == ["loss_pca", "loss_smooth_obj", "loss_smooth_hand",
                        "loss_v2d_hand", "loss_sil_obj", "loss_inter",
                        "loss_scale_obj", "loss_scale_hand"]
    assert set(tm) == set(jm)
    for k in list(jl) + list(jm):
        j = float(np.asarray({**jl, **jm}[k]))
        t = float({**tl, **tm}[k])
        np.testing.assert_allclose(t, j, rtol=3e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(TL.weighted_sum(tl, JL.DEFAULT_LW)),
                               float(JL.weighted_sum(jl, JL.DEFAULT_LW)),
                               rtol=3e-4)


def test_weighted_sum_gradient_per_leaf():
    js, _ = scene_pair()
    _, tset = SETTINGS
    lw = dict(JL.DEFAULT_LW)
    jg = _jax_side()[2]
    state, consts, cfg = port_from_jax(js)
    state = state.map(lambda x: x.clone().requires_grad_(True))
    TL.weighted_sum(TL.compute_all_losses(state, consts, cfg, lw,
                                          roi_settings=tset)[0],
                    lw).backward()
    for name, g in jg.items():
        t = getattr(state, name).grad
        t = np.zeros_like(g) if t is None else t2n(t)
        if not np.any(g):
            assert not np.any(t), name
            continue
        assert_grad_close(t, g, name=name)


def _interaction_inputs():
    js, ts = scene_pair()
    vo = np.asarray(js.gt_verts_object) + np.array([0.06, 0.0, 0.0],
                                                   np.float32)
    vh = np.asarray(js.gt_verts_hand)
    K = np.asarray(js.consts.camintr)
    return vh, vo, K, js.cfg


@pytest.mark.parametrize("inter_type", ["centroid", "min"])
def test_interaction_loss_both_types(inter_type):
    vh, vo, K, jcfg = _interaction_inputs()
    jcfg = dataclasses.replace(jcfg, inter_type=inter_type)
    tcfg = TM.HomanConfig(hand_sides=jcfg.hand_sides, inter_type=inter_type)

    def jf(h, o):
        loss, m = JL.compute_interaction_loss(h, o, jnp.asarray(K), jcfg)
        return loss["loss_inter"], m["handobj_maxdist"]

    (jloss, jdist), (jgh, jgo) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(vh), jnp.asarray(vo))
    th = torch.from_numpy(vh).requires_grad_(True)
    to = torch.from_numpy(vo).requires_grad_(True)
    tl, tm = TL.compute_interaction_loss(th, to, torch.from_numpy(K), tcfg)
    tl["loss_inter"].backward()
    assert float(jloss) > 0  # the gate is open: the term is exercised
    np.testing.assert_allclose(tl["loss_inter"].item(), float(jloss),
                               rtol=3e-4)
    np.testing.assert_allclose(tm["handobj_maxdist"].item(), float(jdist),
                               rtol=3e-4)
    assert_grad_close(t2n(th.grad), np.asarray(jgh), name="d/dhand")
    assert_grad_close(t2n(to.grad), np.asarray(jgo), name="d/dobject")


def test_sil_loss_hand_matches():
    js, _ = scene_pair()
    jset, tset = settings_pair(64, 16, 64)
    state, consts, cfg = port_from_jax(js)
    jv, _ = JM.get_verts_hand(js.init_state, js.consts, js.cfg)
    tv, _ = TM.get_verts_hand(state, consts, cfg)
    np.testing.assert_allclose(t2n(tv), np.asarray(jv), atol=1e-5)
    j = JL.compute_sil_loss_hand(jv, js.consts.faces_hand,
                                 js.consts.camintr_rois_hand,
                                 js.consts.ref_mask_hand,
                                 js.consts.keep_mask_hand, jset)
    t = TL.compute_sil_loss_hand(tv, consts.faces_hand,
                                 consts.camintr_rois_hand,
                                 consts.ref_mask_hand, consts.keep_mask_hand,
                                 tset)
    np.testing.assert_allclose(t["loss_sil_hand"].item(),
                               float(j["loss_sil_hand"]), rtol=3e-4)


def test_joints_hand_match():
    js, _ = scene_pair()
    state, consts, cfg = port_from_jax(js)
    np.testing.assert_allclose(
        t2n(TM.get_joints_hand(state, consts, cfg)),
        np.asarray(JM.get_joints_hand(js.init_state, js.consts, js.cfg)),
        atol=1e-5)
    assert TM.optimizer_param_labels(cfg) == dataclasses.asdict(
        JM.optimizer_param_labels(js.cfg))


@pytest.mark.parametrize("key", ["lw_collision", "lw_contact", "lw_depth"])
def test_later_slice_terms_raise(key):
    """Every term of the JAX package is ported, the triangle-triangle
    collision (collision_mode="tritri") included: each term computes; the
    collision and contact terms raise only without closed_hand_faces."""
    _, ts = scene_pair()
    lw = dict(TL.DEFAULT_LW, **{key: 1.0})
    cfg = dataclasses.replace(ts.cfg, collision_mode="tritri")
    args = (ts.init_state, ts.consts, cfg, lw)
    if key in ("lw_collision", "lw_contact"):
        with pytest.raises(ValueError, match="closed_hand_faces"):
            TL.compute_all_losses(*args)
    loss_dict, _ = TL.compute_all_losses(
        *args, closed_hand_faces=ts.closed_hand_faces)
    value = loss_dict[key.replace("lw", "loss")]
    assert value.shape == () and bool(torch.isfinite(value))
