"""PyTorch port: one clip's frames over a mesh that spans two processes
(parallel/frames.py inside parallel/multihost.py's gloo group), against the
JAX package's unsharded fit and the port's own (CPU).

One pair of worker processes runs every case in one group, joined through
MASTER_ADDR/MASTER_PORT (`initialize(None, ...)`); the test process builds
the scenes, hands them to the workers as the port's tensors (torch.save),
and computes the references while the workers fit. Each worker asserts
that neither `jax` nor `homan_tpu` was loaded.

Bands: against JAX, tests/test_multihost.py's own (loss rtol 2e-4,
translations_object atol 1e-5); against the port's unsharded fit,
tests/test_torch_parallel.py test_fit_frames_sharded_matches_single's
(loss rtol 2e-4, translations 1e-5, PCA 1e-4, scales 1e-5), and the Adam
moments (which carry each gradient's scale, where Adam's step does not)
within 1e-4 of each field's maximum; between the two ranks, bit equality.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from homan_tpu.fit import joint as JJ
from homan_tpu.frontend.gtsynth import make_synthetic_scene as jscene
from homan_tpu_torch import convert
from homan_tpu_torch.fit import joint as TJ
from homan_tpu_torch.parallel import multihost
from homan_tpu_torch.render.rasterizer import RasterSettings

from torch_port_common import port_from_jax, t2n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_multihost.py's weights; tests/test_torch_parallel.py's
# LW_FRAMES; the interaction terms of chip_smoke.py's interaction fit.
LW_JAX = {"lw_sil_obj": 1.0, "lw_v2d_hand": 50.0, "lw_smooth_obj": 1.0,
          "lw_smooth_hand": 1.0, "lw_pca": 0.004, "lw_scale_obj": 0.001,
          "lw_scale_hand": 0.001}
LW_FRAMES = dict(LW_JAX, lw_inter=1.0)
LW_INTER = {"lw_collision": 1e-3, "lw_contact": 1.0}
ITERS_A, ITERS_B, ITERS_C, ITERS_R, VIZ_STEP = 3, 5, 1, 3, 2
STATE_BANDS = (("translations_object", 1e-5), ("translations_hand", 1e-5),
               ("mano_pca_pose", 1e-4), ("int_scales_object", 1e-5),
               ("int_scales_hand", 1e-5))
CASES = ("a", "b1", "b2", "r", "c")

WORKER = r"""
import datetime, sys
import torch
torch.set_num_threads(2)
from homan_tpu_torch.parallel import frames as fpar
from homan_tpu_torch.parallel import multihost

pid, scene_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(None, 2, pid, timeout=datetime.timedelta(seconds=120))
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == pid
sc = torch.load(scene_path, weights_only=False)
out = {}


def seeded(rank, shape, seed):
    g = torch.Generator().manual_seed(100 * seed + rank)
    return torch.randn(shape, generator=g)


# (e) The collectives alone.
x = seeded(pid, (3, 4), 1).requires_grad_(True)
ints = torch.arange(6, dtype=torch.int32).reshape(3, 2) + 10 * pid
flags = torch.arange(3) % 2 == pid
y, y_ints, y_flags = multihost.gather_frames([x, ints, flags])
(y * seeded(pid, (6, 4), 2)).sum().backward()
s = torch.tensor([1.5, -2.0], requires_grad=True)
(s_rep,) = multihost.replicate([s])
(s_rep * seeded(pid, (2,), 3)).sum().backward()
out["collectives"] = {"y": y.detach(), "ints": y_ints, "flags": y_flags,
                      "x_grad": x.grad, "s_grad": s.grad,
                      "s_rep": s_rep.detach()}

# (f) The driver's count and the mesh over both processes.
from homan_tpu_torch.cli import fit_video
real_count = torch.cuda.device_count
torch.cuda.device_count = lambda: 4
out["driver"] = {n: fit_video._frames_shard_devices(n, torch.device("cuda"))
                 for n in (8, 10, 12, 15)}
torch.cuda.device_count = real_count
out["driver_cpu"] = fit_video._frames_shard_devices(8, torch.device("cpu"))
mesh = fpar.make_frame_mesh(devices=["cpu"] * 4)
out["mesh"] = [mesh.size, mesh.process_count, mesh.process_index]
try:
    fpar.make_frame_mesh(3, devices=["cpu"] * 4)
    out["mesh_odd"] = "accepted"
except ValueError:
    out["mesh_odd"] = "ValueError"


def fit(key, entries, iters, state=None, **kw):
    state0, consts, cfg, roi = sc[key]
    state = state0 if state is None else state
    viz = []
    final, hist, opt = fpar.fit_frames_sharded(
        state, consts, cfg, fpar.make_frame_mesh(devices=["cpu"] * entries),
        loss_weights=sc["lw_" + key], num_iterations=iters, roi_settings=roi,
        viz_step=sc["viz_step"], viz_callback=lambda i, s: viz.append(
            vars(s)), return_opt_state=True, **kw)
    return {"final": vars(final), "hist": hist, "opt": opt, "viz": viz}


# (a) tests/test_multihost.py's case: 2 processes x 4 entries.
out["a"] = fit("a", 4, sc["iters_a"])
# (b) two hands: 2 processes x 1 and x 2 entries.
out["b1"] = fit("b", 1, sc["iters_b"])
out["b2"] = fit("b", 2, sc["iters_b"])
# Resumed from b2's final state and Adam state.
out["r"] = fit("b", 2, sc["iters_r"], state=type(sc["b"][0])(
    **out["b2"]["final"]), opt_state=out["b2"]["opt"])
# (c) collision and contact on the grid SDF.
out["c"] = fit("c", 1, sc["iters_c"], closed_hand_faces=sc["closed_c"])

dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "homan_tpu"))
assert not bad, bad
torch.save(out, out_path)
"""


def _roi(js):
    r = js.roi_settings
    return RasterSettings(image_size=r.image_size, tile_px=r.tile_px,
                          edges_per_tile=r.edges_per_tile)


def _port_fit(scene, lw, iters, state=None, **kw):
    state0, consts, cfg, roi = scene
    state = state0 if state is None else state
    viz = []
    final, hist, opt = TJ.optimize_hand_object(
        state, consts, cfg, loss_weights=lw, num_iterations=iters,
        roi_settings=roi, viz_step=VIZ_STEP,
        viz_callback=lambda i, s: viz.append(vars(s)),
        return_opt_state=True, device="cpu", **kw)
    return {"final": vars(final), "hist": hist, "opt": opt, "viz": viz}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' outputs (one dict per rank) and the references."""
    tmp = tmp_path_factory.mktemp("multihost_frames")
    js_a = jscene(seed=5, frame_nb=8, image_size=64, rend_size=32)
    js_b = jscene(seed=3, frame_nb=8, hand_sides=("left", "right"),
                  image_size=64, rend_size=32)
    # Two frames: the plain voxelizer takes seconds a frame on the CPU.
    js_c = jscene(seed=5, frame_nb=2, image_size=64, rend_size=32)
    scenes = {}
    for key, js in (("a", js_a), ("b", js_b), ("c", js_c)):
        scenes[key] = (*port_from_jax(js), _roi(js))
    # The object scale optimized in (b) and (c): the replicated leaf then
    # carries a gradient (both scales are frozen in these scenes' cfg).
    for key, extra in (("b", {}), ("c", {"sdf_mode": "grid"})):
        state, consts, cfg, roi = scenes[key]
        scenes[key] = (state, consts, dataclasses.replace(
            cfg, optimize_object_scale=True, **extra), roi)
    closed_c = convert.faces_from_numpy(js_c.closed_hand_faces, "cpu")
    payload = dict(scenes, lw_a=LW_JAX, lw_b=LW_FRAMES, lw_c=LW_INTER,
                   closed_c=closed_c, iters_a=ITERS_A, iters_b=ITERS_B,
                   iters_c=ITERS_C, iters_r=ITERS_R, viz_step=VIZ_STEP)
    scene_path = tmp / "scenes.pt"
    torch.save(payload, scene_path)
    worker = tmp / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    outs = [tmp / f"out{pid}.pt" for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(scene_path),
         str(outs[pid])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(2)]
    try:
        # The references, while the workers fit.
        jf, jh = JJ.optimize_hand_object(
            js_a.init_state, js_a.consts, js_a.cfg, loss_weights=LW_JAX,
            num_iterations=ITERS_A, roi_settings=js_a.roi_settings)
        refs = {"jax_a": {"loss": np.asarray(jh["loss"]),
                          "t_obj": np.asarray(jf.translations_object)},
                "b": _port_fit(scenes["b"], LW_FRAMES, ITERS_B),
                "c": _port_fit(scenes["c"], LW_INTER, ITERS_C,
                               closed_hand_faces=closed_c)}
        b = refs["b"]
        refs["r"] = _port_fit(scenes["b"], LW_FRAMES, ITERS_R,
                              state=type(scenes["b"][0])(**b["final"]),
                              opt_state=b["opt"])
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    return refs, [torch.load(o, weights_only=False) for o in outs]


def _assert_states_close(got, want):
    for k, atol in STATE_BANDS:
        if want[k] is not None:
            np.testing.assert_allclose(t2n(got[k]), t2n(want[k]), atol=atol,
                                       err_msg=k)


def _assert_matches_single(run, ref):
    np.testing.assert_allclose(t2n(run["hist"]["loss"]),
                               t2n(ref["hist"]["loss"]), rtol=2e-4)
    _assert_states_close(run["final"], ref["final"])
    assert len(run["viz"]) == len(ref["viz"])
    for got, want in zip(run["viz"], ref["viz"]):
        _assert_states_close(got, want)
    assert run["opt"].keys() == ref["opt"].keys()
    for group, want in ref["opt"].items():
        got = run["opt"][group]
        assert got["count"] == want["count"]
        for m in ("mu", "nu"):
            for name, t in want[m].items():
                scale = max(float(t.abs().max()), 1e-30)
                err = float((got[m][name] - t).abs().max())
                assert err <= 1e-4 * scale, (group, m, name, err, scale)


def test_process_mesh_fit_matches_jax(runs):
    """tests/test_multihost.py:117-164 in the port: 2 processes x 4 CPU
    entries fit the 8-frame clip as the JAX package's unsharded fit."""
    refs, outs = runs
    for out in outs:
        np.testing.assert_allclose(t2n(out["a"]["hist"]["loss"]),
                                   refs["jax_a"]["loss"], rtol=2e-4)
        np.testing.assert_allclose(
            t2n(out["a"]["final"]["translations_object"]),
            refs["jax_a"]["t_obj"], atol=1e-5)


@pytest.mark.parametrize("entries", [1, 2])
def test_process_mesh_two_hands_matches_single(runs, entries):
    """The two-hand 8-frame clip over 2 processes x 1 and x 2 entries: the
    port's unsharded fit's losses, states, viz_callback states and Adam
    state."""
    refs, outs = runs
    for out in outs:
        _assert_matches_single(out[f"b{entries}"], refs["b"])
        assert len(out[f"b{entries}"]["viz"]) == 2
        assert out[f"b{entries}"]["final"]["translations_hand"].shape[0] \
            == 16


def test_process_mesh_resume_matches_single(runs):
    """Resumed from the two-entry fit's whole-clip state and Adam state:
    each process takes its rows of the moments, as the unsharded resume
    takes them all."""
    refs, outs = runs
    for out in outs:
        assert out["r"]["opt"]["rigid"]["count"] == ITERS_B + ITERS_R
        _assert_matches_single(out["r"], refs["r"])


def test_process_mesh_interaction_matches_single(runs):
    """Collision and contact on the grid SDF: the grids cross the gather;
    one step, so the Adam moments are the gradient itself."""
    refs, outs = runs
    for out in outs:
        run = out["c"]
        assert float(run["hist"]["loss_collision"][0]) > 0
        _assert_matches_single(run, refs["c"])


def _assert_same(a, b, path):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("case", CASES)
def test_process_mesh_ranks_agree_bitwise(runs, case):
    """Both ranks return the same bits: final states (the replicated
    scales too), histories, viz states and Adam states."""
    _, outs = runs
    if case != "a":  # the object scale moved: it was optimized
        assert float(outs[0][case]["final"]["int_scales_object"][0]) != 1.0
    _assert_same(outs[0][case], outs[1][case], case)


def _seeded(rank, shape, seed):
    g = torch.Generator().manual_seed(100 * seed + rank)
    return torch.randn(shape, generator=g)


def test_gather_frames_and_replicate_autograd(runs):
    """gather_frames' forward is torch.cat of the ranks' rows (bit for bit,
    ints and bools too); its backward is the sum of the ranks' upstream
    gradients at this rank's rows; replicate is the identity whose
    backward sums."""
    _, outs = runs
    xs = [_seeded(r, (3, 4), 1) for r in range(2)]
    ups = sum(_seeded(r, (6, 4), 2) for r in range(2))
    for pid, out in enumerate(outs):
        c = out["collectives"]
        assert torch.equal(c["y"], torch.cat(xs))
        assert torch.equal(c["ints"], torch.cat([
            torch.arange(6, dtype=torch.int32).reshape(3, 2) + 10 * r
            for r in range(2)]))
        assert torch.equal(c["flags"], torch.cat([
            torch.arange(3) % 2 == r for r in range(2)]))
        torch.testing.assert_close(c["x_grad"], ups[3 * pid:3 * pid + 3],
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(
            c["s_grad"], sum(_seeded(r, (2,), 3) for r in range(2)),
            rtol=0, atol=1e-6)
        assert torch.equal(c["s_rep"], torch.tensor([1.5, -2.0]))


def test_driver_counts_every_process_entries(runs):
    """Inside a group, fit_video's --frames_sharded counts world x local
    CUDA entries (the JAX driver's len(jax.devices())), in the sizes a
    process-spanning mesh takes; the mesh knows both processes."""
    _, outs = runs
    for pid, out in enumerate(outs):
        assert out["driver"] == {8: 8, 10: 2, 12: 6, 15: 1}
        assert out["driver_cpu"] == 1
        assert out["mesh"] == [8, 2, pid]
        assert out["mesh_odd"] == "ValueError"


def test_initialize_needs_a_coordinator(monkeypatch):
    """No coordinator named and none in the environment: a ValueError that
    names both ways (the workers above join through the environment)."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="coordinator_address.*MASTER_ADDR"):
        multihost.initialize(None, 2, 0)
    multihost.initialize(None, 1, 0)  # one process: nothing to join
