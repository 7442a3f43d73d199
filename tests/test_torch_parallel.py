"""PyTorch port vs JAX package: parallel/ (batched clips, frame sharding,
multi-process glue), the driver contract (entry.py) and resuming a fit
from an Adam state (CPU, same numpy inputs).

Meshes here are several entries of the one CPU device (`cpu` repeated);
the JAX side runs on its conftest's 8 virtual CPU devices.

Bands: against JAX, the stage-C parity bands of tests/test_torch_fit.py
(iteration-0 terms rtol 3e-4, totals rtol 3e-3, final translations and
rotations atol 2e-3); the port's batched or sharded fit against its own
single fit, the JAX package's own bands (tests/test_sharding.py: loss rtol
2e-4, translations atol 1e-5, PCA 1e-4, scales 1e-5); pad_mesh invariance
silhouette 1e-5, phi 1e-6.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.core.mano import ManoLayer as JManoLayer
from homan_tpu.core.meshes import bumpy_potato as jbumpy
from homan_tpu.fit import joint as JJ
from homan_tpu.frontend.gtsynth import make_synthetic_scene as jscene
from homan_tpu.parallel import clips as jpar
from homan_tpu_torch import convert
from homan_tpu_torch.core.meshes import bumpy_potato, pad_mesh
from homan_tpu_torch.fit import joint as TJ
from homan_tpu_torch.parallel import clips as par
from homan_tpu_torch.parallel import frames as fpar
from homan_tpu_torch.render.rasterizer import MeshTopology, RasterSettings

from torch_port_common import port_from_jax, settings_pair, t2n, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LW_CLIPS = {"lw_smooth_obj": 1.0, "lw_smooth_hand": 1.0}
LW_FRAMES = {"lw_sil_obj": 1.0, "lw_v2d_hand": 50.0, "lw_smooth_obj": 1.0,
             "lw_smooth_hand": 1.0, "lw_pca": 0.004, "lw_scale_obj": 0.001,
             "lw_scale_hand": 0.001, "lw_inter": 1.0}
ROI = RasterSettings(image_size=32, tile_px=16)  # the scenes' roi_settings


@pytest.fixture(scope="module")
def clip_scenes():
    """Four JAX clips sharing the hand model and the object (as
    tests/test_sharding.py), and the port's state, consts, cfg of each."""
    layer = JManoLayer.synthetic(0)
    obj = jbumpy(2, 0.08, seed=0)
    js = [jscene(seed=i, frame_nb=2, image_size=64, rend_size=32,
                 mano_layer=layer, obj_mesh=obj) for i in range(4)]
    return js, [port_from_jax(s) for s in js]


def _stacked(port):
    return (par.stack_clips([p[0] for p in port]),
            par.stack_clips([p[1] for p in port]), port[0][2])


def test_fit_clips_batched_matches_jax(clip_scenes):
    js, port = clip_scenes
    lw = dict(LW_CLIPS, lw_sil_obj=1.0, lw_v2d_hand=50.0)
    jf, jh = jpar.fit_clips_batched(
        jpar.stack_clips([s.init_state for s in js]),
        jpar.stack_clips([s.consts for s in js]), js[0].cfg,
        loss_weights=lw, num_iterations=5, roi_settings=js[0].roi_settings,
        mesh=jpar.make_clip_mesh(4))
    states, consts, cfg = _stacked(port)
    tf, th = par.fit_clips_batched(
        states, consts, cfg, loss_weights=lw, num_iterations=5,
        roi_settings=ROI, mesh=par.make_clip_mesh(devices=["cpu"] * 4))
    assert th["loss"].shape == (4, 5)
    # The JAX batched history holds the total and the metrics only.
    for k in ("loss", "iou_object", "v2d_hand"):
        np.testing.assert_allclose(t2n(th[k][:, 0]), np.asarray(jh[k][:, 0]),
                                   rtol=3e-4, err_msg=k)
    np.testing.assert_allclose(t2n(th["loss"]), np.asarray(jh["loss"]),
                               rtol=3e-3)
    np.testing.assert_allclose(t2n(tf.translations_object),
                               np.asarray(jf.translations_object), atol=2e-3)
    np.testing.assert_allclose(t2n(tf.translations_hand),
                               np.asarray(jf.translations_hand), atol=2e-3)


@pytest.mark.parametrize("entries", [1, 2])
def test_fit_clips_batched_matches_single(clip_scenes, entries):
    """Each clip of the batch fits as it does alone (clips share no
    parameter; one Adam over the stacked leaves is one Adam per clip)."""
    _, port = clip_scenes
    states, consts, cfg = _stacked(port)
    final, hist = par.fit_clips_batched(
        states, consts, cfg, loss_weights=LW_CLIPS, num_iterations=5,
        roi_settings=ROI, mesh=par.make_clip_mesh(devices=["cpu"] * entries))
    for i in (0, 3):
        single, h1 = TJ.optimize_hand_object(
            port[i][0], port[i][1], cfg, loss_weights=LW_CLIPS,
            num_iterations=5, roi_settings=ROI, device="cpu")
        np.testing.assert_allclose(t2n(hist["loss"][i]), t2n(h1["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(t2n(final.translations_object[i]),
                                   t2n(single.translations_object), atol=1e-5)
        np.testing.assert_allclose(t2n(final.mano_pca_pose[i]),
                                   t2n(single.mano_pca_pose), atol=1e-4)


def test_shard_clip_batch_requires_divisibility(clip_scenes):
    _, port = clip_scenes
    states = par.stack_clips([p[0] for p in port[:3]])
    with pytest.raises(ValueError, match="divisible"):
        par.shard_clip_batch(states, par.make_clip_mesh(devices=["cpu"] * 2))
    shares = par.shard_clip_batch(states,
                                  par.make_clip_mesh(devices=["cpu"] * 3))
    assert [s.translations_object.shape[0] for s in shares] == [1, 1, 1]


def test_stacked_jax_trees_convert(clip_scenes):
    """A stacked JAX tree converts to the stack of the converted trees."""
    js, port = clip_scenes
    jstack = to_numpy(jpar.stack_clips([s.consts for s in js]))
    stacked = convert.consts_from_numpy(jstack, device="cpu")
    ours = par.stack_clips([p[1] for p in port])
    got = dict(par.tree_leaves(stacked))
    want = dict(par.tree_leaves(ours))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_clip_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        par.make_clip_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fpar.make_frame_mesh(2)
    mesh = par.make_clip_mesh(devices=["cpu", "cpu", "cpu"], n_devices=2)
    assert mesh.size == 2 and mesh.axis == "clips"


def _padded_objects():
    meshes = [bumpy_potato(2, 0.08, seed=1),   # 162 verts / 320 faces
              bumpy_potato(1, 0.07, seed=2)]   # 42 verts / 80 faces
    v_bucket = max(m[0].shape[0] for m in meshes)
    f_bucket = max(m[1].shape[0] for m in meshes)
    return meshes, [pad_mesh(v, f, v_bucket, f_bucket) for v, f in meshes]


def test_pad_mesh_render_and_sdf_invariant():
    """Padded meshes render the same soft silhouette and voxelize to the
    same interior SDF (tests/test_sharding.py:138-164) on the plain path;
    tests/test_torch_cuda.py holds the kernels to the same."""
    from homan_tpu_torch.interactions.voxelize import voxelize
    from homan_tpu_torch.render.rasterizer import rasterize_soft
    v, f = bumpy_potato(2, 0.3, seed=2)
    vp, fp = pad_mesh(v, f, v.shape[0] + 37, f.shape[0] + 53)
    K = torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]])
    settings = RasterSettings(image_size=64, tile_px=16, edges_per_tile=384)
    shift = torch.tensor([0, 0, 1.0])
    sil = rasterize_soft(torch.from_numpy(v)[None] + shift,
                         MeshTopology.from_faces(f), K, settings)["sil"]
    sil_p = rasterize_soft(torch.from_numpy(vp)[None] + shift,
                           MeshTopology.from_faces(fp), K, settings)["sil"]
    np.testing.assert_allclose(t2n(sil_p), t2n(sil), atol=1e-5)
    phi = voxelize(torch.from_numpy(v)[None], torch.from_numpy(f), 16)
    phi_p = voxelize(torch.from_numpy(vp)[None], torch.from_numpy(fp), 16)
    assert bool((phi > 0).any())
    np.testing.assert_allclose(t2n(phi_p), t2n(phi), atol=1e-6)


def pad_topology(topo: MeshTopology, n_edges: int) -> MeshTopology:
    """Edges padded to n_edges with boundary-free, never-contour slots."""
    pad = n_edges - topo.edges.shape[0]
    return MeshTopology(
        faces=topo.faces,
        edges=torch.cat([topo.edges, torch.zeros((pad, 2),
                                                 dtype=torch.int64)]),
        edge_faces=torch.cat([topo.edge_faces,
                              torch.full((pad, 2), -1, dtype=torch.int64)]),
        edge_dir_f1=torch.cat([topo.edge_dir_f1,
                               torch.zeros(pad, dtype=torch.bool)]))


def test_heterogeneous_objects_multiclip_via_buckets():
    """Clips of different objects batch once padded to a common bucket
    (tests/test_sharding.py:167-219): per-clip topologies go through the
    vmapped loss batched, and each clip still fits as it does alone."""
    from homan_tpu_torch.core.mano import ManoLayer
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
    _, padded = _padded_objects()
    topos = [MeshTopology.from_faces(f) for _, f in padded]
    e_bucket = max(t.edges.shape[0] for t in topos)
    layer = ManoLayer.synthetic(0, device="cpu")
    scenes = []
    for (vp, fp), topo in zip(padded, topos):
        s = make_synthetic_scene(np.eye(3, dtype=np.float32), seed=7,
                                 frame_nb=2, image_size=64, rend_size=32,
                                 mano_layer=layer, obj_mesh=(vp, fp),
                                 device="cpu")
        scenes.append(dataclasses.replace(s, consts=dataclasses.replace(
            s.consts, faces_object=pad_topology(topo, e_bucket))))
    lw = {"lw_sil_obj": 1.0, "lw_smooth_obj": 1.0, "lw_smooth_hand": 1.0}
    final, hist = par.fit_clips_batched(
        par.stack_clips([s.init_state for s in scenes]),
        par.stack_clips([s.consts for s in scenes]), scenes[0].cfg,
        loss_weights=lw, num_iterations=2, roi_settings=ROI,
        mesh=par.make_clip_mesh(devices=["cpu", "cpu"]))
    loss = t2n(hist["loss"])
    assert loss.shape == (2, 2) and np.isfinite(loss).all()
    for i, s in enumerate(scenes):
        single, h1 = TJ.optimize_hand_object(
            s.init_state, s.consts, s.cfg, loss_weights=lw, num_iterations=2,
            roi_settings=ROI, device="cpu")
        np.testing.assert_allclose(loss[i], t2n(h1["loss"]), rtol=2e-4)
        np.testing.assert_allclose(t2n(final.translations_object[i]),
                                   t2n(single.translations_object), atol=1e-5)


@pytest.fixture(scope="module")
def two_hand_scene():
    js = jscene(seed=3, frame_nb=8, hand_sides=("left", "right"),
                image_size=64, rend_size=32)
    return port_from_jax(js)


@pytest.mark.parametrize("entries", [2, 4])
def test_fit_frames_sharded_matches_single(two_hand_scene, entries):
    """One clip's 8 frames over 2 and 4 entries, two hands (the
    interleaved B*H rows split on frame boundaries)."""
    state, consts, cfg = two_hand_scene
    mesh = fpar.make_frame_mesh(devices=["cpu"] * entries)
    sharded, hist_s = fpar.fit_frames_sharded(
        state, consts, cfg, mesh, loss_weights=LW_FRAMES, num_iterations=5,
        roi_settings=ROI)
    single, hist_1 = TJ.optimize_hand_object(
        state, consts, cfg, loss_weights=LW_FRAMES, num_iterations=5,
        roi_settings=ROI, device="cpu")
    np.testing.assert_allclose(t2n(hist_s["loss"]), t2n(hist_1["loss"]),
                               rtol=2e-4)
    for k, atol in (("translations_object", 1e-5), ("translations_hand",
                                                     1e-5),
                    ("mano_pca_pose", 1e-4), ("int_scales_object", 1e-5),
                    ("int_scales_hand", 1e-5)):
        np.testing.assert_allclose(t2n(getattr(sharded, k)),
                                   t2n(getattr(single, k)), atol=atol,
                                   err_msg=k)
    shards, consts_sh = fpar.shard_frames(state, consts, mesh)
    per = 8 // entries
    assert [s.translations_object.shape[0] for s in shards] == [per] * entries
    assert [s.translations_hand.shape[0] for s in shards] == [2 * per] * \
        entries
    assert consts_sh[-1].ref_mask_hand.shape[0] == 2 * per
    assert torch.equal(shards[1].int_scales_object, state.int_scales_object)


def test_frame_shard_requires_divisibility(two_hand_scene):
    state, consts, _ = two_hand_scene
    with pytest.raises(ValueError, match="divisible"):
        fpar.shard_frames(state, consts,
                          fpar.make_frame_mesh(devices=["cpu"] * 3))


def test_frame_shardings_match_jax():
    """The prefix trees say what the JAX ones do: split fields carry the
    axis, replicated ones None (P() there)."""
    from homan_tpu.parallel import frames as jfpar
    jmesh = jfpar.make_frame_mesh(2)
    mesh = fpar.make_frame_mesh(devices=["cpu"] * 2)
    for jt, tt in ((jfpar.state_shardings(jmesh), fpar.state_shardings(mesh)),
                   (jfpar.consts_shardings(jmesh),
                    fpar.consts_shardings(mesh))):
        for f in dataclasses.fields(jt):
            spec = getattr(jt, f.name).spec
            assert getattr(tt, f.name) == (spec[0] if len(spec) else None), \
                f.name


def _optax_layout(opt_state):
    """The numpy layout of convert.adam_state_from_optax from an optax
    multi_transform state."""
    out = {}
    for label, masked in opt_state.inner_states.items():
        if not masked.inner_state:  # "frozen": an empty EmptyState()
            continue
        adam = masked.inner_state[0]
        fields = [f.name for f in dataclasses.fields(adam.mu)
                  if isinstance(getattr(adam.mu, f.name), jax.Array)]
        out[label] = {"count": np.asarray(adam.count),
                      "mu": {k: np.asarray(getattr(adam.mu, k))
                             for k in fields},
                      "nu": {k: np.asarray(getattr(adam.nu, k))
                             for k in fields}}
    return out


def _into_optax(template, layout):
    inner = dict(template.inner_states)
    for label, g in layout.items():
        masked = inner[label]
        adam = masked.inner_state[0]
        adam = adam._replace(
            count=jnp.asarray(g["count"], jnp.int32),
            mu=dataclasses.replace(adam.mu, **{
                k: jnp.asarray(v) for k, v in g["mu"].items()}),
            nu=dataclasses.replace(adam.nu, **{
                k: jnp.asarray(v) for k, v in g["nu"].items()}))
        inner[label] = masked._replace(
            inner_state=(adam,) + tuple(masked.inner_state[1:]))
    return template._replace(inner_states=inner)


def test_opt_state_resume_matches_jax():
    """A 5-step JAX fit resumed for 5 more steps from its Adam state, in
    both packages, against the 10-step fits; and the port's state carried
    back into the JAX fit."""
    from torch_port_common import scene_pair
    js, _ = scene_pair()
    jset, tset = settings_pair(64, 32, 48)
    lw = dict(JJ.L.DEFAULT_LW)
    lw_items = tuple(sorted(lw.items()))
    optimizer = JJ.make_optimizer(js.cfg, 1e-2)
    j5, jos5, _ = JJ._run_phase(js.init_state, optimizer.init(js.init_state),
                                js.consts, jnp.zeros((1, 3), jnp.int32),
                                js.cfg, lw_items, 5, 1e-2, jset, False)
    j10, jh10 = JJ.optimize_hand_object(js.init_state, js.consts, js.cfg,
                                        num_iterations=10, roi_settings=jset)
    jr, jhr = JJ.optimize_hand_object(j5, js.consts, js.cfg,
                                      num_iterations=5, roi_settings=jset,
                                      opt_state=jos5)
    np.testing.assert_allclose(np.asarray(jr.translations_object),
                               np.asarray(j10.translations_object),
                               atol=1e-5)

    state, consts, cfg = port_from_jax(js)
    state5 = convert.state_from_numpy(to_numpy(j5), device="cpu")
    os5 = convert.adam_state_from_optax(_optax_layout(jos5), device="cpu")
    assert {g: os5[g]["count"] for g in os5} == {"rigid": 5, "mano": 5,
                                                 "rot": 5}
    tr, thr, tos = TJ.optimize_hand_object(
        state5, consts, cfg, num_iterations=5, roi_settings=tset,
        opt_state=os5, return_opt_state=True, device="cpu")
    t10, th10 = TJ.optimize_hand_object(state, consts, cfg,
                                        num_iterations=10, roi_settings=tset,
                                        device="cpu")
    assert {g: tos[g]["count"] for g in tos} == {"rigid": 10, "mano": 10,
                                                 "rot": 10}
    np.testing.assert_allclose(t2n(thr["loss"][0]), float(jhr["loss"][0]),
                               rtol=3e-4)
    np.testing.assert_allclose(t2n(thr["loss"]), np.asarray(jhr["loss"]),
                               rtol=3e-3)
    for ours in (tr, t10):
        np.testing.assert_allclose(t2n(ours.translations_object),
                                   np.asarray(j10.translations_object),
                                   atol=2e-3)
        np.testing.assert_allclose(t2n(ours.translations_hand),
                                   np.asarray(j10.translations_hand),
                                   atol=2e-3)
    # Resumed equals uninterrupted in the port as well.
    np.testing.assert_allclose(t2n(tr.translations_object),
                               t2n(t10.translations_object), atol=1e-5)

    # And back: the port's 5-step state resumes the JAX fit.
    p5, _, pos5 = TJ.optimize_hand_object(
        state, consts, cfg, num_iterations=5, roi_settings=tset,
        return_opt_state=True, device="cpu")
    jos_back = _into_optax(jos5, convert.adam_state_to_optax(pos5))
    jb, _ = JJ.optimize_hand_object(
        jax.tree_util.tree_map(jnp.asarray, type(j5)(**{
            k: (None if v is None else t2n(v))
            for k, v in vars(p5).items()})),
        js.consts, js.cfg, num_iterations=5, roi_settings=jset,
        opt_state=jos_back)
    np.testing.assert_allclose(np.asarray(jb.translations_object),
                               np.asarray(j10.translations_object),
                               atol=2e-3)


WORKER = r"""
import json, sys
from homan_tpu_torch.parallel import multihost

pid, coord, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid)
import torch.distributed as dist
assert dist.get_world_size() == 2
idxs = multihost.host_sample_indices(total=10, data_step=1, data_offset=0)
local = {"metric": [100.0 * pid + i for i in idxs],
         "count": [float(len(idxs))]}
gathered = multihost.allgather_metrics(local)
with open(out_path, "w") as f:
    json.dump({"pid": pid, "idxs": list(map(int, idxs)),
               "metric": [float(x) for x in gathered["metric"]],
               "count": [float(x) for x in gathered["count"]]}, f)
dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                           "homan_tpu"))
assert not bad, bad
"""


def test_two_process_gloo_allgather(tmp_path):
    """tests/test_multihost.py:42-80 over torch.distributed (gloo): the
    index space splits disjointly and completely, every process sees both
    processes' metrics."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs = [], []
    for pid in range(2):
        outs.append(tmp_path / f"out{pid}.json")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(pid), f"localhost:{port}",
             str(outs[-1])], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            p.kill()
    payloads = [json.loads(o.read_text()) for o in outs]
    all_idxs = sorted(payloads[0]["idxs"] + payloads[1]["idxs"])
    assert all_idxs == list(range(10))
    assert not set(payloads[0]["idxs"]) & set(payloads[1]["idxs"])
    for pl in payloads:
        assert len(pl["metric"]) == 10
        assert sorted(pl["count"]) == [5.0, 5.0]
    assert payloads[0]["metric"] == payloads[1]["metric"]
    vals = np.asarray(payloads[0]["metric"])
    assert (vals >= 100).any() and (vals < 100).any()


def test_multihost_single_process():
    from homan_tpu_torch.parallel import multihost
    multihost.initialize(num_processes=1)
    assert multihost.host_sample_indices(7, data_step=2, data_offset=1) == [
        1, 3, 5]
    out = multihost.allgather_metrics({"a": [1.0, 2.0]})
    np.testing.assert_array_equal(out["a"], [1.0, 2.0])


def test_entry_contract(monkeypatch):
    """entry() gives the flagship scene's full loss and its metrics, on
    `cuda` unless the caller names the CPU."""
    from homan_tpu_torch import entry
    fn, (state,) = entry.entry(device="cpu")
    loss, metrics = fn(state)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert {"iou_object", "v2d_hand", "edge_budget_excess"} <= set(metrics)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()


def test_dryrun_multichip_on_cpu(capsys):
    from homan_tpu_torch import entry
    entry.dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out
