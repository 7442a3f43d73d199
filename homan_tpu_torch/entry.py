"""The driver contract of the port (the JAX package's __graft_entry__.py).

entry(device=None) -> (loss_fn, (state,)): the full joint-fit loss of the
flagship scene, a 10-frame synthetic hand-object clip at 256^2 rendered at
128^2, with silhouette, keypoint, smoothness, prior and interaction terms.

dryrun_multichip(n, device=None): one step of the batched clip fit with n
clips over an n-entry clip mesh, then one step of the frame-sharded fit of
one clip over an n-entry frame mesh, on tiny shapes, with the JAX dry
run's checks. On the card the mesh takes the CUDA devices in turn (one
card: n entries of it); on the CPU, n entries of `cpu`.
"""
from __future__ import annotations

import numpy as np
import torch

from homan_tpu_torch import resolve_device


def _make_scene(frame_nb=10, image_size=128, rend_size=64, seed=0,
                mano_layer=None, obj_mesh=None, device=None):
    from homan_tpu_torch.core.geometry import random_rotations
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
    rot0 = random_rotations(1, torch.Generator().manual_seed(seed))[0]
    return make_synthetic_scene(rot0.numpy(), seed=seed, frame_nb=frame_nb,
                                image_size=image_size, rend_size=rend_size,
                                mano_layer=mano_layer, obj_mesh=obj_mesh,
                                device=device)


def entry(device=None):
    from homan_tpu_torch.fit import losses as L

    scene = _make_scene(frame_nb=10, image_size=256, rend_size=128,
                        device=resolve_device(device))
    lw = dict(L.DEFAULT_LW)

    def forward(state):
        loss_dict, metric_dict = L.compute_all_losses(
            state, scene.consts, scene.cfg, lw,
            roi_settings=scene.roi_settings)
        return L.weighted_sum(loss_dict, lw), metric_dict

    return forward, (scene.init_state,)


def _mesh_devices(n_devices: int, device) -> list:
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The batched clip step and the frame-sharded step on an n-entry
    mesh (module docstring); raises AssertionError on a failed check."""
    from homan_tpu_torch.core.mano import ManoLayer
    from homan_tpu_torch.core.meshes import bumpy_potato
    from homan_tpu_torch.parallel import clips as par
    from homan_tpu_torch.parallel import frames as fpar

    devices = _mesh_devices(n_devices, device)
    first = devices[0]
    # Tiny shapes: 2 frames, 64 px evidence, a low-poly object shared by the
    # clips so their trees stack.
    layer = ManoLayer.synthetic(0, device=first)
    obj_mesh = bumpy_potato(2, 0.08, seed=0)
    scenes = [_make_scene(frame_nb=2, image_size=64, rend_size=32, seed=i,
                          mano_layer=layer, obj_mesh=obj_mesh, device=first)
              for i in range(n_devices)]
    states = par.stack_clips([s.init_state for s in scenes])
    consts = par.stack_clips([s.consts for s in scenes])
    cfg = scenes[0].cfg

    mesh = par.make_clip_mesh(devices=devices)
    # The default loss set minus the off-by-default SDF terms.
    lw = {"lw_sil_obj": 1.0, "lw_v2d_hand": 50.0, "lw_smooth_obj": 1.0,
          "lw_smooth_hand": 1.0, "lw_pca": 0.004, "lw_inter": 1.0,
          "lw_scale_obj": 0.001, "lw_scale_hand": 0.001}
    final_states, history = par.fit_clips_batched(
        states, consts, cfg, loss_weights=lw, num_iterations=1,
        roi_settings=scenes[0].roi_settings, mesh=mesh)
    loss = history["loss"].cpu().numpy()
    assert loss.shape == (n_devices, 1), loss.shape
    assert np.isfinite(loss).all(), loss
    moved = float((final_states.translations_object
                   - states.translations_object.to(first)).abs().max())
    assert moved > 0, "optimizer step did not update the clips' states"

    # One clip's frames over the same devices: the smoothness differences
    # cross the shard boundaries, the global scales' gradients gather on
    # the first entry. frame_nb >= 2: a 1-frame clip's frame difference
    # is an empty mean.
    seq_scene = _make_scene(frame_nb=max(2, n_devices), image_size=64,
                            rend_size=32, seed=n_devices, mano_layer=layer,
                            obj_mesh=obj_mesh, device=first)
    fmesh = fpar.make_frame_mesh(devices=devices)
    shards, _ = fpar.shard_frames(seq_scene.init_state, seq_scene.consts,
                                  fmesh)
    assert [s.translations_object.device for s in shards] == [
        torch.device(d) for d in fmesh.devices], "shards off their entries"
    seq_final, seq_hist = fpar.fit_frames_sharded(
        seq_scene.init_state, seq_scene.consts, seq_scene.cfg, fmesh,
        loss_weights=lw, num_iterations=1,
        roi_settings=seq_scene.roi_settings)
    seq_loss = seq_hist["loss"].cpu().numpy()
    assert np.isfinite(seq_loss).all(), seq_loss
    assert seq_final.translations_object.shape[0] == max(2, n_devices)
    print(f"dryrun_multichip({n_devices}): ok, loss={loss.ravel()}, "
          f"seq loss={seq_loss.ravel()}")
