"""One clip's frame axis split over devices (homan_tpu/parallel/frames.py).

The JAX package shards every per-frame tensor along its frame axis and lets
GSPMD insert the halo exchange of the smoothness term and the all-reduces
of the loss and of the global scales' gradients. Here, in one process, each
mesh entry holds its frames' rows of the state and consts on its device,
and a step runs `losses.render_terms` (MANO, the renders, the SDF grids:
every kernel launch) per entry on that entry's device. The per-frame
outputs are then gathered on the first entry's device, where
`losses.reduce_terms` computes the terms that couple frames exactly: the
smoothness differences across shard boundaries, the frame means, the
priors of the global `int_scales_object` / `int_scales_hand`, which live on
the first entry. Autograd runs back across the `.to(device)` copies, so no
gradient is averaged by hand, and each entry's Adam update stays on its
device (Adam is elementwise: the split update equals the unsplit one).

Hands use the frame-major interleaved B*H rows, so contiguous shards keep
whole frames: frame_nb must be divisible by the mesh size.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from homan_tpu_torch.fit import joint as joint_lib
from homan_tpu_torch.fit import losses as L
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.parallel.clips import DeviceMesh, make_mesh, tree_map


def make_frame_mesh(n_devices: int | None = None, axis: str = "frames",
                    devices: Sequence | None = None) -> DeviceMesh:
    return make_mesh(n_devices, axis, devices)


def state_shardings(mesh: DeviceMesh, axis: str = "frames") -> M.HomanState:
    """Which HomanState fields split by frame (the axis name) and which
    replicate (None): the JAX package's prefix tree as data."""
    return M.HomanState(
        translations_object=axis, rotations_object=axis,
        translations_hand=axis, rotations_hand=axis, mano_pca_pose=axis,
        mano_rot=axis, mano_trans=axis, mano_betas=axis,
        int_scales_object=None, int_scales_hand=None, cams_hand=axis)


def consts_shardings(mesh: DeviceMesh, axis: str = "frames"
                     ) -> M.HomanConsts:
    """Which HomanConsts fields split by frame (the axis name) and which
    replicate (None): the evidence splits, the canonical geometry, the
    topologies and the MANO model replicate."""
    return M.HomanConsts(
        verts_object_og=None, faces_object=None, verts_hand_og=axis,
        faces_hand=None, ref_verts2d_hand=axis, ref_mask_object=axis,
        keep_mask_object=axis, ref_mask_hand=axis, keep_mask_hand=axis,
        camintr_rois_object=axis, camintr_rois_hand=axis, camintr=axis,
        mano_params_by_side=None, masks_object=axis, masks_hand=axis)


def _split(tree, spec_tree, mesh: DeviceMesh):
    """One copy of a state or consts per mesh entry, on its device: the
    fields named by spec_tree sliced to the entry's rows (their leading
    axis split in mesh.size equal parts), the others whole."""
    out = []
    for k, dev in enumerate(mesh.devices):
        fields = {}
        for name, spec in vars(spec_tree).items():
            value = getattr(tree, name)
            if spec is None or value is None:
                fields[name] = tree_map(lambda t, d=dev: t.to(d), value)
            else:
                per = value.shape[0] // mesh.size
                fields[name] = value[k * per:(k + 1) * per].to(dev)
        out.append(type(tree)(**fields))
    return out


def shard_frames(state: M.HomanState, consts: M.HomanConsts,
                 mesh: DeviceMesh, axis: str = "frames"
                 ) -> Tuple[list, list]:
    """One clip's state and consts split by frame over the mesh: a list of
    states and a list of consts, one per entry, on its device. Requires
    frame_nb % mesh.size == 0 (whole frames per entry)."""
    n = mesh.size
    frame_nb = state.translations_object.shape[0]
    if frame_nb % n:
        raise ValueError(
            f"frame_nb={frame_nb} must be divisible by the mesh size {n}"
            " (pad the clip or drop devices)")
    return (_split(state, state_shardings(mesh, axis), mesh),
            _split(consts, consts_shardings(mesh, axis), mesh))


def _gather(trees, device):
    """Concatenate same-structure trees' tensors along their frame axis on
    `device`; other leaves (an int edge capacity) come from the first."""
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                    *trees)


def fit_frames_sharded(
    state: M.HomanState,
    consts: M.HomanConsts,
    cfg: M.HomanConfig,
    mesh: DeviceMesh,
    axis: str = "frames",
    loss_weights: Dict[str, float] | None = None,
    num_iterations: int = 400,
    lr: float = 1e-2,
    closed_hand_faces=None,
    roi_settings=None,
    raster_schedule=None,
    viz_step: int | None = None,
    viz_callback=None,
    full_settings=None,
    opt_state=None,
    return_opt_state: bool = False,
):
    """Joint fit of ONE clip with its frames split over `mesh`: the keyword
    surface of fit.joint.optimize_hand_object but `device` (the mesh
    places everything). Returns (final state, histories[, Adam state]) on
    the first entry's device; the result matches the unsharded fit to
    float rounding (batched reductions run in other shapes).
    """
    lw = dict(L.DEFAULT_LW)
    if loss_weights:
        lw.update(loss_weights)
    states, consts_sh = shard_frames(state, consts, mesh, axis)
    first = mesh.devices[0]
    devices = mesh.devices
    consts_full = joint_lib.consts_to(consts, first)
    closed = [None if closed_hand_faces is None
              else torch.as_tensor(closed_hand_faces).to(d) for d in devices]
    # Per-frame fields: one leaf per entry; global fields: one leaf on the
    # first entry, copied to the others inside the step.
    shard_params = [joint_lib.leaf_params(s, cfg, d)
                    for s, d in zip(states, devices)]
    params = {}
    for name, spec in vars(state_shardings(mesh, axis)).items():
        if shard_params[0][name] is None:
            params[name] = None
        elif spec is None:
            params[name] = shard_params[0][name]
        else:
            params[name] = [p[name] for p in shard_params]

    def entry_state(k):
        return M.HomanState(**{
            n: (None if p is None else p[k] if isinstance(p, list)
                else p.to(devices[k])) for n, p in params.items()})

    def gathered_state():
        return M.HomanState(**{
            n: (None if p is None else _gather(p, first)
                if isinstance(p, list) else p) for n, p in params.items()})

    def loss_fn(settings):
        rendered = _gather(
            [L.render_terms(entry_state(k), consts_sh[k], cfg, lw, closed[k],
                            settings, full_settings)
             for k in range(mesh.size)], first)
        loss_dict, metric_dict = L.reduce_terms(
            rendered, gathered_state(), consts_full, cfg, lw, closed[0],
            settings)
        return L.weighted_sum(loss_dict, lw), loss_dict, metric_dict

    def after_step(i, iters, done, total_iters):
        if (viz_callback is not None and viz_step
                and (i % viz_step == 0 or i == iters)
                and done < total_iters):
            viz_callback(done, gathered_state().map(
                lambda x: x.detach().clone()))

    if raster_schedule is None:
        raster_schedule = [(num_iterations, roi_settings)]
    optimizer, history = joint_lib.fit_loop(
        params, cfg, lr, loss_fn, raster_schedule, after_step, opt_state)
    final = gathered_state().map(lambda x: x.detach().clone())
    if return_opt_state:
        return final, history, joint_lib.adam_state(optimizer, params, cfg)
    return final, history
