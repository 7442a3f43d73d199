"""One clip's frame axis split over devices (homan_tpu/parallel/frames.py).

The JAX package shards every per-frame tensor along its frame axis and lets
GSPMD insert the halo exchange of the smoothness term and the all-reduces
of the loss and of the global scales' gradients. Here each mesh entry
holds its frames' rows of the state and consts on its device, and a step
runs `losses.render_terms` (MANO, the renders, the SDF grids: every kernel
launch) per entry on that entry's device. The per-frame outputs are then
gathered on the first entry's device, where `losses.reduce_terms`
computes the terms that couple frames exactly: the smoothness differences
across shard boundaries, the frame means, the priors of the global
`int_scales_object` / `int_scales_hand`, which live on the first entry.
Autograd runs back across the `.to(device)` copies, and each entry's Adam
update stays on its device (Adam is elementwise: the split update equals
the unsplit one).

A mesh may span processes (make_frame_mesh inside multihost.initialize's
group). Every process is handed the whole clip and keeps its entries'
rows; the gather then also takes every process's rows in rank order
(multihost.gather_frames), so every process computes the same loss from
the same whole-clip tensors, and the global scales enter each process's
renders through multihost.replicate, whose backward sums their gradient
over processes. Each process backpropagates loss / processes; the gather's
backward sums the processes' upstream gradients, so the replicated leaves
get the same all-reduced gradient, hence the same Adam update, everywhere.

Hands use the frame-major interleaved B*H rows, so contiguous shards keep
whole frames: frame_nb must be divisible by the mesh size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from homan_tpu_torch.fit import joint as joint_lib
from homan_tpu_torch.fit import losses as L
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.parallel import multihost
from homan_tpu_torch.parallel.clips import (DeviceMesh, make_mesh, tree_leaves,
                                            tree_map, tree_replace)


def make_frame_mesh(n_devices: int | None = None, axis: str = "frames",
                    devices: Sequence | None = None) -> DeviceMesh:
    """The frame axis's mesh.

    Outside a process group: `devices` as named (repeats allowed), or the
    first `n_devices` CUDA devices (all of them by default). Inside one
    (multihost.initialize), the mesh spans every process in rank order, as
    jax.devices() does after jax.distributed.initialize: this process's
    entries are `devices` or its CUDA devices, every process holds as many,
    and `n_devices` counts the entries of all processes."""
    world = multihost.process_count()
    if world == 1:
        return make_mesh(n_devices, axis, devices)
    if n_devices is not None:
        if n_devices % world:
            raise ValueError(f"{n_devices} mesh entries do not split over "
                             f"{world} processes")
        n_devices //= world
    local = make_mesh(n_devices, axis, devices)
    n = len(local.devices)
    most, least = multihost.all_max([n, -n])
    if most != -least:
        raise ValueError(f"processes hold {-least} to {most} mesh entries; "
                         "a frame mesh needs as many in each")
    return dataclasses.replace(local, process_count=world,
                               process_index=multihost.process_index())


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
    """One copy of a state or consts per local mesh entry, on its device:
    the fields named by spec_tree sliced to the entry's rows (their leading
    axis split in mesh.size equal parts, global entry `process_index *
    local + j` taking part j of this process's block), the others whole."""
    out = []
    base = mesh.process_index * len(mesh.devices)
    for k, dev in enumerate(mesh.devices):
        fields = {}
        for name, spec in vars(spec_tree).items():
            value = getattr(tree, name)
            if spec is None or value is None:
                fields[name] = tree_map(lambda t, d=dev: t.to(d), value)
            else:
                per = value.shape[0] // mesh.size
                fields[name] = value[(base + k) * per:
                                     (base + k + 1) * per].to(dev)
        out.append(type(tree)(**fields))
    return out


def shard_frames(state: M.HomanState, consts: M.HomanConsts,
                 mesh: DeviceMesh, axis: str = "frames"
                 ) -> Tuple[list, list]:
    """One clip's state and consts split by frame over the mesh: this
    process's lists of states and of consts, one per local entry, on its
    device (every process is handed the whole clip and keeps its
    entries' rows). Requires frame_nb % mesh.size == 0 (whole frames per
    entry)."""
    n = mesh.size
    frame_nb = state.translations_object.shape[0]
    if frame_nb % n:
        raise ValueError(
            f"frame_nb={frame_nb} must be divisible by the mesh size {n}"
            " (pad the clip or drop devices)")
    return (_split(state, state_shardings(mesh, axis), mesh),
            _split(consts, consts_shardings(mesh, axis), mesh))


def _int_leaves(tree) -> list:
    """The int leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, int) and not isinstance(tree, bool):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _int_leaves(v)]
    return []


def _put_ints(tree, values):
    """`tree` with its int leaves taken in order from the iterator."""
    if isinstance(tree, int) and not isinstance(tree, bool):
        return next(values)
    if isinstance(tree, dict):
        return {k: _put_ints(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_put_ints(v, values) for v in tree)
    return tree


def _gather(trees, device):
    """Same-structure trees, one per local entry, as one whole-clip tree on
    `device`: the tensors concatenated along their frame axis, then every
    process's rows in rank order (multihost.gather_frames, one collective
    for the tree); an int leaf (an edge capacity) is its maximum over the
    entries of every process, so every process decides alike."""
    cat = tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                   *trees)
    ints = [max(xs) for xs in zip(*(_int_leaves(t) for t in trees))]
    cat = _put_ints(cat, iter(multihost.all_max(ints)))
    leaves = list(tree_leaves(cat))
    gathered = multihost.gather_frames([t for _, t in leaves])
    return tree_replace(cat, {p: t for (p, _), t in zip(leaves, gathered)})


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
    places everything). Over a mesh that spans processes, every process
    makes the same call with the whole clip. Returns (final state,
    histories[, Adam state]), whole, on the first local entry's device of
    every process; the result matches the unsharded fit to float rounding
    (batched reductions run in other shapes).
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
    # Per-frame fields: one leaf per local entry; global fields: one leaf on
    # the first entry, replicated on every process and copied to the
    # other entries inside the step.
    shard_params = [joint_lib.leaf_params(s, cfg, d)
                    for s, d in zip(states, devices)]
    params, split = {}, []
    for name, spec in vars(state_shardings(mesh, axis)).items():
        if shard_params[0][name] is None:
            params[name] = None
        elif spec is None:
            params[name] = shard_params[0][name]
        else:
            params[name] = [p[name] for p in shard_params]
            split.append(name)
    global_names = [n for n, p in params.items()
                    if p is not None and n not in split]

    def whole_state(rows, glob):
        return M.HomanState(**{n: rows.get(n, glob.get(n)) for n in params})

    def loss_fn(settings):
        glob = dict(zip(global_names, multihost.replicate(
            [params[n] for n in global_names])))

        def entry(k):
            st = M.HomanState(**{
                n: (None if p is None else p[k] if n in split
                    else glob[n].to(devices[k])) for n, p in params.items()})
            return {"rendered": L.render_terms(
                st, consts_sh[k], cfg, lw, closed[k], settings,
                full_settings), "state": {n: params[n][k] for n in split}}

        # The renders and the split fields of every entry of every process
        # in one gather; reduce_terms couples the frames on the whole clip.
        whole = _gather([entry(k) for k in range(len(devices))], first)
        loss_dict, metric_dict = L.reduce_terms(
            whole["rendered"], whole_state(whole["state"], glob),
            consts_full, cfg, lw, closed[0], settings)
        return L.weighted_sum(loss_dict, lw), loss_dict, metric_dict

    def final_state():
        with torch.no_grad():
            rows = _gather([{n: params[n][k] for n in split}
                            for k in range(len(devices))], first)
            return whole_state(rows, {n: params[n] for n in global_names}
                               ).map(lambda x: x.detach().clone())

    def after_step(i, iters, done, total_iters):
        if (viz_callback is not None and viz_step
                and (i % viz_step == 0 or i == iters)
                and done < total_iters):
            viz_callback(done, final_state())

    if raster_schedule is None:
        raster_schedule = [(num_iterations, roi_settings)]
    if opt_state is not None:
        opt_state = _process_moments(opt_state, split, mesh)
    # Every process backpropagates total / processes: the gather's
    # backward sums the processes' upstream gradients (multihost).
    optimizer, history = joint_lib.fit_loop(
        params, cfg, lr, loss_fn, raster_schedule, after_step, opt_state,
        backward_scale=1.0 / mesh.process_count)
    final = final_state()
    if return_opt_state:
        with torch.no_grad():
            return final, history, _gather_moments(
                joint_lib.adam_state(optimizer, params, cfg), split, first)
    return final, history


def _process_moments(opt_state, split, mesh: DeviceMesh):
    """A whole-clip Adam state with each split field's moments cut to this
    process's block of rows."""
    if mesh.process_count == 1:
        return opt_state

    def block(t):
        per = t.shape[0] // mesh.process_count
        return t[mesh.process_index * per:(mesh.process_index + 1) * per]

    return {g: {"count": v["count"],
                **{m: {n: block(t) if n in split else t
                       for n, t in v[m].items()} for m in ("mu", "nu")}}
            for g, v in opt_state.items()}


def _gather_moments(opt_state, split, device):
    """This process's Adam state (adam_state's layout) with each split
    field's moments gathered from every process, in rank order."""
    moments = {(g, m, n): t for g, v in opt_state.items()
               for m in ("mu", "nu") for n, t in v[m].items() if n in split}
    whole = _gather([moments], device)
    return {g: {"count": v["count"],
                **{m: {n: whole.get((g, m, n), t) for n, t in v[m].items()}
                   for m in ("mu", "nu")}}
            for g, v in opt_state.items()}
