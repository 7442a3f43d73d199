"""Batched fitting of independent clips (homan_tpu/parallel/clips.py).

The JAX package stacks a batch of clips on a leading axis, vmaps the
per-clip joint fit over it and shards that axis over a `jax.sharding.Mesh`.
Here `torch.func.vmap` carries the clip axis through the per-clip loss:
every torch operation runs once for all clips of a mesh entry, and each
kernel wrapper's vmap rule folds the clip axis into its frame axis
(render/shade.py `fold_batched`), so a step launches each kernel once per
mesh entry, not once per clip. The step's loss is the sum of the clips'
totals: clips share no parameter, so each gets its own gradient, and one
torch Adam over the stacked leaves equals one Adam per clip (the update is
elementwise and every clip takes the same steps).

A mesh is an ordered tuple of torch devices with an axis name. Entries may
repeat a device: torch has one CPU device, so the CPU tests build meshes of
four `cpu` entries; entries on one device run one after another.

Clips of different objects stack once padded to one shape
(core/meshes.py `pad_mesh`, and their topologies' edges to one count);
consts that every clip shares (the same object topology, the MANO model)
are given to the loss once, not per clip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.fit import joint as joint_lib
from homan_tpu_torch.fit import losses as L
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.render.rasterizer import RasterSettings


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An ordered tuple of devices along one named axis: this process's
    entries (`devices`) of a mesh that spans `process_count` processes,
    each holding as many entries, in rank order; this process is
    `process_index`. Global entry `process_index * len(devices) + j` is
    local entry j."""
    devices: Tuple[torch.device, ...]
    axis: str
    process_count: int = 1
    process_index: int = 0

    @property
    def size(self) -> int:
        """Entries over all processes."""
        return len(self.devices) * self.process_count


def make_mesh(n_devices: int | None, axis: str,
              devices: Sequence | None) -> DeviceMesh:
    """`devices` as named (repeats allowed), or the first `n_devices` CUDA
    devices (all of them by default); raises without CUDA."""
    if devices is None:
        resolve_device(None)
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"{n} devices asked for, {count} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None:
            devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(tuple(devices), axis)


def make_clip_mesh(n_devices: int | None = None, axis: str = "clips",
                   devices: Sequence | None = None) -> DeviceMesh:
    return make_mesh(n_devices, axis, devices)


def tree_map(fn, *trees):
    """fn over the tensors of same-structure trees of dataclasses (the
    state, the consts, MeshTopology), dicts, lists and tuples; None and
    other leaves come from the first tree."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return type(t0)(**{f.name: tree_map(fn, *(getattr(t, f.name)
                                                   for t in trees))
                           for f in dataclasses.fields(t0)})
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return t0


def tree_leaves(tree, path=()):
    """(path, tensor) pairs of a tree, in tree_map's order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))


def tree_replace(tree, leaves: Dict, path=()):
    """`tree` with the tensor at each path taken from `leaves`."""
    if isinstance(tree, torch.Tensor):
        return leaves[path]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_replace(getattr(tree, f.name),
                                                  leaves, path + (f.name,))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_replace(v, leaves, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_replace(v, leaves, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def stack_clips(items):
    """Stack same-structure trees (HomanState, HomanConsts, MeshTopology,
    dicts of tensors) along a new leading clip axis."""
    return tree_map(lambda *xs: torch.stack(xs), *items)


def shard_clip_batch(tree, mesh: DeviceMesh, axis: str = "clips"):
    """Split a stacked-clip tree's leading axis over the mesh: one tree per
    entry, on its device, in order. The clip count must be divisible by
    the mesh size."""
    sizes = {t.shape[0] for _, t in tree_leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"clip axes differ in length: {sorted(sizes)}")
    n_clips = sizes.pop()
    if n_clips % mesh.size:
        raise ValueError(f"{n_clips} clips must be divisible by the "
                         f"{axis!r} mesh size {mesh.size}")
    per = n_clips // mesh.size
    return [tree_map(lambda t, k=k, dev=dev: t[k * per:(k + 1) * per]
                     .to(dev), tree)
            for k, dev in enumerate(mesh.devices)]


def _clip_loss(consts: M.HomanConsts, cfg: M.HomanConfig, lw, closed):
    """The batched loss of one mesh entry's clips: (params, settings) ->
    ((C,) totals, loss dict, metric dict), each entry (C,).

    A consts tensor equal across the clips goes in once, unbatched (the
    object topology, the MANO model where the clips share them)."""
    shared, batched = {}, {}
    for path, t in tree_leaves(consts):
        if torch.equal(t, t[:1].expand_as(t)):
            shared[path] = t[0]
        else:
            batched[path] = t
    keys = list(batched)

    def per_clip(state_leaves, batched_leaves, settings):
        state = M.HomanState(**state_leaves)
        leaves = dict(shared)
        leaves.update(zip(keys, batched_leaves))
        loss_dict, metric_dict = L.compute_all_losses(
            state, tree_replace(consts, leaves), cfg, lw,
            closed_hand_faces=closed, roi_settings=settings)
        return L.weighted_sum(loss_dict, lw), loss_dict, metric_dict

    def loss(params, settings):
        return torch.func.vmap(
            lambda s, b: per_clip(s, b, settings), in_dims=(0, 0))(
                params, [batched[k] for k in keys])
    return loss


def fit_clips_batched(
    states: M.HomanState,
    consts: M.HomanConsts,
    cfg: M.HomanConfig,
    loss_weights: Dict[str, float] | None = None,
    num_iterations: int = 400,
    lr: float = 1e-2,
    roi_settings: RasterSettings | None = None,
    mesh: DeviceMesh | None = None,
    axis: str = "clips",
    closed_hand_faces=None,
    device=None,
) -> Tuple[M.HomanState, Dict[str, torch.Tensor]]:
    """Fit a batch of independent clips (every leaf of states and consts
    carries a leading clip axis), each mesh entry fitting its share of the
    clips in one set of launches a step.

    mesh: the entries the clips split over (make_clip_mesh); None fits
    every clip on `device` (default `cuda`; raises without CUDA).
    closed_hand_faces: (F, 3), shared by the clips, for the collision and
    contact terms.

    Returns (final states, histories), both with a leading clip axis
    (histories (C, num_iterations)), on the first entry's device.
    """
    if mesh is None:
        mesh = make_clip_mesh(devices=[resolve_device(device)], axis=axis)
    lw = dict(L.DEFAULT_LW)
    if loss_weights:
        lw.update(loss_weights)
    first = mesh.devices[0]
    entries, params_all = [], {}
    for dev, (st, cs) in zip(mesh.devices,
                             shard_clip_batch((states, consts), mesh, axis)):
        params = joint_lib.leaf_params(st, cfg, dev)
        closed = (None if closed_hand_faces is None
                  else torch.as_tensor(closed_hand_faces).to(dev))
        entries.append((params, _clip_loss(cs, cfg, lw, closed)))
        for name, t in params.items():
            params_all.setdefault(name, []).append(t)
    params_all = {k: (None if v[0] is None else v)
                  for k, v in params_all.items()}

    def loss_fn(settings):
        outs = [loss({k: v for k, v in params.items() if v is not None},
                     settings) for params, loss in entries]
        cat = lambda xs: torch.cat([x.to(first) for x in xs])  # noqa: E731
        return (cat([o[0] for o in outs]),
                {k: cat([o[1][k] for o in outs]) for k in outs[0][1]},
                {k: cat([o[2][k] for o in outs]) for k in outs[0][2]})

    _, history = joint_lib.fit_loop(params_all, cfg, lr, loss_fn,
                                    [(num_iterations, roi_settings)])
    final = M.HomanState(**{
        k: (None if v is None else
            torch.cat([t.detach().to(first) for t in v]))
        for k, v in params_all.items()})
    return final, {k: v.transpose(0, 1) for k, v in history.items()}
