"""Carry the JAX package's data across: numpy dicts -> the port's objects.

The JAX side's HomanState, HomanConsts (MANO params and MeshTopology
included), HomanConfig and the scene's closed-hand faces are handed over as
numpy arrays in plain dicts (field name -> array, nested dicts for the
topologies and MANO params), so this module needs neither jax nor the JAX
package. Both sides then compute the same thing from the same values.
Stacked trees (parallel/clips.py's leading clip axis) convert the same way.

An optax Adam state (the JAX fit's `opt_state`, one ScaleByAdamState per
label of its multi_transform) is handed over as {label: {"count", "mu":
{field: array}, "nu": {field: array}}}, the layout of the port's
fit/joint.py `adam_state`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core.mano import params_to_tensors
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.render.rasterizer import MeshTopology

_TOPOLOGY_FIELDS = ("faces", "edges", "edge_faces", "edge_dir_f1")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def config_from_dict(d: Dict[str, Any]) -> M.HomanConfig:
    d = dict(d)
    d["hand_sides"] = tuple(d["hand_sides"])
    return M.HomanConfig(**d)


def state_from_numpy(d: Dict[str, Any], device=None) -> M.HomanState:
    dev = resolve_device(device)
    return M.HomanState(**{
        k: (None if v is None else _tensor(v, dev)) for k, v in d.items()})


def topology_from_numpy(d: Dict[str, Any], device=None) -> MeshTopology:
    """MeshTopology from its arrays (extra fields such as the JAX side's
    TPU-only scatter-avoidance slots are ignored)."""
    return MeshTopology.from_arrays(
        device=resolve_device(device), **{k: d[k] for k in _TOPOLOGY_FIELDS})


def consts_from_numpy(d: Dict[str, Any], device=None) -> M.HomanConsts:
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(M.HomanConsts):
        v = d[f.name]
        if f.name in ("faces_object", "faces_hand"):
            out[f.name] = topology_from_numpy(v, dev)
        elif f.name == "mano_params_by_side":
            out[f.name] = {side: (None if p is None
                                  else params_to_tensors(p, dev))
                           for side, p in v.items()}
        else:
            out[f.name] = _tensor(v, dev)
    return M.HomanConsts(**out)


def faces_from_numpy(a, device=None) -> torch.Tensor:
    """(F, 3) int64 faces, e.g. the JAX scene's closed_hand_faces."""
    return _tensor(a, resolve_device(device))


def adam_state_from_optax(d: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's Adam state (fit/joint.py adam_state) from an optax
    state's numpy layout (module docstring); labels with no field (optax's
    masked-out groups) are dropped."""
    dev = resolve_device(device)
    return {label: {"count": int(np.asarray(g["count"])),
                    "mu": {k: _tensor(v, dev) for k, v in g["mu"].items()},
                    "nu": {k: _tensor(v, dev) for k, v in g["nu"].items()}}
            for label, g in d.items() if g["mu"]}


def adam_state_to_optax(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The numpy layout of an optax state from the port's Adam state
    (counts as int32, as optax keeps them)."""
    return {label: {"count": np.asarray(g["count"], np.int32),
                    "mu": {k: v.detach().cpu().numpy()
                           for k, v in g["mu"].items()},
                    "nu": {k: v.detach().cpu().numpy()
                           for k, v in g["nu"].items()}}
            for label, g in opt_state.items()}
