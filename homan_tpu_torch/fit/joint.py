"""Stage C — joint hand+object optimization (homan_tpu/fit/joint.py:32-199).

The JAX package compiles the Adam loop into one `lax.scan`; here it is an
eager PyTorch loop. The three-LR-group Adam (rigid lr, mano 10 lr, rotations
10 lr) is `torch.optim.Adam` with three parameter groups; frozen fields stay
out of the optimizer. optax's and torch's Adam apply the same update (bias
correction, eps 1e-8 outside the square root).

Loss histories stay on the device and are stacked once at the end: the loop
makes no per-step host sync, as the scan makes none. `fit_loop` is the loop
of every fit: this module's, the batched clips' and the frame-sharded one
(parallel/).

The Adam state (`opt_state`, `adam_state`): per group label, as optax keeps
one ScaleByAdamState per label, {"count": steps taken, "mu": {field:
first moment}, "nu": {field: second moment}}; convert.py carries an optax
state across.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.fit import losses as L
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.render.rasterizer import MeshTopology
from homan_tpu_torch.utils_profiling import span

_GROUP_LR_SCALE = {"rigid": 1.0, "mano": 10.0, "rot": 10.0}


def _as_list(x):
    return x if isinstance(x, list) else [x]


def make_optimizer(params: Dict[str, torch.Tensor], cfg: M.HomanConfig,
                   lr: float = 1e-2) -> torch.optim.Adam:
    """Adam over the trainable fields of `params` (name -> leaf tensor, or
    a list of leaves where a field is split over devices)."""
    labels = M.optimizer_param_labels(cfg)
    groups = []
    for group, scale in _GROUP_LR_SCALE.items():
        members = [t for n, g in labels.items() if g == group
                   for t in _as_list(params[n]) if t is not None]
        if members:
            groups.append({"params": members, "lr": lr * scale,
                           "name": group})
    return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def adam_state(optimizer: torch.optim.Adam, params: Dict[str, torch.Tensor],
               cfg: M.HomanConfig) -> Dict[str, Dict]:
    """The optimizer's state per group label (module docstring). A field
    split over devices (a list of leaves) has its moments concatenated on
    its first leaf's device. A group that has taken no step has count 0
    and zero moments."""
    labels = M.optimizer_param_labels(cfg)

    def moment(name, key):
        leaves = _as_list(params[name])
        return torch.cat([
            optimizer.state[p][key].detach().to(leaves[0].device)
            if p in optimizer.state else torch.zeros_like(p).to(
                leaves[0].device) for p in leaves])

    out = {}
    for group in _GROUP_LR_SCALE:
        names = [n for n, g in labels.items()
                 if g == group and params[n] is not None]
        if not names:
            continue
        st = optimizer.state.get(_as_list(params[names[0]])[0], {})
        out[group] = {"count": int(st["step"]) if "step" in st else 0,
                      "mu": {n: moment(n, "exp_avg") for n in names},
                      "nu": {n: moment(n, "exp_avg_sq") for n in names}}
    return out


def load_adam_state(optimizer: torch.optim.Adam,
                    params: Dict[str, torch.Tensor], opt_state: Dict) -> None:
    """Put an adam_state-layout state into a fresh optimizer (a field split
    over devices takes its rows of each moment)."""
    for group in opt_state.values():
        count = int(group["count"])
        if count == 0:
            continue
        for name, mu in group["mu"].items():
            leaves = _as_list(params[name])
            rows = [p.shape[0] for p in leaves]
            for p, m, v in zip(leaves, mu.split(rows),
                               group["nu"][name].split(rows)):
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": m.detach().to(p.device, p.dtype).clone(),
                    "exp_avg_sq": v.detach().to(p.device, p.dtype).clone()}


def _to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, MeshTopology):
        return MeshTopology(**{k: v.to(device) for k, v in vars(x).items()})
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    return x


def consts_to(consts: M.HomanConsts, device) -> M.HomanConsts:
    return M.HomanConsts(**{k: _to_device(v, device)
                            for k, v in vars(consts).items()})


def leaf_params(state: M.HomanState, cfg: M.HomanConfig,
                device) -> Dict[str, torch.Tensor]:
    """Fresh leaves of `state` on `device`, the trainable ones requiring
    grad (name -> tensor, None kept)."""
    labels = M.optimizer_param_labels(cfg)
    params = {}
    for name, value in vars(state).items():
        if value is None:
            params[name] = None
            continue
        t = value.detach().to(device).clone()
        t.requires_grad_(labels[name] != "frozen")
        params[name] = t
    return params


def fit_loop(params: Dict[str, torch.Tensor], cfg: M.HomanConfig, lr: float,
             loss_fn: Callable, raster_schedule: List,
             after_step: Callable | None = None, opt_state=None,
             backward_scale: float = 1.0,
             ) -> Tuple[torch.optim.Adam, Dict[str, torch.Tensor]]:
    """The Adam loop of every fit.

    loss_fn(settings) -> (total, loss_dict, metric_dict) for the current
    leaves; `total` is a scalar, or a (C,) vector of independent clips'
    totals whose sum gives each clip its own gradient. after_step(i, iters,
    done, total_iters) runs after each step (i counts within the phase).
    backward_scale: what the total is multiplied by before its backward
    (the histories keep it unscaled); a frame-sharded fit over processes
    gives 1 / processes.
    Under utils_profiling.tracing() each step is a `fit.step` span holding
    `fit.forward` (loss_fn), `fit.backward` and `fit.adam`.
    Returns the optimizer and the histories, stacked on a leading step axis.
    """
    optimizer = make_optimizer(params, cfg, lr)
    if opt_state is not None:
        load_adam_state(optimizer, params, opt_state)
    total_iters = sum(it for it, _ in raster_schedule)
    history: Dict[str, list] = {}
    done = 0
    for iters, settings in raster_schedule:
        for i in range(1, iters + 1):
            with span("fit.step"):
                optimizer.zero_grad(set_to_none=True)
                with span("fit.forward"):
                    loss, loss_dict, metric_dict = loss_fn(settings)
                    total = loss if loss.dim() == 0 else loss.sum()
                    if backward_scale != 1.0:
                        total = total * backward_scale
                with span("fit.backward"):
                    total.backward()
                with span("fit.adam"):
                    optimizer.step()
                for k, v in (("loss", loss), *loss_dict.items(),
                             *metric_dict.items()):
                    history.setdefault(k, []).append(v.detach())
                done += 1
                if after_step is not None:
                    after_step(i, iters, done, total_iters)
    return optimizer, {k: torch.stack(v) for k, v in history.items()}


def optimize_hand_object(
    state: M.HomanState,
    consts: M.HomanConsts,
    cfg: M.HomanConfig,
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
    device=None,
):
    """Run the joint fit; returns (final_state, loss/metric histories), and
    the final Adam state third with return_opt_state.

    closed_hand_faces: (F, 3) hand topology of the collision and contact
    terms (needed when lw_collision or lw_contact > 0).

    raster_schedule: optional list of (num_iters, RasterSettings) phases
    (coarse-to-fine silhouette softness); overrides num_iterations and
    roi_settings. Adam state carries across phases.

    viz_step/viz_callback: when both are set, viz_callback(iters_done,
    state) runs after every viz_step iterations of a phase and at the end
    of each phase, except after the last iteration.

    full_settings: the ordinal-depth term's full-image RasterSettings; None
    keeps the JAX package's default, RasterSettings(image_size=
    cfg.image_size). Its faces_per_tile bounds the faces binned per tile.

    opt_state: an Adam state to resume from (adam_state's layout, e.g. a
    return_opt_state result or convert.adam_state_from_optax); None starts
    fresh, as the JAX package's `opt_state=None`.

    device: where the fit runs (default `cuda`; raises when CUDA is absent).
    state and consts are moved there.
    """
    device = resolve_device(device)
    lw = dict(L.DEFAULT_LW)
    if loss_weights:
        lw.update(loss_weights)
    consts = consts_to(consts, device)
    if closed_hand_faces is not None:
        closed_hand_faces = _to_device(
            torch.as_tensor(closed_hand_faces), device)
    params = leaf_params(state, cfg, device)
    s = M.HomanState(**params)

    def loss_fn(settings):
        loss_dict, metric_dict = L.compute_all_losses(
            s, consts, cfg, lw, closed_hand_faces=closed_hand_faces,
            roi_settings=settings, full_settings=full_settings)
        return L.weighted_sum(loss_dict, lw), loss_dict, metric_dict

    def after_step(i, iters, done, total_iters):
        # After every viz_step iterations of a phase and at its end.
        if (viz_callback is not None and viz_step
                and (i % viz_step == 0 or i == iters)
                and done < total_iters):
            viz_callback(done, s.map(lambda x: x.detach().clone()))

    if raster_schedule is None:
        raster_schedule = [(num_iterations, roi_settings)]
    optimizer, history = fit_loop(params, cfg, lr, loss_fn, raster_schedule,
                                  after_step, opt_state)
    final = s.map(lambda x: x.detach().clone())
    if return_opt_state:
        return final, history, adam_state(optimizer, params, cfg)
    return final, history
