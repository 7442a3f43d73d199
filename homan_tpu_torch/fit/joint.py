"""Stage C — joint hand+object optimization (homan_tpu/fit/joint.py:32-199).

The JAX package compiles the Adam loop into one `lax.scan`; here it is an
eager PyTorch loop. The three-LR-group Adam (rigid lr, mano 10 lr, rotations
10 lr) is `torch.optim.Adam` with three parameter groups; frozen fields stay
out of the optimizer. optax's and torch's Adam apply the same update (bias
correction, eps 1e-8 outside the square root).

Loss histories stay on the device and are stacked once at the end: the loop
makes no per-step host sync, as the scan makes none.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.fit import losses as L
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.render.rasterizer import MeshTopology

_GROUP_LR_SCALE = {"rigid": 1.0, "mano": 10.0, "rot": 10.0}


def make_optimizer(params: Dict[str, torch.Tensor], cfg: M.HomanConfig,
                   lr: float = 1e-2) -> torch.optim.Adam:
    """Adam over the trainable fields of `params` (name -> leaf tensor)."""
    labels = M.optimizer_param_labels(cfg)
    groups = []
    for group, scale in _GROUP_LR_SCALE.items():
        members = [params[n] for n, g in labels.items() if g == group]
        if members:
            groups.append({"params": members, "lr": lr * scale,
                           "name": group})
    return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)


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
    device=None,
) -> Tuple[M.HomanState, Dict[str, torch.Tensor]]:
    """Run the joint fit; returns (final_state, loss/metric histories).

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
    labels = M.optimizer_param_labels(cfg)
    params = {}
    for name, value in vars(state).items():
        if value is None:
            params[name] = None
            continue
        t = value.detach().to(device).clone()
        t.requires_grad_(labels[name] != "frozen")
        params[name] = t
    s = M.HomanState(**params)
    optimizer = make_optimizer(params, cfg, lr)

    if raster_schedule is None:
        raster_schedule = [(num_iterations, roi_settings)]
    total_iters = sum(it for it, _ in raster_schedule)

    history: Dict[str, list] = {}
    done = 0
    for iters, settings in raster_schedule:
        for i in range(1, iters + 1):
            optimizer.zero_grad(set_to_none=True)
            loss_dict, metric_dict = L.compute_all_losses(
                s, consts, cfg, lw, closed_hand_faces=closed_hand_faces,
                roi_settings=settings, full_settings=full_settings)
            loss = L.weighted_sum(loss_dict, lw)
            loss.backward()
            optimizer.step()
            for k, v in (("loss", loss), *loss_dict.items(),
                         *metric_dict.items()):
                history.setdefault(k, []).append(v.detach())
            done += 1
            # After every viz_step iterations of a phase and at its end.
            if (viz_callback is not None and viz_step
                    and (i % viz_step == 0 or i == iters)
                    and done < total_iters):
                viz_callback(done, s.map(lambda x: x.detach().clone()))
    final = s.map(lambda x: x.detach().clone())
    return final, {k: torch.stack(v) for k, v in history.items()}
