"""The joint fit: Adam over the clips' free leaves, three learning rates.

Translations take lr, rotations (6D) and the hand's pose and shape
coefficients 10 lr; the MANO global rotation and offset and both intrinsic
scales stay fixed. Adam as Kingma and Ba write it (beta 0.9 and 0.999, eps
1e-8 outside the square root, bias-corrected moments).
"""
from __future__ import annotations

import torch

from portbench.reference import losses

GROUPS = {"t_obj": 1.0, "t_hand": 1.0, "r_obj": 10.0, "r_hand": 10.0,
          "pca": 10.0, "betas": 10.0}


def fit(state, consts, rc, lw, steps: int, lr: float):
    """Run `steps` Adam steps from `state` (a dict of leaves, unchanged).

    Returns (final leaves, histories {term: (C, steps)} with "loss" the
    weighted total)."""
    x = {k: v.detach().clone() for k, v in state.items()}
    m = {k: torch.zeros_like(x[k]) for k in GROUPS}
    v = {k: torch.zeros_like(x[k]) for k in GROUPS}
    hist = {}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(1, steps + 1):
        for k in GROUPS:
            x[k].requires_grad_(True)
        parts, total = losses.terms(x, consts, rc, lw)
        grads = torch.autograd.grad(total.sum(), [x[k] for k in GROUPS])
        for name, val in (("loss", total), *parts.items()):
            hist.setdefault(name, []).append(val.detach())
        with torch.no_grad():
            for k, g in zip(GROUPS, grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                mh = m[k] / (1 - b1 ** i)
                vh = v[k] / (1 - b2 ** i)
                x[k] = x[k].detach() - lr * GROUPS[k] * mh / (
                    torch.sqrt(vh) + eps)
    return ({k: t.detach() for k, t in x.items()},
            {k: torch.stack(h, 1) for k, h in hist.items()})


def forward_terms(state, consts, rc, lw, clips_per_block: int = 8):
    """The terms (C,) and total at `state` without a step, in blocks of
    clips so that any batch fits."""
    C = state["t_obj"].shape[0]
    parts, totals = {}, []
    with torch.no_grad():
        for c0 in range(0, C, clips_per_block):
            sl = slice(c0, c0 + clips_per_block)
            p, t = losses.terms({k: v[sl] for k, v in state.items()},
                                clip_slice(consts, sl), rc, lw)
            totals.append(t)
            for k, val in p.items():
                parts.setdefault(k, []).append(val)
    return {k: torch.cat(v) for k, v in parts.items()}, torch.cat(totals)


SHARED = ("mano", "hand_faces")


def clip_slice(consts, sl):
    """consts restricted to the clips sl (shared entries kept whole)."""
    out = {}
    for k, v in consts.items():
        if k in SHARED:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = {kk: vv[sl] for kk, vv in v.items()}
        else:
            out[k] = v[sl]
    return out
