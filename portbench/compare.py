"""The comparison that decides `correct`.

The program's answer for a clip is its fit: the loss history it reports
(each term at every step) and the leaves it ends with. The reference
(reference/) works the history out again from the same inputs. Each
figure lets a clip or two read beyond it: round-off decides a pixel's
coverage or a nearest vertex now and then, and such a switch moves single
clips (PERF.md), while a lower precision moves every clip and a fault
confined to part of the batch moves many.

- `term_gap`: every clip of the checked fit, step 1 (the loss at the
  initial leaves, before any update): for each loss term and clip, the gap
  between the program's value and the reference's, over the reference's
  largest value of that term; per term the second largest over the clips
  (one may stand out: no sound run has had two); the worst term. This
  holds MANO, the projections, the raster prep, the shade forward, the
  voxelizer and the SDF sampling, and every term of the recipe.
- `loss_gap`: a sample of clips drawn from the seed, fitted by the
  reference through the first `check_steps` steps: for each clip the
  largest relative gap between the two loss histories there, and the
  third largest over the clips (two may stand out: in step 2 the contact
  term's nearest-vertex switches moved two clips of 16 in two seeds of
  13). From step 2 on every loss value follows from the updates before
  it, so this holds the shade backward, the rest of the gradient and the
  Adam update, clip by clip: a clip whose update is dropped or doubled
  reads far beyond the limit.

The fitted leaves after the last step and the later losses are not
compared: sound runs agree within 2e-6 through step 50 on every seed tried,
then on some seeds a single pixel's coverage or a nearest-vertex switch,
decided by round-off, moves a clip's loss by up to 1e-3 and its leaves by
as much, which is more than the TF32 control moves them (PERF.md).
"""
from __future__ import annotations

import time

import torch

from portbench.reference import fit as ref_fit


def kth_largest(x: torch.Tensor, k: int) -> float:
    """The k-th largest value of a 1-D tensor (its smallest where it has
    fewer): a figure over clips that lets k - 1 of them stand out."""
    return float(torch.topk(x, min(k, x.numel())).values[-1])


def term_gap(port_hist, ref_terms, ref_total):
    """(worst gap, {term: gap}, {term: largest clip's gap}) at step 1: per
    term the second largest over the clips of each clip's gap over the
    term's largest value."""
    gaps, tops = {}, {}
    for k, r in list(ref_terms.items()) + [("loss", ref_total)]:
        key = k if k == "loss" else "loss_" + k
        p = port_hist[key][:, 0].to(r.device, torch.float64)
        r = r.to(torch.float64)
        top = float(r.abs().max())
        err = (p - r).abs()
        if top > 0:
            gaps[k] = kth_largest(err / top, 2)
            tops[k] = float(err.max()) / top
        else:
            gaps[k] = tops[k] = (0.0 if float(err.max()) == 0
                                 else float("inf"))
    return max(gaps.values()), gaps, tops


def clip_gaps(port_loss, ref_loss):
    """Each clip's largest relative gap of two loss histories (clips,
    steps) over the reference's steps: (clips,)."""
    p = port_loss[:, :ref_loss.shape[1]].to(ref_loss.device, torch.float64)
    r = ref_loss.to(torch.float64)
    return ((p - r).abs() / r.abs().clamp(min=1e-30)).amax(1)


def run(port_hist, state, consts, rc, lw, steps, lr, sample):
    """Every figure of the comparison, {name: value}, and the details.

    port_hist: {key: (C, steps)}; state, consts: the inputs both sides were
    given (reference layout); steps: how many steps the reference follows;
    sample: indices of the clips it follows."""
    t0 = time.perf_counter()
    ref_terms, ref_total = ref_fit.forward_terms(state, consts, rc, lw)
    tg, t_detail, t_tops = term_gap(port_hist, ref_terms, ref_total)
    t1 = time.perf_counter()
    idx = torch.as_tensor(sample, device=state["t_obj"].device)
    _, hist = ref_fit.fit({k: v[idx] for k, v in state.items()},
                          ref_fit.clip_slice(consts, idx), rc, lw, steps,
                          lr)
    p_loss = port_hist["loss"][idx.to(port_hist["loss"].device)]
    gaps = clip_gaps(p_loss, hist["loss"])
    figures = {"term_gap": tg, "loss_gap": kth_largest(gaps, 3)}
    detail = {"seconds": {"step1_all_clips": t1 - t0,
                          "steps_of_sample": time.perf_counter() - t1},
              "terms": t_detail, "terms_largest_clip": t_tops,
              "loss_gap_clips": gaps.tolist()}
    return figures, detail
