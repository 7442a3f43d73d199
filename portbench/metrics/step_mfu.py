"""The step's share of the card's float32 peak, %: the operations a fit
step needs (the three kernels' work on the traced fit's inputs, and the
dense float work of the rest counted from shapes, yardstick/work.py) over
the traced stretch's wall time per step times 67 TFLOP/s; nothing where
the recipe counts no step's work (no `dense_ops`)."""
from portbench.yardstick.peaks import FP32_OPS_PER_S


def read(ctx):
    w = ctx.work
    if "dense_ops" not in w or ctx.steps <= 0 or ctx.window_s <= 0:
        return None
    ops = (sum(w[k]["ops"] for k in ("shade_fwd", "shade_bwd") if k in w)
           + w["dense_ops"] + sum(v["ops"] for v in w.get("voxelize", [])))
    return 100.0 * ops / (ctx.window_s / ctx.steps * FP32_OPS_PER_S)
