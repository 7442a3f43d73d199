"""The step's share of the card's float32 peak, %: the operations a fit
step needs (the three kernels' work on the traced fit's inputs, and the
dense float work of the rest counted from shapes, yardstick/work.py) over
the traced stretch's wall time per step times 67 TFLOP/s."""
from portbench.yardstick.peaks import FP32_OPS_PER_S


def read(ctx):
    w = ctx.work
    ops = (w["shade_fwd"]["ops"] + w["shade_bwd"]["ops"] + w["dense_ops"]
           + sum(v["ops"] for v in w.get("voxelize", [])))
    if ctx.steps <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * ops / (ctx.window_s / ctx.steps * FP32_OPS_PER_S)
