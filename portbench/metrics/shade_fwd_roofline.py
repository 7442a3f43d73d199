"""The shade forward kernel's share of its roofline, %: the least time the
card needs for the kernel's work on these inputs (yardstick/work.py, the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s), times its
launches in the traced stretch, over its device time there; nothing
where the stretch holds no launch of it, and an error where it does and
the recipe counts no work for it."""
from portbench.yardstick import trace
from portbench.yardstick.peaks import bound_s

NAME = "shade_fwd_kernel"


def read(ctx):
    t = trace.kernel_s(ctx.ops, NAME)
    n = sum(1 for name, _, _ in ctx.ops if NAME in name)
    if t <= 0 or n == 0:
        return None
    if "shade_fwd" not in ctx.work:
        raise KeyError("the shade forward ran in the traced stretch, but the "
                       "recipe's work() counts no 'shade_fwd' work")
    w = ctx.work["shade_fwd"]
    return 100.0 * n * bound_s(w["bytes"], w["ops"])[0] / t
