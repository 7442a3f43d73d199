"""The shade backward's share of its roofline, %: the least time for the
work on these inputs (the argmin residuals of every pixel read, the picked
pixels' residuals and cotangent read, the slot gradients written; 14
operations a picked pixel), times its launches in the traced stretch, over
the device time of its two kernels (strips and finalize) there; nothing
where the stretch holds no launch of it, and an error where it does and
the recipe counts no work for it."""
from portbench.yardstick import trace
from portbench.yardstick.peaks import bound_s


def read(ctx):
    t = trace.kernel_s(ctx.ops, "shade_bwd_")
    n = sum(1 for name, _, _ in ctx.ops if "shade_bwd_strip_kernel" in name)
    if t <= 0 or n == 0:
        return None
    if "shade_bwd" not in ctx.work:
        raise KeyError("the shade backward ran in the traced stretch, but the "
                       "recipe's work() counts no 'shade_bwd' work")
    w = ctx.work["shade_bwd"]
    return 100.0 * n * bound_s(w["bytes"], w["ops"])[0] / t
