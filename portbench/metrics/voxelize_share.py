"""The voxelizer kernel's share of the device's busy time in the traced
stretch, %."""
from portbench.yardstick import trace


def read(ctx):
    t = trace.kernel_s(ctx.ops, "voxelize_kernel")
    if t <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * t / ctx.busy_s
