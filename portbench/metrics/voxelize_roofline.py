"""The voxelizer kernel's share of its roofline, %: the least time for a
step's launches (the hand's and the object's meshes of every clip-frame:
the crossing test per (column, triangle), the distance per (inside cell,
triangle) with the inside cells these meshes have, the packed triangles
read and the grids written), times the steps of the traced stretch, over
the kernel's device time there."""
from portbench.yardstick import trace
from portbench.yardstick.peaks import bound_s

NAME = "voxelize_kernel"


def read(ctx):
    launches = ctx.work.get("voxelize")
    t = trace.kernel_s(ctx.ops, NAME)
    n = sum(1 for name, _, _ in ctx.ops if NAME in name)
    if not launches or t <= 0 or n == 0:
        return None
    per_step = sum(bound_s(w["bytes"], w["ops"])[0] for w in launches)
    return 100.0 * per_step * (n / len(launches)) / t
