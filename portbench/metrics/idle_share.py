"""Device idle share of the traced stretch, %: the time in which no
operation ran on the device, over the stretch's wall on the host clock."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
