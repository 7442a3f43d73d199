"""The second traced stretch of a traced run: the program's own spans and
counters (homan_tpu_torch/utils_profiling.py) on, for the per-layer
metrics of the fit loop, the raster prep and the interactions layer.

The first stretch (harness.py) is the last `trace_steps` steps of the
window's first fit with CUDA activity alone and the program's tracing
off. This one is the same fit once more, after the window and the
comparison: the cell's inputs made again from the same seed by its
recipe's prepare, the recipe's full fit, and its last `trace_steps`
optimizer steps under torch.profiler with CPU and CUDA activity and
`tracing()` on, selected by the same global optimizer step hook (the
profile itself stops once the fit has returned). The first of its
metrics to be read runs it and keeps the result on the reading's
context; the others read that. Without a card, or with a program that
has no tracing switch, there is no stretch and its metrics read nothing.

It prints one `spans:` line on standard error: the accounting of
yardstick/spans.py (device and idle seconds by span), the program's
counters, and the stretch's ms a step beside the first stretch's, the
cost of tracing when on.
"""
from __future__ import annotations

import json
import sys
import time

from portbench import harness
from portbench.yardstick import spans as S

# A range around the stretch, so its bounds are read on the trace's clock.
MARK = "portbench.stretch"


class SpanStretch(harness.Stretch):
    """harness.Stretch with CPU activity and the program's tracing on."""

    def __init__(self, total: int, n: int, profiling):
        super().__init__(total, n)
        self.profiling = profiling
        self.counts = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.torch.cuda.synchronize()
        self.tracing = self.profiling.tracing()
        self.tracing.__enter__()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.torch.cuda.synchronize()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        """The stretch's end: the device synchronized, the clock read and
        the range closed. The profile runs on until finish()."""
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.mark.__exit__(None, None, None)

    def finish(self):
        """Stop the profile once the fit has returned: the profiler can
        drop a range still open when it stops (the last step's
        `fit.step`, in some profiles on the card)."""
        self.counts = self.profiling.counters()
        self.prof.stop()
        self.tracing.__exit__(None, None, None)


def events(prof):
    """(program spans, the host's other ops and calls, the device's
    operations, the marker's (start, end)) of a finished profile; the
    device's copies of host ranges are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, host, device, mark = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append(S.Device(name, e.start_ns(), e.end_ns(),
                                       e.correlation_id()))
            continue
        h = S.Host(name, e.start_ns(), e.end_ns(), e.start_thread_id(),
                   e.correlation_id(), e.sequence_nr(), e.fwd_thread_id())
        if not e.is_user_annotation():
            host.append(h)
        elif name == MARK:
            mark = (h.start, h.end)
        elif name in S.SPANS:
            spans.append(h)
    if mark is None:
        raise RuntimeError(f"the stretch's range {MARK!r} is not in its "
                           "trace")
    return spans, host, device, mark


def run(ctx):
    """Run the stretch for the cell of the reading's context (its recipe,
    cfg, traffic, seed and device); returns the accounting with
    `counters`, `ms_per_step` and `first_ms_per_step` (None without a card
    or without the program's tracing switch)."""
    import torch
    if not torch.cuda.is_available():
        return None
    from homan_tpu_torch import utils_profiling
    if not hasattr(utils_profiling, "tracing"):
        print("spans: none (the program has no tracing switch)",
              file=sys.stderr, flush=True)
        return None
    from torch.optim.optimizer import register_optimizer_step_post_hook
    recipe, cfg = ctx.recipe, ctx.cfg
    inputs = recipe.prepare(cfg, ctx.traffic, ctx.seed, ctx.device)
    n = int(cfg["trace_steps"])
    stretch = SpanStretch(recipe.optimizer_steps(cfg), n, utils_profiling)
    hook = register_optimizer_step_post_hook(stretch)
    try:
        recipe.fit(inputs, int(cfg["steps"]))
    finally:
        hook.remove()
    if stretch.t1 is None:
        raise RuntimeError("no optimizer step hook fired: the second "
                           "stretch holds nothing")
    stretch.finish()
    spans, host, device, (t0, t1) = events(stretch.prof)
    out = S.summary(spans, host, device, t0, t1)
    out["counters"] = stretch.counts
    out["ms_per_step"] = 1e3 * (stretch.t1 - stretch.t0) / n
    out["first_ms_per_step"] = 1e3 * ctx.window_s / ctx.steps
    print("spans: " + json.dumps(out), file=sys.stderr, flush=True)
    return out


def of(ctx):
    """The second stretch's accounting for this traced run, run once."""
    if not hasattr(ctx, "spans"):
        ctx.spans = run(ctx)
    return ctx.spans


def share(ctx, table: str, span: str, base: str):
    """100 x the stretch's `table`[span] over its `base` seconds; None
    where the stretch or the span is absent."""
    s = of(ctx)
    if s is None or span not in s[table] or s[base] <= 0:
        return None
    return 100.0 * s[table][span] / s[base]
