"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison, and the result line.

What the cell fits is its configuration's recipe (recipes/<name>.py, found
by the configuration's "recipe" key): the harness calls the recipe's fit,
one whole fit a call, timed on the host clock and ended with
torch.cuda.synchronize(). Fits run back to back; one more starts only
while the time so far plus the mean fit so far stays within --seconds, and
every window holds at least two. clip_s is the window's wall time over the
units (the recipe's clips) its fits finished.

With --trace 1 the last `trace_steps` optimizer steps of the window's first
fit run under torch.profiler (CUDA activity), selected by torch.optim's
global step hooks with the device synchronized at both ends; the hooks are
registered in traced runs only.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import types

FORBIDDEN = ("jax", "jaxlib", "flax", "homan_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_cell(bench: dict, root: str, workload: str):
    """(cell entry, configuration dict, traffic dict) of a cell, each found
    by name: the configuration's file as BENCHMARK.json names it, the
    traffic in traffic/<name>.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return cell, cfg, traffic


def metrics_of(bench: dict, workload: str, kind: str):
    """The cell's metric entries of `kind` ("end_to_end" or "per_layer"):
    those without a workloads list, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str):
    """metrics/<name>.py's read(ctx)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_recipe(name: str):
    """recipes/<name>.py, the module that fits a configuration's cells."""
    return importlib.import_module("portbench.recipes." + name)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


# ---------------------------------------------------------------------------
# The traced stretch
# ---------------------------------------------------------------------------
class Stretch:
    """torch.profiler over steps (total - n, total] of one fit, selected by
    a global optimizer step hook: the device synchronized and the host
    clock read at both ends."""

    def __init__(self, total: int, n: int):
        import torch
        self.torch = torch
        self.first, self.last = total - n, total
        self.count, self.prof, self.t0, self.t1 = 0, None, None, None
        self.steps = n

    def __call__(self, optimizer, args, kwargs):
        self.count += 1
        if self.count == self.first:
            self.start()
        elif self.count == self.last:
            self.stop()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def events(self):
        """(device ops [(name, start_ns, end_ns)], host call names)."""
        cuda = self.torch.autograd.DeviceType.CUDA
        ops, calls = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                ops.append((e.name(), e.start_ns(), e.end_ns()))
            else:
                calls.append(e.name())
        return ops, calls


def trace_context(stretch, work, **cell):
    """What the per-layer readers read: the first stretch's device ops,
    launch calls, wall, steps and busy time, the recipe's work of a step,
    and `cell` (recipe, cfg, traffic, seed, device), from which
    span_stretch.py runs the second stretch."""
    from portbench.yardstick import trace
    ops, calls = stretch.events()
    return types.SimpleNamespace(
        ops=ops, launches=trace.count_launches(calls),
        window_s=stretch.t1 - stretch.t0, steps=stretch.steps,
        busy_s=trace.busy_s(ops), work=work, **cell)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------
def run_window(fit, seconds: float, after=None,
               clock=time.perf_counter):
    """Fits back to back: one more starts only while the time so far plus
    the mean fit so far stays within `seconds`, and at least two run.
    fit() runs one whole fit and returns when the device has finished it;
    after(i, output) runs after each, inside the window. Returns (walls,
    the window's wall time, the last fit's output)."""
    walls = []
    w0 = clock()
    while True:
        a = clock()
        out = fit()
        walls.append(clock() - a)
        if after is not None:
            after(len(walls) - 1, out)
        elapsed = clock() - w0
        if len(walls) >= 2 and elapsed + sum(walls) / len(walls) > seconds:
            return walls, clock() - w0, out


def main(args, t_start: float, root: str) -> int:
    """The command: the cell run on the first CUDA device; 2 where CUDA is
    absent or has fewer devices than the cell asks for, 3 where a
    forbidden module was loaded. Prints the result line."""
    bench = load_benchmark(root)
    cell, cfg, traffic = load_cell(bench, root, args.workload)
    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch sees {count}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_cell(bench, args, cfg, traffic, dev, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check failed {result['failed']} limit 0", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench, args, cfg, traffic, dev, t_start: float) -> dict:
    """Set-up, window, comparison and, with args.trace, the traced stretch
    of one cell on device `dev`; returns the result dict. On a CPU device
    (the tests) the program runs its kernels' plain versions, and the
    traced stretch is not available."""
    import torch
    import homan_tpu_torch  # noqa: F401  (switches TF32 off on import)
    from torch.optim.optimizer import register_optimizer_step_post_hook

    recipe = load_recipe(cfg["recipe"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def precision(tf32: bool):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32

    # The configuration states float32 with TF32 off; the control switches
    # TF32 on for the program, after the port is imported.
    precision(args.control == "tf32")

    card = card_line() if cuda else "cpu"
    print(f"card: {card}", file=sys.stderr, flush=True)
    marks = {"imports": time.perf_counter() - t_start}
    inputs = recipe.prepare(cfg, traffic, args.seed, dev)
    units = int(recipe.units(inputs))
    sync()
    marks["inputs"] = time.perf_counter() - t_start
    steps = int(cfg["steps"])

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    recipe.fit(inputs, int(cfg["warmup_steps"]))
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: {units} units; imports done at "
          f"{marks['imports']:.3f} s, inputs at {marks['inputs']:.3f} s",
          file=sys.stderr, flush=True)

    stretch = hook = None
    if args.trace:
        stretch = Stretch(recipe.optimizer_steps(cfg), int(cfg["trace_steps"]))
        hook = register_optimizer_step_post_hook(stretch)
    finite, first = [], []

    def one_fit():
        out = recipe.fit(inputs, steps)
        sync()
        return out

    def after(i, out):
        nonlocal hook
        if hook is not None:
            hook.remove()
            hook = None
        finite.append(recipe.finite(out))
        if not first:
            first.append(out)

    walls, window_s, out = run_window(one_fit, args.seconds, after)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    attempted = len(walls) * units
    failed = int(sum(int((~f).sum()) for f in finite))
    print(f"window {window_s:.3f} s: {len(walls)} fits of {units} units, "
          "walls " + ", ".join(f"{w:.3f}" for w in walls), file=sys.stderr,
          flush=True)

    recipe.release(inputs)
    if cuda:
        torch.cuda.empty_cache()

    # The reference, in float32 with TF32 off whatever the program ran.
    precision(False)
    c0 = time.perf_counter()
    figures, detail = recipe.compare(out, inputs, cfg, traffic, args.seed)
    print(f"comparison {time.perf_counter() - c0:.3f} s: "
          + json.dumps(detail), file=sys.stderr, flush=True)
    checks = {k: {"value": figures[k], "limit": lim}
              for k, lim in cfg["checks"].items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and failed == 0 and attempted > 0)

    metrics = {}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak, "power": card}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        from portbench.yardstick import trace
        if stretch.t1 is None:
            raise RuntimeError("no optimizer step hook fired: the traced "
                               "stretch holds nothing")
        work = recipe.work(first[0], inputs, cfg)
        ctx = trace_context(stretch, work, recipe=recipe, cfg=cfg,
                            traffic=traffic, seed=args.seed, device=dev)
        device["busy_s"] = ctx.busy_s
        device["window_s"] = ctx.window_s
        for m in metrics_of(bench, args.workload, "per_layer"):
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": trace.top_ops(ctx.ops),
                               "idle_gaps": trace.idle_gaps(ctx.ops)}
        print("work a step: " + json.dumps(work), file=sys.stderr,
              flush=True)
    else:
        values = {"clip_s": window_s / attempted, "setup_s": setup_s}
        for m in metrics_of(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result["checks"] = checks
    return result
