"""A configuration, a traffic mix, a per-layer metric or a recipe dropped
into its folder is found by its name, with no code edited."""
import importlib
import json
import os
import shutil
import sys
import time
import types

import pytest
import torch

from portbench import harness, readings
from portbench.recipes import REQUIRED
from portbench.tests import tiny

# A recipe of its own: Adam on seeded least-squares problems, one unit a
# problem, compared with the closed-form answer.
TOY_RECIPE = '''
import contextlib
import types

import torch


def prepare(cfg, traffic, seed, device):
    g = torch.Generator(device=device).manual_seed(int(seed))
    P, m, n = int(traffic["problems"]), int(cfg["rows"]), int(cfg["cols"])
    A = torch.randn((P, m, n), generator=g, device=device)
    b = torch.randn((P, m, 1), generator=g, device=device)
    return types.SimpleNamespace(A=A, b=b, lr=float(cfg["lr"]))


def optimizer_steps(cfg):
    return int(cfg["steps"])


def fit(inputs, steps):
    x = torch.zeros(inputs.A.shape[0], inputs.A.shape[2], 1,
                    device=inputs.A.device, requires_grad=True)
    opt = torch.optim.Adam([x], lr=inputs.lr)
    for _ in range(steps):
        opt.zero_grad()
        ((inputs.A @ x - inputs.b) ** 2).sum().backward()
        opt.step()
    return x.detach()


def units(inputs):
    return inputs.A.shape[0]


def finite(output):
    return torch.isfinite(output).flatten(1).all(1)


def release(inputs):
    pass


def compare(output, inputs, cfg, traffic, seed):
    best = torch.linalg.lstsq(inputs.A, inputs.b).solution
    gap = ((output - best).norm(dim=(1, 2)) / best.norm(dim=(1, 2))).max()
    return {"solution_gap": float(gap)}, {}


def work(output, inputs, cfg):
    return {}


@contextlib.contextmanager
def stalled():
    """Every optimizer step skipped."""
    orig = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


def faults():
    return {"stalled": stalled}
'''


def test_new_config_traffic_and_metric_are_found(tmp_path):
    name = f"_found_{os.getpid()}"
    traffic = os.path.join(harness.HERE, "traffic", name + ".json")
    metric = os.path.join(harness.HERE, "metrics", name + ".py")
    try:
        with open(traffic, "w") as fh:
            json.dump({"clips": 5, "objects": [], "check_clips": 1}, fh)
        with open(metric, "w") as fh:
            fh.write("def read(ctx):\n    return ctx.steps * 2.0\n")
        os.makedirs(tmp_path / "cfgs")
        shutil.copy(os.path.join(tiny.ROOT, "portbench", "configs",
                                 "homan_step1.json"),
                    tmp_path / "cfgs" / "other.json")
        bench = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
        bench["configs"].append(dict(bench["configs"][0], name="other",
                                     file="cfgs/other.json"))
        bench["workloads"].append({"name": "new_cell", "config": "other",
                                   "traffic": name, "chips": 1, "why": "x"})
        bench["per_layer"].append({"name": name, "unit": "%",
                                   "workloads": ["new_cell"]})
        with open(tmp_path / "BENCHMARK.json", "w") as fh:
            json.dump(bench, fh)
        loaded = harness.load_benchmark(str(tmp_path))
        cell, cfg, tr = harness.load_cell(loaded, str(tmp_path), "new_cell")
        assert cell["config"] == "other" and cfg["steps"] == 201
        assert tr["clips"] == 5
        names = [m["name"] for m in harness.metrics_of(loaded, "new_cell",
                                                       "per_layer")]
        assert name in names and "voxelize_share" not in names
        assert name not in [m["name"] for m in harness.metrics_of(
            loaded, "step1_batch", "per_layer")]
        read = harness.load_reader(name)
        assert read(types.SimpleNamespace(steps=4)) == 8.0
    finally:
        for path in (traffic, metric):
            if os.path.exists(path):
                os.remove(path)


def test_every_listed_metric_has_a_reader():
    bench = harness.load_benchmark(tiny.ROOT)
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_new_recipe_is_found_and_runs_a_cell(tmp_path):
    name = f"_toy_{os.getpid()}"
    recipe = os.path.join(harness.HERE, "recipes", name + ".py")
    traffic = os.path.join(harness.HERE, "traffic", name + ".json")
    try:
        with open(recipe, "w") as fh:
            fh.write(TOY_RECIPE)
        with open(traffic, "w") as fh:
            json.dump({"problems": 4}, fh)
        importlib.invalidate_caches()
        toy = harness.load_recipe(name)
        assert all(callable(getattr(toy, fn)) for fn in REQUIRED)
        cfg = {"name": "toy", "recipe": name, "rows": 12, "cols": 5,
               "lr": 0.05, "steps": 300, "warmup_steps": 2,
               "trace_steps": 10, "checks": {"solution_gap": 1e-4}}
        with open(tmp_path / "toy.json", "w") as fh:
            json.dump(cfg, fh)
        bench = json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))
        bench["configs"].append({"name": "toy", "source": "x",
                                 "file": "toy.json", "reduced": [],
                                 "why": "x"})
        bench["workloads"].append({"name": "toy_cell", "config": "toy",
                                   "traffic": name, "chips": 1, "why": "x"})
        with open(tmp_path / "BENCHMARK.json", "w") as fh:
            json.dump(bench, fh)
        loaded = harness.load_benchmark(str(tmp_path))
        _, cfg, tr = harness.load_cell(loaded, str(tmp_path), "toy_cell")
        args = types.SimpleNamespace(workload="toy_cell", seed=2 ** 31 + 5,
                                     seconds=0.0, trace=0, control="none")
        r = harness.run_cell(loaded, args, cfg, tr, torch.device("cpu"),
                             time.perf_counter())
        assert r["correct"], r["checks"]
        assert r["attempted"] == 2 * 4 and r["failed"] == 0
        assert set(r["metrics"]) == {"clip_s", "setup_s"}
        assert list(r)[-1] == "checks"
        assert 0 <= r["checks"]["solution_gap"]["value"] <= 1e-4
        # The recipe's own fault is a mode of readings.py, as is the
        # sound program.
        seed, cpu = 2 ** 31 + 6, torch.device("cpu")
        sound = readings.read("toy_cell", cfg, tr, seed, "sound", cpu)
        stalled = readings.read("toy_cell", cfg, tr, seed, "stalled", cpu)
        assert sound["correct"] and not stalled["correct"], (sound, stalled)
        assert stalled["figures"]["solution_gap"] == pytest.approx(1.0)
        # Stopped far from the answer, the same cell is not correct.
        cfg["steps"] = 5
        r = harness.run_cell(loaded, args, cfg, tr, torch.device("cpu"),
                             time.perf_counter())
        assert not r["correct"], r["checks"]
    finally:
        for path in (recipe, traffic):
            if os.path.exists(path):
                os.remove(path)
        sys.modules.pop("portbench.recipes." + name, None)


def test_every_configuration_names_a_recipe():
    bench = harness.load_benchmark(tiny.ROOT)
    for c in bench["configs"]:
        with open(os.path.join(tiny.ROOT, c["file"])) as fh:
            recipe = harness.load_recipe(json.load(fh)["recipe"])
        for fn in REQUIRED:
            assert callable(getattr(recipe, fn)), (c["name"], fn)
