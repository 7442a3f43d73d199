"""A configuration, a traffic mix or a per-layer metric dropped into its
folder is found by its name, with no code edited."""
import json
import os
import shutil
import types

from portbench import harness
from portbench.tests import tiny


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
