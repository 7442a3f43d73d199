"""A cell cut to a size the CPU runs in seconds, for the tests: the same
code path as a run on the card, with the program's kernels in their plain
PyTorch versions."""
import copy
import os
import time
import types

import torch

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell(workload="step1_batch"):
    bench = harness.load_benchmark(ROOT)
    _, cfg, traffic = harness.load_cell(bench, ROOT, workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(frames=3, rend_size=64, steps=4, warmup_steps=1,
               check_steps=4)
    cfg["raster"]["tile_px"] = 32
    traffic.update(clips=6, check_clips=6)
    return bench, cfg, traffic


def run(workload="step1_batch", seed=2 ** 31 + 17, control="none"):
    bench, cfg, traffic = cell(workload)
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.0,
                                 trace=0, control=control)
    return harness.run_cell(bench, args, cfg, traffic, torch.device("cpu"),
                            time.perf_counter())
