#!/usr/bin/env python3
"""The readings that the comparison's limits are set from: the program's
fit of a cell's batch at the cell's own size, on many seeds in one process
(set-up paid once), each compared with the reference as a run compares it.

    python3 portbench/readings.py --workload step2_batch \\
        --seeds 11 12 13 --modes sound tf32 half_update

Modes: `sound`, the program as the configuration states it; `tf32`, the
lower-precision control (TF32 switched on after the port is imported);
and each fault of the cell's recipe (its faults(); joint_fit's
`half_update` applies every optimizer step to the first half of the clips
only). The recipe (recipes/) makes the inputs, fits and compares, as a run
does. Prints one JSON line per seed and mode: the figures beside their
limits, whether a run would read `correct`, and the details. It runs no
measured window and prints no benchmark result.
"""
import argparse
import contextlib
import json
import os
import sys
import time

MODES = ("sound", "tf32")


def read(workload, cfg, traffic, seed, mode, dev):
    """One seed's figures in one mode: {figures, limits, correct, failed,
    detail, seconds}."""
    import torch
    import homan_tpu_torch  # noqa: F401  (switches TF32 off on import)
    from portbench import harness

    def precision(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32

    t0 = time.perf_counter()
    recipe = harness.load_recipe(cfg["recipe"])
    precision(False)
    inputs = recipe.prepare(cfg, traffic, seed, dev)
    precision(mode == "tf32")
    fault = (contextlib.nullcontext() if mode in MODES
             else recipe.faults()[mode]())
    with fault:
        out = recipe.fit(inputs, int(cfg["steps"]))
    failed = int((~recipe.finite(out)).sum())
    recipe.release(inputs)
    precision(False)
    figures, detail = recipe.compare(out, inputs, cfg, traffic, seed)
    limits = dict(cfg["checks"])
    correct = (all(figures[k] <= v for k, v in limits.items())
               and failed == 0)
    return {"workload": workload, "seed": seed, "mode": mode,
            "correct": correct, "figures": figures, "limits": limits,
            "failed": failed, "detail": detail,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["sound"],
                   help="sound, tf32 or a fault of the cell's recipe")
    args = p.parse_args(argv)
    # The caches of run.py, at the same fixed paths inside the checkout.
    root, here = os.getcwd(), os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(here, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, root)
    from portbench import harness
    _, cfg, traffic = harness.load_cell(harness.load_benchmark(root), root,
                                        args.workload)
    known = MODES + tuple(harness.load_recipe(cfg["recipe"]).faults())
    unknown = [m for m in args.modes if m not in known]
    if unknown:
        p.error(f"unknown modes {unknown}; this cell's are {list(known)}")
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    for mode in args.modes:
        for seed in args.seeds:
            r = read(args.workload, cfg, traffic, seed, mode, dev)
            print(json.dumps(r), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
