#!/usr/bin/env python3
"""The readings that the comparison's limits are set from: the program's
fit of a cell's batch at the cell's own size, on many seeds in one process
(set-up paid once), each compared with the reference as a run compares it.

    python3 portbench/readings.py --workload step2_batch \\
        --seeds 11 12 13 --modes sound tf32 half_update

Modes: `sound`, the program as the configuration states it; `tf32`, the
lower-precision control (TF32 switched on after the port is imported);
`half_update`, a fault: every optimizer step applied to the first half of
the clips only. Prints one JSON line per seed and mode: the figures beside
their limits, whether a run would read `correct`, and the details. It runs
no measured window and prints no benchmark result.
"""
import argparse
import contextlib
import json
import os
import sys
import time

MODES = ("sound", "tf32", "half_update")


@contextlib.contextmanager
def half_update():
    """Every optimizer step applied to the first half of the clips only
    (the leaves' leading axis, rounded down): the others keep their
    leaves."""
    import torch
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)
    kept = []

    def pre(optimizer, args, kwargs):
        kept[:] = [(p, p.detach()[p.shape[0] // 2:].clone())
                   for g in optimizer.param_groups for p in g["params"]]

    def post(optimizer, args, kwargs):
        with torch.no_grad():
            for p, old in kept:
                p[p.shape[0] // 2:] = old

    hooks = [register_optimizer_step_pre_hook(pre),
             register_optimizer_step_post_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def read(workload, cfg, traffic, seed, mode, dev):
    """One seed's figures in one mode: {figures, limits, correct, failed,
    detail, seconds}."""
    import torch
    import homan_tpu_torch  # noqa: F401  (switches TF32 off on import)
    from homan_tpu_torch.parallel.clips import fit_clips_batched
    from portbench import compare, harness, scene

    def precision(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32

    t0 = time.perf_counter()
    B, C = int(cfg["frames"]), int(traffic["clips"])
    precision(False)
    state, consts, info = scene.make_clips(cfg, traffic, seed, dev)
    ke, demand = harness.edge_slots(state, consts, cfg, B)
    states, pconsts, pcfg, settings, hand_faces = harness.program_inputs(
        state, consts, info, cfg, ke)
    lw = dict(cfg["loss_weights"])
    steps, lr = int(cfg["steps"]), float(cfg["lr"])
    precision(mode == "tf32")
    fault = (half_update() if mode == "half_update"
             else contextlib.nullcontext())
    with fault:
        final, hist = fit_clips_batched(
            states, pconsts, pcfg, loss_weights=lw, num_iterations=steps,
            lr=lr, roi_settings=settings, closed_hand_faces=hand_faces,
            device=dev)
    failed = int((~(torch.isfinite(hist["loss"]).all(1)
                    & torch.isfinite(final.translations_object).reshape(
                        C, -1).all(1))).sum())
    port_hist = {k: v.detach() for k, v in hist.items()}
    del final, hist, states, pconsts
    precision(False)
    gen = torch.Generator().manual_seed(int(seed))
    sample = sorted(torch.randperm(C, generator=gen)[
        :int(traffic["check_clips"])].tolist())
    figures, detail = compare.run(port_hist, state, consts,
                                  harness.recipe_constants(cfg), lw,
                                  int(cfg["check_steps"]), lr, sample)
    limits = dict(cfg["checks"])
    correct = (all(figures[k] <= v for k, v in limits.items())
               and failed == 0)
    return {"workload": workload, "seed": seed, "mode": mode,
            "correct": correct, "figures": figures, "limits": limits,
            "failed": failed, "ke": ke, "demand": demand, "sample": sample,
            "detail": detail, "seconds": time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", choices=MODES, default=["sound"])
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
