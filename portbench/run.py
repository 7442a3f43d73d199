#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout.

    python3 portbench/run.py --workload step2_batch --seed 7 --seconds 51 \
        --trace 0

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with --trace
1 its per-layer metrics), device, with --trace 1 breakdown, and last the
figures that decide `correct`, each beside its limit (also the last lines
of standard error). Exits non-zero with no result line when CUDA is absent
or has fewer devices than the cell asks for, when the program cannot be
imported, or when jax, jaxlib, flax or homan_tpu were loaded.

--control tf32 runs the program with TF32 switched on after it is imported:
the lower-precision control the comparison must refuse. The benchmark's own
runs never pass it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
# Caches at fixed paths inside the checkout, so that only a checkout's
# first run builds. The program keeps its nvcc libraries in its own
# package directory (homan_tpu_torch/_build), also inside the checkout.
CACHE = os.path.join(HERE, ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "tf32"), default="none")
    return p.parse_args(argv)


if __name__ == "__main__":
    from portbench import harness
    sys.exit(harness.main(parse(), T_START, ROOT))
