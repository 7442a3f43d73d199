"""The benchmark of homan_tpu_torch, the PyTorch/CUDA port of homan_tpu.

One command runs one cell once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations and metrics are listed in BENCHMARK.json at the
root of the checkout. Everything that belongs to one configuration
(`configs/`), one traffic mix (`traffic/`), one per-layer metric
(`metrics/`) or one recipe (`recipes/`) is a file of its own, found by its
name. A recipe is what a configuration fits: it makes the inputs, runs one
whole fit, counts its units and its work, and compares the answer with its
plain reference (`recipes/__init__.py`); a configuration names it under
"recipe". The harness (`harness.py`, `span_stretch.py`) reaches the
program only through the recipe.

`reference/` is the plain PyTorch reference that decides `correct` for the
joint fit (`recipes/joint_fit.py`, `compare.py`); it imports nothing of
the port. `yardstick/` holds the peaks of the card, the kernels' work
formulas and the trace arithmetic, frozen here so that a change to the
program cannot move them.
"""
