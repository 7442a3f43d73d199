"""Recipes: the one part of a run that depends on what the program fits.

A configuration names its recipe under the key "recipe"; the harness finds
it as the module recipes/<name>.py (harness.load_recipe). Loading the cell,
the precision switch, set-up timing, the measured window and `clip_s`, the
traced stretches, the check for forbidden modules, the metric readers and
the result line are the harness's and hold for every recipe.

A recipe module defines:

- prepare(cfg, traffic, seed, device) -> inputs: the cell's inputs made on
  the device from the seed, in the program's types and in the layout its
  reference reads. Runs during set-up.
- optimizer_steps(cfg) -> int: the torch.optim steps that one whole fit
  takes (fit(inputs, cfg["steps"])); the traced stretches are its last
  cfg["trace_steps"] of them, found by torch.optim's global step hook.
- fit(inputs, steps) -> output: one whole fit, as the window times it; the
  harness synchronizes the device after it. The warm-up passes
  cfg["warmup_steps"].
- units(inputs) -> int: what one fit finishes; `clip_s` is the window's
  wall over the units of its fits.
- finite(output) -> bool tensor (units,): False where a unit's answer is
  not finite; each counts in `failed`.
- release(inputs): drops what only the program reads, once the window has
  closed, so that the reference runs with the program's state freed.
- compare(output, inputs, cfg, traffic, seed) -> (figures, detail): the
  comparison with the recipe's plain reference of the window's last
  output, figures keyed as the configuration's "checks"; detail, a JSON
  dict for standard error, also says what prepare made.
- work(output, inputs, cfg) -> dict: the work of one step that the
  yardstick's readers read (metrics/), from the traced fit's output: per
  kernel {"bytes", "ops"} under the kernel's key ("shade_fwd",
  "shade_bwd", a list under "voxelize") and "dense_ops"; a reader whose
  key is absent reads nothing; a kernel that launched in the traced
  stretch with no work counted for it is an error.
- faults() -> {name: context manager factory}: the planted faults of the
  recipe's cells, each switched on around a fit (readings.py --modes
  <name>): readings of the program broken underneath, from which a
  limit's upper end is set.

The second traced stretch (span_stretch.py) runs prepare and fit once more
with the program's tracing on.
"""

# The functions every recipe module defines, in the order above.
REQUIRED = ("prepare", "optimizer_steps", "fit", "units", "finite",
            "release", "compare", "work", "faults")
