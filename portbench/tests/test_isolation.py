"""What a run loads: never jax, jaxlib, flax or homan_tpu, compared by
whole top-level module names (homan_tpu_torch is not homan_tpu); and the
reference, with the scene generator, the comparison and the yardstick,
loads nothing of the program either."""
import json
import subprocess
import sys

from portbench.tests import tiny

FORBIDDEN = ("jax", "jaxlib", "flax", "homan_tpu")

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests import tiny
r = tiny.run()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from portbench import compare, scene
from portbench.reference import fit, losses
from portbench.yardstick import peaks, trace, work
from portbench.tests import tiny
bench, cfg, traffic = tiny.cell("step2_batch")
cfg["steps"] = 2
state, consts, info = scene.make_clips(cfg, traffic, 3, "cpu")
rc = {{"rend_size": cfg["rend_size"], "image_size": cfg["image_size"],
      "sigma": 1e-5, "bin_margin_px": 8.0, "sdf_grid": 16}}
final, hist = fit.fit(state, consts, rc, cfg["loss_weights"], 2, 0.01)
assert torch.isfinite(hist["loss"]).all()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(script):
    out = subprocess.run([sys.executable, "-c",
                          script.format(root=tiny.ROOT)], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    top = _loaded(HARNESS)
    assert "homan_tpu_torch" in top  # the run did drive the program
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded(REFERENCE)
    assert "torch" in top
    bad = top & (set(FORBIDDEN) | {"homan_tpu_torch"})
    assert not bad, bad
