"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU silently."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "homan_tpu_torch")

_FIT_SCRIPT = """
import sys
import numpy as np
import homan_tpu_torch
from homan_tpu_torch.fit.joint import optimize_hand_object
from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
from homan_tpu_torch.render import RasterSettings

scene = make_synthetic_scene(np.eye(3, dtype=np.float32), frame_nb=2,
                             image_size=64, rend_size=32, device="cpu")
_, hist = optimize_hand_object(
    scene.init_state, scene.consts, scene.cfg, num_iterations=2,
    roi_settings=RasterSettings(32, tile_px=16, edges_per_tile=48),
    device="cpu")
assert np.isfinite(hist["loss"].numpy()).all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "homan_tpu"))
print("LOADED", bad)
"""


_STAGE_B_SCRIPT = """
import sys
import numpy as np
import homan_tpu_torch
from homan_tpu_torch.core.meshes import bumpy_potato
from homan_tpu_torch.fit.poseinit import find_optimal_poses
from homan_tpu_torch.frontend.evidence import build_object_mask_info
from homan_tpu_torch.frontend.gtevidence import mask_to_bbox, render_full_mask
from homan_tpu_torch.render import RasterSettings

v, f = bumpy_potato(1, 0.08, seed=0)
K = np.array([[115.2, 0, 64], [0, 115.2, 64], [0, 0, 1]], np.float32)
verts = v[None] + np.array([0.02, -0.01, 0.55], np.float32)
mask = render_full_mask(verts, f, K[None], 128, device="cpu")[0]
info = build_object_mask_info(mask, mask_to_bbox(mask), None, 64)
res = find_optimal_poses(v, f, [info], [K], (128, 128),
                         num_initializations=8, num_iterations=2,
                         rend_size=64, settings=RasterSettings(
                             64, tile_px=32, edges_per_tile=96),
                         device="cpu")
assert np.isfinite(res[0]["rotations"].numpy()).all()
assert 0.0 <= res[0]["best_iou"] <= 1.0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "homan_tpu"))
print("LOADED", bad)
"""


_DRIVER_SCRIPT = """
import os
import sys
import tempfile
import numpy as np
import chip_smoke
from homan_tpu_torch.cli import fit_video

with tempfile.TemporaryDirectory() as root:
    chip_smoke.write_ho3d_tree(root, frames=4, obj_subdiv=1)
    os.chdir(root)
    out = fit_video.main(fit_video.get_args([
        "--gt_masks", "1", "--frame_nb", "2", "--chunk_step", "1",
        "--num_initializations", "4", "--num_obj_iterations", "1",
        "--num_joint_iterations", "2", "--rend_size", "64",
        "--result_root", "res"]), device="cpu")
    assert os.path.exists("res/samples/00000000/joint_fit.npz")
    assert np.isfinite(out[0]["final_loss"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "homan_tpu"))
print("LOADED", bad)
"""


_CACHED_DRIVER_SCRIPT = """
import importlib.util
import os
import sys
import tempfile


class Blocked:
    # The card's machine has neither PIL nor pandas: the cached-evidence
    # path must not need them. Found, so a lookup succeeds; an import
    # raises, as a missing package does.
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "pandas"):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        raise ImportError(f"{spec.name} is not installed")

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
import chip_smoke
from homan_tpu_torch.cli import (convert_reference, fit_video,
                                 track_dataset)
from homan_tpu_torch.data import core50, epic, factory, hoa
from homan_tpu_torch.frontend import adapters, assign, cachedfit
from homan_tpu_torch.tracking import kalman, sequences

torch.set_num_threads(2)  # the suite's workers share the cores
with tempfile.TemporaryDirectory() as root:
    chip_smoke.write_ho3d_tree(root, frames=4, obj_subdiv=1)
    os.chdir(root)
    clip = ["--frame_nb", "2", "--chunk_step", "1"]
    chip_smoke.write_evidence_tree("ev", clip, device="cpu")
    out = fit_video.main(fit_video.get_args(clip + [
        "--evidence_root", "ev", "--num_initializations", "4",
        "--num_obj_iterations", "1", "--num_joint_iterations", "2",
        "--rend_size", "64", "--result_root", "res"]), device="cpu")
    assert os.path.exists("res/samples/00000000/joint_fit.npz")
    assert set(out[0]["budgets"]) == {"stage_b", "stage_c"}
    assert np.isfinite(out[0]["final_loss"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "homan_tpu", "PIL",
                                    "pandas"))
print("LOADED", bad)
"""


_VIZ_SCRIPT = """
import importlib.util
import os
import sys
import tempfile


class Blocked:
    # Where the card's machine lacks cv2, PIL and matplotlib, the overlays
    # and the evaluation's videos are still written (PNG, APNG).
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "matplotlib", "pandas"):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        raise ImportError(f"{spec.name} is not installed")

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, Blocked())
import numpy as np
import torch
from homan_tpu_torch import native
from homan_tpu_torch.cli import eval_ho3d, process_meshes
from homan_tpu_torch.core.meshes import bumpy_potato
from homan_tpu_torch.eval import report
from homan_tpu_torch.interactions import intersect
from homan_tpu_torch.viz import extras, render_viz

torch.set_num_threads(2)
v, f = bumpy_potato(1, 0.08, seed=0)
v = v[None] + np.array([0, 0, 0.5], np.float32)
K = np.array([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]], np.float32)
frames = render_viz.render_scene([v], [f], ["gold"], K, image_size=64,
                                 device="cpu")
with tempfile.TemporaryDirectory() as root:
    out = render_viz.make_video(frames * 2, os.path.join(root, "a.webm"))
    assert out.endswith("a.apng") and len(render_viz.read_apng(out)) == 2
    grid = render_viz.save_image_grid({"r": frames},
                                      os.path.join(root, "g.png"))
    assert render_viz.read_apng(grid)[0].shape == (64, 64, 3)
assert native.edt2d_squared(np.eye(3)).shape == (3, 3)
tri = torch.from_numpy(v[0][f])
assert intersect.tri_tri_intersect(tri, tri + 0.01).any()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "homan_tpu", "cv2",
                                    "PIL", "matplotlib", "pandas"))
print("LOADED", bad)
"""


_PARALLEL_SCRIPT = """
import sys
import numpy as np
import torch
from homan_tpu_torch import entry, utils_profiling
from homan_tpu_torch.parallel import clips, frames, multihost

torch.set_num_threads(2)
entry.dryrun_multichip(2, device="cpu")
assert multihost.host_sample_indices(4) == [0, 1, 2, 3]
stats = utils_profiling.measure_duty_cycle(lambda: torch.ones(3) * 2)
assert "wall_s" in stats
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "homan_tpu"))
print("LOADED", bad)
"""


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_fit_runs_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _FIT_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_stage_b_runs_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _STAGE_B_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_driver_runs_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _DRIVER_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cached_driver_runs_without_jax_pil_or_pandas():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CACHED_DRIVER_SCRIPT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_viz_eval_native_run_without_jax_or_image_libraries():
    """The modules of the overlays, the evaluation, the report, the tritri
    collision and the host library import no jax; with cv2, PIL and
    matplotlib missing the writers still write files the user can open."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _VIZ_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_parallel_and_entry_run_without_jax_in_a_fresh_process():
    """parallel/ (batched clips, frame sharding, multihost), entry.py and
    the profiling helpers import no jax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PARALLEL_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """eval_ho3d.main and render_scene run on `cuda` unless given a device:
    without CUDA they raise instead of falling back to the CPU."""
    import argparse
    from homan_tpu_torch.cli import eval_ho3d
    from homan_tpu_torch.viz import render_viz
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(results_root=str(tmp_path), split="test",
                              frame_nb=10, box_mode="gt", chunk_step=1,
                              mano_root=str(tmp_path), dump_codalab=False,
                              report=False, render_videos=False,
                              display_freq=1000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_ho3d.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_viz.render_scene([np.zeros((1, 3, 3), np.float32)],
                                [np.array([[0, 1, 2]])], ["gold"],
                                np.eye(3, dtype=np.float32)[None])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_ho3d.evaluate_results(str(tmp_path), None, None)


def test_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|homan_tpu)(\s|\.|,|$)"
        r"|\bhoman_tpu\.|import_module\(\s*['\"](jax|homan_tpu)\b",
        re.MULTILINE)
    checked = 0
    for path in _sources():
        with open(path) as fh:
            text = fh.read()
        hits = [m.group(0) for m in pattern.finditer(text)]
        assert not hits, (path, hits)
        checked += 1
    assert checked > 10


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from homan_tpu_torch import resolve_device
    from homan_tpu_torch.core.mano import ManoLayer
    from homan_tpu_torch.fit.joint import optimize_hand_object
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene

    if not torch.cuda.is_available():  # as this machine is: no patching
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_synthetic_scene(np.eye(3), frame_nb=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ManoLayer.synthetic(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthetic_scene(np.eye(3), frame_nb=2)
    scene = make_synthetic_scene(np.eye(3), frame_nb=2, image_size=64,
                                 rend_size=32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_hand_object(scene.init_state, scene.consts, scene.cfg,
                             num_iterations=1)
    from homan_tpu_torch.fit.poseinit import find_optimal_poses
    from homan_tpu_torch.frontend.gtevidence import render_full_mask
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_full_mask(np.zeros((1, 3, 3)), np.array([[0, 1, 2]]),
                         np.eye(3)[None], 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        find_optimal_poses(np.zeros((3, 3)), np.array([[0, 1, 2]]), [],
                           [], (64, 64))
    assert resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    import homan_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_every_kernel_source_is_built():
    """Every csrc/ of the package is built; each kernel's library is keyed
    by its own source."""
    from homan_tpu_torch import _build
    assert _build.sources() == ["depth", "prep", "shade", "voxelize"]
    paths = {name: _build._lib_path(name) for name in _build.sources()}
    assert len(set(paths.values())) == 4
    assert all(os.path.basename(p).startswith(n + "-")
               for n, p in paths.items())
