#!/usr/bin/env python
"""The fit_video driver's metrics on the CPU, the PyTorch port's against the
JAX package's, on chip_smoke.py's synthetic HO-3D clip at the driver's own
schedule (10 frames, 50 stage-B and 201 joint steps, rend_size 256) with
fewer stage-B candidates.

Both drivers take the same candidate rotations (the JAX package's draw) and
the same instance-render face budget (the demand the port measures at tile
64; the JAX default of 256 faces a tile drops faces at this clip). For
each driver the script prints the clip's mean metrics before and after
the joint fit and the loss terms at the first and last joint step; it also
prints the clip's ground-truth contact (penetration depth of the GT hand
into the GT object, and hand-to-object distances), and for every metric
whether both drivers move it the same way.

Usage (about 20 minutes on 4 CPU threads):
  JAX_PLATFORMS=cpu python scripts/driver_metrics_cpu.py [--inits 48]
      [--workdir DIR]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("add-s_obj", "chamfer_dists_obj", "verts_dists_hand",
           "pen_depths")


def summary(folder, wall):
    with open(os.path.join(folder, "samples", "00000000", "results.pkl"),
              "rb") as f:
        res = pickle.load(f)
    out = {"wall_s": wall}
    for k in METRICS:
        for key in (k + "_init", k):
            out[key] = float(np.mean(np.asarray(res["metrics"][key],
                                                np.float64)))
    out["losses_first_last"] = {
        k: [float(np.asarray(v, np.float64)[0]),
            float(np.asarray(v, np.float64)[-1])]
        for k, v in res["losses"].items()}
    return out


def gt_contact(tree, frame_nb, chunk_step):
    """Per frame of sample 0: the GT hand's largest penetration into the GT
    object (the port's interaction metric), the least hand-vertex to
    object-vertex distance, and the share of hand vertices within 1 cm."""
    import torch

    from homan_tpu_torch.data.ho3d import HO3D
    from homan_tpu_torch.eval.pointmetrics import get_inter_metrics
    cwd = os.getcwd()
    os.chdir(tree)
    try:
        ds = HO3D(frame_nb=frame_nb, chunk_step=chunk_step, device="cpu",
                  cache_folder=os.path.join(tree, "gt_cache"))
        a = ds[0]
    finally:
        os.chdir(cwd)
    hv = torch.as_tensor(np.asarray(a["hands"][0]["verts3d"], np.float32))
    ov = torch.as_tensor(np.asarray(a["objects"][0]["verts3d"], np.float32))
    m = get_inter_metrics(hv, ov, ds.mano.faces("right").numpy(),
                          np.asarray(a["objects"][0]["faces"][0]))
    d = torch.cdist(hv, ov).amin(-1)
    return {"pen_depth_m": [float(x) for x in m["pen_depths"]],
            "has_contact": m["has_contact"],
            "min_dist_m": [float(x) for x in d.amin(-1)],
            "share_within_1cm": [float(x) for x in (d < 0.01).float()
                                 .mean(-1)]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--inits", type=int, default=48)
    parser.add_argument("--workdir", default=os.path.join(
        ROOT, "data", "cache", "driver_metrics_cpu"))
    parser.add_argument("--threads", type=int, default=4)
    opts = parser.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(opts.threads)

    import chip_smoke
    from homan_tpu.core import geometry as jgeo
    work = os.path.abspath(opts.workdir)
    tree = os.path.join(work, "tree")
    if not os.path.exists(tree):
        chip_smoke.write_ho3d_tree(tree, frames=40)
    argv = ["--gt_masks", "1", "--chunk_step", "4", "--num_initializations",
            str(opts.inits), "--prewarm", "0", "--viz_step", "0"]
    print(json.dumps({"gt_contact": gt_contact(tree, 10, 4)}), flush=True)
    rots = np.array(jgeo.random_rotations(jax.random.PRNGKey(0),
                                          opts.inits))

    # The port, from the tree, its rotations the JAX package's draw.
    from homan_tpu_torch.cli import fit_video as TF
    from homan_tpu_torch.core import geometry as tgeo
    tgeo.random_rotations = (
        lambda n, generator=None, upright=False, device=None:
        torch.from_numpy(rots[:n]).to(device))
    os.chdir(tree)
    t0 = time.perf_counter()
    port = TF.main(TF.get_args(argv + ["--result_root",
                                       os.path.join(work, "port")]),
                   device="cpu")
    out = {"port": summary(os.path.join(work, "port"),
                           time.perf_counter() - t0)}
    out["port"]["budgets"] = port[0]["budgets"]
    print(json.dumps({"port": out["port"]}, default=str), flush=True)

    # The JAX driver, from a sibling folder linking the tree's data (its
    # own frame-index cache), the instance render at the port's demand.
    os.environ["HOMAN_TPU_DISABLE_PREWARM"] = "1"
    from homan_tpu.cli import fit_video as JF
    from homan_tpu.frontend import gtevidence as jgt
    from homan_tpu.render import rasterizer as jr
    from homan_tpu.viz import render_viz
    kf = port[0]["budgets"]["instance_masks"]["face_demand"][64]
    jgt.RasterSettings = functools.partial(jr.RasterSettings,
                                           faces_per_tile=kf)

    def no_viz(*a, **k):
        raise RuntimeError("overlays are not compared")

    render_viz.visualize_hand_object = no_viz
    jcwd = os.path.join(work, "jax_cwd")
    os.makedirs(jcwd, exist_ok=True)
    for name in ("local_data", "extra_data"):
        if not os.path.exists(os.path.join(jcwd, name)):
            os.symlink(os.path.join(tree, name), os.path.join(jcwd, name))
    os.chdir(jcwd)
    t0 = time.perf_counter()
    JF.main(JF.get_args(argv + ["--result_root", os.path.join(work, "jax")]))
    out["jax"] = summary(os.path.join(work, "jax"), time.perf_counter() - t0)
    print(json.dumps({"jax": out["jax"]}), flush=True)

    same = {k: bool(np.sign(out["port"][k] - out["port"][k + "_init"])
                    == np.sign(out["jax"][k] - out["jax"][k + "_init"]))
            for k in METRICS}
    print(json.dumps({"same_direction": same}), flush=True)


if __name__ == "__main__":
    main()
