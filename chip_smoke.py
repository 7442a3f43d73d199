#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. set-up: card, power limit, versions; TF32 off; build every CUDA kernel
     from homan_tpu_torch/render/csrc (nvcc, sm_90a).
  2. kernels vs plain versions on the card, on the packs the port's prep
     builds at the headline fit's shape (30 frames, 256^2, tile 128; Ke 48
     and the Ke the fit runs, sized from the measured contour-edge demand
     as the JAX package's auto_edge_settings does) and at the evidence
     renders' (tile 16): values, argmin agreement, forward-only mode,
     gradients; CUDA-event medians of both.
  3. the slice: the synthetic 30-frame scene and the 400-step stage-C fit,
     twice, with the launch counts of each kernel read around the second
     run; losses finite and falling, no edge-budget overflow; a 10-step
     torch.profiler window; then a small fit run on the card and on the
     CPU from the same inputs must agree.
The last lines are the card, a JSON line of per-kernel numbers and
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
CUDA is absent or any phase fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

FRAMES, ITERS, REND, TILE, KE = 30, 400, 256, 128, 48
# Edge-slot buckets and headroom of the JAX package's auto_edge_settings
# (homan_tpu/render/rasterizer.py:949,952).
EDGE_BUCKETS = (48, 64, 96, 128, 192, 256, 384, 512)
EDGE_SAFETY = 1.3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def random_rotation(seed):
    """Uniform rotation from a normalized Gaussian quaternion (numpy)."""
    q = np.random.RandomState(seed).randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def time_ms(torch, fn, reps=25, warmup=3):
    """Median CUDA-event time of fn over `reps` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bounds(seg_pack, static):
    """Least times (ms) of the forward and backward on these inputs.

    Forward: bytes = seg_pack + anchors read, sil/amin/rx/ry/tc written;
    operations = FWD_OPS_PER_PIXEL_SLOT per pixel and VALID slot of its
    tile (the kernel loops k < n_e). Backward: bytes = five residuals and
    the cotangent read, gseg written; operations per pixel.
    """
    from homan_tpu_torch.render import shade
    B, T = seg_pack.shape[:2]
    px = B * T * static.tile_px ** 2
    seg_bytes = seg_pack.numel() * 4
    slot_px = float(seg_pack[:, :, 5].sum()) * static.tile_px ** 2
    share = slot_px / (px * static.ke)
    fwd_bytes = seg_bytes + px * 4 + px * 20
    fwd_ops = shade.FWD_OPS_PER_PIXEL_SLOT * slot_px
    bwd_bytes = px * 24 + seg_bytes
    bwd_ops = shade.BWD_OPS_PER_PIXEL * px
    return (_bound(fwd_bytes, fwd_ops), _bound(bwd_bytes, bwd_ops), share)


def _bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def compare_kernels(torch, name, seg_pack, anchors, static, timed):
    """Kernel pair vs plain versions on one pack; returns the numbers."""
    from homan_tpu_torch.render import shade
    seg_pack = seg_pack.detach().contiguous()
    anchors = anchors.contiguous()
    k_out = shade.shade_fwd(seg_pack, anchors, static, want_residuals=True)
    k_only = shade.shade_fwd(seg_pack, anchors, static,
                             want_residuals=False)[0]
    p_out = shade.shade_fwd_plain(seg_pack, anchors, static, True)
    torch.cuda.synchronize()
    sil_err = float((k_out[0] - p_out[0]).abs().max())
    check(sil_err <= 2e-5, f"{name}: sil max err {sil_err} > 2e-5")
    check(torch.equal(k_only, k_out[0]),
          f"{name}: forward-only sil differs from the residual run's")
    same = k_out[1] == p_out[1]
    agree = float(same.float().mean())
    check(agree >= 0.999, f"{name}: argmin agrees on {agree:.6f} < 0.999")
    d2_k = k_out[2] ** 2 + k_out[3] ** 2
    d2_p = p_out[2] ** 2 + p_out[3] ** 2
    tie_err = float((d2_k - d2_p).abs()[~same].max()) if agree < 1 else 0.0
    check(tie_err <= 1e-7, f"{name}: argmin ties differ by {tie_err}")
    res_err = max(float((a - b).abs()[same].max())
                  for a, b in zip(k_out[2:], p_out[2:]))
    check(res_err <= 1e-6, f"{name}: rx/ry/tc max err {res_err} > 1e-6")

    gen = torch.Generator(device=seg_pack.device).manual_seed(0)
    gcot = torch.randn(k_out[0].shape, generator=gen,
                       device=seg_pack.device)
    g_k = shade.shade_bwd(k_out, gcot, static)
    g_p = shade.shade_bwd_plain(p_out, gcot, static)
    torch.cuda.synchronize()
    g_err = float((g_k - g_p).abs().max())
    g_scale = float(g_p.abs().max())
    check(g_scale > 0, f"{name}: plain gradient is all zero")
    check(g_err <= 3e-3 * g_scale,
          f"{name}: gseg err {g_err} > 3e-3 of max {g_scale}")
    check(torch.equal(g_k, shade.shade_bwd(k_out, gcot, static)),
          f"{name}: backward kernel is not deterministic")
    (fb, fby), (bb, bby), fill = bounds(seg_pack, static)
    out = {"sil_err": sil_err, "argmin_agree": agree, "res_err": res_err,
           "gseg_err": g_err, "gseg_max": g_scale, "fwd_bound_ms": fb,
           "fwd_bound_by": fby, "bwd_bound_ms": bb, "bwd_bound_by": bby,
           "valid_slot_share": fill}
    if timed:
        out["fwd_ms"] = time_ms(torch, lambda: shade.shade_fwd(
            seg_pack, anchors, static, True))
        out["fwd_only_ms"] = time_ms(torch, lambda: shade.shade_fwd(
            seg_pack, anchors, static, False))
        out["fwd_plain_ms"] = time_ms(torch, lambda: shade.shade_fwd_plain(
            seg_pack, anchors, static, True), reps=20)
        out["bwd_ms"] = time_ms(torch, lambda: shade.shade_bwd(
            k_out, gcot, static))
        out["bwd_plain_ms"] = time_ms(torch, lambda: shade.shade_bwd_plain(
            p_out, gcot, static), reps=20)
    print(f"kernel check [{name}] B,T,tp,ke={tuple(seg_pack.shape[:2])},"
          f"{static.tile_px},{static.ke}: " + json.dumps(out), flush=True)
    return out


def run_fit(torch, joint, scene, settings, iters, device):
    from homan_tpu_torch.render import shade
    shade.shade_fwd_launches = 0
    shade.shade_bwd_launches = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = joint.optimize_hand_object(
        scene.init_state, scene.consts, scene.cfg, num_iterations=iters,
        roi_settings=settings, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (shade.shade_fwd_launches, shade.shade_bwd_launches)
    return final, {k: v.cpu() for k, v in hist.items()}, wall, launches


def profile_steps(torch, joint, scene, settings, iters):
    """torch.profiler over `iters` fit steps: wall and device-busy time per
    step, kernel launches per step, and the top device kernels."""
    from torch.profiler import ProfilerActivity, profile
    cuda_t = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        joint.optimize_hand_object(scene.init_state, scene.consts, scene.cfg,
                                   num_iterations=iters,
                                   roi_settings=settings, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda_t
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("cudaLaunchKernel"))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {"steps": iters, "wall_ms_per_step": wall / iters * 1e3,
           "device_busy_ms_per_step": busy_us / iters / 1e3,
           "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
           "launch_calls_per_step": launches / iters,
           "top_kernels_us_per_step": [
               [e.key[:60], e.self_device_time_total / iters] for e in top]}
    print("profile (torch.profiler on, adds host time): "
          + json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    import homan_tpu_torch
    from homan_tpu_torch import _build
    from homan_tpu_torch.core.meshes import bumpy_potato
    from homan_tpu_torch.fit import joint
    from homan_tpu_torch.fit import model as M
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
    from homan_tpu_torch.render import rasterizer as R

    # 1. Set-up -------------------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    homan_tpu_torch.set_precision()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas [{name}]: {line.strip()}", flush=True)

    # 2. Kernels vs plain versions --------------------------------------------
    t0 = time.perf_counter()
    scene = make_synthetic_scene(
        random_rotation(0), seed=0, frame_nb=FRAMES, image_size=2 * REND,
        rend_size=REND, obj_mesh=bumpy_potato(3, 0.08, seed=0),
        device="cuda")
    torch.cuda.synchronize()
    print(f"scene: {FRAMES} frames, {REND}^2 evidence in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with torch.no_grad():
        v_obj, _ = M.get_verts_object(scene.init_state, scene.consts)
        v_hand, _ = M.get_verts_hand(scene.init_state, scene.consts,
                                     scene.cfg)
    c = scene.consts
    headline = R.RasterSettings(REND, tile_px=TILE, edges_per_tile=KE)
    # The headline's 48 slots per tile are too few for this scene (the
    # JAX package's own scene has the same demand): size the fit's slots
    # as auto_edge_settings does, from the demand at the initial poses.
    demand = R.check_edge_budget(v_obj, c.faces_object,
                                 c.camintr_rois_object, headline)
    need = int(np.ceil(demand["max_demand"] * EDGE_SAFETY))
    ke_fit = min(b for b in EDGE_BUCKETS if b >= need)
    fit_settings = R.RasterSettings(REND, tile_px=TILE, edges_per_tile=ke_fit)
    print(f"edge budget: demand {demand['max_demand']} at the initial poses "
          f"(Ke {KE} overflows: {demand['overflow']}); the fit runs Ke "
          f"{ke_fit}", flush=True)
    packs = {
        "fit": (v_obj, c.faces_object, c.camintr_rois_object, fit_settings),
        "headline-ke48": (v_obj, c.faces_object, c.camintr_rois_object,
                          headline),
        "evidence-object": (scene.gt_verts_object, c.faces_object,
                            c.camintr_rois_object, scene.roi_settings),
        "evidence-hand": (v_hand, c.faces_hand, c.camintr_rois_hand,
                          R.RasterSettings(REND, tile_px=16)),
    }
    results = {}
    for name, (verts, topo, K, st) in packs.items():
        with torch.no_grad():
            seg, anc, _, static = R.shade_prep(verts, topo, K, st)
        results[name] = compare_kernels(torch, name, seg, anc, static,
                                        timed=True)

    # 3. The slice: stage-C fit at the headline shape ---------------------------
    runs = []
    for i in range(2):
        final, hist, wall, launches = run_fit(torch, joint, scene,
                                              fit_settings, ITERS, "cuda")
        runs.append((wall, launches))
        print(f"fit run {i + 1}: {ITERS} steps in {wall:.3f} s "
              f"({wall / ITERS * 1e3:.3f} ms/step); launches shade_fwd="
              f"{launches[0]} shade_bwd={launches[1]}", flush=True)
        loss = hist["loss"]
        check(all(bool(torch.isfinite(v).all()) for v in hist.values()),
              "non-finite loss or metric")
        check(float(loss[-1]) < float(loss[0]),
              f"loss did not fall: {float(loss[0])} -> {float(loss[-1])}")
        check(float(hist["edge_budget_excess"].max()) <= 0,
              "edge budget overflowed during the fit")
        check(launches[0] >= ITERS and launches[1] == ITERS,
              f"kernels not launched on every step: {launches}")
    print(f"fit: loss {float(loss[0]):.6f} -> {float(loss[-1]):.6f}; "
          f"iou_object {float(hist['iou_object'][0]):.4f} -> "
          f"{float(hist['iou_object'][-1]):.4f}; edge_budget_excess max "
          f"{float(hist['edge_budget_excess'].max()):.0f}", flush=True)
    check(float(hist["iou_object"][-1]) > float(hist["iou_object"][0]),
          "object IoU did not improve")
    fit_launches = runs[1][1]
    step = profile_steps(torch, joint, scene, fit_settings, 10)

    # Kernel path vs plain path: one small scene, fit on the card and on
    # the CPU from the same inputs (the CPU runs the plain versions).
    small = make_synthetic_scene(random_rotation(1), seed=1, frame_nb=3,
                                 image_size=128, rend_size=64, device="cpu")
    small_set = R.RasterSettings(64, tile_px=32, edges_per_tile=48)
    _, h_gpu, _, l_gpu = run_fit(torch, joint, small, small_set, 10, "cuda")
    _, h_cpu, _, l_cpu = run_fit(torch, joint, small, small_set, 10, "cpu")
    check(l_gpu == (10, 10) and l_cpu == (0, 0),
          f"small fit launches gpu={l_gpu} cpu={l_cpu}")
    rel = float(((h_gpu["loss"] - h_cpu["loss"]).abs()
                 / h_cpu["loss"].abs()).max())
    print(f"small fit, card vs CPU plain path: 10-step loss max rel err "
          f"{rel:.3g}", flush=True)
    check(rel <= 3e-3, f"card and CPU fits disagree: rel err {rel}")

    # Result lines ------------------------------------------------------------
    h = results["fit"]
    kernels = [
        {"name": "shade_fwd", "route": "cuda",
         "source": "homan_tpu_torch/render/csrc/shade.cu",
         "replaces": "homan_tpu/render/pallas_shade.py:86",
         "launches": fit_launches[0], "max_abs_err": h["sil_err"],
         "ms": h["fwd_ms"], "plain_ms": h["fwd_plain_ms"],
         "bound_ms": h["fwd_bound_ms"], "bound_by": h["fwd_bound_by"],
         "library_ms": None},
        {"name": "shade_bwd", "route": "cuda",
         "source": "homan_tpu_torch/render/csrc/shade.cu",
         "replaces": "homan_tpu/render/pallas_shade.py:281",
         "launches": fit_launches[1], "max_abs_err": h["gseg_err"],
         "ms": h["bwd_ms"], "plain_ms": h["bwd_plain_ms"],
         "bound_ms": h["bwd_bound_ms"], "bound_by": h["bwd_bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"fit": {
        "frames": FRAMES, "iters": ITERS, "rend": REND, "tile": TILE,
        "ke": ke_fit, "first_wall_s": runs[0][0],
        "second_wall_s": runs[1][0], "ms_per_step": runs[1][0] / ITERS * 1e3,
        "profiled": step}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
