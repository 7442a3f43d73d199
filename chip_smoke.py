#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab voxelize=OTHER.cu --ab shade_fwd=OTHER.cu \
        --ab shade_bwd=OTHER.cu --ab depth=OTHER.cu

Phases, each fatal on failure:
  1. set-up: card, power limit, versions; TF32 off; build every CUDA kernel
     from the package's csrc/ directories (nvcc, sm_90a, one process per
     source, all at once), printing ptxas' registers and spills.
  2. kernels vs plain versions on the card, at the shapes the paths give
     them, each timed two ways: `ms`, the CUDA-event median of runs of 10
     calls of the wrapper back to back (the wrapper's host work overlaps
     the device's, and a kernel shorter than that work reads the host's
     rate), and `device_ms`, the call's time on the device alone with a
     cold L2: CUDA events around each of 30 calls, each queued behind an
     L2 flush and a spin so the host is ahead, the median (see device_ms):
     - the shade pair on the packs the port's prep builds at the headline
       fit's shape (30 frames, 256^2, tile 128; Ke 48 and the Ke the fit
       runs, sized from the measured contour-edge demand as the JAX
       package's auto_edge_settings does) and at the evidence renders'
       (tile 16): bit-equality with the plain forward, the bands (sil
       2e-5, argmin >= 0.999, ties 1e-7, residuals 1e-6), forward-only
       mode, gradients; the bound counts the work the kernel does on
       these inputs (shade.fwd_work); the backward also on adversarial
       residuals from a numpy seed (no pixel, one slot, pixel index mod
       Ke, only slot Ke - 1; Ke 48 to 3000, tiles 24 to 200), within 3e-3
       of the plain version's maximum and deterministic; its scratch
       bytes, read from the list counts its kernel wrote; its library
       yardsticks, never called by the port: the contributions (the plain
       elementwise pass), then one `index_add_` of the picked pixels'
       contributions (selected before the timed call) into (B T Ke, 4)
       buckets keyed by the argmin slot (float atomics: not
       deterministic), and one `torch.einsum` of a one-hot (P, Ke)
       selection against the (P, 4) contributions per tile (the JAX
       package's formulation, cuBLAS);
     - the depth pair on the object's and the hand's face packs at the
       depth fit's shape (10 frames, 512^2, tile 64) at the face budget
       sized from the measured demand and at the default 256: depth and
       amax bit-equal to the plain version, gpack within 3e-3 of its max,
       deterministic, zero outside rows 9-11; the bound counts the work
       the kernel's exact cull leaves (depth.fwd_work), the dense count
       beside it, and the evaluated share of the (pixel, valid slot) pairs;
       the backward's library yardstick, one `index_add_` of the covered
       pixels' contributions, as for the shade backward;
     - the voxelizer on the interaction fit's hand and object at G 16, 32
       and 64: within 1e-5, inside sets identical, deterministic; the
       inside share, the bound of the work these inputs need (crossing
       test per column, distance per inside point) and the dense sweep's
       bound `dense_bound_ms` beside it; then at the JAX launcher's larger
       grids: G 128 on frame 0's hand (1,552 faces) and object (1,280),
       G 256 on bumpy_potato(1, 0.07) (80 faces), against the plain
       version by the same checks, and G 512 and 1,024 on box_mesh()
       shifted a fraction of a cell (BOX_SHIFT) against the box's analytic
       interior distance: the same inside set, phi within 1e-5,
       deterministic (the kernels line's voxelize `grids` keys);
     - the raster prep kernel (render/csrc/prep.cu) at the benchmark
       cells' shape (PREP_FRAMES frames of the headline clip's object,
       256^2, tile 64, Ke 96): shade_prep's seg_pack, anchors and e_demand
       and the launch's idx, hit and slot_of equal to the plain prep's
       (`_shade_prep_plain`, its binning) on the same card tensors by
       torch.equal, one launch a prep; `ms` and `device_ms` the launch
       alone, `prep_ms` and `prep_device_ms` the card path's whole forward,
       `plain_ms` the plain prep's forward; the bound counts the bytes the
       launch writes and reads (its arithmetic is ~100 times below).
     --ab NAME=PATH builds another source of a kernel with the same C
     interface (the parent commit's, a design variant), checks its output
     against the package's (depth: depth, amax and gpack bit-equal, on the
     depth fit's object and hand packs; shade_bwd: gseg within 3e-3 of the
     plain version's maximum, on the headline fit's pack and the hand's
     evidence pack, the variant given the scratch its layout needs) and
     times the two in turns (package, other, other, package), by `ms` and
     by `device_ms`, with each call's kernels split by one torch.profiler
     window, then stops before phase 3.
  3. the paths, each run twice with every launch count set to 0 just
     before a run and read just after (in every path the prep kernel once
     for each shade forward: rasterize_soft preps every render); losses
     finite and falling, no
     edge-budget overflow, a 10-step torch.profiler window each:
     - the stage-C headline: the 30-frame, 400-step fit;
     - the interaction fit (bench.py bench_config3, grid SDF, collision
       1e-3 and contact 1): 10 frames, 400 steps, two voxelizer launches
       per step;
     - the ordinal-depth fit (bench.py bench_depth, lw_depth 1): 10
       frames, 100 steps, object and hand rendered at 512^2 every step,
       no face-budget overflow at the initial or the final poses;
     then small fits of each path on the card and on the CPU (plain
     versions) from the same inputs must agree.
  4. stage B, the object-pose search (bench.py bench_stageb): the clip
     built by the port (10 frames, 512^2 masks from render_full_mask,
     evidence at 256^2); the contour-edge demand of frame 0's 500 initial
     candidates at the refinement's 128^2 and the rescore's 256^2 (tile
     128) sizes Ke (x1.3, next bucket; the bench's 64 drops edges); the
     search at full width (500 candidates, 35 coarse and 50 refinement
     steps, chunks of 125) twice, counts set to 0 just before each run and
     read just after, which must equal the path's own count (shade_fwd
     with residuals 640, forward-only 24, shade_bwd 640), best IoU >= 0.9;
     the demand of every frame's final candidates at both sizes within
     Ke; one parallel_frames search; the shade pair held and timed at
     stage B's packs (coarse B 125 and B 500, refinement B 125, at 128^2;
     the rescore's B 125 at 256^2, forward-only); a 10-step profiler window
     of frame 0's refinement; a small search (3 frames, 24 candidates, 5
     steps, 64^2) on the card and on the CPU from the same injected
     rotations: poses within 2e-3, best IoU within 1e-3.
  5. the fit_video driver (homan_tpu_torch/cli/fit_video.py), --gt_masks 1
     at get_args' defaults (10 frames, 500 candidates, 50 stage-B and 201
     joint steps, rend_size 256) on a synthetic HO-3D tree written to a
     temporary directory (40 frames, HO-3D's camera, the synthetic MANO
     hand as a MANO pickle, a turning bumpy_potato(3, 0.08)), twice, counts
     set to 0 just before each run and read just after, which must equal
     the path's count (driver_launches: every stage-B search, 201 shade
     steps per stage-C fit of the retry ladder, two voxelizer launches of
     the interaction metrics); per run the wall per clip and each stage
     timer; gates: the three files, a finite falling loss, no edge excess
     on the kept fit, the instance render's Kf covering the face demand
     re-measured on the clip, stage B's demand within its Ke and best IoU
     >= 0.9, every metric finite; the overlays (the driver's default
     --viz_step 20): final_points.png, final_points.<webm|apng> (5 frames,
     256 x 512) and optim_evolution.<webm|apng> (the initial frame, 10
     snapshots, the final frame, 256^2) decode to those frames in the
     format the card's libraries give, the driver logs neither
     "visualization failed" nor "viz_step render failed", every overlay
     render's Kf covers its face demand (the JAX budget min(2048, F + 64)
     at tile 64 beside it), the viz_step_snapshots and viz_final timers
     are reported; the hand and object pixels of the
     instance render that the JAX default budget (256 faces a 64-pixel
     tile) would get wrong, counted; then a 3-frame clip (24 candidates, 5
     and 5 steps, 64^2) on the card and on the CPU: joint states within
     3e-3 of each array's maximum, instance-mask pixels that differ
     counted (at most 0.1% of the mask pixels).
  6. the driver on cached detections, --evidence_root at get_args' defaults
     on the same synthetic clip: one CachedEvidence record a frame written
     by the port's adapters (write_evidence_tree: the instance render's
     masks cut to HO-3D's 480 x 640 frame, FrankMocap-layout hand estimates
     with 2 px of seeded noise on the 2D points); twice, counts set to 0
     just before each run and read just after, which must equal the path's
     count (driver_launches); a third run in one torch.profiler window for
     the device's busy and idle share; gates as phase 5's (no instance
     render here); the shade pair and the voxelizer held against their
     plain versions and timed at every input shape the second run handed
     them (the kernels line's `cached` keys); a 3-frame clip (24
     candidates, 5 and 5 steps, 64^2) on the card and on the CPU from one
     evidence tree: joint states within 3e-3 of each array's maximum.
  7. the HO-3D evaluation (cli/eval_ho3d.py main, --dump_codalab --report
     --render_videos) of phase 5's second run on the tree phase 5 fitted
     (40 full-rate frames: one metric batch), counts set to 0 just before
     and read just after (one voxelizer launch a batch of up to 64 frames,
     nothing else); every summary metric finite, pred.json one entry per
     full-rate frame, the HTML, the turntable (12 frames) and the clip
     video (40 frames, 128^2) decode; its wall; the voxelizer held against
     its plain version and timed at every batch shape it was handed (the
     kernels line's `eval` keys).
  8. the tritri fit: bench_config3's scene (10 frames, 400 steps, 256^2,
     collision 1e-3 and contact 1, grid SDF) with collision_mode "tritri",
     twice, counts set to 0 just before each run and read just after
     (tritri_launches: the voxelizer twice a step for the contact term's
     grids, one shade pair a step); loss finite and falling, no edge
     overflow; a 10-step profiler window (device busy ms a step, idle
     share) and one of the tritri term alone, its share of the step's
     device time; a small tritri fit (3 frames, 3 steps, 64^2) on the card
     and on the CPU: losses and final states within 3e-3.
  9. parallel/ (launch overhead, not card capacity, sets these times):
     the batched clip fit (parallel/clips.py) at bench.py bench_multiclip's
     full preset, 4 clips x 10 frames x 400 steps at 256^2, tile 128, Ke
     sized from the demand, twice with counts set to 0 just before each
     run and read just after (the shade pair 400 times a fit, not 1,600),
     every clip's loss finite and falling, no edge excess, a 10-step
     profiler window beside the headline's launch calls; each clip after
     50 steps within 3e-3 of its own single-clip card fit, the walls per
     clip side by side; two objects padded by pad_mesh into one batch (5
     steps), and the shade pair's silhouette and the voxelizer's phi on
     a padded mesh against the unpadded (1e-5, 1e-6); fit_frames_sharded
     over 2 entries of the card (8 frames, two hands, 50 steps, 256^2)
     within 3e-3 of the unsharded fit; the driver with --frames_sharded 1
     on phase 5's small clip (run there): the warning, and the joint state
     of the run without the flag within 3e-3; multihost in two processes
     over gloo; entry.dryrun_multichip(4); then (g) the headline clip (30
     frames, 256^2, tile 128, Ke sized from the demand) with its frames
     over a mesh of two processes that share the card (gloo, one entry
     each, 15 frames a process, parallel/multihost.py's gather_frames and
     replicate), 50 steps, each worker fitting three times with counts
     set to 0 just before each run and read just after (the last run with
     host time taken around every collective); gates: the two ranks'
     final states and loss histories bit-equal, each within 3e-3 of the
     unsharded card fit at the same steps, shade_fwd and shade_bwd 50
     launches a run in each process, the shade pair at a worker's
     15-frame pack against its plain version (phase 2's checks), neither
     worker loading jax or homan_tpu; a worker's failure fails the phase
     and every process is stopped; printed: the wall per step of the
     sharded and the unsharded fit and the collectives' time per step.
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
# The interaction fit (bench.py bench_config3, grid SDF) and the
# ordinal-depth fit (bench.py bench_depth): 10 frames, 512^2 full image.
FRAMES2, ITERS2, ITERS3, GRID, DEPTH_TILE = 10, 400, 100, 32, 64
VOX_GRIDS = (16, 32, 64)  # the grid sizes of the fits' scene checks
LW_INTER = {"lw_collision": 1e-3, "lw_contact": 1.0}
LW_DEPTH = {"lw_depth": 1.0}
# Stage B (bench.py bench_stageb): 10 frames, 500 candidates, 50 steps a
# frame after 35 coarse ones, 125 candidates a chunk, 256^2 evidence at tile
# 128, refined at 128^2; the bench's edges_per_tile.
FRAMES_B, INITS_B, ITERS_B, COARSE_B, CHUNK_B, KE_BENCH_B = (
    10, 500, 50, 35, 125, 64)
# The raster prep kernel's check (phase 2) at the benchmark cells' shape
# (portbench: 96 clips x 10 frames of the 1,280-face object, 256^2, tile
# 64, Ke 96): the headline clip's 30 frames, 32 times over.
PREP_FRAMES, PREP_TILE, PREP_KE = 960, 64, 96
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


def time_ms(torch, fn, reps=25, warmup=3, inner=10):
    """Median CUDA-event time of one call of fn, over `reps` runs of
    `inner` calls back to back (so the host's launch work overlaps the
    device's; a plain version of many launches takes inner=1)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


_L2_FLUSH = []  # a buffer larger than the card's 50 MB L2


def flush_l2(torch):
    """Overwrite the L2 cache (one `bitwise_not_` kernel over 128 MB)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.zeros(128 << 20, dtype=torch.uint8,
                                     device="cuda"))
    _L2_FLUSH[0].bitwise_not_()


# Calls per device_ms, and the spin (GPU clock cycles, ~1 ms) that holds
# the stream after each flush, so the host has queued the whole call
# before the device reaches it.
DEVICE_CALLS, SPIN_CYCLES = 30, 2_000_000


def device_ms(torch, fn):
    """Device time of one call of fn with a cold L2 (flush_l2 before each
    call: inputs under 50 MB otherwise stay in L2 between calls back to
    back): CUDA events recorded just before and just after each call, the
    flush and a spin queued ahead of them; the median over DEVICE_CALLS
    calls. fn must not wait for the device (kernels_ms times one that
    does)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(DEVICE_CALLS):
        flush_l2(torch)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def kernels_ms(torch, fn):
    """The summed durations of fn's kernels (kernel_split_us), for a call
    that blocks the host (the plain shade contributions copy sigma to the
    card), where device_ms's events would also time the host's launches."""
    return sum(us * n for us, n in kernel_split_us(torch, fn).values()) / 1e3


def kernel_split_us(torch, fn):
    """{kernel name: (median us, runs per call)} of one call of fn, L2
    overwritten before each of DEVICE_CALLS calls, from one torch.profiler
    window (the profiler drops records at times: runs per call are
    rounded, and the median of the durations it kept stands)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile
    cuda_t = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DEVICE_CALLS):
            flush_l2(torch)
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(list)
    for e in prof.events():
        if (e.device_type == cuda_t and "bitwise_not" not in e.name
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name].append(e.time_range.elapsed_us())
    return {name[:60]: (statistics.median(us),
                        max(1, round(len(us) / DEVICE_CALLS)))
            for name, us in by_name.items()}


def bounds(seg_pack, anchors, static):
    """Least times (ms) of the forward and backward on these inputs.

    Forward: bytes = seg_pack + anchors read, sil/amin/rx/ry/tc written;
    operations = the kernel's work on these inputs, replayed by
    shade.fwd_work (records per (row, VALID slot), pass 1 per (pixel,
    VALID slot), skip tests per (pixel group, VALID slot), pass 2 where a
    group does not skip its slot). Backward: bytes = amin of every pixel
    and the other four residuals and the cotangent of the pixels that
    picked a slot (only they reach gseg) read, gseg written; operations
    per picked pixel. Its dense count beside it: all six arrays of every
    pixel read (the first design's bound). Last, the forward-only mode's:
    the forward's operations, sil alone written.
    """
    from homan_tpu_torch.render import shade
    B, T = seg_pack.shape[:2]
    px = B * T * static.tile_px ** 2
    seg_bytes = seg_pack.numel() * 4
    work = shade.fwd_work(seg_pack, anchors, static)
    share = work["row_slots"] / static.tile_px / (B * T * static.ke)
    evaluated = work["evaluated_group_slots"] / work["group_slots"]
    fwd_bytes = seg_bytes + px * 4 + px * 20
    fwd_ops = shade.fwd_work_ops(work)
    picked = int((shade.shade_fwd(seg_pack, anchors, static)[1] >= 0).sum())
    bwd = _bound(px * 4 + picked * 20 + seg_bytes,
                 shade.BWD_OPS_PER_PIXEL * picked)
    bwd_dense = _bound(px * 24 + seg_bytes, shade.BWD_OPS_PER_PIXEL * px)
    fwd_only = _bound(seg_bytes + px * 4 + px * 4, fwd_ops)
    return (_bound(fwd_bytes, fwd_ops), bwd, share, evaluated, bwd_dense,
            picked / px, fwd_only)


def _bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def shade_bwd_library(torch, res, gcot, static, g_p):
    """The shade backward's library yardsticks on these residuals, each
    checked against the plain version's gseg (3e-3 of its maximum) and
    timed by device_ms: the contributions (the plain elementwise pass, by
    kernels_ms), then one `index_add_` of the picked pixels' contributions into (B T Ke,
    4) buckets keyed by the argmin slot (float atomics: not deterministic;
    the picked pixels are selected outside the timed call, so no bucket of
    unpicked pixels serialises it), and one `torch.einsum` of a one-hot
    (P, Ke) selection against all contributions per tile (cuBLAS; the JAX
    package's own formulation)."""
    from homan_tpu_torch.render import shade
    sil, amin, rx, ry, tc = res
    B, T, ke, P = sil.shape[0], sil.shape[1], static.ke, sil[0, 0].numel()
    dev = sil.device

    def contrib():
        return shade._bwd_contrib(sil, rx, ry, tc, gcot, static.sigma)

    c = contrib().reshape(B * T, P, 4)
    am = amin.reshape(B * T, P).long()
    picked = am >= 0
    index = (torch.arange(B * T, device=dev)[:, None] * ke + am)[picked]
    flat = c[picked]
    acc = torch.zeros((B * T * ke, 4), device=dev)
    acc.index_add_(0, index, flat)
    onehot = (amin.reshape(B * T, P, 1)
              == torch.arange(ke, device=dev)).float()
    g_es = torch.einsum("npk,npc->nkc", onehot, c)
    scale = float(g_p.abs().max())
    for label, g in (("index_add_", acc.reshape(B, T, ke, 4)),
                     ("einsum", g_es.reshape(B, T, ke, 4))):
        err = float((g.permute(0, 1, 3, 2) - g_p[:, :, :4]).abs().max())
        check(err <= 3e-3 * scale, f"shade_bwd library {label}: err {err} "
              f"> 3e-3 of max {scale}")
    return {"library_contrib_ms": kernels_ms(torch, contrib),
            "library_index_add_ms": device_ms(
                torch, lambda: acc.index_add_(0, index, flat)),
            "library_einsum_ms": device_ms(
                torch, lambda: torch.einsum("npk,npc->nkc", onehot, c))}


def depth_bwd_library(torch, d, a, gcot, static, g_p):
    """The depth backward's library yardstick: the contributions (coef px,
    coef py, coef) and one `index_add_` of the covered pixels' into
    (B T Kf, 3) buckets keyed by the argmax slot (selected outside the
    timed call, as for the shade backward), checked against the plain
    version's rows 9-11 (3e-3 of their maximum) and timed by device_ms
    (the contributions by kernels_ms)."""
    from homan_tpu_torch.render import depth
    B, T, kf, P = d.shape[0], d.shape[1], static.kf, d[0, 0].numel()
    dev = d.device
    px, py, _ = depth._pixel_coords(static, T, dev)

    def contrib():
        coef = torch.where(d > 0.0, -gcot * d * d, torch.zeros((), device=dev))
        return torch.stack([coef * px, coef * py, coef], dim=-1)

    am = a.reshape(B * T, P).long()
    covered = am >= 0
    flat = contrib().reshape(B * T, P, 3)[covered]
    index = (torch.arange(B * T, device=dev)[:, None] * kf + am)[covered]
    acc = torch.zeros((B * T * kf, 3), device=dev)
    acc.index_add_(0, index, flat)
    g = acc.reshape(B, T, kf, 3).permute(0, 1, 3, 2)
    scale = float(g_p.abs().max())
    err = float((g - g_p[:, :, 9:12]).abs().max())
    check(err <= 3e-3 * scale, f"depth_bwd library index_add_: err {err} > "
          f"3e-3 of max {scale}")
    return {"library_contrib_ms": kernels_ms(torch, contrib),
            "library_index_add_ms": device_ms(
                torch, lambda: acc.index_add_(0, index, flat))}


def adversarial_residuals(torch, pattern, tp, ke, b=4, t=4, seed=0):
    """Shade residuals (sil, amin, rx, ry, tc) and a cotangent, (b, t, tp,
    tp), from a numpy seed, with the argmin slots of `pattern`: "none"
    (every pixel -1), "one" (slot ke // 3 everywhere), "mod" (pixel index
    mod Ke: every warp sees 32 distinct slots or more) or "last" (slot
    Ke - 1 on every other pixel)."""
    rng = np.random.RandomState(seed)
    shape = (b, t, tp, tp)
    idx = np.arange(tp * tp).reshape(tp, tp)
    amin = {"none": np.full(shape, -1), "one": np.full(shape, ke // 3),
            "mod": np.broadcast_to(idx % ke, shape),
            "last": np.broadcast_to(np.where(idx % 2 == 0, ke - 1, -1),
                                    shape)}[pattern]
    arrays = (rng.uniform(0, 1, shape), rng.randn(*shape) * 0.01,
              rng.randn(*shape) * 0.01, rng.uniform(0, 1, shape),
              rng.randn(*shape))
    f32 = [torch.from_numpy(x.astype(np.float32)).cuda() for x in arrays]
    amin = torch.from_numpy(np.ascontiguousarray(amin, np.int32)).cuda()
    res = (f32[0], amin, *f32[1:4])
    return res, f32[4]


def check_shade_bwd_adversarial(torch):
    """The shade backward on adversarial residuals against its plain
    version: within 3e-3 of the plain maximum, deterministic, rows 4-7
    zero. Returns the largest error relative to that maximum."""
    from homan_tpu_torch.render import shade
    worst = {}
    # Ke 3000 takes the finalize's second 2048-slot window.
    for tp, ke in ((128, 96), (128, 512), (128, 3000), (24, 48), (200, 96)):
        for pattern in ("none", "one", "mod", "last"):
            res, gcot = adversarial_residuals(torch, pattern, tp, ke)
            st = shade.ShadeStatic(tp, 2 * tp, 2, 1e-4, 0.01, ke)
            g_k = shade.shade_bwd(res, gcot, st)
            g_p = shade.shade_bwd_plain(res, gcot, st)
            torch.cuda.synchronize()
            label = f"{pattern}-tp{tp}-ke{ke}"
            err = float((g_k - g_p).abs().max())
            scale = float(g_p.abs().max())
            check((scale > 0) == (pattern != "none"),
                  f"adversarial {label}: plain maximum {scale}")
            check(err <= 3e-3 * scale,
                  f"adversarial {label}: gseg err {err} > 3e-3 of {scale}")
            check(torch.equal(g_k, shade.shade_bwd(res, gcot, st)),
                  f"adversarial {label}: backward is not deterministic")
            check(not bool(g_k[:, :, 4:].any()),
                  f"adversarial {label}: gseg rows 4-7 not zero")
            worst[label] = err / scale if scale else err
    print("shade_bwd adversarial residuals (err / plain max): "
          + json.dumps(worst), flush=True)
    return max(worst.values())


def shade_bwd_scratch_bytes(torch, res, gcot, static, g_ref):
    """The shade backward's scratch traffic, read from what its kernel
    wrote: one call through the C interface with lists the script holds,
    then each strip's count word; each list (a 4-byte count, 20 bytes per
    entry) is written once and read once per 2048-slot window of the
    finalize (csrc/shade.cu kWindow). None for a tile of one strip."""
    from homan_tpu_torch.render import shade
    B, T = res[0].shape[:2]
    n_strips = -(-static.tile_px ** 2 // shade.BWD_STRIP_PIXELS)
    if n_strips == 1:
        return 0
    lf = shade.bwd_list_floats(static.ke)
    lists = torch.full((B * T * n_strips, lf), -1, dtype=torch.int32,
                       device=res[0].device)
    gseg = torch.empty_like(g_ref)
    rc = shade._lib().shade_bwd(
        *(x.data_ptr() for x in res), gcot.data_ptr(), lists.data_ptr(),
        gseg.data_ptr(), B, T, static.tile_px, static.ke, n_strips,
        static.sigma, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"shade_bwd launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    check(torch.equal(gseg, g_ref), "shade_bwd with the script's lists "
          "differs from the wrapper's call")
    counts = lists[:, 0]
    check(bool(((counts >= 0) & (counts <= min(static.ke,
                                               shade.BWD_STRIP_PIXELS))).all()),
          "shade_bwd left a strip's count unwritten or out of range")
    windows = -(-static.ke // 2048)
    return (1 + windows) * (4 * counts.numel() + 20 * int(counts.sum()))


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
    (fb, fby), (bb, bby), fill, evaluated, (bd, _), picked, (ob, oby) = \
        bounds(seg_pack, anchors, static)
    scratch = shade_bwd_scratch_bytes(torch, k_out, gcot, static, g_k)
    out = {"bit_equal": all(torch.equal(a, b) for a, b in zip(k_out, p_out)),
           "sil_err": sil_err, "argmin_agree": agree, "res_err": res_err,
           "gseg_err": g_err, "gseg_max": g_scale, "fwd_bound_ms": fb,
           "fwd_bound_by": fby, "fwd_only_bound_ms": ob,
           "fwd_only_bound_by": oby, "bwd_bound_ms": bb, "bwd_bound_by": bby,
           "bwd_dense_bound_ms": bd, "picked_share": picked,
           "bwd_scratch_bytes": scratch,
           "valid_slot_share": fill, "evaluated_share": evaluated}
    if timed:
        out["fwd_ms"] = time_ms(torch, lambda: shade.shade_fwd(
            seg_pack, anchors, static, True))
        out["fwd_only_ms"] = time_ms(torch, lambda: shade.shade_fwd(
            seg_pack, anchors, static, False))
        out["fwd_plain_ms"] = time_ms(torch, lambda: shade.shade_fwd_plain(
            seg_pack, anchors, static, True), reps=20, inner=1)
        out["bwd_ms"] = time_ms(torch, lambda: shade.shade_bwd(
            k_out, gcot, static))
        out["bwd_plain_ms"] = time_ms(torch, lambda: shade.shade_bwd_plain(
            p_out, gcot, static), reps=20, inner=1)
        out["fwd_device_ms"] = device_ms(torch, lambda: shade.shade_fwd(
            seg_pack, anchors, static, True))
        out["fwd_only_device_ms"] = device_ms(torch, lambda: shade.shade_fwd(
            seg_pack, anchors, static, False))
        out["bwd_device_ms"] = device_ms(torch, lambda: shade.shade_bwd(
            k_out, gcot, static))
        out["bwd_library"] = shade_bwd_library(torch, k_out, gcot, static,
                                               g_p)
    print(f"kernel check [{name}] B,T,tp,ke={tuple(seg_pack.shape[:2])},"
          f"{static.tile_px},{static.ke}: " + json.dumps(out), flush=True)
    return out


def compare_prep(torch, name, verts, topo, K, st):
    """The raster prep kernel against the plain prep on the same card
    tensors: shade_prep's seg_pack, anchor_px and e_demand against
    _shade_prep_plain's, the launch's idx, hit and slot_of against the
    plain binning's, each by torch.equal; one launch a shade_prep. Timed:
    `ms` and `device_ms` the launch alone, `prep_ms` and `prep_device_ms`
    the card path's whole forward (projection, gathers and pack
    included), `plain_ms` the plain prep's forward. Bound: the bytes the
    launch writes (every output) and reads (the vertices, projected and in
    camera space, and the topology, once); its arithmetic (a few
    operations a face, an edge and a (row, list entry)) is ~100 times
    below. Returns the numbers."""
    from homan_tpu_torch.render import rasterizer as R
    margin, static = R._pack_static(topo, st)
    S, tp, ke = static.image_size, static.tile_px, static.ke

    def launch():
        return R._prep_launch(uv, verts, topo.faces, topo.edges,
                              topo.edge_faces, topo.edge_dir_f1, None, S, tp,
                              ke, st.znear, margin)

    with torch.no_grad():
        uv, z = R.project_ndc(verts, K)
        n0 = R.prep_launches
        kern = R.shade_prep(verts, topo, K, st)
        check(R.prep_launches == n0 + 1, f"{name}: shade_prep launched the "
              f"prep kernel {R.prep_launches - n0} times, not once")
        plain = R._shade_prep_plain(verts, topo, K, st)
        out = launch()
        p0, p1, _, is_contour, _ = R._contour_data(uv, z, topo, st)
        overlap = R._tile_overlap(torch.minimum(p0, p1),
                                  torch.maximum(p0, p1), is_contour, st,
                                  margin)
        p_bins = R._bin_first(overlap, ke)
    torch.cuda.synchronize()
    names = ("seg_pack", "anchor_px", "e_demand", "idx", "hit", "slot_of")
    equal = {n: a.dtype == b.dtype and torch.equal(a, b) for n, a, b in
             zip(names, kern[:3] + out[2:5], plain[:3] + p_bins)}
    check(all(equal.values()), f"{name}: the prep kernel's outputs differ "
          f"from the plain prep's: {equal}")
    check(kern[3] == plain[3], f"{name}: ShadeStatic {kern[3]} differs "
          f"from the plain prep's {plain[3]}")
    err = max(float((a - b).abs().max()) for a, b in zip(kern[:2], plain[:2]))
    B, E, F = verts.shape[0], topo.edges.shape[0], topo.faces.shape[0]
    n_bytes = (sum(t.numel() * t.element_size() for t in out)
               + (uv.numel() + verts.numel()) * 4 + F * 3 * 8 + E * 33)
    bound, bound_by = _bound(n_bytes, 0)
    n_c, n_r = out[7].double(), out[8].double()
    res = {"frames": B, "image": S, "tile": tp, "ke": ke, "edges": E,
           "faces": F, "equal": equal, "max_abs_err": err,
           "demand_max": int(plain[2].max()),
           "contour_edges_per_frame": float(n_c.mean()),
           "list_entries_read_per_frame": float(n_r.mean()),
           "bytes": n_bytes, "bound_ms": bound, "bound_by": bound_by}
    del kern, plain, out, overlap, p_bins
    with torch.no_grad():
        res["ms"] = time_ms(torch, launch)
        res["device_ms"] = device_ms(torch, launch)
        res["prep_ms"] = time_ms(torch, lambda: R.shade_prep(verts, topo, K,
                                                             st))
        res["prep_device_ms"] = device_ms(
            torch, lambda: R.shade_prep(verts, topo, K, st))
        res["plain_ms"] = time_ms(torch, lambda: R._shade_prep_plain(
            verts, topo, K, st), reps=10, inner=1)
    print(f"kernel check [{name}] B,T,tp,ke={B},{static.g ** 2},{tp},{ke} "
          f"(bit-equal): " + json.dumps(res), flush=True)
    return res


def depth_bounds(face_pack, static):
    """Least times (ms) of the depth forward and backward on these inputs.

    Forward: bytes = rows 0-12 of each tile's valid slots read, depth and
    amax written; operations = the kernel's work on these inputs, replayed
    by depth.fwd_work (cull tests per (region, valid slot) and per
    (sub-tile, slot its region keeps), FWD_OPS_PER_PIXEL_SLOT per (pixel,
    slot its sub-tile keeps)). The dense count beside it: the whole pack
    read and FWD_OPS_PER_PIXEL_SLOT per (pixel, valid slot of its tile).
    Backward: bytes = depth, amax and the cotangent read, gpack written;
    operations per pixel.
    """
    from homan_tpu_torch.render import depth
    B, T = face_pack.shape[:2]
    px = B * T * static.tile_px ** 2
    pack_bytes = face_pack.numel() * 4
    work = depth.fwd_work(face_pack, static)
    n_valid = work["valid_pixel_slots"] // static.tile_px ** 2
    fwd = _bound(13 * 4 * n_valid + px * 8, depth.fwd_work_ops(work))
    dense = _bound(pack_bytes + px * 8, depth.FWD_OPS_PER_PIXEL_SLOT
                   * work["valid_pixel_slots"])
    bwd = _bound(px * 12 + pack_bytes, depth.BWD_OPS_PER_PIXEL * px)
    return fwd, bwd, dense, work


def compare_depth(torch, name, face_pack, static, timed):
    """Depth kernel pair vs plain versions on one pack; returns numbers."""
    from homan_tpu_torch.render import depth
    fp = face_pack.detach().contiguous()
    k_d, k_a = depth.depth_fwd(fp, static)
    p_d, p_a = depth.depth_fwd_plain(fp, static)
    torch.cuda.synchronize()
    covered = p_d > 0
    check(bool(covered.any()), f"{name}: nothing covered")
    # The kernel scans each sub-tile's culled slots in the plain version's
    # expressions and order: depth and amax are bit-equal.
    bit_equal = torch.equal(k_d, p_d) and torch.equal(k_a, p_a)
    abs_err = float((k_d - p_d).abs().max())
    agree = 1.0 - int((k_a != p_a).sum()) / int(covered.sum())
    check(bit_equal, f"{name}: depth/amax differ from the plain version's "
          f"(depth max err {abs_err}, amax agreement {agree})")

    gen = torch.Generator(device=fp.device).manual_seed(0)
    gcot = torch.randn(k_d.shape, generator=gen, device=fp.device)
    g_k = depth.depth_bwd(k_d, k_a, gcot, static)
    g_p = depth.depth_bwd_plain(p_d, p_a, gcot, static)
    torch.cuda.synchronize()
    g_err = float((g_k - g_p).abs().max())
    g_scale = float(g_p.abs().max())
    check(g_scale > 0, f"{name}: plain gradient is all zero")
    check(g_err <= 3e-3 * g_scale,
          f"{name}: gpack err {g_err} > 3e-3 of max {g_scale}")
    check(torch.equal(g_k, depth.depth_bwd(k_d, k_a, gcot, static)),
          f"{name}: depth backward kernel is not deterministic")
    outside = torch.cat([g_k[:, :, :9], g_k[:, :, 12:]], dim=2)
    check(not bool(outside.any()), f"{name}: gpack nonzero outside rows 9-11")
    (fb, fby), (bb, bby), (db, dby), work = depth_bounds(fp, static)
    out = {"bit_equal": bit_equal, "depth_abs_err": abs_err,
           "amax_agree": agree, "gpack_err": g_err,
           "gpack_max": g_scale, "fwd_bound_ms": fb, "fwd_bound_by": fby,
           "fwd_dense_bound_ms": db, "fwd_dense_bound_by": dby,
           "bwd_bound_ms": bb, "bwd_bound_by": bby,
           "valid_slot_share": work["valid_pixel_slots"]
           / (fp.shape[0] * fp.shape[1] * static.tile_px ** 2 * static.kf),
           "evaluated_share": work["pixel_slots"]
           / max(work["valid_pixel_slots"], 1),
           "covered_share": float(covered.float().mean())}
    if timed:
        out["fwd_ms"] = time_ms(torch, lambda: depth.depth_fwd(fp, static))
        out["fwd_plain_ms"] = time_ms(
            torch, lambda: depth.depth_fwd_plain(fp, static), reps=3,
            warmup=1, inner=1)
        out["bwd_ms"] = time_ms(torch, lambda: depth.depth_bwd(
            k_d, k_a, gcot, static))
        out["bwd_plain_ms"] = time_ms(torch, lambda: depth.depth_bwd_plain(
            p_d, p_a, gcot, static), reps=10, inner=1)
        out["fwd_device_ms"] = device_ms(torch, lambda: depth.depth_fwd(
            fp, static))
        out["bwd_device_ms"] = device_ms(torch, lambda: depth.depth_bwd(
            k_d, k_a, gcot, static))
        out["bwd_library"] = depth_bwd_library(torch, k_d, k_a, gcot, static,
                                               g_p)
    print(f"depth check [{name}] B,T,tp,kf={tuple(fp.shape[:2])},"
          f"{static.tile_px},{static.kf}: " + json.dumps(out), flush=True)
    return out


def compare_voxelize(torch, name, verts, faces, grid, timed):
    """Voxelizer kernel vs its plain version on one mesh batch, in the
    normalized frame build_scene_sdfs hands it; returns numbers. Untimed
    (`timed` False), plain_ms is the wall of the check's one plain call."""
    from homan_tpu_torch.interactions import sdf as S
    from homan_tpu_torch.interactions import voxelize as V
    center, scale = S.normalize_to_unit_box(verts)
    local = ((verts - center) / scale).detach().contiguous()
    faces = faces.to(verts.device)
    pack = V.pack_triangles(local, faces)
    k = V.voxelize_pack(pack, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = S.voxelize_interior_sdf(local, faces, grid)
    torch.cuda.synchronize()
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    err = float((k - p).abs().max())
    check(err <= 1e-5, f"{name}: phi max err {err} > 1e-5")
    check(torch.equal(k > 0, p > 0), f"{name}: inside sets differ")
    check(bool((p > 0).any()), f"{name}: no grid point inside")
    check(torch.equal(k, V.voxelize_pack(pack, grid)),
          f"{name}: voxelizer is not deterministic")
    inside = p > 0
    n_faces = faces.shape[0]
    out_bytes = pack.numel() * 4 + k.numel() * 4
    bound, bound_by = _bound(out_bytes, V.work_ops(
        n_faces, int(inside.sum()), grid, local.shape[0]))
    dense, _ = _bound(out_bytes, V.DENSE_OPS_PER_POINT_FACE * local.shape[0]
                      * grid ** 3 * n_faces)
    out = {"phi_err": err, "inside_share": float(inside.float().mean()),
           "bound_ms": bound, "bound_by": bound_by, "dense_bound_ms": dense}
    out["ms"] = time_ms(torch, lambda: V.voxelize_pack(pack, grid))
    out["device_ms"] = device_ms(torch, lambda: V.voxelize_pack(pack, grid))
    out["plain_ms"] = (time_ms(torch, lambda: S.voxelize_interior_sdf(
        local, faces, grid), reps=3, warmup=1, inner=1) if timed
        else plain_once_ms)
    print(f"voxelize check [{name}] B,F,G={local.shape[0]},{faces.shape[0]},"
          f"{grid}: " + json.dumps(out), flush=True)
    return out, pack


# The box of the G 512 and 1,024 checks: core/meshes.py box_mesh() moved
# by a fraction of a cell in y. Its caps are split along their diagonals,
# and a column through a diagonal meets both triangles of each cap (the
# shared edge's function is 0), four crossings, so reads as outside in the
# plain version and the JAX kernel alike; the shift keeps every diagonal
# off the cell centres at G 16-1,024 (tests/test_torch_voxelize_grids.py).
BOX_SHIFT = (0.0, 0.37 / 512, 0.0)
LARGE_GRIDS = (128, 256, 512, 1024)


def compare_voxelize_box(torch, grid):
    """The kernel at G on the shifted box against the box's analytic
    interior distance min_i(h_i - |x_i - c_i|): the same inside set, phi
    within 1e-5, deterministic; its times and bound."""
    from homan_tpu_torch.core.meshes import box_mesh
    from homan_tpu_torch.interactions import voxelize as V
    v, f = box_mesh()
    v = torch.from_numpy(v + np.asarray(BOX_SHIFT, np.float32))[None].cuda()
    pack = V.pack_triangles(v, torch.from_numpy(f.astype(np.int64)).cuda())
    phi = V.voxelize_pack(pack, grid)[0]
    axis = -1.0 + (2.0 * torch.arange(grid, device="cuda",
                                      dtype=torch.float32) + 1.0) / grid
    d = [0.5 - (axis - c).abs() for c in BOX_SHIFT]
    ref = torch.minimum(torch.minimum(d[0][:, None, None],
                                      d[1][None, :, None]),
                        d[2][None, None, :]).clamp_(min=0)
    inside = ref > 0
    check(torch.equal(phi > 0, inside), f"box-g{grid}: inside set differs "
          f"from the box's ({int((phi > 0).sum())} vs {int(inside.sum())})")
    err = float((phi - ref).abs().max())
    del ref, d
    check(err <= 1e-5, f"box-g{grid}: phi max err {err} > 1e-5")
    n_inside = int(inside.sum())
    del inside
    check(torch.equal(phi, V.voxelize_pack(pack, grid)[0]),
          f"box-g{grid}: voxelizer is not deterministic")
    del phi
    bound, bound_by = _bound(pack.numel() * 4 + 4 * grid ** 3,
                             V.work_ops(f.shape[0], n_inside, grid, 1))
    out = {"phi_err": err, "inside_share": n_inside / grid ** 3,
           "bound_ms": bound, "bound_by": bound_by,
           "ms": time_ms(torch, lambda: V.voxelize_pack(pack, grid),
                         reps=5, warmup=1, inner=1),
           "device_ms": device_ms(torch, lambda: V.voxelize_pack(pack, grid)),
           "plain_ms": None, "reference": "analytic box distance"}
    torch.cuda.empty_cache()
    print(f"voxelize check [box-g{grid}] B,F,G=1,{f.shape[0]},{grid}: "
          + json.dumps(out), flush=True)
    return out


def large_grid_checks(torch, v_hand, hand_faces, v_obj, obj_faces):
    """Phase 2's voxelizer at G 128-1,024 (the JAX launcher's range beyond
    the fits' 16-64): G 128 on frame 0's hand and object of the
    interaction fit, G 256 on bumpy_potato(1, 0.07) (80 faces), both
    against the plain version; G 512 and 1,024 on the shifted box against
    its analytic distance. Returns {name: row}."""
    from homan_tpu_torch.core.meshes import bumpy_potato
    rows = {}
    for m, v, f in (("hand", v_hand, hand_faces), ("object", v_obj,
                                                   obj_faces)):
        rows[f"g128-{m}"], _ = compare_voxelize(
            torch, f"{m}-g128", v[:1].contiguous(), f, 128, timed=False)
    pv, pf = bumpy_potato(1, 0.07, seed=0)
    rows["g256-potato"], _ = compare_voxelize(
        torch, "potato-g256", torch.from_numpy(pv)[None].cuda(),
        torch.from_numpy(pf.astype(np.int64)), 256, timed=False)
    torch.cuda.empty_cache()
    for grid in (512, 1024):
        rows[f"g{grid}-box"] = compare_voxelize_box(torch, grid)
    return rows


def build_variant(path):
    """Build another source of a kernel (same flags as the package's) into
    its own library, for a timing comparison in turns."""
    import ctypes
    import hashlib
    import os
    from homan_tpu_torch import _build
    with open(path, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(_build.NVCC_FLAGS).encode())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"variant-{h.hexdigest()[:16]}.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                          path], capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"nvcc failed on {path}: {res.stdout}"
          f"{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas [variant {path}]: {line.strip()}", flush=True)
    return ctypes.CDLL(out)


def ab_compare(torch, specs, vox_packs, shade_inputs, depth_packs):
    """Each `name=path.cu` of `specs` (name voxelize, shade_fwd, shade_bwd
    or depth; path another source with the same C interface, e.g. the
    parent commit's) against the package's kernels on the same inputs: its
    output checked, then both timed in turns (package, variant, variant,
    package) on each input, by time_ms and by device_ms."""
    import ctypes
    from homan_tpu_torch.interactions import voxelize as V
    from homan_tpu_torch.render import depth as D
    from homan_tpu_torch.render import shade
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for spec in specs:
        name, path = spec.split("=", 1)
        lib = build_variant(path)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}  # label -> (the package's call, the variant's call)
        if name == "voxelize":
            fn = lib.voxelize
            fn.argtypes = [ptr] * 2 + [i32] * 3 + [f32, ptr]
            for m, pack in vox_packs.items():
                B, _, fpad = pack.shape
                phi = torch.empty((B, GRID, GRID, GRID), device=pack.device)
                ref = V.voxelize_pack(pack, GRID)

                def run(pack=pack, phi=phi, B=B, fpad=fpad):
                    check(fn(pack.data_ptr(), phi.data_ptr(), B, GRID, fpad,
                             V.BIG, stream) == 0, f"{path}: launch failed")
                run()
                torch.cuda.synchronize()
                check(torch.equal(phi > 0, ref > 0),
                      f"{path}: inside sets differ from the package's")
                check(float((phi - ref).abs().max()) <= 1e-5,
                      f"{path}: phi differs from the package's")
                calls[f"voxelize[{m}]"] = (
                    lambda pack=pack: V.voxelize_pack(pack, GRID), run)
        elif name == "shade_fwd":
            fn = lib.shade_fwd
            fn.argtypes = [ptr] * 7 + [i32] * 6 + [f32] * 3 + [ptr]
            seg, anc, st = shade_inputs["fit"]
            seg, anc = seg.contiguous(), anc.contiguous()
            outs = [torch.empty(anc.shape, device=anc.device)
                    for _ in range(5)]
            outs[1] = torch.empty(anc.shape, dtype=torch.int32,
                                  device=anc.device)
            ref = shade.shade_fwd(seg, anc, st, True)

            def run():
                check(fn(seg.data_ptr(), anc.data_ptr(),
                         *(o.data_ptr() for o in outs), seg.shape[0],
                         seg.shape[1], st.g, st.tile_px, st.ke, 1,
                         1.0 / st.image_size, st.sigma, st.cap2,
                         stream) == 0, f"{path}: launch failed")
            run()
            torch.cuda.synchronize()
            check(float((outs[0] - ref[0]).abs().max()) <= 2e-5,
                  f"{path}: sil differs from the package's")
            calls["shade_fwd[fit]"] = (
                lambda: shade.shade_fwd(seg, anc, st, True), run)
        elif name == "shade_bwd":
            fn = lib.shade_bwd
            fn.argtypes = [ptr] * 8 + [i32] * 5 + [f32, ptr]
            # The package's sources say how many pixels a block of their
            # first launch covers; the older ones (the first design) covered
            # 256 and wrote dense (B, T, C, 4, Ke) partials.
            try:
                strip = int(lib.shade_bwd_strip_pixels())
            except AttributeError:
                strip = 256
            for m in ("fit", "evidence-hand"):
                seg, anc, st = shade_inputs[m]
                res = shade.shade_fwd(seg.contiguous(), anc.contiguous(), st,
                                      True)
                B, T = seg.shape[:2]
                tp, ke = st.tile_px, st.ke
                n = -(-tp * tp // strip)
                cap = min(ke, strip)
                scratch = torch.empty(
                    B * T * (n * max(4 * ke, 4 + -(-cap // 4) * 4 + 4 * cap)
                             + 4), device=seg.device)
                gcot = torch.randn(res[0].shape, device=seg.device,
                                   generator=torch.Generator(
                                       seg.device).manual_seed(0))
                ref = shade.shade_bwd(res, gcot, st)
                scale = float(shade.shade_bwd_plain(res, gcot, st).abs().max())
                vg = torch.empty_like(ref)

                def run(res=res, gcot=gcot, st=st, vg=vg, B=B, T=T, n=n,
                        scratch=scratch):
                    check(fn(*(x.data_ptr() for x in res), gcot.data_ptr(),
                             scratch.data_ptr(), vg.data_ptr(), B, T,
                             st.tile_px, st.ke, n, st.sigma, stream) == 0,
                          f"{path}: shade_bwd launch failed")
                run()
                torch.cuda.synchronize()
                err = float((vg - ref).abs().max())
                check(err <= 3e-3 * scale, f"{path}: gseg on {m} differs "
                      f"from the package's by {err} (plain max {scale})")
                print(f"ab [shade_bwd] {m}: variant gseg within {err} of the "
                      f"package's (plain max {scale})", flush=True)
                calls[f"shade_bwd[{m}]"] = (
                    lambda res=res, gcot=gcot, st=st: shade.shade_bwd(
                        res, gcot, st), run)
        elif name == "depth":
            fwd, bwd = lib.depth_fwd, lib.depth_bwd
            fwd.argtypes = [ptr] * 3 + [i32] * 5 + [f32, ptr]
            bwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
            for m, (fp, st) in depth_packs.items():
                B, T = fp.shape[:2]
                tp, kf = st.tile_px, st.kf
                n_chunks = -(-tp * tp // D.BLOCK_PIXELS)
                d, a = D.depth_fwd(fp, st)
                gcot = torch.randn(d.shape, device=fp.device,
                                   generator=torch.Generator(
                                       fp.device).manual_seed(0))
                gp = D.depth_bwd(d, a, gcot, st)
                vd, va = torch.empty_like(d), torch.empty_like(a)
                vg = torch.empty_like(gp)
                # Per-chunk scratch, as large as either layout needs: the
                # package's compact lists or earlier sources' dense
                # (B, T, C, 3, Kf) partials.
                scratch = torch.empty(
                    B * T * n_chunks * max(3 * kf, D.BWD_LIST_FLOATS),
                    device=fp.device)

                def run_fwd(fp=fp, st=st, vd=vd, va=va, B=B, T=T):
                    check(fwd(fp.data_ptr(), vd.data_ptr(), va.data_ptr(),
                              B, T, st.g, st.tile_px, st.kf,
                              1.0 / st.image_size, stream) == 0,
                          f"{path}: depth_fwd launch failed")

                def run_bwd(d=d, a=a, gcot=gcot, st=st, vg=vg, B=B, T=T,
                            scratch=scratch, n_chunks=n_chunks):
                    check(bwd(d.data_ptr(), a.data_ptr(), gcot.data_ptr(),
                              scratch.data_ptr(), vg.data_ptr(), B, T, st.g,
                              st.tile_px, st.kf, n_chunks,
                              1.0 / st.image_size, stream) == 0,
                          f"{path}: depth_bwd launch failed")
                run_fwd()
                run_bwd()
                torch.cuda.synchronize()
                check(torch.equal(vd, d) and torch.equal(va, a),
                      f"{path}: depth/amax on {m} differ from the "
                      f"package's")
                check(torch.equal(vg, gp),
                      f"{path}: gpack on {m} differs from the package's")
                calls[f"depth_fwd[{m}]"] = (
                    lambda fp=fp, st=st: D.depth_fwd(fp, st), run_fwd)
                calls[f"depth_bwd[{m}]"] = (
                    lambda d=d, a=a, gcot=gcot, st=st: D.depth_bwd(
                        d, a, gcot, st), run_bwd)
        else:
            raise RuntimeError(f"--ab takes voxelize=, shade_fwd=, "
                               f"shade_bwd= or depth=, got {spec}")
        out = {}
        for label, pair in calls.items():
            turns = {"package": [], "variant": []}
            dev_turns = {"package": [], "variant": []}
            parts = {}
            for who in ("package", "variant", "variant", "package"):
                fn_ = pair[who == "variant"]
                turns[who].append(time_ms(torch, fn_))
                dev_turns[who].append(device_ms(torch, fn_))
                parts[who] = kernel_split_us(torch, fn_)
            out[label] = {
                "turns_ms": turns, "turns_device_ms": dev_turns,
                "package_ms": statistics.mean(turns["package"]),
                "variant_ms": statistics.mean(turns["variant"]),
                "package_device_ms": statistics.mean(dev_turns["package"]),
                "variant_device_ms": statistics.mean(dev_turns["variant"]),
                "last_turn_kernels_us": parts}
        print(f"ab [{name}] package vs {path} (outputs "
              f"{'bit-equal' if name == 'depth' else 'checked'}): "
              + json.dumps(out), flush=True)


def size_faces(demand, n_faces):
    """Face slots for a measured per-tile demand: x1.3, the next power of
    two, at most the mesh's face count (the tile then holds every face)."""
    need = int(np.ceil(demand * EDGE_SAFETY))
    return min(1 << max(need - 1, 0).bit_length(), n_faces)


def _counter_modules():
    from homan_tpu_torch.interactions import voxelize
    from homan_tpu_torch.render import depth, rasterizer, shade
    return {"shade_fwd": shade, "shade_fwd_only": shade, "shade_bwd": shade,
            "depth_fwd": depth, "depth_bwd": depth, "voxelize": voxelize,
            "prep": rasterizer}


def reset_counts():
    for name, mod in _counter_modules().items():
        setattr(mod, name + "_launches", 0)


def read_counts():
    return {name: getattr(mod, name + "_launches")
            for name, mod in _counter_modules().items()}


def run_fit(torch, joint, scene, settings, iters, device, **fit_kw):
    """One fit with every launch count set to 0 just before it and read
    just after; returns (final, history, wall seconds, counts)."""
    reset_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = joint.optimize_hand_object(
        fit_kw.pop("state", scene.init_state), scene.consts,
        fit_kw.pop("cfg", scene.cfg), num_iterations=iters,
        roi_settings=settings, device=device, **fit_kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return final, {k: v.cpu() for k, v in hist.items()}, wall, read_counts()


def profile_window(torch, run, steps, label):
    """torch.profiler around run(), which takes `steps` steps: wall and
    device-busy time per step, the device's idle share, kernel launches per
    step, and the top device kernels."""
    from torch.profiler import ProfilerActivity, profile
    cuda_t = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda_t
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith("cudaLaunchKernel"))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {"steps": steps, "wall_ms_per_step": wall / steps * 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
           "launch_calls_per_step": launches / steps,
           "top_kernels_us_per_step": [
               [e.key[:60], e.self_device_time_total / steps] for e in top]}
    print(f"profile [{label}] (torch.profiler on, adds host time): "
          + json.dumps(out), flush=True)
    return out


def profile_clip(torch, run, label):
    """One driver clip, run(), in a torch.profiler window of CUDA activity:
    its wall, the device's busy time (the union of its kernel, copy and set
    intervals) and idle share, the kernel launches, and the kernels that
    take the most device time. Read from the raw trace: the profiler's own
    aggregation (key_averages) takes minutes over a clip's ~10^6 events."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile
    cuda_t = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, launches = [], defaultdict(int), 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda_t:
            spans.append((e.start_ns(), e.end_ns()))
            by_name[e.name()[:60]] += e.duration_ns()
        elif e.name().startswith("cudaLaunchKernel"):
            launches += 1
    busy_ns, end = 0, None
    for start, stop in sorted(spans):
        if end is None or start >= end:
            busy_ns += stop - start
            end = stop
        elif stop > end:
            busy_ns += stop - end
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_s": wall, "device_busy_s": busy_ns / 1e9,
           "device_idle_share": 1.0 - busy_ns / 1e9 / wall,
           "device_events": len(spans), "launch_calls": launches,
           "top_kernels_ms": [[name, ns / 1e6] for name, ns in top]}
    print(f"profile [{label}] (torch.profiler, CUDA activity): "
          + json.dumps(out), flush=True)
    return out


def profile_steps(torch, joint, scene, settings, iters, label, **fit_kw):
    """profile_window over `iters` steps of a stage-C fit."""
    return profile_window(torch, lambda: joint.optimize_hand_object(
        fit_kw.pop("state", scene.init_state), scene.consts,
        fit_kw.pop("cfg", scene.cfg), num_iterations=iters,
        roi_settings=settings, device="cuda", **fit_kw), iters, label)


def check_history(hist, label, iou=False):
    loss = hist["loss"]
    check(all(bool(np.isfinite(v.numpy()).all()) for v in hist.values()),
          f"{label}: non-finite loss or metric")
    check(float(loss[-1]) < float(loss[0]),
          f"{label}: loss did not fall: {float(loss[0])} -> "
          f"{float(loss[-1])}")
    check(float(hist["edge_budget_excess"].max()) <= 0,
          f"{label}: edge budget overflowed during the fit")
    if iou:
        check(float(hist["iou_object"][-1]) > float(hist["iou_object"][0]),
              f"{label}: object IoU did not improve")


def timed_fit_pair(torch, joint, scene, settings, iters, label, expect,
                   **fit_kw):
    """The fit twice, counts read around each run; `expect` maps kernel
    names to the launch count the run must show. Returns (walls, counts
    of the second run, history of the second run, final state)."""
    walls = []
    for i in range(2):
        final, hist, wall, counts = run_fit(torch, joint, scene, settings,
                                            iters, "cuda", **dict(fit_kw))
        walls.append(wall)
        print(f"{label} run {i + 1}: {iters} steps in {wall:.3f} s "
              f"({wall / iters * 1e3:.3f} ms/step); launches "
              + json.dumps(counts), flush=True)
        check_history(hist, label)
        for name, n in expect.items():
            check(counts[name] == n, f"{label}: {name} launched "
                  f"{counts[name]} times, expected {n}")
    loss = hist["loss"]
    print(f"{label}: loss {float(loss[0]):.6f} -> {float(loss[-1]):.6f}; "
          + ", ".join(f"{k} {float(hist[k][0]):.6g} -> "
                      f"{float(hist[k][-1]):.6g}"
                      for k in ("loss_collision", "loss_contact",
                                "loss_depth", "iou_object") if k in hist),
          flush=True)
    if "loss_depth" in hist:
        active = hist["loss_depth"] > 0
        print(f"{label}: ordinal-depth term active on {int(active.sum())} "
              f"of {iters} steps, max {float(hist['loss_depth'].max()):.6g}",
              flush=True)
    return walls, counts, hist, final


def small_fit_pair(torch, joint, scene, settings, iters, label, expect,
                   states=False, **fit_kw):
    """The same small fit on the card and on the CPU (plain versions) from
    the same inputs: totals within rtol 3e-3; kernels launched on the card
    only; with `states`, also the final states within 3e-3 of each field's
    maximum, returned beside the totals' error."""
    f_gpu, h_gpu, w_gpu, l_gpu = run_fit(torch, joint, scene, settings,
                                         iters, "cuda", **dict(fit_kw))
    f_cpu, h_cpu, w_cpu, l_cpu = run_fit(torch, joint, scene, settings,
                                         iters, "cpu", **dict(fit_kw))
    for name, n in expect.items():
        check(l_gpu[name] == n, f"{label}: card {name} launches "
              f"{l_gpu[name]} != {n}")
    check(not any(l_cpu.values()), f"{label}: CPU run launched {l_cpu}")
    rel = float(((h_gpu["loss"] - h_cpu["loss"]).abs()
                 / h_cpu["loss"].abs()).max())
    print(f"{label}, card vs CPU plain path: {iters}-step loss max rel err "
          f"{rel:.3g} (card {w_gpu:.1f} s, CPU {w_cpu:.1f} s)", flush=True)
    check(rel <= 3e-3, f"{label}: card and CPU fits disagree: rel err {rel}")
    if not states:
        return rel
    err = {k: float((getattr(f_gpu, k).cpu() - v).abs().max()
                    / max(float(v.abs().max()), 1e-30))
           for k, v in vars(f_cpu).items() if v is not None}
    print(f"{label}, card vs CPU plain path: final state max rel err "
          + json.dumps(err), flush=True)
    check(max(err.values()) <= 3e-3, f"{label}: card and CPU states "
          f"differ: {err}")
    return rel, err


def sized_edges(R, verts, topo, K, settings):
    """Ke from the measured contour-edge demand, as the JAX package's
    auto_edge_settings does (x1.3, next bucket)."""
    demand = R.check_edge_budget(verts, topo, K, settings)
    need = int(np.ceil(demand["max_demand"] * EDGE_SAFETY))
    return min(b for b in EDGE_BUCKETS if b >= need), demand


def overlap_state(scene):
    """The ground-truth state with the object moved just in front of the
    first hand, so the ordinal-depth pairs are active from the start."""
    import dataclasses
    gt = scene.gt_state
    th = gt.translations_hand
    t = th[::scene.cfg.hand_nb] + th.new_tensor([0.03, 0.0, -0.06])
    return dataclasses.replace(gt, translations_object=t)


def stage_b_clip(frames, image_size, rend, device):
    """bench.py bench_stageb's clip, built by the port alone
    (bench.py:103-128, :140-160): the 1280-face bumpy potato turning 0.04
    rad a frame about z and drifting in x, focal 0.9 x image_size; full
    masks by render_full_mask, evidence by build_object_mask_info at
    `rend`. Returns vertices, faces, annotations and Ks."""
    from homan_tpu_torch.core.meshes import bumpy_potato
    from homan_tpu_torch.frontend.evidence import build_object_mask_info
    from homan_tpu_torch.frontend.gtevidence import (mask_to_bbox,
                                                     render_full_mask)
    v, f = bumpy_potato(3, 0.08, seed=0)
    K = np.array([[image_size * 0.9, 0, image_size / 2],
                  [0, image_size * 0.9, image_size / 2], [0, 0, 1.0]],
                 np.float32)
    verts = []
    for t in range(frames):
        a = 0.04 * t
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]], np.float32)
        verts.append(v @ Rz.T + np.array([0.02 + 0.002 * t, -0.01, 0.55],
                                         np.float32))
    masks = render_full_mask(np.stack(verts), f,
                             np.tile(K[None], (frames, 1, 1)), image_size,
                             device=device)
    ann = []
    for m in masks:
        info = build_object_mask_info(m, mask_to_bbox(m), None, rend)
        info["full_mask"] = m.astype(np.float32)
        ann.append(info)
    return v, f, ann, [K] * frames


def stage_b_launches(frames, inits, iters, coarse, chunk, prune, rescore,
                     parallel):
    """Shade launches of one find_optimal_poses call: {"shade_fwd": with
    residuals plus forward-only, "shade_fwd_only", "shade_bwd", "prep":
    one a forward}. A
    refinement of n candidates in chunks of c runs ceil(n / c) chunks a
    step with a gradient, then each chunk once without (its final
    evaluation); the rescore runs its chunks once without."""
    def fit(n, c, steps):
        k = -(-n // c)
        return k * steps, k

    def chunks(n, c):
        return -(-n // c)

    runs = []  # (residual launches, forward-only launches)
    kept = inits
    if prune is not None and prune < inits:
        runs.append(fit(inits, chunk, coarse))
        kept = prune
    rest = frames - 1 if parallel and frames > 1 else 0
    runs += [fit(kept, chunk, iters)] * (frames - rest)
    if rest:
        runs.append(fit(rest * kept, min(3 * chunk, rest * kept), iters))
    if rescore:
        runs.append((0, chunks(frames * kept, chunk)))
    res = sum(r for r, _ in runs)
    only = sum(o for _, o in runs)
    return {"shade_fwd": res + only, "shade_fwd_only": only,
            "shade_bwd": res, "depth_fwd": 0, "depth_bwd": 0,
            "voxelize": 0, "prep": res + only}


def posed(torch, geo, vertices, rot, trans):
    """(C, V, 3) candidate vertices from (C, 3, 3) or (C, 3, 2) rotations."""
    if rot.shape[-1] == 2:
        rot = geo.rot6d_to_matrix(rot)
    return torch.einsum("vj,cjk->cvk", vertices, rot) + trans


def edge_demand(torch, R, verts, topo, K, settings, chunk=125):
    """check_edge_budget of the renders (its max demand against the
    capacity) and each render's own demand (shade_prep's e_demand), in
    chunks."""
    budget = R.check_edge_budget(verts, topo, K, settings)
    per = []
    with torch.no_grad():
        for s in range(0, verts.shape[0], chunk):
            per.append(R.shade_prep(verts[s:s + chunk], topo,
                                    K[s:s + chunk], settings)[2])
    per = torch.cat(per)
    check(int(per.max()) == budget["max_demand"],
          f"shade_prep's demand {int(per.max())} differs from "
          f"check_edge_budget's {budget['max_demand']}")
    return budget, per


def stage_b_phase(torch, R):
    """The stage-B phase: bench.py bench_stageb's search at full width,
    twice, then in parallel_frames mode; its edge budget; the shade pair at
    its packs; a profiled refinement window; a small search on the card
    against the CPU. Returns (result dict, kernel rows by pack)."""
    import contextlib

    from homan_tpu_torch.core import geometry as geo
    from homan_tpu_torch.fit import poseinit
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    v_np, f_np, ann, Ks = stage_b_clip(FRAMES_B, 2 * REND, REND, "cuda")
    torch.cuda.synchronize()
    print(f"stage B clip: {FRAMES_B} frames, {2 * REND}^2 masks, evidence "
          f"at {REND}^2 in {time.perf_counter() - t0:.2f} s", flush=True)
    vertices = torch.from_numpy(v_np).to(dev)
    topo = R.MeshTopology.from_faces(f_np, device=dev)
    refine_size = poseinit._refine_settings(
        R.RasterSettings(REND, tile_px=TILE), 0.5).image_size
    wide = {"refine": R.RasterSettings(refine_size, tile_px=TILE,
                                       edges_per_tile=1 << 20),
            "rescore": R.RasterSettings(REND, tile_px=TILE,
                                        edges_per_tile=1 << 20)}

    # Edge budget at the initial candidates of frame 0, at both
    # resolutions; Ke sized from the larger demand (x1.3, next bucket).
    rot0 = geo.random_rotations(INITS_B, torch.Generator().manual_seed(0),
                                device=dev)
    _, _, _, K_roi0 = poseinit._frame_evidence(ann[0], Ks[0], REND, dev)
    r6, tr0 = poseinit._chain_init(vertices, rot0, ann[0]["bbox"],
                                   torch.from_numpy(Ks[0]).to(dev))
    init_verts = posed(torch, geo, vertices, rot0, tr0)
    K_init = K_roi0.expand(INITS_B, 3, 3)
    demand = {}
    for res, st in wide.items():
        b, per = edge_demand(torch, R, init_verts, topo, K_init, st)
        demand[res] = {"initial_max": b["max_demand"],
                       "initial_median": float(per.float().median()),
                       "initial_share_over_bench_ke": float(
                           (per > KE_BENCH_B).float().mean())}
    need = int(np.ceil(max(d["initial_max"] for d in demand.values())
                       * EDGE_SAFETY))
    ke_b = min(b for b in EDGE_BUCKETS if b >= need)
    settings = R.RasterSettings(REND, tile_px=TILE, edges_per_tile=ke_b)
    print(f"stage B edge budget at frame 0's {INITS_B} initial candidates: "
          + json.dumps(demand) + f"; bench Ke {KE_BENCH_B}; the search runs "
          f"Ke {ke_b}", flush=True)

    # The search at full width, twice. The rescore's inputs (every frame's
    # final candidates) are kept for the budget check and the packs.
    kept = {}
    score = poseinit._score_candidates

    def keep_score(*args, **kw):
        kept["args"] = args
        kept["group"] = kw["group"]
        return score(*args, **kw)

    search_kw = dict(num_initializations=INITS_B, num_iterations=ITERS_B,
                     rend_size=REND, settings=settings, seed=0,
                     prune_to="auto", coarse_iterations=COARSE_B,
                     refine_scale=0.5, candidate_chunk=CHUNK_B, device="cuda")
    prune = max(INITS_B // 4, 16)

    def search(label, **kw):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = poseinit.find_optimal_poses(
            v_np, f_np, ann, Ks, (2 * REND, 2 * REND),
            **dict(search_kw, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        expect = stage_b_launches(FRAMES_B, INITS_B, ITERS_B, COARSE_B,
                                  CHUNK_B, prune, True,
                                  kw.get("parallel_frames", False))
        best = res[0]["best_iou"]
        print(f"stage B {label}: {wall:.3f} s, best IoU {best:.6f}; "
              f"launches " + json.dumps(counts), flush=True)
        check(counts == expect, f"stage B {label}: launches {counts}, the "
              f"path's count is {expect}")
        check(best >= 0.9, f"stage B {label}: best IoU {best} < 0.9")
        check(len(res) == FRAMES_B and all(
            bool(torch.isfinite(r["rotations"]).all()) for r in res),
            f"stage B {label}: non-finite or missing poses")
        return wall, best, counts

    poseinit._score_candidates = keep_score
    try:
        walls, bests = [], []
        for i in range(2):
            w, b, counts = search(f"run {i + 1}")
            walls.append(w)
            bests.append(b)
    finally:
        poseinit._score_candidates = score
    wall_p, best_p, counts_p = search("parallel_frames",
                                      parallel_frames=True)

    # The budget at every frame's final candidates, at both resolutions.
    _, _, _, _, ev_K, r6_all, t_all, _ = kept["args"]
    C = kept["group"]
    final_verts = posed(torch, geo, vertices, r6_all, t_all)
    K_all = ev_K.repeat_interleave(C, 0)
    for res, st in wide.items():
        b, _ = edge_demand(torch, R, final_verts, topo, K_all, st)
        demand[res]["final_max"] = b["max_demand"]
        demand[res]["capacity"] = ke_b
        check(b["max_demand"] <= ke_b and demand[res]["initial_max"] <= ke_b,
              f"stage B: {res} renders overflow Ke {ke_b}: {demand[res]}")
    print("stage B edge demand against capacity: " + json.dumps(demand),
          flush=True)

    # The shade pair at stage B's packs.
    st_ref = R.RasterSettings(refine_size, tile_px=TILE, edges_per_tile=ke_b)

    def pack(verts, K, st):
        with torch.no_grad():
            seg, anc, _, static = R.shade_prep(verts, topo, K, st)
        return seg, anc, static

    packs = {
        "stage_b_coarse": pack(init_verts[:CHUNK_B], K_init[:CHUNK_B],
                               st_ref),
        "stage_b_coarse_b500": pack(init_verts, K_init, st_ref),
        "stage_b_refine": pack(final_verts[:C], K_all[:C], st_ref),
        "stage_b_rescore": pack(final_verts[:C], K_all[:C], settings),
    }
    rows = {name: compare_kernels(torch, name, *p, timed=True)
            for name, p in packs.items()}

    # A 10-step profiler window of frame 0's refinement.
    mask, _, _, K_roi = poseinit._frame_evidence(ann[0], Ks[0], REND, dev)
    ref_r, keep_r, edt_r = poseinit._refine_evidence(mask, refine_size, 0.0,
                                                     dev)
    prof = profile_window(torch, lambda: poseinit._fit_candidates(
        vertices, topo, ref_r, keep_r, edt_r, K_roi, r6_all[:C],
        t_all[:C], st_ref, num_iterations=10, candidate_chunk=CHUNK_B),
        10, "stage B refinement")

    out = {"frames": FRAMES_B, "inits": INITS_B, "iters": ITERS_B,
           "coarse_iters": COARSE_B, "rend": REND, "refine": refine_size,
           "tile": TILE, "ke": ke_b, "edge_demand": demand,
           "first_wall_s": walls[0], "second_wall_s": walls[1],
           "best_iou": bests, "launches": counts,
           "parallel_frames": {"wall_s": wall_p, "best_iou": best_p,
                               "launches": counts_p},
           "profiled_refinement": prof}

    # The card against the CPU: a small search with the same injected
    # rotations on both sides.
    @contextlib.contextmanager
    def injected(rots):
        draw = geo.random_rotations
        geo.random_rotations = (
            lambda n, generator=None, upright=False, device=None:
            rots[:n].to(device))
        try:
            yield
        finally:
            geo.random_rotations = draw

    sv, sf, s_ann, s_Ks = stage_b_clip(3, 128, 64, "cpu")
    u = np.random.RandomState(1).uniform(size=(3, 24)).astype(np.float32)
    rots = geo.arvo_rotations(torch.from_numpy(u))
    small = {}
    with injected(rots):
        for d in ("cuda", "cpu"):
            reset_counts()
            small[d] = poseinit.find_optimal_poses(
                sv, sf, s_ann, s_Ks, (128, 128), num_initializations=24,
                num_iterations=5, rend_size=64,
                settings=R.RasterSettings(64, tile_px=32,
                                          edges_per_tile=128),
                device=d)
            small[d + "_counts"] = read_counts()
    expect = stage_b_launches(3, 24, 5, 0, CHUNK_B, None, False, False)
    check(small["cuda_counts"] == expect, f"small stage B: card "
          f"launches {small['cuda_counts']}, expected {expect}")
    check(not any(small["cpu_counts"].values()),
          f"small stage B: CPU run launched {small['cpu_counts']}")
    err = {k: max(float((g[k].cpu() - c[k]).abs().max())
                  for g, c in zip(small["cuda"], small["cpu"]))
           for k in ("rotations", "translations")}
    err["best_iou"] = abs(small["cuda"][0]["best_iou"]
                          - small["cpu"][0]["best_iou"])
    print("small stage B, card vs CPU plain path: " + json.dumps(err),
          flush=True)
    check(err["rotations"] <= 2e-3 and err["translations"] <= 2e-3,
          f"small stage B: card and CPU poses differ: {err}")
    check(err["best_iou"] <= 1e-3, f"small stage B: best IoU differs: "
          f"{err}")
    out["card_vs_cpu"] = err
    return out, rows


# The synthetic HO-3D clip of phase 5: HO-3D's camera, the synthetic MANO
# hand written as a MANO pickle, a rotating bumpy potato as the YCB object.
HO3D_SEQ, HO3D_OBJ = "ABF11", "003_cracker_box"
HO3D_K = np.array([[614.0, 0, 320.0], [0, 614.0, 240.0], [0, 0, 1]])


def write_mano_pickle(path, arrays):
    """Write MANO arrays (homan_tpu_torch.core.mano._synthetic_arrays
    layout) as a MANO_RIGHT.pkl in the license-gated file's format: a
    scipy-sparse J_regressor, the kinematic tree with the root's parent
    2^32 - 1, uint32 faces `f`."""
    import os
    import pickle

    import scipy.sparse
    parents = np.asarray(arrays["parents"], np.int64).copy()
    parents[0] = 2 ** 32 - 1
    payload = {
        "v_template": np.asarray(arrays["v_template"]),
        "shapedirs": np.asarray(arrays["shapedirs"]),
        "posedirs": np.asarray(arrays["posedirs"]),
        "J_regressor": scipy.sparse.csc_matrix(arrays["J_regressor"]),
        "weights": np.asarray(arrays["weights"]),
        "kintree_table": np.stack([parents, np.arange(len(parents))]),
        "f": np.asarray(arrays["faces"]).astype(np.uint32),
        "hands_components": np.asarray(arrays["hands_components"]),
        "hands_mean": np.asarray(arrays["hands_mean"]),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def write_ho3d_tree(root, frames=40, seed=0, obj_subdiv=3):
    """An HO-3D tree under `root`, where the HO3D dataset's and the
    driver's defaults look (local_data/datasets/ho3d/train/<seq>/meta/
    NNNN.pkl, local_data/datasets/ycbmodels/<obj>/textured_simple_2000.obj,
    extra_data/mano/MANO_RIGHT.pkl): `frames` frames of HO-3D's camera
    (614 px focal, centre (320, 240)), a hand pose drawn from a numpy seed
    on the synthetic MANO hand, and a bumpy potato of radius 0.08 m turning
    a little more each frame. Returns root."""
    import os
    import pickle

    from homan_tpu_torch.core.mano import _synthetic_arrays
    from homan_tpu_torch.core.meshes import bumpy_potato, save_obj
    meta = os.path.join(root, "local_data", "datasets", "ho3d", "train",
                        HO3D_SEQ, "meta")
    os.makedirs(meta, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(frames):
        annot = {
            "camMat": HO3D_K,
            "handJoints3D": rng.randn(21, 3) * 0.02 + [0.1, 0, -0.5],
            "handPose": (rng.randn(48) * 0.05).astype(np.float64),
            "handTrans": np.array([0.1, 0.0, -0.5]),
            "handBeta": np.zeros(10),
            "objName": HO3D_OBJ,
            "objRot": (np.array([0.2, 0.1, 0.05])
                       * (1 + 0.1 * i)).reshape(3, 1),
            "objTrans": np.array([0.0, 0.0, -0.45]),
        }
        with open(os.path.join(meta, f"{i:04d}.pkl"), "wb") as f:
            pickle.dump(annot, f)
    ycb = os.path.join(root, "local_data", "datasets", "ycbmodels", HO3D_OBJ)
    os.makedirs(ycb, exist_ok=True)
    v, fc = bumpy_potato(obj_subdiv, 0.08, seed=1)
    save_obj(os.path.join(ycb, "textured_simple_2000.obj"), v, fc)
    write_mano_pickle(os.path.join(root, "extra_data", "mano",
                                   "MANO_RIGHT.pkl"), _synthetic_arrays(0))
    return root


HO3D_FRAME_H = 480  # HO-3D's frames are 640 wide, 480 high


def write_evidence_tree(evidence_root, argv, seed=0, device="cuda"):
    """Record, with the port's adapters, one CachedEvidence record for every
    frame of every sample the driver fits with `argv` (fit_video flags; run
    from the root of a write_ho3d_tree tree), as a detector run would leave
    them: the hand and object instance masks of the port's z-buffered
    render at the sized Kf (gtevidence.render_instance_masks), cut to
    HO-3D's 480 x 640 frame, tagged with class_id and hand_side; hand
    estimates in FrankMocap's layout, as the JAX package's tests record
    them: the GT hand's vertices, the rest hand's Procrustes rotation and
    translation onto them, PCA pose, mano_rot, mano_trans and betas zero,
    and the projected vertices with 2 px of noise from
    np.random.RandomState(seed). Returns the instance renders' budgets, one
    per sample."""
    import torch

    from homan_tpu_torch.cli import fit_video
    from homan_tpu_torch.core.mano import mano_forward
    from homan_tpu_torch.data.factory import get_dataset
    from homan_tpu_torch.frontend import gtevidence
    from homan_tpu_torch.frontend.adapters import record_cached_evidence
    from homan_tpu_torch.frontend.cachedfit import frame_key
    args = fit_video.get_args(list(argv))
    ds, image_size = get_dataset(args.dataset, split=args.split,
                                 frame_nb=args.frame_nb,
                                 chunk_step=args.chunk_step,
                                 mano_root=args.mano_root, device=device)
    hand_faces = ds.mano.faces("right").cpu().numpy()
    with torch.no_grad():
        zeros = torch.zeros((1, 48), device=device)
        rest = mano_forward(ds.mano.params["right"], zeros[:, :10],
                            zeros[:, :3], zeros[:, 3:])["verts"][0]
    rest = rest.cpu().numpy()
    rng = np.random.RandomState(seed)
    budgets = []
    for idx in range(args.data_offset, len(ds), args.data_step):
        a = ds[idx]
        hand = np.asarray(a["hands"][0]["verts3d"], np.float32)
        obj = np.asarray(a["objects"][0]["verts3d"], np.float32)
        K = np.asarray(a["camera"]["K"], np.float64)
        (hand_m, obj_m), budget = gtevidence.render_instance_masks(
            [hand, obj], [hand_faces, a["objects"][0]["faces"][0]], K,
            image_size, device=device)
        budgets.append(budget)
        for t, fid in enumerate(a["frame_idxs"]):
            hv = hand[t]
            proj = hv @ K[t].astype(np.float32).T
            uv = proj[:, :2] / proj[:, 2:]
            R, tr = gtevidence.procrustes_rigid(rest, hv)
            mask = hand_m[t, :HO3D_FRAME_H]
            person = {
                "bboxes": gtevidence.mask_to_bbox(mask)[None],
                "cams": np.zeros((1, 3), np.float32),
                "verts": hv[None],
                "verts2d": (uv + rng.randn(*uv.shape) * 2.0).astype(
                    np.float32)[None],
                "rotations": R[None],
                "translations": tr[None, None],
                "mano_pca_pose": np.zeros((1, 16), np.float32),
                "mano_rot": np.zeros((1, 3), np.float32),
                "mano_trans": np.zeros((1, 3), np.float32),
                "mano_betas": np.zeros((1, 10), np.float32),
                "masks": mask[None],
                "hand_side": ["right_hand"],
            }
            record_cached_evidence(evidence_root, frame_key(a["seq_idx"], fid),
                                   person, obj_m[t, :HO3D_FRAME_H])
    return budgets


# Phase 5: the fit_video driver at get_args' defaults (10 frames, 500
# candidates, 50 and 201 steps, rend_size 256) on the synthetic clip, and a
# small clip (3 frames, 24 candidates, 5 and 5 steps, rend_size 64) on the
# card and on the CPU.
CLIP = ["--chunk_step", "4"]
SMALL_CLIP = ["--frame_nb", "3", "--chunk_step", "1"]
SMALL_FIT = ["--num_initializations", "24", "--num_obj_iterations", "5",
             "--num_joint_iterations", "5", "--rend_size", "64"]
DRIVER_ARGV = ["--gt_masks", "1"] + CLIP
SMALL_DRIVER_ARGV = ["--gt_masks", "1"] + SMALL_CLIP + SMALL_FIT
DRIVER_METRICS = ("add-s_obj", "chamfer_dists_obj", "verts_dists_hand",
                  "pen_depths")


def driver_launches(args, budgets):
    """Kernel launches of one driver clip, from the code: every stage-B
    search (find_optimal_poses at its defaults: halving to C // 4 from 64
    candidates on, 35 coarse steps, chunks of 125, the rescore where the
    refinement renders smaller) at stage_b_launches' count; 201 shade
    forwards with residuals and backwards for each stage-C fit of the
    retry ladder; one voxelizer launch for each of the two interaction
    metrics (the fit and its initial state)."""
    from homan_tpu_torch.fit import poseinit
    from homan_tpu_torch.render.rasterizer import RasterSettings
    sb = budgets["stage_b"]
    inits = args.num_initializations
    refine = poseinit._refine_settings(
        RasterSettings(args.rend_size, tile_px=sb["tile_px"]), 0.5)
    one = stage_b_launches(
        args.frame_nb, inits, args.num_obj_iterations, 35, 125,
        max(inits // 4, 16) if inits >= 64 else None,
        refine.image_size != args.rend_size,
        bool(args.stageb_parallel_frames))
    fits = len(budgets["stage_c"]["attempts"])
    out = {k: v * sb["attempts"] for k, v in one.items()}
    for name in ("shade_fwd", "shade_bwd", "prep"):
        out[name] += args.num_joint_iterations * fits
    out["voxelize"] += 2
    return out


def driver_outputs(folder):
    """The files of sample 0 under a result root: (indep, joint state,
    results)."""
    import os
    import pickle
    sample = os.path.join(folder, "samples", "00000000")
    with open(os.path.join(sample, "indep_fit.pkl"), "rb") as f:
        indep = pickle.load(f)
    state = dict(np.load(os.path.join(sample, "joint_fit.npz")))
    with open(os.path.join(sample, "results.pkl"), "rb") as f:
        res = pickle.load(f)
    return indep, state, res


def check_driver_run(label, folder, summary):
    """The driver's gates on one run: its files, a finite and falling loss,
    no edge-budget excess on the kept fit, the instance render's face
    budget covering its demand (the GT-mask path; the cached path renders
    none), stage B's demand within its budget and best IoU >= 0.9, every
    metric finite."""
    import os
    for name in ("indep_fit.pkl", "joint_fit.npz", "results.pkl"):
        check(os.path.exists(os.path.join(folder, "samples", "00000000",
                                          name)), f"{label}: no {name}")
    check(os.path.exists(os.path.join(folder, "results.pkl")),
          f"{label}: no aggregate results.pkl")
    indep, state, res = driver_outputs(folder)
    loss = np.asarray(res["losses"]["loss"])
    check(all(np.isfinite(np.asarray(v, np.float64)).all()
              for v in res["losses"].values()),
          f"{label}: non-finite loss or metric history")
    check(loss[-1] < loss[0], f"{label}: loss did not fall: {loss[0]} -> "
          f"{loss[-1]}")
    check(max(res["losses"]["edge_budget_excess"]) <= 0,
          f"{label}: the kept fit dropped contour edges")
    check(all(np.isfinite(np.asarray(v, np.float64)).all()
              for v in res["metrics"].values()), f"{label}: non-finite "
          "metric")
    check(all(np.isfinite(v).all() for v in state.values()),
          f"{label}: non-finite joint state")
    b = summary["budgets"]
    im, sb = b.get("instance_masks"), b["stage_b"]
    check(im is None or im["faces_per_tile"] >= im["face_demand"][
        im["tile_px"]], f"{label}: instance render Kf {im} below its demand")
    check(sb["edge_demand"] <= sb["edge_capacity"],
          f"{label}: stage B dropped contour edges: {sb}")
    best = indep["object_parameters"][0]["best_iou"]
    check(best >= 0.9, f"{label}: stage B best IoU {best} < 0.9")
    return indep, state, res


def remeasure_instance_budget(torch, args, budget):
    """The instance render's face demand measured again on the clip's GT
    scene (the dataset's hand and object at 256^2, at the tile it ran and
    at the JAX package's tile 64): Kf must cover it at its tile. Also the
    fault the sizing avoids: the same render at the JAX default (tile 64,
    256 faces a tile) against the sized one, hand and object pixels that
    differ over the clip. Returns (demand by tile, face count, {"object",
    "hand": (pixels that differ, pixels of the sized render)})."""
    from homan_tpu_torch.data.factory import get_dataset
    from homan_tpu_torch.render import rasterizer as R
    ds, image_size = get_dataset(args.dataset, split=args.split,
                                 frame_nb=args.frame_nb,
                                 chunk_step=args.chunk_step,
                                 mano_root=args.mano_root, device="cuda")
    a = ds[0]
    hand = np.asarray(a["hands"][0]["verts3d"], np.float32)
    obj = np.asarray(a["objects"][0]["verts3d"], np.float32)
    hand_faces = ds.mano.faces("right").cpu().numpy()
    faces = np.concatenate([hand_faces,
                            np.asarray(a["objects"][0]["faces"][0])
                            + hand.shape[1]])
    K = np.asarray(a["camera"]["K"], np.float64).copy()
    K[:, :2] /= image_size
    dev = torch.device("cuda")
    verts = torch.from_numpy(np.concatenate([hand, obj], 1)).to(dev)
    Kt = torch.from_numpy(K.astype(np.float32)).to(dev)
    demand = {}
    for tp in sorted({budget["tile_px"], 64}):
        st = R.RasterSettings(256, tile_px=tp, faces_per_tile=1 << 20)
        demand[tp] = R.check_face_budget(verts, faces, Kt, st)["max_demand"]
    check(demand[budget["tile_px"]] <= budget["faces_per_tile"],
          f"instance render: demand {demand} above Kf {budget}")
    colors = torch.zeros((len(faces), 3), device=dev)
    colors[:len(hand_faces), 0] = 1.0
    colors[len(hand_faces):, 1] = 1.0
    masks = []
    for tp, kf in ((budget["tile_px"], budget["faces_per_tile"]), (64, 256)):
        rgb = R.rasterize_hard(
            verts, faces, Kt, colors, R.RasterSettings(
                256, tile_px=tp, faces_per_tile=kf), background=0.0,
            ambient=1.0, diffuse=0.0, specular=0.0, shading="flat")["rgb"]
        masks.append(rgb > 0.5)
    lost = {name: (int((masks[0][..., c] != masks[1][..., c]).sum()),
                   int(masks[0][..., c].sum()))
            for name, c in (("hand", 0), ("object", 1))}
    return demand, len(faces), lost


def capture_driver_inputs(torch, prefix="driver"):
    """A context manager recording, while the driver (or `prefix`'s path)
    runs, the first inputs of each distinct shape it hands the kernels: the
    shade pair's through rasterizer.shade_prep (keyed by batch, tiles,
    image size, tile, Ke, the mesh's edge count and whether the render
    takes a gradient) and the voxelizer's through sdf.build_scene_sdfs
    (keyed by mesh batch, faces and grid). Yields {"shade": {name: (verts,
    topo, K, settings)}, "voxelize": {name: (verts, faces, grid)}}; records
    launch nothing."""
    import contextlib

    from homan_tpu_torch.interactions import sdf as S
    from homan_tpu_torch.render import rasterizer as R

    @contextlib.contextmanager
    def capture():
        got = {"shade": {}, "voxelize": {}}
        prep, build = R.shade_prep, S.build_scene_sdfs

        def record_prep(verts, topo, K, settings):
            grad = torch.is_grad_enabled() and verts.requires_grad
            S_, tp = settings.image_size, settings.tile_px
            E = int(topo.edges.shape[0])
            name = (f"{prefix} B{verts.shape[0]} T{(S_ // tp) ** 2} {S_}px "
                    f"tile{tp} Ke{min(settings.edges_per_tile, E)} E{E} "
                    + ("fwd+bwd" if grad else "fwd_only"))
            got["shade"].setdefault(name, (verts.detach().clone(), topo,
                                           K.detach().clone(), settings))
            return prep(verts, topo, K, settings)

        def record_build(verts_list, faces_list, grid_size=32, **kw):
            for v, f in zip(verts_list, faces_list):
                name = (f"{prefix} metrics B{v.shape[0]} F{f.shape[0]} "
                        f"G{grid_size}")
                got["voxelize"].setdefault(name, (v.detach().clone(), f,
                                                  grid_size))
            return build(verts_list, faces_list, grid_size, **kw)

        R.shade_prep, S.build_scene_sdfs = record_prep, record_build
        try:
            yield got
        finally:
            R.shade_prep, S.build_scene_sdfs = prep, build

    return capture()


def driver_kernel_checks(torch, got):
    """Each kernel against its plain version, timed, at every input shape
    the driver's run handed it (capture_driver_inputs). Returns (shade rows,
    voxelizer rows) by name."""
    from homan_tpu_torch.render import rasterizer as R
    shade_rows = {}
    for name, (verts, topo, K, settings) in sorted(got["shade"].items()):
        with torch.no_grad():
            seg, anc, _, static = R.shade_prep(verts, topo, K, settings)
        shade_rows[name] = compare_kernels(torch, name, seg, anc, static,
                                           timed=True)
        shade_rows[name]["fwd_only"] = name.endswith("fwd_only")
    vox_rows = {name: compare_voxelize(torch, name, v, f, g, timed=True)[0]
                for name, (v, f, g) in sorted(got["voxelize"].items())}
    return shade_rows, vox_rows


VIZ_WARNINGS = ("visualization failed", "viz_step render failed")


def logged_warnings(name):
    """A context manager collecting (and printing) the WARNING records of
    logger `name` while it is open; yields the list of messages."""
    import contextlib
    import logging

    class Collect(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            got.append(msg)
            print(f"[{name}] WARNING {msg}", flush=True)

    @contextlib.contextmanager
    def collect():
        handler = Collect(level=logging.WARNING)
        log = logging.getLogger(name)
        log.addHandler(handler)
        try:
            yield got
        finally:
            log.removeHandler(handler)

    got = []
    return collect()


def decode_media(path):
    """The frames of an image or video the overlays wrote, as a list of
    (H, W, 3) arrays: the port's own PNG and APNG files with its reader,
    other PNGs (matplotlib's) with PIL, webm and mp4 with cv2."""
    from homan_tpu_torch.viz import render_viz
    if path.endswith((".png", ".apng")):
        try:
            return render_viz.read_apng(path)
        except ValueError:  # a PNG of another writer (matplotlib's)
            from PIL import Image, ImageSequence
            return [np.asarray(f.convert("RGB"))
                    for f in ImageSequence.Iterator(Image.open(path))]
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def check_overlays(label, summary, args, warnings):
    """The driver's overlay gates: no render warning; final_points.png,
    final_points.<webm|apng> (one frontal | top-down frame for each of the
    first five frames, 256 x 512) and, with --viz_step, optim_evolution.
    <webm|apng> (the initial frame, a snapshot every viz_step steps of the
    kept fit, the final frame, 256^2), each decoding to those frames; every
    render's face budget covering its demand; the viz timers. Returns a
    record: the files' formats, frame counts, the demand, and where the JAX
    package's budget of min(2048, F + 64) faces a 64-pixel tile would drop
    faces."""
    import os
    bad = [w for w in warnings if w.startswith(VIZ_WARNINGS)]
    check(not bad, f"{label}: a render failed: {bad}")
    files = {os.path.basename(p): p for p in summary["viz_files"]}
    n = min(5, args.frame_nb)
    snaps = (len(range(args.viz_step, args.num_joint_iterations,
                       args.viz_step)) if args.viz_step else 0)
    want = {"final_points": (n, (256, 512, 3))}
    if snaps:
        want["optim_evolution"] = (snaps + 2, (256, 256, 3))
    videos = {name.split(".")[0]: name for name in files
              if name != "final_points.png"}
    check("final_points.png" in files and set(videos) == set(want)
          and all(name.endswith((".webm", ".apng"))
                  for name in videos.values()),
          f"{label}: overlays {sorted(files)}")
    out = {"files": {}}
    for name, path in sorted(files.items()):
        check(os.path.getsize(path) > 0, f"{label}: {path} is empty")
        frames = decode_media(path)
        shape = tuple(frames[0].shape) if frames else None
        out["files"][name] = {"frames": len(frames), "shape": shape}
        if name == "final_points.png":
            check(len(frames) == 1, f"{label}: {path} holds {len(frames)} "
                  "images")
            continue
        stem = name.split(".")[0]
        check((len(frames), shape) == want[stem], f"{label}: {path} decodes "
              f"to {len(frames)} frames of {shape}, expected {want[stem]}")
    budgets = summary["viz_budgets"]
    fits = len(summary["budgets"]["stage_c"]["attempts"])
    check(len(budgets) == 2 * snaps * fits + 4, f"{label}: {len(budgets)} "
          f"overlay renders, expected {2 * snaps * fits + 4}")
    for b in budgets:
        check(b["faces_per_tile"] >= b["face_demand"][b["tile_px"]],
              f"{label}: overlay render Kf below its demand: {b}")
    d64 = max(b["face_demand"][64] for b in budgets)
    jax_kf = min(2048, budgets[0]["faces"] + 64)
    for key in ("viz_step_snapshots", "viz_final"):
        check(key in summary["timers"] or (key == "viz_step_snapshots"
                                           and not snaps),
              f"{label}: no {key} timer")
    out.update({"renders": len(budgets), "faces": budgets[0]["faces"],
                "tile_px": sorted({b["tile_px"] for b in budgets}),
                "kf_max": max(b["faces_per_tile"] for b in budgets),
                "demand_at_tile64_max": d64, "jax_kf_at_tile64": jax_kf,
                "jax_budget_drops_faces": d64 > jax_kf})
    print(f"{label} overlays: " + json.dumps(out), flush=True)
    return out


def driver_run(torch, argv, label, folder, capture=False, profile=False):
    """One fit_video run at `argv` (from the working folder, results in
    `folder`) with the launch counts set to 0 just before it and read just
    after, held to the path's count (driver_launches); its wall and stage
    timers printed; the driver's gates (check_driver_run) and its overlays'
    (check_overlays; the driver's warnings are collected). `capture`
    records the kernels' inputs (capture_driver_inputs); `profile` runs it
    in one torch.profiler window (profile_clip) instead of timing it.
    Returns (record, args, summary, results, captured inputs or None,
    profile window or None)."""
    import contextlib

    from homan_tpu_torch.cli import fit_video
    args = fit_video.get_args(argv + ["--result_root", folder])
    window = wall = None
    reset_counts()
    with (capture_driver_inputs(torch) if capture
          else contextlib.nullcontext()) as got, \
            logged_warnings(fit_video.logger.name) as warnings:
        if profile:
            ran = []
            window = profile_clip(torch, lambda: ran.append(
                fit_video.main(args, device="cuda")), label)
            summary = ran[0]
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = fit_video.main(args, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(summary) == 1, f"{label}: {len(summary)} samples")
    summary = summary[0]
    expect = driver_launches(args, summary["budgets"])
    print(f"{label}: " + (f"{wall:.3f} s a clip" if wall else "profiled")
          + "; launches " + json.dumps(counts), flush=True)
    for name, sec in sorted(summary["timers"].items(),
                            key=lambda kv: -kv[1]):
        print(f"{label} timer {name}: {sec:.3f} s"
              + (f" ({sec / wall:.1%})" if wall else ""), flush=True)
    check(counts == expect, f"{label}: launches {counts}, the path's count "
          f"is {expect}")
    indep, _, res = check_driver_run(label, folder, summary)
    overlays = check_overlays(label, summary, args, warnings)
    record = {"wall_s": wall, "timers": summary["timers"],
              "launches": counts, "overlays": overlays,
              "best_iou": indep["object_parameters"][0]["best_iou"],
              "loss": [res["losses"]["loss"][0], res["losses"]["loss"][-1]]}
    return record, args, summary, res, got, window


def small_driver_pair(argv, label):
    """The small clip at `argv` on the card and on the CPU (plain versions)
    from the same inputs: the card's launches the path's count, none on the
    CPU, the joint states within 3e-3 of each array's maximum. Returns
    ({"cuda", "cpu": (indep, joint state, results)}, the relative errors)."""
    from homan_tpu_torch.cli import fit_video
    small = {}
    for d in ("cuda", "cpu"):
        folder = f"{label.replace(' ', '_')}_{d}"
        args = fit_video.get_args(argv + ["--result_root", folder])
        reset_counts()
        t0 = time.perf_counter()
        summary = fit_video.main(args, device=d)[0]
        counts = read_counts()
        print(f"{label} on {d}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        expect = (driver_launches(args, summary["budgets"]) if d == "cuda"
                  else dict.fromkeys(counts, 0))
        check(counts == expect, f"{label}: {d} launches {counts}, expected "
              f"{expect}")
        small[d] = driver_outputs(folder)
    cs = small["cpu"][1]
    err = {k: float(np.abs(small["cuda"][1][k] - cs[k]).max()
                    / max(np.abs(cs[k]).max(), 1e-30)) for k in cs}
    print(f"{label}, card vs CPU plain path: joint state max rel err "
          + json.dumps(err), flush=True)
    check(max(err.values()) <= 3e-3, f"{label}: card and CPU joint states "
          f"differ: {err}")
    return small, err


def driver_phase(torch, root):
    """Phase 5: the fit_video driver, --gt_masks 1 at get_args' defaults,
    twice on the synthetic HO-3D clip written under `root` (the second
    run's results stay in root/run1 for phase 7), with the launch counts
    read around each run; each kernel against its plain version at every
    shape the second run handed it; then the small clip on the card and on
    the CPU. Returns the result dict, the second run's launch counts and
    the kernel rows at the driver's shapes (shade, voxelizer)."""
    import os

    out = {}
    cwd = os.getcwd()
    write_ho3d_tree(root, frames=40)
    os.chdir(root)
    try:
        runs = []
        for i in range(2):
            record, args, summary, res, got, _ = driver_run(
                torch, DRIVER_ARGV, f"driver run {i + 1}", f"run{i}",
                capture=i == 1)
            runs.append(record)
        counts = record["launches"]
        shade_rows, vox_rows = driver_kernel_checks(torch, got)
        check(any(not r["fwd_only"] for r in shade_rows.values())
              and any(r["fwd_only"] for r in shade_rows.values())
              and vox_rows, "driver: no kernel inputs captured: "
              f"{sorted(shade_rows)} {sorted(vox_rows)}")
        remeasured, n_faces, lost = remeasure_instance_budget(
            torch, args, summary["budgets"]["instance_masks"])
        metrics = {}
        for k in DRIVER_METRICS:
            for key in (k, k + "_init"):
                metrics[key] = float(np.mean(res["metrics"][key]))
        b = summary["budgets"]
        print("driver budgets: " + json.dumps(
            {"instance_masks": b["instance_masks"],
             "instance_demand_remeasured": remeasured,
             "instance_faces": n_faces,
             "jax_default_kf_overflows": remeasured[64] > 256,
             "jax_default_pixels_differing_of_sized": lost,
             "stage_b": b["stage_b"], "stage_c": b["stage_c"]}),
            flush=True)
        print("driver metrics (means over the clip's frames): "
              + json.dumps(metrics), flush=True)
        out = {"runs": runs, "budgets": b, "metrics": metrics,
               "instance_demand_remeasured": remeasured,
               "jax_default_pixels_differing_of_sized": lost}

        # The small clip on the card and on the CPU.
        small, err = small_driver_pair(SMALL_DRIVER_ARGV, "small driver")
        (gi, _, _), (ci, _, _) = small["cuda"], small["cpu"]
        masks = [("hand", gi["person_parameters"]["masks"],
                  ci["person_parameters"]["masks"])] + [
            (f"object {t}", g["masks"], c["masks"]) for t, (g, c) in
            enumerate(zip(gi["object_parameters"],
                          ci["object_parameters"]))]
        diff = {name: int((np.asarray(g) != np.asarray(c)).sum())
                for name, g, c in masks}
        total = sum(int(np.asarray(c).sum()) for _, _, c in masks)
        print(f"small driver: instance-mask pixels that differ "
              f"{json.dumps(diff)} of {total} mask pixels", flush=True)
        check(sum(diff.values()) <= 1e-3 * total, f"small driver: "
              f"instance masks differ on {diff} pixels")
        out["card_vs_cpu"] = {"state_rel_err": err,
                              "mask_pixels_differing": diff,
                              "mask_pixels": total}
        out["frames_sharded_flag"] = sharded_driver_check(torch,
                                                          small["cuda"])
    finally:
        os.chdir(cwd)
    return out, counts, shade_rows, vox_rows


def cached_phase(torch):
    """Phase 6: the fit_video driver with --evidence_root at get_args'
    defaults on the synthetic HO-3D clip, from the evidence
    write_evidence_tree records with the port's adapters: twice, the launch
    counts read around each run and held to the path's count; each kernel
    against its plain version at every shape the second run handed it; a
    third run in one torch.profiler window (device busy and idle share);
    then the small clip on the card and on the CPU. Returns the result
    dict, the second run's launch counts and the kernel rows at this path's
    shapes (shade, voxelizer)."""
    import os
    import tempfile

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        write_ho3d_tree(root, frames=40)
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            ev_budgets = write_evidence_tree("ev", CLIP, device="cuda")
            print(f"cached evidence: {len(ev_budgets)} clip(s) recorded in "
                  f"{time.perf_counter() - t0:.3f} s; instance render "
                  + json.dumps(ev_budgets), flush=True)
            # Two timed runs, the second's kernel inputs recorded, then a
            # third in one profiler window (device busy and idle share).
            runs, got, window = [], None, None
            for i in range(3):
                record, args, summary, res, got_i, win = driver_run(
                    torch, CLIP + ["--evidence_root", "ev"],
                    f"cached driver run {i + 1}", f"cached{i}",
                    capture=i == 1, profile=i == 2)
                check("instance_masks" not in summary["budgets"],
                      "cached driver: it rendered instance masks")
                runs.append(record)
                got, window = got_i or got, win or window
            t0 = time.perf_counter()
            shade_rows, vox_rows = driver_kernel_checks(torch, got)
            print(f"cached driver: kernel checks in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            check(any(not r["fwd_only"] for r in shade_rows.values())
                  and any(r["fwd_only"] for r in shade_rows.values())
                  and vox_rows, "cached driver: no kernel inputs captured: "
                  f"{sorted(shade_rows)} {sorted(vox_rows)}")
            metrics = {key: float(np.mean(res["metrics"][key]))
                       for k in DRIVER_METRICS for key in (k, k + "_init")}
            b = summary["budgets"]
            print("cached driver budgets: " + json.dumps(
                {"stage_b": b["stage_b"], "stage_c": b["stage_c"]}),
                flush=True)
            print("cached driver metrics (means over the clip's frames): "
                  + json.dumps(metrics), flush=True)
            out = {"runs": runs, "budgets": b, "metrics": metrics,
                   "evidence_instance_render": ev_budgets,
                   "profiled": window}

            # The small clip on the card and on the CPU, on one evidence
            # tree.
            write_evidence_tree("ev_small", SMALL_CLIP, device="cuda")
            small, err = small_driver_pair(
                SMALL_CLIP + SMALL_FIT + ["--evidence_root", "ev_small"],
                "small cached driver")
            iou = [float(small[d][0]["object_parameters"][0]["best_iou"])
                   for d in ("cuda", "cpu")]
            print(f"small cached driver: best IoU {iou}", flush=True)
            out["card_vs_cpu"] = {"state_rel_err": err, "best_iou": iou}
        finally:
            os.chdir(cwd)
    return out, runs[1]["launches"], shade_rows, vox_rows


# Phase 7: the HO-3D evaluation (cli/eval_ho3d.py) of phase 5's results.
EVAL_ARGV = ["--results_root", "run1", "--split", "val", "--dump_codalab",
             "--report", "--render_videos"]
EVAL_BATCH = 64  # eval_ho3d's frames per metric call


def eval_phase(torch, root, frames):
    """Phase 7: eval_ho3d.main over the results tree phase 5's second run
    left in root/run1, on the dataset it fitted (the synthetic tree,
    `frames` full-rate frames), with --dump_codalab, --report and
    --render_videos: launch counts set to 0 just before and read just
    after (the voxelizer once a batch of up to 64 frames: the interaction
    metrics voxelize the object; nothing else launches a kernel); gates:
    every summary metric finite, pred.json one entry per full-rate frame,
    the HTML and the videos exist and decode; the voxelizer held against
    its plain version and timed at every batch shape the evaluation handed
    it. Returns the result dict, the launch counts and the voxelizer rows
    (the kernels line's `eval` keys)."""
    import glob
    import os

    from homan_tpu_torch.cli import eval_ho3d
    cwd = os.getcwd()
    os.chdir(root)
    try:
        args = eval_ho3d.get_args(EVAL_ARGV)
        reset_counts()
        with capture_driver_inputs(torch, "eval") as got:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = eval_ho3d.main(args, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        expect = dict.fromkeys(counts, 0)
        expect["voxelize"] = -(-frames // EVAL_BATCH)
        print(f"evaluation: {wall:.3f} s; launches " + json.dumps(counts),
              flush=True)
        check(counts == expect, f"evaluation: launches {counts}, the "
              f"path's count is {expect}")
        check(summary and all(np.isfinite(v) for v in summary.values()),
              f"evaluation: summary {summary}")
        with open("run1/pred.json") as fh:
            joints, verts = json.load(fh)
        check(len(joints) == len(verts) == frames, f"evaluation: pred.json "
              f"holds {len(joints)} / {len(verts)} entries, not {frames}")
        check(np.asarray(joints[0]).shape == (21, 3)
              and np.asarray(verts[0]).shape == (778, 3),
              "evaluation: pred.json entry shapes")
        for name in ("pred.zip", "report.html", "eval_report.html",
                     "eval_metrics.pkl"):
            check(os.path.exists(os.path.join("run1", name)),
                  f"evaluation: no {name}")
        videos = {}
        for path in sorted(glob.glob("run1/test_vids/*")):
            decoded = decode_media(path)
            videos[os.path.basename(path)] = {
                "frames": len(decoded),
                "shape": tuple(decoded[0].shape) if decoded else None}
        want = {"rot": (12, (128, 128, 3)),
                "seq": (min(frames, 60), (128, 128, 3))}
        check(sorted(v.split("_")[0] for v in videos) == ["rot", "seq"],
              f"evaluation: videos {sorted(videos)}")
        for name, v in videos.items():
            check((v["frames"], v["shape"]) == want[name.split("_")[0]],
                  f"evaluation: {name} decodes to {v}")
        vox_rows = {name: compare_voxelize(torch, name, v, f, g,
                                           timed=True)[0]
                    for name, (v, f, g) in sorted(got["voxelize"].items())}
        check(vox_rows, "evaluation: no voxelizer input captured")
        print("evaluation summary: " + json.dumps(summary), flush=True)
        out = {"wall_s": wall, "launches": counts, "summary": summary,
               "pred_entries": len(joints), "videos": videos,
               "full_rate_frames": frames}
    finally:
        os.chdir(cwd)
    return out, counts, vox_rows


def tritri_launches(iters, hand_nb, lw):
    """Kernel launches of a stage-C fit with collision_mode "tritri" (grid
    SDF), from the code: the tritri term launches no kernel of the port
    (plain PyTorch); the SDF terms run for contact alone, voxelizing each
    hand and the object every step (build_interaction_grids), and not at
    all when lw_contact is 0; one shade pair a step."""
    vox = (hand_nb + 1) * iters if lw.get("lw_contact", 0) > 0 else 0
    return {"voxelize": vox, "shade_fwd": iters, "shade_bwd": iters,
            "depth_fwd": 0, "depth_bwd": 0, "prep": iters}


def tritri_phase(torch, joint, scene, roi, cfg, step_sdf, small,
                 small_set):
    """Phase 8: bench_config3's scene (10 frames, 400 steps, 256^2, collision
    1e-3 and contact 1, grid SDF) with collision_mode "tritri": twice,
    counts set to 0 just before each run and read just after
    (tritri_launches), loss finite and falling, no edge overflow; a 10-step
    profiler window of the fit and one of the tritri term alone (forward
    and backward at the fit's initial poses), its share of the step's
    device time; a small fit on the card and on the CPU (states within
    3e-3). Returns the result dict and the second run's counts."""
    import dataclasses

    from homan_tpu_torch.fit import model as M
    from homan_tpu_torch.interactions import intersect
    kw = dict(cfg=cfg, loss_weights=LW_INTER,
              closed_hand_faces=scene.closed_hand_faces)
    expect = tritri_launches(ITERS2, cfg.hand_nb, LW_INTER)
    walls, counts, hist, _ = timed_fit_pair(
        torch, joint, scene, roi, ITERS2, "tritri fit", expect, **kw)
    check("loss_collision" in hist and "loss_contact" in hist,
          f"tritri fit: terms {sorted(hist)}")
    step = profile_steps(torch, joint, scene, roi, 10, "tritri fit", **kw)
    # The tritri term alone at the fit's shapes: forward and backward.
    with torch.no_grad():
        vo, _ = M.get_verts_object(scene.init_state, scene.consts)
        vh, _ = M.get_verts_hand(scene.init_state, scene.consts, scene.cfg)
    hf = torch.as_tensor(scene.closed_hand_faces, device="cuda")
    of = scene.consts.faces_object.faces

    def term():
        h = vh.detach().clone().requires_grad_(True)
        intersect.compute_collision_loss_tritri(h, hf, vo, of,
                                                cfg.hand_nb).backward()

    torch.cuda.reset_peak_memory_stats()
    alone = profile_window(torch, lambda: [term() for _ in range(10)], 10,
                           "tritri term alone")
    alone["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    share = alone["device_busy_ms_per_step"] / step["device_busy_ms_per_step"]
    pairs = (vo.shape[0] * cfg.hand_nb * int(hf.shape[0])
             * int(of.shape[0]))
    busy = alone["device_busy_ms_per_step"]
    print(f"tritri fit: the tritri term takes {busy:.4f} ms of device "
          f"time a step, {share:.3f} of the fit's "
          f"{step['device_busy_ms_per_step']:.4f} (step-wise "
          f"{step['device_busy_ms_per_step'] - step_sdf:+.4f} ms against "
          f"the SDF-collision fit); {pairs} triangle pairs a step, chunks "
          f"of {intersect.PAIR_CHUNK}", flush=True)
    # Small fits on the card and on the CPU from the same inputs.
    small_cfg = dataclasses.replace(small.cfg, sdf_mode="grid",
                                    collision_mode="tritri")
    rel, state_err = small_fit_pair(
        torch, joint, small, small_set, 3, "small tritri fit",
        tritri_launches(3, small_cfg.hand_nb, LW_INTER), states=True,
        cfg=small_cfg, loss_weights=LW_INTER,
        closed_hand_faces=small.closed_hand_faces)
    loss = hist["loss"]
    return {"frames": FRAMES2, "iters": ITERS2, "sdf_mode": "grid",
            "collision_mode": "tritri", "first_wall_s": walls[0],
            "second_wall_s": walls[1],
            "ms_per_step": walls[1] / ITERS2 * 1e3, "launches": counts,
            "loss": [float(loss[0]), float(loss[-1])],
            "loss_collision": [float(hist["loss_collision"][0]),
                               float(hist["loss_collision"][-1])],
            "profiled": step, "tritri_alone": alone,
            "tritri_device_share": share, "pairs_per_step": pairs,
            "pair_chunk": intersect.PAIR_CHUNK,
            "card_vs_cpu": {"loss_rel_err": rel,
                            "state_rel_err": state_err}}, counts


# Phase 9 (parallel/): bench.py bench_multiclip's full preset, 4 clips x
# 10 frames x 400 steps at 256^2, tile 128 (bench.py:185-217, 791); the
# frame-sharded fit of one 8-frame two-hand clip over 2 entries of the card.
CLIPS9, FRAMES9, ITERS9, CHECK_ITERS9 = 4, 10, 400, 50
SHARD_FRAMES9, SHARD_ITERS9, SHARD_ENTRIES9 = 8, 50, 2

_MULTIHOST_WORKER = """
import json, sys
from homan_tpu_torch.parallel import multihost
pid, coord = int(sys.argv[1]), sys.argv[2]
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid)
idxs = multihost.host_sample_indices(total=10)
got = multihost.allgather_metrics({"metric": [100.0 * pid + i
                                              for i in idxs],
                                   "count": [float(len(idxs))]})
print(json.dumps({"idxs": list(map(int, idxs)),
                  "metric": [float(x) for x in got["metric"]],
                  "count": [float(x) for x in got["count"]]}))
import torch.distributed as dist
dist.destroy_process_group()
"""


def multihost_check():
    """parallel/multihost.py in two processes over gloo (localhost): the
    sample indices split disjointly and completely, and both processes
    gather both processes' metrics. Every process is stopped."""
    import os
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST_WORKER, str(pid),
         f"localhost:{port}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            check(p.returncode == 0, f"multihost worker failed: {err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    idxs = sorted(outs[0]["idxs"] + outs[1]["idxs"])
    check(idxs == list(range(10)) and not set(outs[0]["idxs"])
          & set(outs[1]["idxs"]), f"multihost: indices {outs}")
    check(outs[0]["metric"] == outs[1]["metric"]
          and len(outs[0]["metric"]) == 10
          and sorted(outs[0]["count"]) == [5.0, 5.0],
          f"multihost: allgather {outs}")
    print("multihost (2 processes, gloo): " + json.dumps(outs), flush=True)
    return {"indices": [o["idxs"] for o in outs], "ok": True}


# Phase 9 (g): the headline clip (bench_joint: 30 frames, 256^2, tile 128)
# with its frames over a mesh of two processes sharing the card, one entry
# each (15 frames a process), gloo.
PROCS9, PROC_ITERS9 = 2, 50

_FRAMES_WORKER = """
import datetime, json, sys, time
import torch
import torch.distributed as dist
import chip_smoke as cs
from homan_tpu_torch.parallel import frames as fpar
from homan_tpu_torch.parallel import multihost
from homan_tpu_torch.render import rasterizer as R
from homan_tpu_torch.fit import model as M

pid, coord, scene_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4])
multihost.initialize(coord, 2, pid, timeout=datetime.timedelta(minutes=3))
sc = torch.load(scene_path, map_location="cuda", weights_only=False)
state, consts, cfg, settings, iters = (sc["state"], sc["consts"], sc["cfg"],
                                       sc["settings"], sc["iters"])
mesh = fpar.make_frame_mesh()
cs.check(mesh.size == 2 and len(mesh.devices) == 1,
         f"frame mesh {mesh}")

# Host time in the collectives: synchronize, the call, synchronize.
spent = [0.0, 0]


def timed(fn):
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out
    return run


def fit():
    cs.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = fpar.fit_frames_sharded(state, consts, cfg, mesh,
                                          num_iterations=iters,
                                          roi_settings=settings)
    torch.cuda.synchronize()
    return final, hist, time.perf_counter() - t0, cs.read_counts()


_, _, wall_first, counts_first = fit()
final, hist, wall, counts = fit()
names = ("all_gather_into_tensor", "all_reduce")
plain = {n: getattr(dist, n) for n in names}
for n in names:
    setattr(dist, n, timed(plain[n]))
_, _, wall_timed, counts_timed = fit()
for n in names:
    setattr(dist, n, plain[n])

# The shade pair at this process's shape, against its plain version.
shard_state, shard_consts = (x[0] for x in fpar.shard_frames(state, consts,
                                                             mesh))
with torch.no_grad():
    v, _ = M.get_verts_object(shard_state, shard_consts)
    seg, anc, _, static = R.shade_prep(v, shard_consts.faces_object,
                                       shard_consts.camintr_rois_object,
                                       settings)
pair = cs.compare_kernels(torch, f"frames-process-{pid}", seg, anc, static,
                          timed=False)
dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                           "homan_tpu"))
cs.check(not bad, f"a frames worker loaded {bad}")
torch.save({"final": {k: None if t is None else t.cpu()
                      for k, t in vars(final).items()},
            "hist": {k: t.cpu() for k, t in hist.items()}}, out_path)
print(json.dumps({
    "pid": pid, "frames": int(seg.shape[0]), "first_wall_s": wall_first,
    "wall_s": wall, "wall_timed_s": wall_timed, "counts": counts,
    "counts_first": counts_first, "counts_timed": counts_timed,
    "collective_s": spent[0],
    "collective_calls": spent[1], "sil_err": pair["sil_err"],
    "gseg_err": pair["gseg_err"]}))
"""


def frames_process_check(torch, joint, scene, settings):
    """Phase 9 (g): the headline clip's frames over two processes sharing
    the card (multihost gloo, one entry each), PROC_ITERS9 steps. Each
    worker fits three times, counts set to 0 just before each run and read
    just after: a first run, the measured run (its results and wall), and
    a run with host time taken around every collective (synchronize before
    and after); then it holds the shade pair at its 15-frame shape against
    the plain version. Gates: the ranks' final
    states and loss histories bit-equal, each within 3e-3 of the unsharded
    card fit at the same steps, the shade pair PROC_ITERS9 times a run in
    each process. A worker failure fails the phase; every process is
    stopped."""
    import os
    import socket
    import tempfile
    from homan_tpu_torch.fit import model as M

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single, h1 = joint.optimize_hand_object(
        scene.init_state, scene.consts, scene.cfg,
        num_iterations=PROC_ITERS9, roi_settings=settings, device="cuda")
    torch.cuda.synchronize()
    wall_un = time.perf_counter() - t0
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "scene.pt")
        torch.save({"state": scene.init_state, "consts": scene.consts,
                    "cfg": scene.cfg, "settings": settings,
                    "iters": PROC_ITERS9}, scene_path)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=repo)
        outs = [os.path.join(tmp, f"out{pid}.pt") for pid in range(PROCS9)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _FRAMES_WORKER, str(pid),
             f"localhost:{port}", scene_path, outs[pid]], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(PROCS9)]
        reports = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                check(p.returncode == 0,
                      f"frames worker failed: {err[-3000:]}")
                for line in out.strip().splitlines()[:-1]:
                    print(f"  [frames worker] {line}", flush=True)
                reports.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                p.kill()
        wall_workers = time.perf_counter() - t0
        results = [torch.load(o, weights_only=False) for o in outs]
    expect = {"shade_fwd": PROC_ITERS9, "shade_bwd": PROC_ITERS9,
              "depth_fwd": 0, "depth_bwd": 0, "voxelize": 0,
              "shade_fwd_only": 0, "prep": PROC_ITERS9}
    for r in reports:
        for key in ("counts_first", "counts", "counts_timed"):
            check(r[key] == expect, f"frames over processes: rank "
                  f"{r['pid']} launches {r[key]}, the path's count is "
                  f"{expect}")
    a, b = results
    for k, t in a["final"].items():
        check((t is None and b["final"][k] is None) or torch.equal(
            t, b["final"][k]), f"frames over processes: ranks differ in {k}")
    for k, t in a["hist"].items():
        check(torch.equal(t, b["hist"][k]),
              f"frames over processes: ranks' histories differ in {k}")
    final = M.HomanState(**a["final"])
    err = state_rel_err(final, single)
    loss_err = float(((a["hist"]["loss"] - h1["loss"].cpu()).abs()
                      / h1["loss"].cpu().abs()).max())
    check(max(err.values()) <= 3e-3 and loss_err <= 3e-3,
          f"frames over processes differ from the unsharded fit: loss "
          f"{loss_err}, states {err}")
    check(float(a["hist"]["edge_budget_excess"].max()) <= 0,
          "frames over processes: edge budget overflowed")
    walls = [r["wall_s"] for r in reports]
    coll = [r["collective_s"] for r in reports]
    rec = {
        "frames": FRAMES, "processes": PROCS9, "iters": PROC_ITERS9,
        "frames_per_process": reports[0]["frames"],
        "sharded_ms_per_step": [w / PROC_ITERS9 * 1e3 for w in walls],
        "sharded_timed_ms_per_step": [r["wall_timed_s"] / PROC_ITERS9 * 1e3
                                      for r in reports],
        "unsharded_ms_per_step": wall_un / PROC_ITERS9 * 1e3,
        "collective_ms_per_step": [c / PROC_ITERS9 * 1e3 for c in coll],
        "collective_calls_per_step": reports[0]["collective_calls"]
        / PROC_ITERS9,
        "workers_wall_s": wall_workers, "launches": reports[0]["counts"],
        "loss_max_rel_err": loss_err, "state_max_rel_err": max(err.values()),
        "shade_pair_sil_err": [r["sil_err"] for r in reports],
        "shade_pair_gseg_err": [r["gseg_err"] for r in reports]}
    print(f"frames over {PROCS9} processes, 1 card ({FRAMES} frames, "
          f"{reports[0]['frames']} a process, {PROC_ITERS9} steps): sharded "
          f"{rec['sharded_ms_per_step']} ms/step, unsharded "
          f"{rec['unsharded_ms_per_step']:.3f} ms/step; collectives "
          f"{rec['collective_ms_per_step']} ms/step "
          f"({rec['collective_calls_per_step']:g} calls a step, host clock "
          f"after synchronize, a run of its own: "
          f"{rec['sharded_timed_ms_per_step']} ms/step); ranks bit-equal; "
          f"vs unsharded loss {loss_err:.3g}, state {max(err.values()):.3g}"
          f"; launches " + json.dumps(reports[0]["counts"]), flush=True)
    return rec


def state_rel_err(a, b):
    """Each field's max |a - b| over the max |b|."""
    return {k: float((getattr(a, k).cpu() - v.cpu()).abs().max()
                     / max(float(v.abs().max()), 1e-30))
            for k, v in vars(b).items() if v is not None}


def parallel_phase(torch, headline_launches, headline_scene,
                   headline_settings):
    """Phase 9: parallel/ on the card. (a) the batched clip fit at
    bench_multiclip's full preset twice, counts read around each run: the
    shade pair launches once a step, each clip's loss finite and falling,
    no edge excess; a 10-step profiler window; (b) each clip after 50
    steps against its own single-clip card fit (within 3e-3), the walls
    per clip side by side; (c) heterogeneous buckets: two objects padded by
    pad_mesh, 5 batched steps, the shade and voxelizer outputs on the
    padded meshes against the unpadded; (d) fit_frames_sharded over 2
    entries of the card against the unsharded fit; (e) multihost in two
    processes; (f) entry.dryrun_multichip(4); (g) the headline clip's
    frames over two processes (frames_process_check). Returns (record,
    counts of the second batched run)."""
    import dataclasses

    from homan_tpu_torch import entry
    from homan_tpu_torch.core.mano import ManoLayer
    from homan_tpu_torch.core.meshes import bumpy_potato, pad_mesh
    from homan_tpu_torch.fit import joint
    from homan_tpu_torch.fit import model as M
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
    from homan_tpu_torch.interactions import voxelize as V
    from homan_tpu_torch.parallel import clips as par
    from homan_tpu_torch.parallel import frames as fpar
    from homan_tpu_torch.render import rasterizer as R

    out = {}
    layer = ManoLayer.synthetic(0, device="cuda")
    obj = bumpy_potato(3, 0.08, seed=0)
    scenes = [make_synthetic_scene(
        random_rotation(i), seed=i, frame_nb=FRAMES9, image_size=2 * REND,
        rend_size=REND, mano_layer=layer, obj_mesh=obj, device="cuda")
        for i in range(CLIPS9)]
    states = par.stack_clips([s.init_state for s in scenes])
    consts = par.stack_clips([s.consts for s in scenes])
    cfg = scenes[0].cfg
    base = R.RasterSettings(REND, tile_px=TILE, edges_per_tile=KE)
    kes = []
    for s in scenes:
        with torch.no_grad():
            v, _ = M.get_verts_object(s.init_state, s.consts)
        kes.append(sized_edges(R, v, s.consts.faces_object,
                               s.consts.camintr_rois_object, base))
    ke = max(k for k, _ in kes)
    settings = R.RasterSettings(REND, tile_px=TILE, edges_per_tile=ke)
    print(f"multiclip: {CLIPS9} clips x {FRAMES9} frames, edge demand "
          f"{[d['max_demand'] for _, d in kes]} (Ke {KE} overflows: "
          f"{any(d['overflow'] for _, d in kes)}); the fit runs Ke {ke}",
          flush=True)

    def batched(iters):
        return par.fit_clips_batched(states, consts, cfg,
                                     num_iterations=iters,
                                     roi_settings=settings, device="cuda")

    walls = []
    for i in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, hist = batched(ITERS9)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        print(f"multiclip run {i + 1}: {ITERS9} steps in {walls[-1]:.3f} s "
              f"({walls[-1] / ITERS9 * 1e3:.3f} ms/step, "
              f"{walls[-1] / CLIPS9:.3f} s a clip); launches "
              + json.dumps(counts), flush=True)
        expect = {"shade_fwd": ITERS9, "shade_bwd": ITERS9, "depth_fwd": 0,
                  "depth_bwd": 0, "voxelize": 0, "shade_fwd_only": 0,
                  "prep": ITERS9}
        check(counts == expect, f"multiclip: launches {counts}, the path's "
              f"count is {expect}")
        loss = hist["loss"].cpu()
        check(bool(torch.isfinite(loss).all()), "multiclip: loss not finite")
        check(bool((loss[:, -1] < loss[:, 0]).all()),
              f"multiclip: a clip's loss did not fall: {loss[:, [0, -1]]}")
        check(float(hist["edge_budget_excess"].max()) <= 0,
              "multiclip: edge budget overflowed during the fit")
    print("multiclip loss per clip: " + json.dumps(
        [[float(a), float(b)] for a, b in loss[:, [0, -1]]]), flush=True)
    window = profile_window(torch, lambda: batched(10), 10, "multiclip")
    print(f"multiclip launch calls per step {window['launch_calls_per_step']}"
          f" for {CLIPS9} clips; the headline fit's (30 frames, one clip) "
          f"{headline_launches}", flush=True)
    out["multiclip"] = {
        "clips": CLIPS9, "frames": FRAMES9, "iters": ITERS9, "rend": REND,
        "tile": TILE, "ke": ke, "first_wall_s": walls[0],
        "second_wall_s": walls[1], "ms_per_step": walls[1] / ITERS9 * 1e3,
        "wall_s_per_clip": walls[1] / CLIPS9, "profiled": window,
        "headline_launch_calls_per_step": headline_launches}

    # (b) Each clip against its own single-clip fit, 50 steps.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final50, _ = batched(CHECK_ITERS9)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    errs, wall_s = [], 0.0
    for i, sc in enumerate(scenes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single, _ = joint.optimize_hand_object(
            sc.init_state, sc.consts, cfg, num_iterations=CHECK_ITERS9,
            roi_settings=settings, device="cuda")
        torch.cuda.synchronize()
        wall_s += time.perf_counter() - t0
        errs.append(state_rel_err(final50.map(lambda x, i=i: x[i]), single))
    worst = max(max(e.values()) for e in errs)
    print(f"multiclip vs single-clip card fits, {CHECK_ITERS9} steps: state "
          f"max rel err {worst:.3g}; wall per clip batched "
          f"{wall_b / CLIPS9:.3f} s, single {wall_s / CLIPS9:.3f} s",
          flush=True)
    check(worst <= 3e-3, f"multiclip: a clip differs from its single fit: "
          f"{errs}")
    out["multiclip"]["vs_single"] = {
        "iters": CHECK_ITERS9, "state_max_rel_err": worst,
        "batched_wall_s_per_clip": wall_b / CLIPS9,
        "single_wall_s_per_clip": wall_s / CLIPS9}

    # (c) Heterogeneous buckets: two objects padded to one bucket.
    meshes = [bumpy_potato(2, 0.08, seed=1), bumpy_potato(1, 0.07, seed=2)]
    vb = max(m[0].shape[0] for m in meshes)
    fb = max(m[1].shape[0] for m in meshes)
    padded = [pad_mesh(v, f, vb, fb) for v, f in meshes]
    topos = [R.MeshTopology.from_faces(f, device="cuda") for _, f in padded]
    eb = max(t.edges.shape[0] for t in topos)

    def pad_topo(t):
        n = eb - t.edges.shape[0]
        z = dict(device="cuda", dtype=torch.int64)
        return R.MeshTopology(
            faces=t.faces, edges=torch.cat([t.edges, torch.zeros((n, 2),
                                                                 **z)]),
            edge_faces=torch.cat([t.edge_faces, torch.full((n, 2), -1,
                                                           **z)]),
            edge_dir_f1=torch.cat([t.edge_dir_f1, torch.zeros(
                n, dtype=torch.bool, device="cuda")]))

    het = []
    for (vp, fp), t in zip(padded, topos):
        sc = make_synthetic_scene(random_rotation(7), seed=7, frame_nb=2,
                                  image_size=64, rend_size=32,
                                  mano_layer=layer, obj_mesh=(vp, fp),
                                  device="cuda")
        het.append(dataclasses.replace(sc, consts=dataclasses.replace(
            sc.consts, faces_object=pad_topo(t))))
    _, h_het = par.fit_clips_batched(
        par.stack_clips([x.init_state for x in het]),
        par.stack_clips([x.consts for x in het]), het[0].cfg,
        num_iterations=5, roi_settings=het[0].roi_settings, device="cuda")
    check(tuple(h_het["loss"].shape) == (2, 5)
          and bool(torch.isfinite(h_het["loss"]).all()),
          f"heterogeneous clips: loss {h_het['loss']}")
    v, f = bumpy_potato(2, 0.3, seed=2)
    vp, fp = pad_mesh(v, f, v.shape[0] + 37, f.shape[0] + 53)
    K = torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]],
                     device="cuda")
    st = R.RasterSettings(image_size=64, tile_px=16, edges_per_tile=384)
    shift = torch.tensor([0, 0, 1.0], device="cuda")
    reset_counts()
    sils = [R.rasterize_soft(torch.from_numpy(a).cuda()[None] + shift,
                             R.MeshTopology.from_faces(b, device="cuda"), K,
                             st)["sil"] for a, b in ((v, f), (vp, fp))]
    phis = [V.voxelize(torch.from_numpy(a).cuda()[None],
                       torch.from_numpy(b.astype(np.int64)).cuda(), 32)
            for a, b in ((v, f), (vp, fp))]
    pad_counts = read_counts()
    sil_err = float((sils[1] - sils[0]).abs().max())
    phi_err = float((phis[1] - phis[0]).abs().max())
    print(f"pad_mesh on the card: silhouette max err {sil_err:.3g}, phi max "
          f"err {phi_err:.3g}; launches " + json.dumps(pad_counts),
          flush=True)
    check(pad_counts["shade_fwd_only"] == 2 and pad_counts["voxelize"] == 2,
          f"pad_mesh check did not run the kernels: {pad_counts}")
    check(sil_err <= 1e-5 and phi_err <= 1e-6 and bool((phis[0] > 0).any()),
          f"pad_mesh changed the kernels' outputs: {sil_err} {phi_err}")
    out["heterogeneous"] = {"loss": h_het["loss"].cpu().tolist(),
                            "pad_sil_err": sil_err, "pad_phi_err": phi_err}

    # (d) One clip's frames over two entries of the card.
    sc = make_synthetic_scene(
        random_rotation(3), seed=3, frame_nb=SHARD_FRAMES9,
        hand_sides=("left", "right"), image_size=2 * REND, rend_size=REND,
        mano_layer=layer, obj_mesh=obj, device="cuda")
    with torch.no_grad():
        v, _ = M.get_verts_object(sc.init_state, sc.consts)
    ke_s, _ = sized_edges(R, v, sc.consts.faces_object,
                          sc.consts.camintr_rois_object, base)
    st = R.RasterSettings(REND, tile_px=TILE, edges_per_tile=ke_s)
    fmesh = fpar.make_frame_mesh(devices=["cuda"] * SHARD_ENTRIES9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded, hs = fpar.fit_frames_sharded(
        sc.init_state, sc.consts, sc.cfg, fmesh,
        num_iterations=SHARD_ITERS9, roi_settings=st)
    torch.cuda.synchronize()
    wall_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    single, h1 = joint.optimize_hand_object(
        sc.init_state, sc.consts, sc.cfg, num_iterations=SHARD_ITERS9,
        roi_settings=st, device="cuda")
    torch.cuda.synchronize()
    wall_un = time.perf_counter() - t0
    err = state_rel_err(sharded, single)
    loss_err = float(((hs["loss"] - h1["loss"]).abs()
                      / h1["loss"].abs()).max())
    print(f"frame-sharded fit ({SHARD_FRAMES9} frames, 2 hands, "
          f"{SHARD_ENTRIES9} entries of one card, {SHARD_ITERS9} steps): "
          f"{wall_sh:.3f} s, unsharded {wall_un:.3f} s; loss max rel err "
          f"{loss_err:.3g}, state max rel err " + json.dumps(err),
          flush=True)
    check(max(err.values()) <= 3e-3 and loss_err <= 3e-3,
          f"frame-sharded fit differs from the unsharded one: {err}")
    out["frames_sharded"] = {
        "frames": SHARD_FRAMES9, "entries": SHARD_ENTRIES9,
        "iters": SHARD_ITERS9, "wall_s": wall_sh, "unsharded_wall_s": wall_un,
        "loss_max_rel_err": loss_err, "state_max_rel_err": max(err.values())}

    # (e) Two processes over gloo; (f) the dry run.
    out["multihost"] = multihost_check()
    t0 = time.perf_counter()
    entry.dryrun_multichip(4)
    out["dryrun_multichip_s"] = time.perf_counter() - t0
    # (g) The headline clip's frames over two processes on the card.
    out["frames_processes"] = frames_process_check(
        torch, joint, headline_scene, headline_settings)
    return out, counts


def sharded_driver_check(torch, small_cuda):
    """Phase 9's driver check, on phase 5's small clip (in its tree): the
    card driver with --frames_sharded 1 logs the JAX driver's warning (one
    card: no split) and writes the joint state of the run without the
    flag, within 3e-3 of each array's maximum."""
    from homan_tpu_torch.cli import fit_video
    args = fit_video.get_args(SMALL_DRIVER_ARGV + ["--frames_sharded", "1",
                                                   "--result_root",
                                                   "small_sharded"])
    with logged_warnings(fit_video.logger.name) as warnings:
        fit_video.main(args, device="cuda")
    check(any("don't split over the available devices" in w
              for w in warnings), f"--frames_sharded 1: no warning in "
          f"{warnings}")
    state = driver_outputs("small_sharded")[1]
    ref = small_cuda[1]
    err = {k: float(np.abs(state[k] - ref[k]).max()
                    / max(np.abs(ref[k]).max(), 1e-30)) for k in ref}
    print("driver --frames_sharded 1 vs without, small clip on the card: "
          "joint state max rel err " + json.dumps(err), flush=True)
    check(max(err.values()) <= 3e-3, f"--frames_sharded 1 changed the "
          f"small clip's fit: {err}")
    return {"warned": True, "state_max_rel_err": max(err.values())}


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ab", action="append", default=[],
                        metavar="NAME=PATH.cu",
                        help="also time another source of kernel NAME "
                        "(voxelize, shade_fwd, shade_bwd, depth) against the "
                        "package's, in turns, after the kernel checks; the "
                        "fits are not run")
    ab = parser.parse_args(argv).ab
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    import dataclasses

    import homan_tpu_torch
    from homan_tpu_torch import _build
    from homan_tpu_torch.core.meshes import bumpy_potato
    from homan_tpu_torch.fit import joint
    from homan_tpu_torch.fit import model as M
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
    from homan_tpu_torch.render import rasterizer as R

    # 1. Set-up -------------------------------------------------------------
    t_start = time.perf_counter()

    def phase_done(n):
        print(f"phase {n} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # The overlay writers use these where they import (viz/render_viz.py).
    from homan_tpu_torch.viz import render_viz
    print("image libraries: " + json.dumps({
        name: render_viz._import_optional(name) is not None
        for name in ("cv2", "PIL.Image", "matplotlib")}), flush=True)
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

    phase_done(1)

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
    ke_fit, demand = sized_edges(R, v_obj, c.faces_object,
                                 c.camintr_rois_object, headline)
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
    results, shade_inputs = {}, {}
    for name, (verts, topo, K, st) in packs.items():
        with torch.no_grad():
            seg, anc, _, static = R.shade_prep(verts, topo, K, st)
        shade_inputs[name] = (seg, anc, static)
        results[name] = compare_kernels(torch, name, seg, anc, static,
                                        timed=True)
    adversarial_err = check_shade_bwd_adversarial(torch)
    reps = PREP_FRAMES // FRAMES
    jitter = torch.randn((PREP_FRAMES, 1, 3), device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(0)) * 2e-3
    prep = compare_prep(
        torch, f"prep-b{PREP_FRAMES}", v_obj.repeat(reps, 1, 1) + jitter,
        c.faces_object, c.camintr_rois_object.repeat(reps, 1, 1),
        R.RasterSettings(REND, tile_px=PREP_TILE, edges_per_tile=PREP_KE))

    # The interaction and ordinal-depth fits' scene: bench.py's
    # bench_config3 / bench_depth, 10 frames, 512^2 image, 256^2 ROI, with
    # the full-image masks the depth term reads.
    t0 = time.perf_counter()
    scene2 = make_synthetic_scene(
        random_rotation(0), seed=0, frame_nb=FRAMES2, image_size=2 * REND,
        rend_size=REND, obj_mesh=bumpy_potato(3, 0.08, seed=0),
        with_full_masks=True, device="cuda")
    torch.cuda.synchronize()
    print(f"scene 2: {FRAMES2} frames, {2 * REND}^2 masks in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    c2 = scene2.consts
    with torch.no_grad():
        v_obj2, _ = M.get_verts_object(scene2.init_state, c2)
        v_hand2, _ = M.get_verts_hand(scene2.init_state, c2, scene2.cfg)
    ke2, demand2 = sized_edges(R, v_obj2, c2.faces_object,
                               c2.camintr_rois_object, headline)
    roi2 = R.RasterSettings(REND, tile_px=TILE, edges_per_tile=ke2)
    print(f"scene 2 edge budget: demand {demand2['max_demand']}; fits run "
          f"Ke {ke2}", flush=True)
    # Face budget of the depth renders: the JAX default keeps 256 faces
    # per tile, far below this scene's demand; size Kf from the demand.
    wide = R.RasterSettings(2 * REND, tile_px=DEPTH_TILE,
                            faces_per_tile=1 << 20)
    meshes = {"object": (v_obj2, c2.faces_object),
              "hand": (v_hand2, c2.faces_hand)}
    face_demand = {m: R.check_face_budget(v, t, c2.camintr, wide)[
        "max_demand"] for m, (v, t) in meshes.items()}
    kf_fit = max(size_faces(face_demand[m], int(t.faces.shape[0]))
                 for m, (_, t) in meshes.items())
    full_fit = R.RasterSettings(2 * REND, tile_px=DEPTH_TILE,
                                faces_per_tile=kf_fit)
    print("face budget at the initial poses: " + ", ".join(
        f"{m} demand {face_demand[m]} vs Kf "
        f"{min(kf_fit, int(t.faces.shape[0]))} (Kf 256 overflows: "
        f"{face_demand[m] > 256})" for m, (_, t) in meshes.items()),
        flush=True)
    depth_results, depth_packs = {}, {}
    for m, (v, t) in meshes.items():
        for kf in (kf_fit, 256):
            st = dataclasses.replace(full_fit, faces_per_tile=kf)
            with torch.no_grad():
                fp, _, static = R.depth_prep(v, t, c2.camintr, st)
            depth_results[(m, kf)] = compare_depth(
                torch, f"{m}-kf{static.kf}", fp, static, timed=True)
            if kf == kf_fit:
                depth_packs[m] = (fp.contiguous(), static)
    vox_results, vox_packs = {}, {}
    for m, v, f in (("hand", v_hand2, scene2.closed_hand_faces),
                    ("object", v_obj2, c2.faces_object.faces)):
        for grid in VOX_GRIDS:
            vox_results[(m, grid)], vox_packs[(m, grid)] = compare_voxelize(
                torch, f"{m}-g{grid}", v, f, grid, timed=grid == GRID)
    vox_large = large_grid_checks(torch, v_hand2, scene2.closed_hand_faces,
                                  v_obj2, c2.faces_object.faces)
    if ab:
        ab_compare(torch, ab, {m: vox_packs[(m, GRID)] for m in meshes},
                   shade_inputs, depth_packs)
        print("kernel checks and --ab comparisons passed; the fits are not "
              "run", flush=True)
        return 0

    phase_done(2)

    # 3. The paths ----------------------------------------------------------
    # 3a. The stage-C fit at the headline shape.
    walls1, counts1, hist, _ = timed_fit_pair(
        torch, joint, scene, fit_settings, ITERS, "fit",
        {"shade_fwd": ITERS, "shade_bwd": ITERS, "depth_fwd": 0,
         "depth_bwd": 0, "voxelize": 0, "prep": ITERS})
    check(float(hist["iou_object"][-1]) > float(hist["iou_object"][0]),
          "object IoU did not improve")
    step1 = profile_steps(torch, joint, scene, fit_settings, 10, "fit")

    # 3b. The interaction fit, grid SDF (the reference's step-2 recipe).
    cfg_grid = dataclasses.replace(scene2.cfg, sdf_mode="grid")
    inter_kw = dict(cfg=cfg_grid, loss_weights=LW_INTER,
                    closed_hand_faces=scene2.closed_hand_faces)
    walls2, counts2, _, _ = timed_fit_pair(
        torch, joint, scene2, roi2, ITERS2, "interaction fit",
        {"voxelize": 2 * ITERS2, "shade_fwd": ITERS2,
         "shade_bwd": ITERS2, "depth_fwd": 0, "depth_bwd": 0,
         "prep": ITERS2}, **inter_kw)
    step2 = profile_steps(torch, joint, scene2, roi2, 10, "interaction fit",
                          **inter_kw)

    # 3c. The ordinal-depth fit at the sized face budget.
    depth_kw = dict(loss_weights=LW_DEPTH, full_settings=full_fit)
    walls3, counts3, hist3, final3 = timed_fit_pair(
        torch, joint, scene2, roi2, ITERS3, "depth fit",
        {"depth_fwd": 2 * ITERS3, "depth_bwd": 2 * ITERS3,
         "shade_fwd": ITERS3, "shade_bwd": ITERS3, "voxelize": 0,
         "prep": ITERS3},
        **depth_kw)
    with torch.no_grad():
        v_obj3, _ = M.get_verts_object(final3, c2)
        v_hand3, _ = M.get_verts_hand(final3, c2, scene2.cfg)
    for m, v, t in (("object", v_obj3, c2.faces_object),
                    ("hand", v_hand3, c2.faces_hand)):
        b = R.check_face_budget(v, t, c2.camintr, full_fit)
        print(f"face budget at the final poses: {m} demand "
              f"{b['max_demand']} vs Kf {b['capacity']}", flush=True)
        check(not b["overflow"], f"depth fit: {m} face budget overflowed")
    step3 = profile_steps(torch, joint, scene2, roi2, 10, "depth fit",
                          **depth_kw)

    phase_done("3abc")

    # 3d. Kernel paths vs plain paths: small fits on the card and on the
    # CPU from the same inputs (the CPU runs the plain versions).
    small = make_synthetic_scene(random_rotation(1), seed=1, frame_nb=3,
                                 image_size=128, rend_size=64,
                                 with_full_masks=True, device="cpu")
    small_set = R.RasterSettings(64, tile_px=32, edges_per_tile=48)
    small_fit_pair(torch, joint, small, small_set, 10, "small fit",
                   {"shade_fwd": 10, "shade_bwd": 10, "prep": 10})
    small_fit_pair(torch, joint, small, small_set, 3,
                   "small interaction fit", {"voxelize": 6},
                   cfg=dataclasses.replace(small.cfg, sdf_mode="grid"),
                   loss_weights=LW_INTER,
                   closed_hand_faces=small.closed_hand_faces)
    small_fit_pair(torch, joint, small, small_set, 5, "small depth fit",
                   {"depth_fwd": 10, "depth_bwd": 10},
                   state=overlap_state(small), loss_weights=LW_DEPTH,
                   full_settings=R.RasterSettings(128, tile_px=32,
                                                  faces_per_tile=2048))

    phase_done(3)

    # 4. Stage B: the object-pose search (bench.py bench_stageb) ------------
    stage_b, b_rows = stage_b_phase(torch, R)
    phase_done(4)

    # 5-7. The fit_video driver, --gt_masks 1 (cli/fit_video.py), on a tree
    # that lives until phase 7 has evaluated its results.
    import tempfile
    with tempfile.TemporaryDirectory() as tree5:
        driver, driver_counts, d_shade, d_vox = driver_phase(torch, tree5)
        phase_done(5)

        # 6. The fit_video driver on cached detections, --evidence_root ----
        cached, cached_counts, c_shade, c_vox = cached_phase(torch)
        phase_done(6)

        # 7. The HO-3D evaluation of phase 5's results (cli/eval_ho3d.py) --
        evaluation, eval_counts, e_vox = eval_phase(torch, tree5, 40)
        phase_done(7)

    # 8. The tritri fit: bench_config3's scene, collision_mode "tritri" ----
    cfg_tritri = dataclasses.replace(cfg_grid, collision_mode="tritri")
    tritri, tritri_counts = tritri_phase(
        torch, joint, scene2, roi2, cfg_tritri,
        step2["device_busy_ms_per_step"], small, small_set)
    phase_done(8)

    # 9. parallel/: batched clips, frame sharding, multihost, the dry run --
    parallel, multiclip_counts = parallel_phase(
        torch, step1["launch_calls_per_step"], scene, fit_settings)
    parallel["driver_frames_sharded"] = driver.pop("frames_sharded_flag")
    phase_done(9)

    # Result lines ------------------------------------------------------------
    h = results["fit"]

    def mean2(key, rows):
        return sum(r[key] for r in rows) / len(rows)

    d_rows = [depth_results[(m, kf_fit)] for m in meshes]
    d_lib = [r["bwd_library"] for r in d_rows]
    v_rows = [vox_results[(m, GRID)] for m in meshes]
    s_lib = h["bwd_library"]
    # `ms` runs the wrapper (host work included), `device_ms` the call on
    # the device alone (CUDA events, cold L2); library_ms is the device time
    # of the one PyTorch call that computes the same reduction from the
    # contributions (the faster of `index_add_` and the one-hot `einsum`
    # for shade_bwd), which the port never calls. Counted numbers (the
    # dense bounds, the picked share) stay on the `kernel check` lines.
    kernels = [
        {"name": "shade_fwd", "route": "cuda",
         "source": "homan_tpu_torch/render/csrc/shade.cu",
         "replaces": "homan_tpu/render/pallas_shade.py:86",
         "launches": counts1["shade_fwd"], "max_abs_err": h["sil_err"],
         "ms": h["fwd_ms"], "device_ms": h["fwd_device_ms"],
         "plain_ms": h["fwd_plain_ms"], "bound_ms": h["fwd_bound_ms"],
         "bound_by": h["fwd_bound_by"], "library_ms": None},
        {"name": "shade_bwd", "route": "cuda",
         "source": "homan_tpu_torch/render/csrc/shade.cu",
         "replaces": "homan_tpu/render/pallas_shade.py:281",
         "launches": counts1["shade_bwd"], "max_abs_err": h["gseg_err"],
         "adversarial_rel_err": adversarial_err,
         "ms": h["bwd_ms"], "device_ms": h["bwd_device_ms"],
         "plain_ms": h["bwd_plain_ms"], "bound_ms": h["bwd_bound_ms"],
         "bound_by": h["bwd_bound_by"],
         "scratch_bytes": h["bwd_scratch_bytes"],
         "library_ms": min(s_lib["library_index_add_ms"],
                           s_lib["library_einsum_ms"]),
         "library_call": "index_add_" if s_lib["library_index_add_ms"]
         <= s_lib["library_einsum_ms"] else "einsum", **s_lib},
        # The depth pair runs twice per step, on the object's and the
        # hand's packs: times and bounds are the mean of one launch on each.
        {"name": "depth_fwd", "route": "cuda",
         "source": "homan_tpu_torch/render/csrc/depth.cu",
         "replaces": "homan_tpu/render/pallas_depth.py:56",
         "launches": counts3["depth_fwd"],
         "max_abs_err": max(r["depth_abs_err"] for r in d_rows),
         "ms": mean2("fwd_ms", d_rows),
         "device_ms": mean2("fwd_device_ms", d_rows),
         "plain_ms": mean2("fwd_plain_ms", d_rows),
         "bound_ms": mean2("fwd_bound_ms", d_rows),
         "bound_by": d_rows[1]["fwd_bound_by"], "library_ms": None},
        {"name": "depth_bwd", "route": "cuda",
         "source": "homan_tpu_torch/render/csrc/depth.cu",
         "replaces": "homan_tpu/render/pallas_depth.py:180",
         "launches": counts3["depth_bwd"],
         "max_abs_err": max(r["gpack_err"] for r in d_rows),
         "ms": mean2("bwd_ms", d_rows),
         "device_ms": mean2("bwd_device_ms", d_rows),
         "plain_ms": mean2("bwd_plain_ms", d_rows),
         "bound_ms": mean2("bwd_bound_ms", d_rows),
         "bound_by": d_rows[1]["bwd_bound_by"],
         "library_ms": mean2("library_index_add_ms", d_lib),
         "library_call": "index_add_",
         "library_contrib_ms": mean2("library_contrib_ms", d_lib)},
        # The voxelizer runs twice per step, on the hand and the object.
        {"name": "voxelize", "route": "cuda",
         "source": "homan_tpu_torch/interactions/csrc/voxelize.cu",
         "replaces": "homan_tpu/interactions/pallas_sdf.py:35",
         "launches": counts2["voxelize"],
         "max_abs_err": max(r["phi_err"] for r in v_rows),
         "ms": mean2("ms", v_rows), "device_ms": mean2("device_ms", v_rows),
         "plain_ms": mean2("plain_ms", v_rows),
         "bound_ms": mean2("bound_ms", v_rows),
         "bound_by": v_rows[0]["bound_by"], "library_ms": None},
        # The raster prep at the benchmark cells' shape (phase 2): the
        # launch alone under ms and device_ms; the card path's whole
        # forward beside it; plain_ms the plain prep's forward.
        {"name": "prep", "route": "cuda",
         "source": "homan_tpu_torch/render/csrc/prep.cu",
         "replaces": "homan_tpu/render/rasterizer.py:442 (XLA)",
         "launches": counts1["prep"]}
        | {k: prep[k] for k in ("max_abs_err", "ms", "device_ms",
                                "prep_ms", "prep_device_ms", "plain_ms",
                                "bound_ms", "bound_by", "bytes", "frames",
                                "contour_edges_per_frame",
                                "list_entries_read_per_frame")}
        | {"library_ms": None},
    ]
    # Stage B's packs, under their own keys: the coarse and refinement
    # renders (B 125, and the coarse at B 500 in one launch; 128^2, one
    # tile) with residuals and the backward, the rescore's (B 125, 256^2,
    # four tiles) forward-only.
    for k in kernels:
        k["launches_per_driver_clip"] = driver_counts[k["name"]]
    for k in kernels[:2]:
        fwd = k["name"] == "shade_fwd"
        k["stage_b"] = {"launches": stage_b["launches"][k["name"]]}
        if fwd:
            k["stage_b"]["launches_forward_only"] = stage_b["launches"][
                "shade_fwd_only"]
        for name, r in b_rows.items():
            only = name == "stage_b_rescore"
            if only and not fwd:
                continue
            pre = "fwd_only_" if only else ("fwd_" if fwd else "bwd_")
            lib = r["bwd_library"]
            k["stage_b"][name] = {
                "ms": r[pre + "ms"], "device_ms": r[pre + "device_ms"],
                "plain_ms": r["fwd_plain_ms" if fwd else "bwd_plain_ms"],
                "bound_ms": r[pre + "bound_ms"],
                "bound_by": r[pre + "bound_by"],
                "max_abs_err": r["sil_err" if fwd else "gseg_err"],
                "library_ms": None if fwd else min(
                    lib["library_index_add_ms"], lib["library_einsum_ms"])}
    kernels[5]["stage_b"] = {"launches": stage_b["launches"]["prep"]}
    # The drivers' own shapes, under "driver" (phase 5, GT masks) and
    # "cached" (phase 6, cached detections): each shade render with
    # residuals and the backward, or forward-only, and the voxelizer of the
    # interaction metrics.
    for k in kernels:
        k["launches_per_cached_clip"] = cached_counts[k["name"]]
        k["launches_per_eval"] = eval_counts[k["name"]]
        k["launches_per_tritri_fit"] = tritri_counts[k["name"]]
        k["launches_per_multiclip_fit"] = multiclip_counts[k["name"]]
        k["launches_per_frames_process_fit"] = parallel[
            "frames_processes"]["launches"][k["name"]]
    for part, shade_rows, vox_rows in (("driver", d_shade, d_vox),
                                       ("cached", c_shade, c_vox)):
        for k in kernels[:2]:
            fwd = k["name"] == "shade_fwd"
            k[part] = {}
            for name, r in shade_rows.items():
                if r["fwd_only"] and not fwd:
                    continue
                pre = ("fwd_only_" if r["fwd_only"] else "fwd_") if fwd \
                    else "bwd_"
                lib = r["bwd_library"]
                k[part][name] = {
                    "ms": r[pre + "ms"], "device_ms": r[pre + "device_ms"],
                    "plain_ms": r["fwd_plain_ms" if fwd else "bwd_plain_ms"],
                    "bound_ms": r[pre + "bound_ms"],
                    "bound_by": r[pre + "bound_by"],
                    "max_abs_err": r["sil_err" if fwd else "gseg_err"],
                    "library_ms": None if fwd else min(
                        lib["library_index_add_ms"],
                        lib["library_einsum_ms"])}
    # The evaluation's voxelizer shapes, under "eval" (phase 7).
    for part, vox_rows in (("driver", d_vox), ("cached", c_vox),
                           ("eval", e_vox)):
        kernels[4][part] = {
            name: {"ms": r["ms"], "device_ms": r["device_ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "max_abs_err": r["phi_err"],
                   "library_ms": None} for name, r in vox_rows.items()}
    # The voxelizer at G 128-1,024 (phase 2), under "grids".
    kernels[4]["grids"] = {
        name: {k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "inside_share")}
        | {"max_abs_err": r["phi_err"], "library_ms": None}
        for name, r in vox_large.items()}
    fits = {
        "fit": {"frames": FRAMES, "iters": ITERS, "rend": REND, "tile": TILE,
                "ke": ke_fit, "first_wall_s": walls1[0],
                "second_wall_s": walls1[1],
                "ms_per_step": walls1[1] / ITERS * 1e3, "profiled": step1},
        "interaction_fit": {
            "frames": FRAMES2, "iters": ITERS2, "sdf_mode": "grid",
            "grid": GRID, "ke": ke2, "first_wall_s": walls2[0],
            "second_wall_s": walls2[1],
            "ms_per_step": walls2[1] / ITERS2 * 1e3, "profiled": step2},
        "depth_fit": {
            "frames": FRAMES2, "iters": ITERS3, "image": 2 * REND,
            "depth_tile": DEPTH_TILE, "kf": kf_fit,
            "face_demand": face_demand, "ke": ke2,
            "first_wall_s": walls3[0], "second_wall_s": walls3[1],
            "ms_per_step": walls3[1] / ITERS3 * 1e3, "profiled": step3},
        "stage_b": stage_b,
        "driver": driver,
        "cached_driver": cached,
        "evaluation": evaluation,
        "tritri_fit": tritri,
        "parallel": parallel,
    }
    rows = [(k["name"], k) for k in kernels] + [
        (f"{k['name']} {name}", r) for k in kernels
        for part in ("stage_b", "driver", "cached", "eval", "grids")
        for name, r in k.get(part, {}).items() if isinstance(r, dict)]
    for label, r in rows:
        for key in ("ms", "device_ms"):
            check(r[key] >= r["bound_ms"], f"{label} reads {key} {r[key]}, "
                  f"below its bound {r['bound_ms']} ms: the bound is wrong")
    print(json.dumps(fits), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
