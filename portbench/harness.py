"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison, and the result line.

The window drives homan_tpu_torch.parallel.clips.fit_clips_batched: each
call is the recipe's full fit of one batch of clips, timed on the host
clock and ended with torch.cuda.synchronize(). Fits run back to back; one
more starts only while the time so far plus the mean fit so far stays
within --seconds, and every window holds at least two. clip_s is the
window's wall time over the clips its fits finished.

With --trace 1 the last `trace_steps` steps of the window's first fit run
under torch.profiler (CUDA activity), selected by torch.optim's global step
hooks with the device synchronized at both ends; the hooks are registered
in traced runs only.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import types

FORBIDDEN = ("jax", "jaxlib", "flax", "homan_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_cell(bench: dict, root: str, workload: str):
    """(cell entry, configuration dict, traffic dict) of a cell, each found
    by name: the configuration's file as BENCHMARK.json names it, the
    traffic in traffic/<name>.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return cell, cfg, traffic


def metrics_of(bench: dict, workload: str, kind: str):
    """The cell's metric entries of `kind` ("end_to_end" or "per_layer"):
    those without a workloads list, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str):
    """metrics/<name>.py's read(ctx)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


# ---------------------------------------------------------------------------
# The program's inputs
# ---------------------------------------------------------------------------
def edge_slots(state, consts, cfg, B):
    """Edge slots a tile (Ke): the configuration's, sized once from the
    demand over many seeds so that every seed runs the same shapes.

    A guard against dropped geometry: the program drops the contour edges
    that overflow a tile's slots, so where a seed's demand at the initial
    poses, times the safety factor, would exceed the configuration's slots
    they are raised as the port's fit_video raises them, to the smallest
    bucket that covers it. No seed measured has needed it (PERF.md)."""
    import torch
    from portbench.reference import losses, silhouette
    r = cfg["raster"]
    with torch.no_grad():
        v_obj = losses.posed(state, consts)[0]
        C = v_obj.shape[0]
        demand = silhouette.edge_demand(
            v_obj.reshape(C * B, -1, 3), consts["K_roi"].reshape(-1, 3, 3),
            losses.frame_topology(consts["obj_topo"], B), cfg["rend_size"],
            r["tile_px"], r["bin_margin_px"])
    need = int(-(-demand * r["edge_safety"] // 1))
    ke = r["edges_per_tile"]
    if need > ke:
        ke = min(b for b in r["edge_buckets"] if b >= need)
    return ke, demand


def program_inputs(state, consts, info, cfg, ke):
    """The same inputs in the program's types: (states, consts, cfg,
    settings, closed hand faces)."""
    import torch
    from homan_tpu_torch.fit import model as M
    from homan_tpu_torch.render.rasterizer import MeshTopology, RasterSettings
    C, B = state["t_obj"].shape[:2]
    dev = state["t_obj"].device
    S = cfg["rend_size"]

    def per_clip(t):
        return t[None].expand((C,) + tuple(t.shape))

    objs = consts["obj_topo"]
    obj_topo = MeshTopology(faces=objs["faces"], edges=objs["edges"],
                            edge_faces=objs["edge_faces"],
                            edge_dir_f1=objs["edge_dir"])
    ht = info["hand_topo"]
    hand_topo = MeshTopology(faces=per_clip(consts["hand_faces"]),
                             edges=per_clip(ht["edges"]),
                             edge_faces=per_clip(ht["edge_faces"]),
                             edge_dir_f1=per_clip(ht["edge_dir"]))
    mano = {k: per_clip(v) for k, v in consts["mano"].items()}
    states = M.HomanState(
        translations_object=state["t_obj"], rotations_object=state["r_obj"],
        translations_hand=state["t_hand"], rotations_hand=state["r_hand"],
        mano_pca_pose=state["pca"], mano_rot=state["mano_rot"],
        mano_trans=state["mano_trans"], mano_betas=state["betas"],
        int_scales_object=state["s_obj"], int_scales_hand=state["s_hand"],
        cams_hand=torch.zeros((C, B, 3), device=dev))
    zeros_roi = torch.zeros((C, B, S, S), device=dev)
    # The recipe weighs neither the hand's silhouette nor ordinal depth:
    # their masks are handed over empty (the full-image depth masks as one
    # pixel), as the program never reads them.
    pconsts = M.HomanConsts(
        verts_object_og=consts["verts_obj"], faces_object=obj_topo,
        verts_hand_og=consts["gt_verts_hand"], faces_hand=hand_topo,
        ref_verts2d_hand=consts["ref2d"], ref_mask_object=consts["ref_mask"],
        keep_mask_object=consts["keep"], ref_mask_hand=zeros_roi,
        keep_mask_hand=torch.ones_like(zeros_roi),
        camintr_rois_object=consts["K_roi"],
        camintr_rois_hand=consts["K_roi_hand"], camintr=consts["K"],
        mano_params_by_side={"right": mano},
        masks_object=torch.zeros((C, B, 1, 1), device=dev),
        masks_hand=torch.zeros((C, B, 1, 1), device=dev))
    r = cfg["raster"]
    pcfg = M.HomanConfig(hand_sides=("right",), image_size=cfg["image_size"],
                         rend_size=S, pca_comps=cfg["hand"]["pca_comps"],
                         optimize_object_scale=False,
                         sdf_mode=cfg["sdf_mode"], collision_mode="sdf")
    settings = RasterSettings(image_size=S, sigma=r["sigma"],
                              tile_px=r["tile_px"], edges_per_tile=ke,
                              bin_margin_px=r["bin_margin_px"],
                              znear=r["znear"])
    return states, pconsts, pcfg, settings, consts["hand_faces"]


def recipe_constants(cfg):
    """What the reference reads of the recipe."""
    r = cfg["raster"]
    return {"rend_size": cfg["rend_size"], "image_size": cfg["image_size"],
            "sigma": r["sigma"], "bin_margin_px": r["bin_margin_px"],
            "sdf_grid": cfg["sdf_grid"]}


# Program state field -> reference leaf, for the free leaves.
LEAVES = {"translations_object": "t_obj", "rotations_object": "r_obj",
          "translations_hand": "t_hand", "rotations_hand": "r_hand",
          "mano_pca_pose": "pca", "mano_betas": "betas"}


def final_leaves(final):
    return {ref: getattr(final, name).detach() for name, ref in
            LEAVES.items()}


# ---------------------------------------------------------------------------
# The traced stretch
# ---------------------------------------------------------------------------
class Stretch:
    """torch.profiler over steps (total - n, total] of one fit, selected by
    a global optimizer step hook: the device synchronized and the host
    clock read at both ends."""

    def __init__(self, total: int, n: int):
        import torch
        self.torch = torch
        self.first, self.last = total - n, total
        self.count, self.prof, self.t0, self.t1 = 0, None, None, None
        self.steps = n

    def __call__(self, optimizer, args, kwargs):
        self.count += 1
        if self.count == self.first:
            self.start()
        elif self.count == self.last:
            self.stop()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def events(self):
        """(device ops [(name, start_ns, end_ns)], host call names)."""
        cuda = self.torch.autograd.DeviceType.CUDA
        ops, calls = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                ops.append((e.name(), e.start_ns(), e.end_ns()))
            else:
                calls.append(e.name())
        return ops, calls


def trace_context(stretch, work):
    from portbench.yardstick import trace
    ops, calls = stretch.events()
    return types.SimpleNamespace(
        ops=ops, launches=trace.count_launches(calls),
        window_s=stretch.t1 - stretch.t0, steps=stretch.steps,
        busy_s=trace.busy_s(ops), work=work)


def stretch_work(final, state, consts, cfg, B, ke, lw):
    """The work of one step at the traced fit's last leaves (the stretch
    is its last steps, over which the leaves barely move)."""
    import torch
    from portbench.reference import losses, voxel
    from portbench.yardstick import work as W
    leaves = dict(state)
    leaves.update(final)
    r = cfg["raster"]
    S = cfg["rend_size"]
    C = state["t_obj"].shape[0]
    N = C * B
    with torch.no_grad():
        v_obj, _, _, detscale = losses.posed(leaves, consts)
        topo = losses.frame_topology(consts["obj_topo"], B)
        fwd, bwd, counts = W.shade_work(
            v_obj.reshape(N, -1, 3), consts["K_roi"].reshape(N, 3, 3), topo,
            S, r["tile_px"], ke, r["bin_margin_px"])
        out = {"shade_fwd": fwd, "shade_bwd": bwd, "counts": counts}
        sdf = lw["lw_collision"] > 0 or lw["lw_contact"] > 0
        Vo = consts["verts_obj"].shape[1]
        Fo = consts["obj_topo"]["faces"].shape[1]
        Eo = consts["obj_topo"]["edges"].shape[1]
        if sdf:
            G = cfg["sdf_grid"]
            launches = []
            meshes = [(detscale.reshape(N, -1, 3), consts["hand_faces"]),
                      (v_obj.reshape(N, -1, 3), topo["faces"])]
            for verts, faces in meshes:
                c, s = voxel.unit_box(verts)
                n_faces = faces.shape[-2]
                ops = 0
                for n0 in range(0, N, 256):
                    f = faces if faces.dim() == 2 else faces[n0:n0 + 256]
                    local = ((verts[n0:n0 + 256] - c[n0:n0 + 256])
                             / s[n0:n0 + 256])
                    inside = voxel.inside_cells(voxel.triangles(local, f),
                                                G).sum((1, 2, 3))
                    valid = ((f[..., 0] != f[..., 1]) & (f[..., 1] != f[..., 2])
                             & (f[..., 0] != f[..., 2])).sum(-1)
                    ops += int(W.vox_work_ops(valid, inside, G, 1).sum())
                launches.append(W.vox_work(N, n_faces, ops, G))
            out["voxelize"] = launches
        out["dense_ops"] = W.dense_ops(
            N, Vo, Fo, Eo, N * S * S, 2 if sdf else 1,
            N * consts["mano"]["v_template"].shape[0] * Vo
            if lw["lw_contact"] > 0 else 0,
            sum(v.numel() for k, v in state.items() if k in (
                "t_obj", "r_obj", "t_hand", "r_hand", "pca", "betas")))
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------
def run_window(fit, seconds: float, after=None,
               clock=time.perf_counter):
    """Fits back to back: one more starts only while the time so far plus
    the mean fit so far stays within `seconds`, and at least two run.
    fit() runs one whole fit and returns when the device has finished it;
    after(i, output) runs after each, inside the window. Returns (walls,
    the window's wall time, the last fit's output)."""
    walls = []
    w0 = clock()
    while True:
        a = clock()
        out = fit()
        walls.append(clock() - a)
        if after is not None:
            after(len(walls) - 1, out)
        elapsed = clock() - w0
        if len(walls) >= 2 and elapsed + sum(walls) / len(walls) > seconds:
            return walls, clock() - w0, out


def main(args, t_start: float, root: str) -> int:
    """The command: the cell run on the first CUDA device; 2 where CUDA is
    absent or has fewer devices than the cell asks for, 3 where a
    forbidden module was loaded. Prints the result line."""
    bench = load_benchmark(root)
    cell, cfg, traffic = load_cell(bench, root, args.workload)
    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch sees {count}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_cell(bench, args, cfg, traffic, dev, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check failed_clips {result['failed']} limit 0", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench, args, cfg, traffic, dev, t_start: float) -> dict:
    """Set-up, window, comparison and, with args.trace, the traced stretch
    of one cell on device `dev`; returns the result dict. On a CPU device
    (the tests) the program runs its kernels' plain versions, and the
    traced stretch is not available."""
    import torch
    import homan_tpu_torch  # noqa: F401  (switches TF32 off on import)
    from torch.optim.optimizer import register_optimizer_step_post_hook
    from homan_tpu_torch.parallel.clips import fit_clips_batched
    from portbench import compare, scene

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def precision(tf32: bool):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32

    # The configuration states float32 with TF32 off; the control switches
    # TF32 on for the program, after the port is imported.
    precision(args.control == "tf32")

    card = card_line() if cuda else "cpu"
    print(f"card: {card}", file=sys.stderr, flush=True)
    B = int(cfg["frames"])
    C = int(traffic["clips"])
    marks = {"imports": time.perf_counter() - t_start}
    state, consts, info = scene.make_clips(cfg, traffic, args.seed, dev)
    ke, demand = edge_slots(state, consts, cfg, B)
    states, pconsts, pcfg, settings, hand_faces = program_inputs(
        state, consts, info, cfg, ke)
    sync()
    marks["scenes"] = time.perf_counter() - t_start
    lw = dict(cfg["loss_weights"])
    steps, lr = int(cfg["steps"]), float(cfg["lr"])

    def fit(n):
        return fit_clips_batched(states, pconsts, pcfg, loss_weights=lw,
                                 num_iterations=n, lr=lr,
                                 roi_settings=settings,
                                 closed_hand_faces=hand_faces, device=dev)

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    fit(int(cfg["warmup_steps"]))
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: {C} clips x {B} frames, Ke {ke} "
          f"(demand {demand}); imports done at {marks['imports']:.3f} s, "
          f"scenes at {marks['scenes']:.3f} s", file=sys.stderr, flush=True)

    stretch = hook = None
    if args.trace:
        stretch = Stretch(steps, int(cfg["trace_steps"]))
        hook = register_optimizer_step_post_hook(stretch)
    finite, first = [], {}

    def one_fit():
        out = fit(steps)
        sync()
        return out

    def after(i, out):
        nonlocal hook
        final, hist = out
        if hook is not None:
            hook.remove()
            hook = None
        finite.append(torch.isfinite(hist["loss"]).all(1)
                      & torch.isfinite(final.translations_object).reshape(
                          C, -1).all(1))
        if not first:
            first["final"] = final_leaves(final)

    walls, window_s, (final, hist) = run_window(one_fit, args.seconds,
                                                after)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    attempted = len(walls) * C
    failed = int(sum(int((~f).sum()) for f in finite))
    print(f"window {window_s:.3f} s: {len(walls)} fits of {C} clips, walls "
          + ", ".join(f"{w:.3f}" for w in walls), file=sys.stderr,
          flush=True)

    port_hist = {k: v.detach() for k, v in hist.items()}
    del final, hist, states, pconsts
    if cuda:
        torch.cuda.empty_cache()

    # The reference, in float32 with TF32 off whatever the program ran.
    precision(False)
    rc = recipe_constants(cfg)
    gen = torch.Generator().manual_seed(int(args.seed))
    sample = sorted(torch.randperm(C, generator=gen)[
        :int(traffic["check_clips"])].tolist())
    c0 = time.perf_counter()
    figures, detail = compare.run(port_hist, state, consts, rc, lw,
                                  int(cfg["check_steps"]), lr, sample)
    print(f"comparison {time.perf_counter() - c0:.3f} s over clips "
          f"{sample}: " + json.dumps(detail), file=sys.stderr, flush=True)
    checks = {k: {"value": figures[k], "limit": lim}
              for k, lim in cfg["checks"].items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and failed == 0 and attempted > 0)

    metrics = {}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak, "power": card}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        from portbench.yardstick import trace
        if stretch.t1 is None:
            raise RuntimeError("no optimizer step hook fired: the traced "
                               "stretch holds nothing")
        work = stretch_work(first["final"], state, consts, cfg, B, ke, lw)
        ctx = trace_context(stretch, work)
        device["busy_s"] = ctx.busy_s
        device["window_s"] = ctx.window_s
        for m in metrics_of(bench, args.workload, "per_layer"):
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": trace.top_ops(ctx.ops),
                               "idle_gaps": trace.idle_gaps(ctx.ops)}
        print("work a step: " + json.dumps(work), file=sys.stderr,
              flush=True)
    else:
        values = {"clip_s": window_s / attempted, "setup_s": setup_s}
        for m in metrics_of(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result["checks"] = checks
    return result
