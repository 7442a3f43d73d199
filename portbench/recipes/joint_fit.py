"""HOMan's joint hand-object fit (stage C) of a batch of clips.

One fit is homan_tpu_torch.parallel.clips.fit_clips_batched over the
traffic's clips, made by scene.make_clips: the configuration's loss
weights, `steps` Adam steps at `lr`, one optimizer step a fit step. Its
answer for a clip is the loss history it reports and the leaves it ends
with; compare.py holds them against the plain reference in reference/.
"""
from __future__ import annotations

import contextlib
import types

from portbench import compare as comparison
from portbench import scene


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
# The recipe's interface (recipes/__init__.py)
# ---------------------------------------------------------------------------
def prepare(cfg, traffic, seed, device):
    """The clips made from the seed, in the reference's layout (state,
    consts) and in the program's types (program)."""
    state, consts, info = scene.make_clips(cfg, traffic, seed, device)
    ke, demand = edge_slots(state, consts, cfg, int(cfg["frames"]))
    return types.SimpleNamespace(
        state=state, consts=consts, ke=ke, demand=demand,
        program=program_inputs(state, consts, info, cfg, ke),
        lw=dict(cfg["loss_weights"]), lr=float(cfg["lr"]), device=device)


def optimizer_steps(cfg):
    return int(cfg["steps"])


def fit(inputs, steps):
    """(final states, histories {key: (clips, steps)})."""
    from homan_tpu_torch.parallel.clips import fit_clips_batched
    states, pconsts, pcfg, settings, hand_faces = inputs.program
    return fit_clips_batched(states, pconsts, pcfg, loss_weights=inputs.lw,
                             num_iterations=steps, lr=inputs.lr,
                             roi_settings=settings,
                             closed_hand_faces=hand_faces,
                             device=inputs.device)


def units(inputs):
    return inputs.state["t_obj"].shape[0]


def finite(output):
    import torch
    final, hist = output
    C = hist["loss"].shape[0]
    return (torch.isfinite(hist["loss"]).all(1)
            & torch.isfinite(final.translations_object).reshape(C, -1).all(1))


def release(inputs):
    inputs.program = None


def compare(output, inputs, cfg, traffic, seed):
    """compare.run on the last fit's histories, its steps followed by the
    reference for `check_clips` clips drawn from the seed."""
    import torch
    _, hist = output
    port_hist = {k: v.detach() for k, v in hist.items()}
    gen = torch.Generator().manual_seed(int(seed))
    sample = sorted(torch.randperm(units(inputs), generator=gen)[
        :int(traffic["check_clips"])].tolist())
    figures, detail = comparison.run(
        port_hist, inputs.state, inputs.consts, recipe_constants(cfg),
        inputs.lw, int(cfg["check_steps"]), inputs.lr, sample)
    C, B = inputs.state["t_obj"].shape[:2]
    detail.update(clips=C, frames=B, ke=inputs.ke, demand=inputs.demand,
                  sample=sample)
    return figures, detail


def work(output, inputs, cfg):
    """The work of one step at the traced fit's last leaves (the stretch
    is its last steps, over which the leaves barely move)."""
    import torch
    from portbench.reference import losses, voxel
    from portbench.yardstick import work as W
    state, consts, lw, ke = inputs.state, inputs.consts, inputs.lw, inputs.ke
    leaves = dict(state)
    leaves.update(final_leaves(output[0]))
    r = cfg["raster"]
    S = cfg["rend_size"]
    B = int(cfg["frames"])
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


def faults():
    return {"half_update": half_update}
