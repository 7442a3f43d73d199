"""Fit hand and object poses over dataset clips: the main driver
(homan_tpu/cli/fit_video.py).

  stage A: GT instance masks and hand evidence (--gt_masks 1,
           frontend/gtevidence.py), or recorded detections replayed
           (--evidence_root DIR, frontend/cachedfit.py);
  stage B: the object-pose search (fit/poseinit.py);
  stage C: the joint hand-object fit (fit/joint.py), its edge budget sized
           from the measured demand and re-run with a larger one when a
           step still overflowed;
  outputs: indep_fit.pkl, joint_fit.npz and results.pkl (point and
           interaction metrics) per sample, and the aggregate results.pkl;
           the overlay renders (viz/render_viz.py): final_points.png (the
           frontal, top-down and initial rows), final_points.webm and,
           with --viz_step, optim_evolution.webm of the snapshots taken
           every viz_step joint steps. Where cv2 is not installed the
           videos are animated PNGs, <stem>.apng; where matplotlib is not,
           the grid is a PNG without row labels. A failed render logs a
           warning ("viz_step render failed", "visualization failed") and
           keeps the fit.

Run on the card:
  python -m homan_tpu_torch.cli.fit_video --dataset ho3d --split val \\
      --gt_masks 1 --frame_nb 10 --num_initializations 500
  python -m homan_tpu_torch.cli.fit_video --dataset core50 \\
      --evidence_root DIR
or on the CPU from Python: main(get_args([...]), device="cpu").

--frames_sharded 1 splits stage C's frames over the CUDA devices
(parallel/frames.py), over as many as divide the clip; where only one
does (one card), it logs a warning and fits unsharded, as the JAX driver.
"""
from __future__ import annotations

import argparse
import functools
import logging
import os
import pickle
from collections import defaultdict

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core.mano import ManoLayer
from homan_tpu_torch.core.meshes import load_closed_hand_faces
from homan_tpu_torch.data.factory import get_dataset
from homan_tpu_torch.eval import pointmetrics
from homan_tpu_torch.fit import joint, postprocess
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.frontend import cachedfit, gtevidence
from homan_tpu_torch.parallel import frames as fpar
from homan_tpu_torch.parallel import multihost
from homan_tpu_torch.render.rasterizer import (MeshTopology, RasterSettings,
                                               auto_edge_settings,
                                               bump_edge_settings)
from homan_tpu_torch.utils_profiling import StageTimers
from homan_tpu_torch.viz import render_viz

logger = logging.getLogger("homan_tpu_torch.fit_video")


def get_args(argv=None):
    """The JAX driver's flags and defaults."""
    parser = argparse.ArgumentParser(
        description="Optimize object meshes w.r.t. hand.")
    parser.add_argument("--dataset", default="ho3d",
                        choices=["ho3d", "epic", "core50"])
    parser.add_argument("--split", default="val",
                        choices=["train", "val", "trainval", "test"])
    parser.add_argument("--chunk_step", default=4, type=int)
    parser.add_argument("--frame_nb", default=10, type=int)
    parser.add_argument("--data_step", default=100, type=int)
    parser.add_argument("--data_offset", default=0, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--box_mode", choices=["gt", "track"], default="gt")
    parser.add_argument("--output_dir", default="output")
    parser.add_argument("--num_obj_iterations", default=50, type=int)
    parser.add_argument("--num_joint_iterations", default=201, type=int)
    parser.add_argument("--num_initializations", default=500, type=int)
    parser.add_argument("--mesh_path", type=str)
    parser.add_argument("--result_root", default="results/tmp")
    parser.add_argument("--resume")
    parser.add_argument("--resume_indep", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--viz_step", default=20, type=int,
                        help="an overlay snapshot every viz_step joint "
                             "steps, written as optim_evolution.webm; 0 "
                             "takes none")
    parser.add_argument("--save_indep", action="store_true")
    parser.add_argument("--only_missing", choices=[0, 1], type=int)
    parser.add_argument("--gt_masks", choices=[0, 1], default=0, type=int)
    parser.add_argument("--evidence_root", type=str,
                        help="folder of per-frame CachedEvidence records "
                             "(frontend/adapters.py record_cached_evidence)"
                             ", replayed as stage A's evidence")
    parser.add_argument("--hand_checkpoint",
                        default="extra_data/hand_module/pretrained_weights/"
                                "pose_shape_best.pth",
                        help="accepted for the reference CLI's flags: the "
                             "checkpoint of a live hand regressor, which "
                             "this pipeline does not run (it reads GT or "
                             "recorded evidence)")
    parser.add_argument("--smpl_path", default="extra_data/smpl",
                        help="accepted for the reference CLI's flags; see "
                             "--hand_checkpoint")
    parser.add_argument("--optimize_mano", choices=[0, 1], default=1, type=int)
    parser.add_argument("--optimize_mano_beta", choices=[0, 1], default=1,
                        type=int)
    parser.add_argument("--optimize_object_scale", choices=[0, 1], default=0,
                        type=int)
    parser.add_argument("--hand_proj_mode", default="persp",
                        choices=["ortho", "persp"])
    parser.add_argument("--sdf_mode", default="direct",
                        choices=["grid", "direct"],
                        help="collision/contact SDF: 'direct' = exact "
                             "interior SDF at sampled verts, 'grid' = "
                             "voxelize + trilinear (the reference's)")
    parser.add_argument("--collision_mode", default="sdf",
                        choices=["sdf", "tritri"],
                        help="collision backend: 'sdf' (the SDF "
                             "penetration term) or 'tritri' (intersecting "
                             "triangle pairs, interactions/intersect.py)")
    parser.add_argument("--rend_size", default=256, type=int)
    parser.add_argument("--stageb_parallel_frames", choices=[0, 1], default=0,
                        type=int,
                        help="refine stage-B frames 1..T-1 together, each "
                             "from frame 0's candidates, instead of "
                             "chaining them")
    parser.add_argument("--frames_sharded", choices=[0, 1], default=0,
                        type=int,
                        help="shard stage C's frames over the CUDA "
                             "devices that divide the clip "
                             "(parallel/frames.py); unsharded, with a "
                             "warning, where only one does")
    parser.add_argument("--prewarm", choices=[0, 1], default=1, type=int,
                        help="accepted for the JAX driver's flags: it "
                             "compiles stage C while stages A and B run; "
                             "eager PyTorch compiles nothing")
    parser.add_argument("--mano_root", default="extra_data/mano")
    parser.add_argument("--closed_fmano_path", type=str,
                        help="closed-fist MANO faces npy; when absent the "
                             "wrist ring is closed by fan triangulation")
    # Loss weights: the reference's lw_ convention.
    parser.add_argument("--lw_smooth", type=float, default=2000)
    parser.add_argument("--lw_v2d_hand", type=float, default=50)
    parser.add_argument("--lw_inter", type=float, default=1)
    parser.add_argument("--lw_contact", type=float, default=0)
    parser.add_argument("--lw_depth", type=float, default=0)
    parser.add_argument("--lw_pca", type=float, default=0.004)
    parser.add_argument("--lw_sil_obj", type=float, default=1)
    parser.add_argument("--lw_sil_hand", type=float, default=0)
    parser.add_argument("--lw_collision", type=float, default=0)
    parser.add_argument("--lw_scale_obj", type=float, default=0.001)
    parser.add_argument("--lw_scale_hand", type=float, default=0.001)
    args = parser.parse_args(argv)
    args.lw_smooth_obj = args.lw_smooth
    args.lw_smooth_hand = args.lw_smooth
    logger.info("Calling with args: %s", args)
    return args


def build_joint_inputs(person_parameters, object_parameters, obj_verts_can,
                       obj_faces, camintr_nc, hand_sides, mano_layer,
                       image_size, rend_size, masks_shape,
                       sdf_mode="direct", collision_mode="sdf",
                       optimize_mano=True, optimize_mano_beta=True,
                       optimize_object_scale=False, hand_proj_mode="persp",
                       device=None):
    """Person and object parameter dicts (numpy) -> (state, consts, cfg)
    on `device` (default `cuda`)."""
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    B = len(object_parameters)
    H = len(hand_sides)
    cfg = M.HomanConfig(hand_sides=tuple(hand_sides), image_size=image_size,
                        rend_size=rend_size, sdf_mode=sdf_mode,
                        collision_mode=collision_mode,
                        optimize_mano=bool(optimize_mano),
                        optimize_mano_beta=bool(optimize_mano_beta),
                        optimize_object_scale=bool(optimize_object_scale),
                        hand_proj_mode=hand_proj_mode)
    obj_trans = torch.cat([t(o["translations"]) for o in object_parameters])
    obj_rots = torch.cat([t(o["rotations"]) for o in object_parameters])
    obj_tar = torch.cat([t(o["target_masks"]).reshape(
        (-1,) + np.shape(o["target_masks"])[-2:]) for o in object_parameters])
    obj_Kroi = torch.cat([t(o["K_roi"])[:, 0] if np.ndim(o["K_roi"]) == 4
                          else t(o["K_roi"]) for o in object_parameters])

    p = person_parameters  # stacked dict, rows t * H + h
    state = M.init_state(
        cfg,
        translations_object=obj_trans,
        rotations_object=obj_rots,
        translations_hand=t(p["translations"]).reshape(B * H, 1, 3),
        rotations_hand=t(p["rotations"]),
        mano_pca_pose=t(p["mano_pca_pose"]),
        mano_rot=t(p["mano_rot"]),
        mano_trans=t(p["mano_trans"]),
        mano_betas=t(p["mano_betas"]),
        device=device)
    hand_tar = t(p["target_masks"])
    consts = M.HomanConsts(
        verts_object_og=t(obj_verts_can),
        faces_object=MeshTopology.from_faces(np.asarray(obj_faces),
                                             device=device),
        verts_hand_og=t(p["verts"]),
        faces_hand=MeshTopology.from_faces(mano_layer.faces("right"),
                                           device=device),
        ref_verts2d_hand=t(p["verts2d"]),
        ref_mask_object=(obj_tar > 0).to(torch.float32),
        keep_mask_object=(obj_tar >= 0).to(torch.float32),
        ref_mask_hand=(hand_tar > 0).to(torch.float32),
        keep_mask_hand=(hand_tar >= 0).to(torch.float32),
        camintr_rois_object=obj_Kroi,
        camintr_rois_hand=t(p["K_roi"]),
        camintr=t(camintr_nc),
        mano_params_by_side={s: mano_layer.params[s] for s in hand_sides},
        masks_object=torch.stack(
            [t(o["masks"]) if o.get("masks") is not None
             else torch.zeros(masks_shape, device=device)
             for o in object_parameters]),
        masks_hand=t(p.get("masks", np.zeros((B * H,) + tuple(masks_shape),
                                             np.float32))))
    return state, consts, cfg


def _frames_shard_devices(frame_nb: int, device) -> int:
    """Largest count of CUDA mesh entries that divides the clip length
    (whole frames per entry); 1 = not applicable. Inside a process group
    the entries are every process's CUDA devices, as the JAX driver's
    len(jax.devices()) counts them, in the sizes a mesh over the processes
    takes (the same count from each)."""
    if device.type != "cuda":
        return 1
    world = multihost.process_count()
    return max((world * j for j in range(1, torch.cuda.device_count() + 1)
                if frame_nb % (world * j) == 0), default=1)


def _sample_metrics(annots, state, final_state, consts, cfg, device):
    """Point metrics against the dataset's GT (object and hand) and the
    interaction metrics of the fit and of its initial state, with the
    reference's key names. Nothing here swallows a failure: the interaction
    metrics run the voxelizer on the card."""
    fit = postprocess.post_process(final_state, consts.mano_params_by_side,
                                   consts.verts_object_og, cfg,
                                   verts_hand_og=consts.verts_hand_og)
    init = postprocess.post_process(state, consts.mano_params_by_side,
                                    consts.verts_object_og, cfg,
                                    verts_hand_og=consts.verts_hand_og)
    runs = (("", fit), ("_init", init))
    metrics = {}

    def gt(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    gt_obj = annots["objects"][0].get("verts3d")
    if gt_obj is not None:
        gt_obj = gt(gt_obj)
        for suffix, res in runs:
            for k, v in pointmetrics.get_point_metrics(
                    gt_obj, res["verts_object"]).items():
                metrics[f"{k}_obj{suffix}"] = v
    gt_hand = annots["hands"][0].get("verts3d")
    if gt_hand is not None and np.abs(gt_hand).sum() > 0:
        gt_hand = gt(gt_hand).reshape(-1, 778, 3)
        for suffix, res in runs:
            metrics[f"verts_dists_hand{suffix}"] = \
                pointmetrics.get_point_metrics(
                    gt_hand, res["verts_hand"])["verts_dists"]
            if gt_obj is not None:
                for k, v in pointmetrics.get_align_metrics(
                        gt_hand, res["verts_hand"], gt_obj,
                        res["verts_object"]).items():
                    metrics[f"{k}{suffix}"] = v
    # Interaction metrics need no GT; the hands of a frame merge into one
    # point set.
    for suffix, res in runs:
        nframes = res["verts_object"].shape[0]
        for k, v in pointmetrics.get_inter_metrics(
                res["verts_hand"].reshape(nframes, -1, 3),
                res["verts_object"], consts.faces_hand,
                consts.faces_object).items():
            metrics[f"{k}{suffix}"] = v
    return metrics


def _write_overlays(timers, sample_folder, state, final_state, consts, cfg,
                    annots, args, optim_frames, viz_budgets):
    """The final overlays (fit_vid_dataset.py:403-469 role): the grid of
    frontal, top-down and initial renders of the first five frames, the
    frontal | top-down video and the snapshots' evolution video. Returns
    the paths written; a failed render logs a warning and keeps the fit."""
    written = []
    try:
        with timers.time("viz_final", sync=True):
            n = min(5, args.frame_nb)
            frontal, top_down = render_viz.visualize_hand_object(
                final_state, consts, cfg, images=annots.get("images"),
                viz_len=n, image_size=256, budgets=viz_budgets)
            init_frontal, _ = render_viz.visualize_hand_object(
                state, consts, cfg, images=annots.get("images"), viz_len=n,
                image_size=256, budgets=viz_budgets)
            written.append(render_viz.save_image_grid(
                {"frontal": frontal, "top_down": top_down,
                 "init": init_frontal},
                os.path.join(sample_folder, "final_points.png")))
            written.append(render_viz.make_video(
                [np.concatenate([f, t], axis=1)
                 for f, t in zip(frontal, top_down)],
                os.path.join(sample_folder, "final_points.webm"), fps=8))
            if optim_frames:
                written.append(render_viz.make_video(
                    [init_frontal[0]] + optim_frames + [frontal[0]],
                    os.path.join(sample_folder, "optim_evolution.webm"),
                    fps=4))
    except Exception as exc:  # a render error must not lose the fit
        logger.warning("visualization failed: %s", exc, exc_info=True)
    return written


def main(args, device=None):
    """Fit every `data_step`-th sample of the dataset from `data_offset`.

    device: where everything runs (default `cuda`; raises when CUDA is
    absent). Files hold numpy arrays only. Returns one summary per fitted
    sample: {"sample", "timers" (seconds by stage), "budgets",
    "final_loss", "viz_files" (the overlay files written), "viz_budgets"
    (each overlay render's tile, Kf and face demand by tile)}.
    """
    device = resolve_device(device)
    np.random.seed(args.seed)
    dataset, image_size = get_dataset(args.dataset, split=args.split,
                                      frame_nb=args.frame_nb,
                                      box_mode=args.box_mode,
                                      chunk_step=args.chunk_step,
                                      mano_root=args.mano_root,
                                      device=device)
    print(f"Processing {len(dataset)} samples")
    if os.path.exists(os.path.join(args.mano_root, "MANO_RIGHT.pkl")):
        mano_layer = ManoLayer.from_folder(args.mano_root, device=device)
    else:
        logger.warning("MANO data not found at %s: using the synthetic test "
                       "model (fits will be structurally correct only)",
                       args.mano_root)
        mano_layer = ManoLayer.synthetic(0, device=device)
    loss_weights = {k: v for k, v in vars(args).items() if k.startswith("lw_")}
    loss_weights.pop("lw_smooth", None)

    closed_hand_faces = None
    if loss_weights.get("lw_collision", 0) > 0 or \
            loss_weights.get("lw_contact", 0) > 0:
        path = args.closed_fmano_path
        if path and not os.path.exists(path):
            raise SystemExit(f"--closed_fmano_path not found: {path}")
        closed_hand_faces = load_closed_hand_faces(
            path, mano_layer.faces("right").cpu().numpy())

    all_metrics = defaultdict(list)
    summaries = []
    for sample_idx in range(args.data_offset, len(dataset), args.data_step):
        timers = StageTimers()
        sample_folder = os.path.join(args.result_root, "samples",
                                     f"{sample_idx:08d}")
        os.makedirs(sample_folder, exist_ok=True)
        check_path = os.path.join(sample_folder, "joint_fit.npz")
        if args.only_missing and os.path.exists(check_path):
            print(f"Skipping existing {check_path}")
            continue

        with timers.time("annots_fetch"):
            annots = dataset[sample_idx]
        indep_fit_path = os.path.join(sample_folder, "indep_fit.pkl")
        state_override = None
        if args.resume:
            resume_folder = os.path.join(args.resume, "samples",
                                         f"{sample_idx:08d}")
            with open(os.path.join(resume_folder, "indep_fit.pkl"),
                      "rb") as f:
                indep = pickle.load(f)
            if not args.resume_indep:
                ck = np.load(os.path.join(resume_folder, "joint_fit.npz"))
                state_override = {k: ck[k] for k in ck.files}
        else:
            if not args.gt_masks and not args.evidence_root:
                raise SystemExit(
                    "need --gt_masks 1 or --evidence_root (no detector "
                    "networks are bundled)")
            with timers.time("stageAB_evidence_poseinit", sync=True):
                if args.gt_masks:
                    indep = gtevidence.prepare_independent_fit(
                        annots, args, dataset, mano_layer, image_size,
                        rend_size=args.rend_size,
                        sample_folder=sample_folder, device=device)
                else:
                    indep = cachedfit.prepare_independent_fit_cached(
                        annots, args, mano_layer, image_size,
                        rend_size=args.rend_size,
                        evidence_root=args.evidence_root,
                        sample_folder=sample_folder, device=device)
            with timers.time("save_indep"):
                with open(indep_fit_path, "wb") as f:
                    pickle.dump(indep, f)

        camintr_nc = np.asarray(annots["camera"]["K"], np.float64).copy()
        camintr_nc[:, :2] = camintr_nc[:, :2] / image_size

        with timers.time("build_joint_inputs"):
            state, consts, cfg = build_joint_inputs(
                indep["person_parameters"], indep["object_parameters"],
                indep["obj_verts_can"], indep["obj_faces"], camintr_nc,
                indep["hand_sides"], mano_layer, image_size, args.rend_size,
                (image_size, image_size), sdf_mode=args.sdf_mode,
                collision_mode=args.collision_mode,
                optimize_mano=args.optimize_mano,
                optimize_mano_beta=args.optimize_mano_beta,
                optimize_object_scale=args.optimize_object_scale,
                hand_proj_mode=args.hand_proj_mode, device=device)
        if state_override is not None:
            state = postprocess.state_from_dict(state_override, device)

        # Edge budget sized from the demand at the initial poses: a dropped
        # contour edge corrupts the winding region, so the budget is never
        # warned past (auto_edge_settings keeps the defaults where they
        # cover the demand, and raises where no tile can).
        default_settings = RasterSettings(image_size=args.rend_size)
        with timers.time("edge_budget_check", sync=True):
            with torch.no_grad():
                vo, _ = M.get_verts_object_parts(
                    state.rotations_object, state.translations_object,
                    state.int_scales_object, consts.verts_object_og)
            sized = auto_edge_settings(vo, consts.faces_object,
                                       consts.camintr_rois_object,
                                       default_settings)
        roi_settings = None  # compute_all_losses' default settings
        if sized != default_settings:
            logger.warning(
                "edge budget sized for this mesh: edges_per_tile %d -> %d "
                "(tile_px %d -> %d)", default_settings.edges_per_tile,
                sized.edges_per_tile, default_settings.tile_px,
                sized.tile_px)
            roi_settings = sized

        # Overlay snapshots every viz_step steps (homan/jointopt.py:158-177
        # role), kept for the evolution video; each render's face budget
        # goes to viz_budgets.
        optim_frames, viz_budgets = [], []

        def viz_callback(iters_done, s):
            try:
                with timers.time("viz_step_snapshots", sync=True):
                    frontal, _ = render_viz.visualize_hand_object(
                        s, consts, cfg, images=annots.get("images"),
                        viz_len=1, image_size=256, budgets=viz_budgets)
                    optim_frames.append(frontal[0])
            except Exception as exc:  # a render error must not lose the fit
                logger.warning("viz_step render failed: %s", exc,
                               exc_info=True)

        fit = functools.partial(joint.optimize_hand_object, device=device)
        if args.frames_sharded:
            frame_nb = state.translations_object.shape[0]
            use = _frames_shard_devices(frame_nb, device)
            if use > 1:
                fmesh = fpar.make_frame_mesh(use)
                fit = functools.partial(fpar.fit_frames_sharded, mesh=fmesh)
                logger.info("stage C frame axis sharded over %d devices",
                            use)
            else:
                logger.warning(
                    "--frames_sharded: %d frames don't split over the "
                    "available devices; running unsharded", frame_nb)

        # The runtime backstop: every step re-measures the demand
        # (edge_budget_excess). A positive excess means the fit dropped
        # contour edges somewhere: discard it, bump the budget past the
        # measured demand and fit again from the same initial state;
        # bump_edge_settings raises when tile 16 cannot cover it.
        attempts = []
        for _ in range(4):
            cur = roi_settings or default_settings
            optim_frames.clear()
            with timers.time("stageC_joint_fit", sync=True):
                final_state, history = fit(
                    state, consts, cfg, loss_weights=loss_weights,
                    num_iterations=args.num_joint_iterations,
                    closed_hand_faces=closed_hand_faces,
                    roi_settings=roi_settings,
                    viz_step=args.viz_step or None,
                    viz_callback=viz_callback if args.viz_step else None)
            excess = (float(history["edge_budget_excess"].max())
                      if "edge_budget_excess" in history else 0.0)
            attempts.append({"tile_px": cur.tile_px,
                             "edges_per_tile": cur.edges_per_tile,
                             "excess": excess})
            if excess <= 0:
                break
            roi_settings = bump_edge_settings(
                cur, int(excess) + cur.edges_per_tile)
            logger.warning(
                "edge budget overflowed by %d mid-fit; discarding the fit "
                "and fitting again with edges_per_tile %d -> %d (tile_px "
                "%d -> %d), attempt %d", int(excess), cur.edges_per_tile,
                roi_settings.edges_per_tile, cur.tile_px,
                roi_settings.tile_px, len(attempts) + 1)
        else:
            raise RuntimeError(
                "edge budget still overflowing after exhausting the "
                "recovery ladder: the converged silhouettes are corrupted")

        np.savez(check_path, **postprocess.state_to_dict(final_state))
        viz_files = _write_overlays(timers, sample_folder, state, final_state,
                                    consts, cfg, annots, args, optim_frames,
                                    viz_budgets)

        with timers.time("metrics_postprocess", sync=True):
            sample_metrics = _sample_metrics(annots, state, final_state,
                                             consts, cfg, device)
        losses = {k: v.cpu().numpy() for k, v in history.items()}
        for k, v in losses.items():
            sample_metrics.setdefault(f"final_{k}", []).append(float(v[-1]))
        for k, v in sample_metrics.items():
            all_metrics[k].extend(v if isinstance(v, list) else [v])
        budgets = dict(indep.get("budgets", {}),
                       stage_c={"sized": {"tile_px": sized.tile_px,
                                          "edges_per_tile":
                                          sized.edges_per_tile},
                                "attempts": attempts})
        with open(os.path.join(sample_folder, "results.pkl"), "wb") as f:
            pickle.dump({"opts": vars(args), "metrics": sample_metrics,
                         "losses": {k: v.tolist() for k, v in losses.items()},
                         "budgets": budgets}, f)
        with open(os.path.join(args.result_root, "results.pkl"), "wb") as f:
            pickle.dump({"opts": vars(args), "metrics": dict(all_metrics)}, f)
        logger.info("[%d] stage timers:\n%s", sample_idx, timers.report())
        final_loss = float(losses["loss"][-1])
        print(f"[{sample_idx}] done; final loss {final_loss:.4f}")
        summaries.append({"sample": sample_idx,
                          "timers": dict(timers.totals),
                          "budgets": budgets, "final_loss": final_loss,
                          "viz_files": viz_files,
                          "viz_budgets": viz_budgets})
    return summaries


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)-8s %(message)s")
    main(get_args())
