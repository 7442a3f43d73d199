"""Stages A and B from cached detector evidence, the --evidence_root path
(homan_tpu/frontend/cachedfit.py).

The production flow: the detectors (FrankMocap, PointRend, 100DOH) run
offline, elsewhere; their outputs are recorded per frame as CachedEvidence
records (frontend/adapters.py converts the reference's own artifacts). This
module assembles a clip's records into the independent-fit payload: the
hand estimates and masks, the object evidence, and the object-pose search
on it.

Where the port departs from the JAX module: stage B runs through
gtevidence.search_object_poses, which sizes the edge budget from the
measured demand and searches again when a render still overflowed (the JAX
module searches at the default budget and never checks the demand); the
payload carries that budget under "budgets". The JAX module's compile
prewarm has no counterpart: eager PyTorch compiles nothing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from homan_tpu_torch import resolve_device
from homan_tpu_torch.frontend import masks as mask_lib
from homan_tpu_torch.frontend.evidence import (CachedEvidence,
                                               get_frame_infos,
                                               stack_person_parameters)
from homan_tpu_torch.frontend.gtevidence import (_to_host, mask_to_bbox,
                                                 search_object_poses)


def frame_key(seq_idx, frame_id) -> str:
    """Name of a clip frame's CachedEvidence record."""
    return f"{seq_idx}_{int(frame_id):06d}"


def prepare_independent_fit_cached(annots: Dict, args, mano_layer,
                                   image_size: int, rend_size: int = 256,
                                   evidence_root: str = "",
                                   sample_folder: str = "/tmp",
                                   device=None) -> Dict:
    """The indep_fit payload of a clip from its cached evidence, every array
    numpy.

    Expects one record a frame at {evidence_root}/{seq_idx}_{frame:06d}.pkl
    with hand estimates (the FrankMocap layout of
    adapters.convert_person_parameters) and class-tagged hand and object
    masks. args needs num_initializations, num_obj_iterations, seed and
    optionally stageb_parallel_frames; `mano_layer` and `sample_folder` are
    unused, as in the JAX module. Besides the JAX payload it holds
    {"budgets": {"stage_b": ...}} (gtevidence.search_object_poses).
    """
    device = resolve_device(device)
    T = len(annots["frame_idxs"])
    K_px = np.asarray(annots["camera"]["K"], np.float64)
    cache = CachedEvidence(evidence_root)
    keys = [frame_key(annots.get("seq_idx", "clip"), fid)
            for fid in annots["frame_idxs"]]

    hand_bboxes = {}
    for hand in annots["hands"]:
        box = hand.get("bbox")
        hand_bboxes[hand["label"]] = (np.asarray(box, np.float32)
                                      if box is not None else None)
    obj_bboxes = np.asarray(annots["objects"][0]["bbox"], np.float32)
    if obj_bboxes.ndim == 1:
        obj_bboxes = np.tile(obj_bboxes[None], (T, 1))

    obj = annots["objects"][0]
    obj_verts_can = np.asarray(obj["canverts3d"])
    if obj_verts_can.ndim == 3:
        obj_verts_can = obj_verts_can[0]
    obj_faces = np.asarray(obj["faces"])
    if obj_faces.ndim == 3:
        obj_faces = obj_faces[0]

    # Tight per-frame boxes from the class-tagged detection masks: the
    # reference's boxes come from the detections themselves, and a
    # dataset's box can be a coarse union crop (CORe50's .mat crop holds
    # hand and object), which would mis-scale stage B's depth init. An
    # empty mask (a recorded miss) keeps the dataset's box.
    sides = [h["label"] for h in annots["hands"]]
    tight_hand = {s: [] for s in sides}
    tight_obj = []
    for key in keys:
        obj_m = cache.masks_from_bboxes(key, None, [-1])
        hand_m = cache.masks_from_bboxes(key, None, [0]) or []
        if (obj_m and "class_id" in obj_m[0]
                and np.any(obj_m[0]["full_mask"])):
            tight_obj.append(mask_to_bbox(obj_m[0]["full_mask"]))
        else:
            tight_obj.append(None)
        # Masks pair with sides by tag, by position only on a full set
        # (as in evidence.get_frame_infos).
        if hand_m and all("hand_side" in m for m in hand_m):
            paired = [(m["hand_side"], m) for m in hand_m
                      if m.get("hand_side") in tight_hand]
        elif len(hand_m) == len(sides):
            paired = list(zip(sides, hand_m))
        else:
            paired = []
        for s, m in paired:
            if "class_id" in m and np.any(m["full_mask"]):
                tight_hand[s].append(mask_to_bbox(m["full_mask"]))
    if all(b is not None for b in tight_obj):
        obj_bboxes = np.stack(tight_obj)
    for s in sides:
        if len(tight_hand[s]) == T:
            hand_bboxes[s] = np.stack(tight_hand[s])

    person_frames, obj_infos = get_frame_infos(
        images=[None] * T, hand_provider=cache, mask_provider=cache,
        hand_bboxes=hand_bboxes, obj_bboxes=obj_bboxes, camintr=K_px,
        image_size=image_size, rend_size=rend_size, frame_keys=keys)

    found, search_budget = search_object_poses(
        obj_verts_can, obj_faces, obj_infos, [K_px[t] for t in range(T)],
        image_size, args, rend_size, device)
    object_parameters = []
    for t in range(T):
        frame = {k: _to_host(v) for k, v in found[t].items()}
        full = np.asarray(obj_infos[t]["full_mask"], np.float32)
        frame["masks"] = full
        frame["full_mask"] = full
        object_parameters.append(frame)

    person_parameters = stack_person_parameters(person_frames)
    hand_sides = [s.replace("_hand", "")
                  for s in person_parameters.pop("hand_sides")]
    H = len(hand_sides)

    # Occlusion-aware hand targets and per-hand ROI intrinsics: one call
    # over all T*H interleaved rows (row t * H + h), each with its frame's
    # object mask and intrinsics.
    if "masks" in person_parameters:
        obj_full = np.stack([np.asarray(obj_infos[t]["full_mask"],
                                        np.float32) for t in range(T)])
        pp = {"bboxes": person_parameters["bboxes"],
              "masks": person_parameters["masks"]}
        batched = mask_lib.add_target_hand_occlusions(
            pp, {"full_mask": np.repeat(obj_full, H, axis=0)},
            np.repeat(np.asarray(K_px, np.float32), H, axis=0),
            rend_size=rend_size)
        person_parameters["target_masks"] = batched["target_masks"]
        person_parameters["K_roi"] = batched["K_roi"]
    person_parameters["hand_sides"] = hand_sides

    return {
        "person_parameters": person_parameters,
        "object_parameters": object_parameters,
        "obj_verts_can": obj_verts_can,
        "obj_faces": obj_faces,
        "hand_sides": hand_sides,
        "budgets": {"stage_b": search_budget},
    }
