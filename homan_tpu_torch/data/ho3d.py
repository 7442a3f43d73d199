"""HO-3D (v2) dataset: GT hand/object poses for YCB objects
(homan_tpu/data/ho3d.py), with the reference's conventions:
  * per-frame meta pickles under {root}/{train|evaluation}/{seq}/meta,
    RGB under ./rgb;
  * camera extrinsics flip y/z;
  * GT hand verts from MANO (axis-angle, flat mean) in meters, translated by
    handTrans, through the port's `mano_forward` on the dataset's device;
  * 21-joint reorder (`core.mano.JOINT_REORDER`);
  * YCB exemplar meshes textured_simple_2000.obj;
  * frame/vid/chunk sampling modes with pickle index caches.

Everything but the MANO forward is host numpy; every array a sample holds
is numpy.
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from homan_tpu_torch import resolve_device
from homan_tpu_torch.core import mano as mano_lib
from homan_tpu_torch.core.meshes import load_obj
from homan_tpu_torch.data.chunking import chunk_vid_index, collate

# Split sequence lists, matching homan/datasets/ho3dconstants.py membership
# exactly (the dataset index iterates the split in sorted order, as the
# reference does at ho3dutils.py:36).
TRAIN_SEQS = [
    "ABF10", "ABF11", "ABF12", "ABF13", "ABF14", "BB10", "BB11", "BB12",
    "BB13", "BB14", "GPMF10", "GPMF11", "GPMF12", "GPMF13", "GPMF14",
    "GSF10", "GSF11", "GSF12", "GSF13", "GSF14", "MC1", "MC2", "MC4", "MC5",
    "MC6", "MDF10", "MDF11", "MDF12", "MDF13", "MDF14", "ND2", "SB10",
    "SB12", "SB14", "SM2", "SM3", "SM4", "SM5", "SMu1", "SMu40", "SMu41",
    "SMu42", "SS1", "SS2", "SS3", "ShSu10", "ShSu12", "ShSu13", "ShSu14",
    "SiBF10", "SiBF11", "SiBF12", "SiBF13", "SiBF14", "SiS1",
]
TRAINVAL_SEQS = [
    "ABF10", "ABF12", "ABF13", "ABF14", "BB10", "BB11", "BB13", "BB14",
    "GPMF10", "GPMF11", "GPMF12", "GPMF14", "GSF10", "GSF11", "GSF12",
    "GSF13", "MC1", "MC2", "MC4", "MC5", "MDF10", "MDF11", "MDF12", "MDF13",
    "SB10", "SB12", "SB14", "SM2", "SM4", "SM5", "SMu1", "SMu40", "SMu42",
    "SS1", "SS2", "SS3", "ShSu10", "ShSu12", "ShSu13", "ShSu14", "SiBF10",
    "SiBF11", "SiBF12", "SiBF13",
]
VAL_SEQS = ["ABF11", "BB12", "GPMF13", "GSF14", "MC6", "MDF14", "ND2", "SM3",
            "SMu41", "SiBF14", "SiS1"]
TEST_SEQS = ["AP10", "AP11", "AP12", "AP13", "AP14", "MPM10", "MPM11",
             "MPM12", "MPM13", "MPM14", "SB11", "SB13", "SM1"]
# Official evaluation ordering (evalho3drecons.py:66-69): seen-object
# sequences first, then the unseen AP* sequences. The seen/unseen boundary
# at frame 7694 of this ordering is where AP10 starts.
EVAL_SEQ_ORDER = ["SM1", "MPM10", "MPM11", "MPM12", "MPM13", "MPM14",
                  "SB11", "SB13", "AP10", "AP11", "AP12", "AP13", "AP14"]
# Codalab seen/unseen YCB split boundary (evalho3drecons.py:140-147): frame
# index within the full interpolated EVAL_SEQ_ORDER frame stream.
SEEN_UNSEEN_BOUNDARY_IDX = 7694


def load_objects(ycb_root: str) -> Dict[str, Dict]:
    """YCB exemplar meshes (homan/datasets/ho3dfullutils.py:7-21)."""
    models = {}
    if not os.path.isdir(ycb_root):
        return models
    for name in sorted(os.listdir(ycb_root)):
        obj_path = os.path.join(ycb_root, name, "textured_simple_2000.obj")
        if os.path.exists(obj_path):
            verts, faces = load_obj(obj_path)
            models[name] = {"verts": verts, "faces": faces, "path": obj_path}
    return models


def build_frame_index(seqs: List[str], root: str, subfolder: str):
    """Walk per-frame meta pickles into (frame_index_rows, annotations)
    (homan/datasets/ho3dutils.py:23-62)."""
    rows = []
    annotations = {}
    for seq in sorted(seqs):
        meta_folder = os.path.join(root, subfolder, seq, "meta")
        if not os.path.isdir(meta_folder):
            warnings.warn(f"missing sequence folder {meta_folder}")
            continue
        frames = sorted(f for f in os.listdir(meta_folder)
                        if f.endswith(".pkl"))
        for fname in frames:
            frame_idx = int(os.path.splitext(fname)[0])
            with open(os.path.join(meta_folder, fname), "rb") as f:
                annot = pickle.load(f)
            annot["img"] = os.path.join(root, subfolder, seq, "rgb",
                                        f"{os.path.splitext(fname)[0]}.png")
            annotations[(seq, frame_idx)] = annot
            rows.append({"seq_idx": seq, "frame_idx": frame_idx,
                         "obj_id": annot.get("objName", "")})
    # Per-sequence frame counts for chunking
    vid_rows = []
    for seq in sorted(seqs):
        fids = sorted(fi for (s, fi) in annotations if s == seq)
        if fids:
            vid_rows.append({"seq_idx": seq, "frame_nb": len(fids),
                             "frame_ids": fids,
                             "obj_id": annotations[(seq, fids[0])].get(
                                 "objName", "")})
    return rows, vid_rows, annotations


class HO3D:
    def __init__(self,
                 root: str = "local_data/datasets",
                 ycb_root: str = "local_data/datasets/ycbmodels",
                 mano_root: str = "extra_data/mano",
                 split: str = "val",
                 mode: str = "chunk",
                 frame_nb: int = 10,
                 chunk_step: int = 4,
                 chunk_spacing: int = 200,
                 track: bool = False,
                 box_mode: str = "gt",
                 use_cache: bool = True,
                 cache_folder: str = "data/cache",
                 load_img: bool = True,
                 mano_layer: Optional[mano_lib.ManoLayer] = None,
                 device=None):
        """device: where the GT hand's MANO forward runs (default `cuda`;
        raises when CUDA is absent); the parameters of `mano_layer` are
        expected there."""
        self.name = "ho3d"
        self.device = resolve_device(device)
        self.image_size = 640
        self.full_image_size = (640, 480)
        self.setup = {"right_hand": 1, "objects": 1}
        self.mode = mode
        self.frame_nb = frame_nb
        self.track = track
        self.box_mode = box_mode
        self.load_img = load_img
        self.root = os.path.join(root, self.name)
        if not os.path.isdir(self.root):
            raise RuntimeError(
                f"HO3D dataset not found at {self.root}; download HO-3D v2 "
                "and the YCB exemplar meshes (see README data section)")
        # y/z flip: HO3D poses are in an OpenGL-style frame (ho3d.py:83-84)
        self.camextr = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                                 [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)
        self.reorder_idxs = np.asarray(mano_lib.JOINT_REORDER)

        if mano_layer is not None:
            self.mano = mano_layer
        elif os.path.exists(os.path.join(mano_root, "MANO_RIGHT.pkl")):
            self.mano = mano_lib.ManoLayer.from_folder(mano_root,
                                                       device=self.device)
        else:
            self.mano = None  # GT hand verts unavailable

        splits = {"train": (TRAIN_SEQS, "train"),
                  "trainval": (TRAINVAL_SEQS, "train"),
                  "val": (VAL_SEQS, "train"),
                  "test": (TEST_SEQS, "evaluation")}
        assert split in splits, f"{split} not in {list(splits)}"
        self.split = split
        seqs, subfolder = splits[split]
        self.subfolder = subfolder

        cache_path = os.path.join(cache_folder, f"{self.name}_{split}.pkl")
        if use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                payload = pickle.load(f)
            self.frame_rows = payload["frame_rows"]
            self.vid_rows = payload["vid_rows"]
            self.annotations = payload["annotations"]
        else:
            self.frame_rows, self.vid_rows, self.annotations = \
                build_frame_index(seqs, self.root, subfolder)
            if use_cache:
                os.makedirs(cache_folder, exist_ok=True)
                with open(cache_path, "wb") as f:
                    pickle.dump({"frame_rows": self.frame_rows,
                                 "vid_rows": self.vid_rows,
                                 "annotations": self.annotations}, f)

        # Tracked boxes (box_mode="track"): replaces GT-derived boxes with
        # track_dataset.py output (homan/datasets/ho3d.py:439-468 role).
        self.tracked_boxes = None
        if box_mode == "track":
            boxes_path = os.path.join("data", "boxes",
                                      f"boxes_ho3d_{split}.pkl")
            if os.path.exists(boxes_path):
                with open(boxes_path, "rb") as f:
                    self.tracked_boxes = pickle.load(f)
            else:
                warnings.warn(f"box_mode='track' but {boxes_path} missing; "
                              "falling back to GT boxes")

        self.obj_meshes = load_objects(ycb_root)
        if mode == "chunk":
            self.chunks = chunk_vid_index(self.vid_rows, chunk_size=frame_nb,
                                          chunk_step=chunk_step,
                                          chunk_spacing=chunk_spacing)
        elif mode == "vid":
            self.chunks = [dict(row, frame_idxs=row["frame_ids"])
                           for row in self.vid_rows]
        else:  # frame mode
            self.chunks = None

    def __len__(self):
        if self.mode == "frame":
            return len(self.frame_rows)
        return len(self.chunks)

    # ----- per-frame accessors (conventions of ho3d.py:270-360) -----
    def get_camintr(self, seq, frame_idx):
        annot = self.annotations[(seq, frame_idx)]
        return np.asarray(annot["camMat"], np.float64)

    def project(self, points3d, cam_intr, camextr=None):
        if camextr is not None:
            points3d = points3d @ camextr[:3, :3].T
        proj = points3d @ cam_intr.T
        return proj[:, :2] / proj[:, 2:]

    def get_joints3d(self, seq, frame_idx):
        annot = self.annotations[(seq, frame_idx)]
        joints = np.asarray(annot["handJoints3D"], np.float64)
        joints = joints @ self.camextr[:3, :3].T
        if joints.ndim == 1:
            joints = np.tile(joints[None], (21, 1))
        return joints[self.reorder_idxs].astype(np.float32)

    def get_hand_verts3d(self, seq, frame_idx):
        """GT MANO verts in meters, camera frame before the y/z flip
        (ho3d.py:313-340)."""
        annot = self.annotations[(seq, frame_idx)]
        if self.mano is None:
            raise RuntimeError("MANO data required for GT hand verts")
        if "handPose" in annot:
            pose = np.asarray(annot["handPose"], np.float32)
            trans = np.asarray(annot["handTrans"], np.float32).ravel()
            betas = np.asarray(annot["handBeta"], np.float32)
        else:
            pose = np.zeros(48, np.float32)
            trans = np.asarray(annot["handJoints3D"], np.float32).reshape(-1)[:3]
            betas = np.zeros(10, np.float32)
        def t(a):
            return torch.as_tensor(a[None], device=self.device)

        with torch.no_grad():
            out = mano_lib.mano_forward(self.mano.params["right"], t(betas),
                                        t(pose[:3]), t(pose[3:]))
        verts = out["verts"][0].cpu().numpy() + trans
        joints = out["joints"][0].cpu().numpy() + trans
        return verts, joints

    def get_obj_verts_trans(self, seq, frame_idx):
        """GT object verts posed in the camera frame (flipped)."""
        annot = self.annotations[(seq, frame_idx)]
        rot = np.asarray(annot["objRot"], np.float64).reshape(3)
        from scipy.spatial.transform import Rotation
        R = Rotation.from_rotvec(rot).as_matrix()
        t = np.asarray(annot["objTrans"], np.float64).ravel()
        verts_can = self.obj_meshes[annot["objName"]]["verts"]
        verts = verts_can @ R.T + t
        return (verts @ self.camextr[:3, :3].T).astype(np.float32)

    def get_obj_verts_can(self, seq, frame_idx):
        annot = self.annotations[(seq, frame_idx)]
        m = self.obj_meshes[annot["objName"]]
        return m["verts"], m["faces"]

    def get_frame_info(self, seq, frame_idx, load_img=True):
        annot = self.annotations[(seq, frame_idx)]
        cam = {"K": self.get_camintr(seq, frame_idx),
               "TWC": np.eye(4)}
        img = None
        if load_img and os.path.exists(annot["img"]):
            from PIL import Image
            img = np.asarray(Image.open(annot["img"]).convert("RGB"))
        hand_info = {"label": "right_hand"}
        if self.mano is not None and "handPose" in annot:
            verts3d, joints3d = self.get_hand_verts3d(seq, frame_idx)
            verts3d_cam = (verts3d @ self.camextr[:3, :3].T).astype(np.float32)
            hand_info["verts3d"] = verts3d_cam
            hand_info["joints3d"] = self.get_joints3d(seq, frame_idx)
            verts2d = self.project(verts3d_cam, cam["K"])
            hand_info["verts2d"] = verts2d.astype(np.float32)
            lo, hi = verts2d.min(0), verts2d.max(0)
            hand_info["bbox"] = np.array([lo[0], lo[1], hi[0], hi[1]],
                                         np.float32)
        obj_info = {"name": annot.get("objName", "")}
        if annot.get("objName", "") in self.obj_meshes:
            verts_can, faces = self.get_obj_verts_can(seq, frame_idx)
            obj_info["canverts3d"] = verts_can
            obj_info["faces"] = faces
            if "objRot" in annot:
                verts3d = self.get_obj_verts_trans(seq, frame_idx)
                obj_info["verts3d"] = verts3d
                proj = self.project(verts3d.astype(np.float64), cam["K"])
                lo, hi = proj.min(0), proj.max(0)
                obj_info["bbox"] = np.array([lo[0], lo[1], hi[0], hi[1]],
                                            np.float32)
        # box_mode="track": tracked boxes replace GT-derived ones
        if self.tracked_boxes is not None and seq in self.tracked_boxes:
            tracks = self.tracked_boxes[seq]
            fids = sorted(fi for (s, fi) in self.annotations if s == seq)
            row = fids.index(frame_idx)
            if "right_hand" in tracks:
                hand_info["bbox"] = np.asarray(tracks["right_hand"][row],
                                               np.float32)
            if "objects" in tracks:
                obj_info["bbox"] = np.asarray(tracks["objects"][row],
                                              np.float32)
        return img, cam, hand_info, obj_info

    def __getitem__(self, idx):
        """Clip sample dict (ho3d.py:212-267 contract); in frame mode, a
        single-frame obs dict (ho3d.py:212-223)."""
        if self.mode == "frame":
            row = self.frame_rows[idx]
            img, camera, hand_info, obj_info = self.get_frame_info(
                row["seq_idx"], row["frame_idx"], load_img=self.load_img)
            return {"img": img, "hands": [hand_info],
                    "objects": [obj_info], "camera": camera,
                    "setup": self.setup}
        chunk = self.chunks[idx]
        seq = chunk["seq_idx"]
        frame_ids = chunk.get("frame_ids")
        if "frame_idxs" in chunk and frame_ids is not None:
            frame_idxs = [frame_ids[i] for i in range(len(frame_ids))
                          ] if self.mode == "vid" else [
                              frame_ids[i] for i in chunk["frame_idxs"]]
        else:
            frame_idxs = chunk["frame_idxs"]
        images, hand_infos, obj_infos, cameras = [], [], [], []
        for fid in frame_idxs:
            img, camera, hand_info, obj_info = self.get_frame_info(
                seq, fid, load_img=self.load_img and not self.track)
            images.append(img)
            hand_infos.append(hand_info)
            obj_infos.append(obj_info)
            cameras.append(camera)
        collated_hand = collate(hand_infos)
        collated_hand["label"] = collated_hand["label"][0]
        return {
            "images": images,
            "hands": [collated_hand],
            "objects": [collate(obj_infos)],
            "camera": collate(cameras),
            "setup": self.setup,
            "frame_idxs": frame_idxs,
            "seq_idx": seq,
        }
