"""EPIC-Kitchens action clips for in-the-wild hand-object fitting
(homan_tpu/data/epic.py): clips mined from the EPIC-100 annotations by verb
and noun, the public HOA hand-object detections read and tracked into
interpolated, smoothed boxes, a square ROI over the clip, and each noun
paired with a ShapeNet exemplar mesh.

Conventions kept: a fixed 200-pixel focal at the 456 x 256 video scale, the
square ROI covering every hand and object box of the clip, the verb and
noun filters' defaults. PIL is imported only to read frames
(TarFrameReader), pandas only to mine clips and by data/hoa.py.
"""
from __future__ import annotations

import os
import pickle
import tarfile
from typing import Dict, List, Optional

import numpy as np

from homan_tpu_torch.core.meshes import (load_obj,
                                         normalize_to_inscribed_sphere)
from homan_tpu_torch.data import hoa as hoa_lib
from homan_tpu_torch.tracking import kalman

DEFAULT_VERBS = ("take", "pick-up", "open", "close", "put", "pour", "hold")
FOCAL_PX = 200.0  # epic.py:385-392
VIDEO_W, VIDEO_H = 456, 256


class TarFrameReader:
    """Frames stored in per-video tar archives (homan/datasets/tarutils.py)."""

    def __init__(self, tar_root: str):
        self.tar_root = tar_root
        self._open: Dict[str, tarfile.TarFile] = {}

    def read_frame(self, video_id: str, frame_idx: int) -> np.ndarray:
        from PIL import Image
        import io as _io
        tar_path = os.path.join(self.tar_root, f"{video_id}.tar")
        if video_id not in self._open:
            self._open[video_id] = tarfile.open(tar_path)
        tf = self._open[video_id]
        name = f"./frame_{frame_idx:010d}.jpg"
        try:
            payload = tf.extractfile(name).read()
        except KeyError:
            payload = tf.extractfile(name[2:]).read()
        return np.asarray(Image.open(_io.BytesIO(payload)).convert("RGB"))


def track_clip_boxes(hoa_df, start: int, stop: int):
    """Interpolated per-frame boxes for object/left/right over [start, stop)
    (homan/tracking/trackhoa.py:26-182 role): take the highest-score
    detection per frame and entity, fill gaps by linear interpolation, then
    KF+RTS smooth."""
    T = stop - start
    tracks = {}
    for entity, sel in (("objects", ("object", "")),
                        ("left_hand", ("hand", "left")),
                        ("right_hand", ("hand", "right"))):
        det_type, side = sel
        boxes = np.full((T, 4), np.nan)
        sub = hoa_df[(hoa_df.det_type == det_type)
                     & (hoa_df.frame >= start) & (hoa_df.frame < stop)]
        if side:
            sub = sub[sub.side == side]
        for frame, grp in sub.groupby("frame"):
            best = grp.iloc[grp.score.values.argmax()]
            boxes[int(frame) - start] = [best.left, best.top,
                                         best.right, best.bottom]
        if np.isnan(boxes).all():
            tracks[entity] = None
            continue
        boxes = kalman.interpolate_missing(boxes)
        tracks[entity] = kalman.track_sequence_boxes(boxes)
    return tracks


def square_roi_for_clip(tracks: Dict[str, np.ndarray], margin: float = 0.1,
                        image_w: int = VIDEO_W, image_h: int = VIDEO_H):
    """Square crop covering all tracked boxes over the clip
    (epic.py:229-251)."""
    all_boxes = np.concatenate([t for t in tracks.values() if t is not None])
    x1, y1 = all_boxes[:, 0].min(), all_boxes[:, 1].min()
    x2, y2 = all_boxes[:, 2].max(), all_boxes[:, 3].max()
    side = max(x2 - x1, y2 - y1) * (1 + margin)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    return np.array([cx - side / 2, cy - side / 2, side], np.float64)


# Noun -> exemplar mesh registry (homan/datasets/epic.py:24-60): candidate
# paths are relative to `model_root` (the pre-simplified ShapeNet dump, same
# files as the Core50 registry) except the jug/pitcher, which the reference
# takes from the processed HO3D YCB pitcher; scale = object diameter in m.
EPIC_MODELS: Dict[str, Dict] = {
    "bottle": {"paths": ["d851cbc873de1c4d3b6eb309177a6753.obj"],
               "scale": 0.2},
    "jug": {"paths": [
        "local_data/datasets/ho3dv2/processmodels/019_pitcher_base/"
        "textured_simple_400.obj"], "scale": 0.25, "absolute": True},
    "pitcher": {"paths": [
        "local_data/datasets/ho3dv2/processmodels/019_pitcher_base/"
        "textured_simple_400.obj"], "scale": 0.25, "absolute": True},
    "plate": {"paths": ["95ac294f47fd7d87e0b49f27ced29e3.obj"],
              "scale": 0.3},
    "cup": {"paths": ["d75af64aa166c24eacbe2257d0988c9c.obj"],
            "scale": 0.12},
    "phone": {"paths": ["7ea27ed05044031a6fe19ebe291582.obj"],
              "scale": 0.07},
    "can": {"paths": ["3fd8dae962fa3cc726df885e47f82f16.obj"], "scale": 0.2},
}


def load_epic_models(shapenet_registry: Optional[Dict[str, str]] = None,
                     model_root: str = "local_data/datasets/shapenetmodels",
                     fallback_sphere: bool = True) -> Dict[str, Dict]:
    """Noun -> normalized exemplar mesh. Explicit registry wins, then
    EPIC_MODELS files on disk, then (with a warning-free default) a
    procedural sphere at the noun's metric scale so the pipeline stays
    runnable without the ShapeNet dump."""
    from homan_tpu_torch.core.meshes import icosphere
    models: Dict[str, Dict] = {}

    def add(noun, verts, faces, scale):
        verts = normalize_to_inscribed_sphere(verts, scale=scale)
        models[noun] = {"verts": verts, "faces": np.asarray(faces, np.int32),
                        "scale": scale}

    for noun, path in (shapenet_registry or {}).items():
        if os.path.exists(path):
            verts, faces = load_obj(path)
            add(noun, verts, faces,
                EPIC_MODELS.get(noun, {}).get("scale", 0.12))
    sphere_v, sphere_f = icosphere(3, 1.0)
    for noun, info in EPIC_MODELS.items():
        if noun in models:
            continue
        cands = [p if info.get("absolute") else os.path.join(model_root, p)
                 for p in info["paths"]]
        path = next((p for p in cands if os.path.exists(p)), None)
        if path is not None:
            verts, faces = load_obj(path)
            add(noun, verts, faces, info["scale"])
        elif fallback_sphere:
            add(noun, sphere_v, sphere_f, info["scale"])
    return models


class Epic:
    def __init__(self,
                 annotations_path: str = "local_data/datasets/epic/EPIC_100_train.pkl",
                 hoa_root: str = "local_data/datasets/epic/hoa",
                 frames_root: str = "local_data/datasets/epic/frames",
                 shapenet_registry: Optional[Dict[str, str]] = None,
                 model_root: str = "local_data/datasets/shapenetmodels",
                 nouns=("bottle", "jug", "can", "cup", "phone"),
                 verbs=DEFAULT_VERBS,
                 frame_nb: int = 10,
                 frame_step: int = 2,
                 image_size: int = 640,
                 use_cache: bool = True,
                 cache_folder: str = "data/cache",
                 load_img: bool = True):
        self.name = "epic"
        self.image_size = image_size
        self.load_img = load_img
        self.frame_nb = frame_nb
        self.frame_step = frame_step
        self.hoa_root = hoa_root
        self.frames = TarFrameReader(frames_root) if os.path.isdir(
            frames_root) else None
        self.models = load_epic_models(shapenet_registry,
                                       model_root=model_root)

        cache_path = os.path.join(
            cache_folder, f"epic_{'_'.join(sorted(nouns))[:40]}.pkl")
        if use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                self.clips = pickle.load(f)
        else:
            self.clips = self._mine_clips(annotations_path, nouns, verbs)
            if use_cache and self.clips:
                os.makedirs(cache_folder, exist_ok=True)
                with open(cache_path, "wb") as f:
                    pickle.dump(self.clips, f)

    def _mine_clips(self, annotations_path, nouns, verbs) -> List[Dict]:
        """Filter EPIC-100 action annotations by verb/noun
        (epic.py:162-207)."""
        if not os.path.exists(annotations_path):
            return []
        import pandas as pd
        annots = pd.read_pickle(annotations_path)
        sel = annots[annots.noun.isin(nouns) & annots.verb.isin(verbs)]
        clips = []
        for _, row in sel.iterrows():
            start = int(row.start_frame)
            stop = int(row.stop_frame)
            if stop - start < self.frame_nb * self.frame_step:
                continue
            clips.append({
                "video_id": row.video_id, "noun": row.noun, "verb": row.verb,
                "start": start, "stop": stop,
            })
        return clips

    def __len__(self):
        return len(self.clips)

    def get_camintr(self):
        return np.array([[FOCAL_PX, 0, VIDEO_W / 2],
                         [0, FOCAL_PX, VIDEO_H / 2], [0, 0, 1]], np.float64)

    def __getitem__(self, idx):
        clip = self.clips[idx]
        hoa_path = os.path.join(self.hoa_root, f"{clip['video_id']}.pkl")
        detections = hoa_lib.load_video_hoa(hoa_path)
        df = hoa_lib.detections_to_dataframe(detections, VIDEO_H, VIDEO_W)
        tracks = track_clip_boxes(df, clip["start"], clip["stop"])
        frame_idxs = list(range(clip["start"],
                                clip["start"]
                                + self.frame_nb * self.frame_step,
                                self.frame_step))
        images = []
        if self.load_img and self.frames is not None:
            for fi in frame_idxs:
                images.append(self.frames.read_frame(clip["video_id"], fi))
        else:
            images = [None] * len(frame_idxs)
        sides = [s for s in ("left_hand", "right_hand")
                 if tracks.get(s) is not None]
        setup = {s: 1 for s in sides}
        setup["objects"] = 1
        model = self.models.get(clip["noun"])
        T = len(frame_idxs)
        hands = []
        for s in sides:
            hands.append({
                "label": s,
                "bbox": np.stack([tracks[s][fi - clip["start"]]
                                  for fi in frame_idxs]).astype(np.float32),
                "verts3d": np.zeros((T, 778, 3), np.float32),
            })
        obj = {
            "name": clip["noun"],
            "bbox": (np.stack([tracks["objects"][fi - clip["start"]]
                               for fi in frame_idxs]).astype(np.float32)
                     if tracks.get("objects") is not None else None),
            "canverts3d": (np.tile(model["verts"][None], (T, 1, 1))
                           if model else None),
            "faces": (np.tile(model["faces"][None], (T, 1, 1))
                      if model else None),
        }
        return {
            "images": images,
            "hands": hands,
            "objects": [obj],
            "camera": {"K": np.tile(self.get_camintr()[None], (T, 1, 1))},
            "setup": setup,
            "frame_idxs": frame_idxs,
            "seq_idx": f"{clip['video_id']}_{clip['start']}",
        }
