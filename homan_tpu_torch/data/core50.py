"""CORe50 in-the-wild hand-object videos, no 3D ground truth
(homan_tpu/data/core50.py).

Sessions of a hand manipulating one of 50 objects (10 categories x 5
instances), fit against ShapeNet exemplar meshes scaled to each object's
size. With no 3D ground truth, the hand vertices are placeholders and the
evaluation is by silhouette.

Registries (tables of the reference's core50constants.py):
  * SESSION_SIDES — which hand each session uses;
  * OBJECT_MODELS — each object's exemplar mesh file (under `model_root`,
    the simplified ShapeNet dump) and metric scale; balls are procedural
    icospheres.

Annotation index: where the `core50_350x350_Annot` .mat tree is present,
the index holds each frame's crop box, hand side, 2D roots and coarse
depths (scipy.io.loadmat); otherwise a walk of the image folders gives the
frame counts (enough for the tracked-box path). PIL is imported only by
__getitem__, to load the frames.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from homan_tpu_torch.core.meshes import icosphere, load_obj
from homan_tpu_torch.data.chunking import chunk_vid_index

# Hand side per session (core50constants.py:4-16) — NOT alternating.
SESSION_SIDES = {
    "s1": "right", "s2": "left", "s3": "left", "s4": "right", "s5": "right",
    "s6": "right", "s7": "left", "s8": "right", "s9": "left", "s10": "right",
    "s11": "left",
}

# Core50 category layout: objects o1..o50, category i covers o(5i+1)..o(5i+5)
CATEGORIES = ["plug_adapter", "mobile_phone", "scissors", "light_bulb",
              "can", "glasses", "ball", "marker", "cup", "remote_control"]
# Typical object diameter in meters per category (fallback when an object
# has no OBJECT_MODELS entry).
CATEGORY_SCALES = {
    "plug_adapter": 0.07, "mobile_phone": 0.15, "scissors": 0.18,
    "light_bulb": 0.11, "can": 0.12, "glasses": 0.16, "ball": 0.07,
    "marker": 0.14, "cup": 0.10, "remote_control": 0.17,
}

# Per-object exemplar registry (core50constants.py:18-130): filename under
# `model_root` (the reference's pre-simplified ShapeNet dump) or a
# procedural "sphere" form, + metric scale (object diameter).
OBJECT_MODELS: Dict[str, Dict] = {
    # Mobile phones
    "o6": {"path": "7ea27ed05044031a6fe19ebe291582.obj", "scale": 0.07},
    "o8": {"path": "3ff176780a009cd93b61739f3c4d4342.obj", "scale": 0.08},
    "o9": {"path": "e55ef720305bfcac284432ce2f42f498.obj", "scale": 0.08},
    "o10": {"path": "d7ed512f7a7daf63772afc88105fa679.obj", "scale": 0.12},
    # Cans
    "o21": {"path": "3fd8dae962fa3cc726df885e47f82f16.obj", "scale": 0.2},
    "o22": {"path": "3fd8dae962fa3cc726df885e47f82f16.obj", "scale": 0.2},
    "o23": {"path": "3fd8dae962fa3cc726df885e47f82f16.obj", "scale": 0.2},
    "o24": {"path": "11c785813efc4b8630eaaf40a8a562c1.obj", "scale": 0.2},
    "o25": {"path": "11c785813efc4b8630eaaf40a8a562c1.obj", "scale": 0.2},
    # Remote controls
    "o46": {"path": "8e167ac56b1a437017d17fdfb5740281.obj", "scale": 0.2},
    "o47": {"path": "57759e351ec76d86d3c1501c166e6b2a.obj", "scale": 0.3},
    "o48": {"path": "a97a5e1c99e165c2327b86d5194a11a7.obj", "scale": 0.12},
    "o49": {"path": "a036b6be1c50f61fa046bbac53886364.obj", "scale": 0.3},
    "o50": {"path": "cc846e66cbfe697bffb5024c146ec04e.obj", "scale": 0.22},
    # Bulbs
    "o16": {"path": "206ef4c97f50caa4a570c6c691c987a8.obj", "scale": 0.12},
    "o17": {"path": "8338a18d589c26d21c648623457982d0.obj", "scale": 0.12},
    "o18": {"path": "8338a18d589c26d21c648623457982d0.obj", "scale": 0.12},
    "o19": {"path": "b0c346ea1fa3ad0b2d7dd0a148440b17.obj", "scale": 0.15},
    # Balls (procedural spheres, core50.py:25-31)
    "o31": {"form": "sphere", "scale": 0.025},
    "o32": {"form": "sphere", "scale": 0.03},
    "o34": {"form": "sphere", "scale": 0.06},
    # Cups
    "o41": {"path": "d75af64aa166c24eacbe2257d0988c9c.obj", "scale": 0.13},
    "o42": {"path": "61c10dccfa8e508e2d66cbf6a91063.obj", "scale": 0.12},
    "o43": {"path": "3143a4accdc23349cac584186c95ce9b.obj", "scale": 0.13},
    "o44": {"path": "9af98540f45411467246665d3d3724c.obj", "scale": 0.13},
    "o45": {"path": "ea127b5b9ba0696967699ff4ba91a25.obj", "scale": 0.13},
}
FOCAL_PX = 480.0  # fixed intrinsics (core50.py:253-260)


def object_category(obj_name: str) -> str:
    idx = int(obj_name.lstrip("o")) - 1
    return CATEGORIES[idx // 5]


def _normalize_exemplar(verts: np.ndarray, scale: float) -> np.ndarray:
    """Mean-center + inscribe in a sphere of diameter `scale`
    (core50.py:33-38)."""
    verts = np.asarray(verts, np.float64)
    verts = verts - verts.mean(0)
    radius = np.linalg.norm(verts, axis=1).max()
    return (verts / radius * (scale / 2)).astype(np.float32)


def load_models(model_registry: Optional[Dict[str, str]] = None,
                model_root: str = "local_data/datasets/shapenetmodels",
                scales: Optional[Dict[str, float]] = None,
                fallback_sphere: bool = True) -> Dict[str, Dict]:
    """Exemplar meshes keyed by object name AND category.

    Resolution order per object: explicit `model_registry` path (keyed by
    object name or category) > OBJECT_MODELS file under `model_root` >
    procedural sphere ("form" entries always; any missing mesh when
    `fallback_sphere`, with a warning — the reference hard-requires the
    ShapeNet dump instead).
    """
    scales = dict(CATEGORY_SCALES, **(scales or {}))
    models: Dict[str, Dict] = {}

    def add(key, verts, faces, path, scale):
        models[key] = {"verts": _normalize_exemplar(verts, scale),
                       "faces": np.asarray(faces, np.int32),
                       "path": path, "scale": scale}

    for key, path in (model_registry or {}).items():
        if not os.path.exists(path):
            continue
        verts, faces = load_obj(path)
        scale = (OBJECT_MODELS.get(key, {}).get("scale")
                 or scales.get(key if key in scales else
                               object_category(key) if key.startswith("o")
                               else key, 0.1))
        add(key, verts, faces, path, scale)

    sphere_v, sphere_f = icosphere(3, 1.0)
    for obj, info in OBJECT_MODELS.items():
        if obj in models:
            continue
        if info.get("form") == "sphere":
            add(obj, sphere_v, sphere_f, "sphere", info["scale"])
            continue
        path = os.path.join(model_root, info["path"])
        if os.path.exists(path):
            verts, faces = load_obj(path)
            add(obj, verts, faces, path, info["scale"])
        elif fallback_sphere:
            add(obj, sphere_v, sphere_f, "sphere(fallback)", info["scale"])
    return models


def load_mat_annot(annot_path: str, scale_factor: float = 1.2) -> Dict:
    """One .mat annotation (core50utils.py:15-53): crop bbox, hand side,
    2D roots, coarse root depths."""
    from scipy.io import loadmat
    raw = loadmat(annot_path)
    hand = raw["annot"]["hand"][0, 0]
    obj = raw["annot"]["object"][0, 0]
    bbox = raw["annot"]["crop"][0, 0]  # (1, 4) x_min y_min x_max y_max
    side = {"R": "right", "L": "left"}[str(hand["side"][0, 0][0])]
    hand_depth = 8000 * (255 - np.float64(
        hand["root_depth_png"][0, 0])) / 1000 / 256
    center = np.array([(bbox[0, 0] + bbox[0, 2]) / 2,
                       (bbox[0, 1] + bbox[0, 3]) / 2])
    scale = scale_factor * np.array([bbox[0, 2] - bbox[0, 0],
                                     bbox[0, 3] - bbox[0, 1]])
    name = os.path.basename(annot_path)
    frame_idx = int(name.split(".")[0].split("_")[3])
    prefix = "_".join(name.split(".")[0].split("_")[1:])
    rgb_path = os.path.join(
        os.path.dirname(annot_path.replace("_Annot", "")), f"C_{prefix}.png")
    return {
        "scale": scale, "center": center, "bbox": bbox[0].astype(np.float32),
        "side": side, "frame_idx": frame_idx,
        "hand_root2d": np.asarray(hand["root2d"][0, 0]),
        "hand_depth": hand_depth,
        "obj_root2d": np.asarray(obj["root2d"][0, 0]),
        "obj_root_depth": obj["root_depth_png"][0, 0],
        "img": rgb_path, "prefix": prefix,
    }


class Core50:
    def __init__(self,
                 root: str = "local_data/datasets/core50",
                 model_registry: Optional[Dict[str, str]] = None,
                 model_root: str = "local_data/datasets/shapenetmodels",
                 split: str = "all",
                 mode: str = "chunk",
                 frame_nb: int = 10,
                 chunk_step: int = 4,
                 chunk_spacing: int = 100,
                 track: bool = True,
                 boxes_path: str = "data/boxes/boxes_core50_all.pkl",
                 session_hands: Optional[Dict[str, str]] = None,
                 use_cache: bool = True,
                 cache_folder: str = "data/cache",
                 load_img: bool = True):
        self.name = "core50"
        self.image_size = 350
        self.full_image_size = (350, 350)
        self.mode = mode
        self.track = track
        self.load_img = load_img
        # Reference layout keeps images under core50_350x350 and .mat annots
        # under core50_350x350_Annot (core50.py:73-75); a bare image tree
        # (tests) is also accepted.
        sub = os.path.join(root, "core50_350x350")
        self.img_root = sub if os.path.isdir(sub) else root
        self.annot_root = self.img_root + "_Annot"
        self.session_hands = session_hands or SESSION_SIDES
        self.models = load_models(model_registry, model_root=model_root)

        # Tracked boxes are required when not re-tracking (core50.py:121-129)
        self.tracked_boxes = None
        if not track and os.path.exists(boxes_path):
            with open(boxes_path, "rb") as f:
                self.tracked_boxes = pickle.load(f)

        cache_path = os.path.join(cache_folder, f"{self.name}_{split}.pkl")
        if use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                payload = pickle.load(f)
            self.vid_rows = payload["vid_rows"]
            self.annotations = payload["annotations"]
        else:
            self.vid_rows, self.annotations = self._build_index()
            if use_cache and self.vid_rows:
                os.makedirs(cache_folder, exist_ok=True)
                with open(cache_path, "wb") as f:
                    pickle.dump({"vid_rows": self.vid_rows,
                                 "annotations": self.annotations}, f)

        if mode == "vid":
            self.chunks = [dict(r, frame_idxs=list(range(r["frame_nb"])))
                           for r in self.vid_rows]
        else:
            self.chunks = chunk_vid_index(self.vid_rows, chunk_size=frame_nb,
                                          chunk_step=chunk_step,
                                          chunk_spacing=chunk_spacing)

    def _build_index(self):
        """Session/object index. With the .mat tree: mirrors
        core50utils.build_frame_index (per-frame annotations keyed
        (session, obj, frame_idx)); otherwise: image-folder walk."""
        rows: List[Dict] = []
        annotations: Dict = {}
        if not os.path.isdir(self.img_root):
            return rows, annotations
        has_annots = os.path.isdir(self.annot_root)
        for session in sorted(os.listdir(self.img_root)):
            spath = os.path.join(self.img_root, session)
            if not os.path.isdir(spath) or session not in self.session_hands:
                continue
            for obj in sorted(os.listdir(spath)):
                opath = os.path.join(spath, obj)
                if not os.path.isdir(opath):
                    continue
                frames = sorted(f for f in os.listdir(opath)
                                if f.endswith((".png", ".jpg")))
                if not frames:
                    continue
                side = self.session_hands[session]
                if has_annots:
                    apath = os.path.join(self.annot_root, session, obj)
                    if os.path.isdir(apath):
                        for aname in sorted(os.listdir(apath)):
                            if not aname.endswith(".mat"):
                                continue
                            info = load_mat_annot(os.path.join(apath, aname))
                            annotations[(session, obj,
                                         info["frame_idx"])] = info
                            side = info["side"]
                rows.append({
                    "session": session, "object": obj,
                    "frame_nb": len(frames),
                    "frames": [os.path.join(opath, f) for f in frames],
                    "hand_side": side,
                    "class": object_category(obj),
                })
        return rows, annotations

    def __len__(self):
        return len(self.chunks)

    def get_camintr(self):
        c = self.image_size / 2
        return np.array([[FOCAL_PX, 0, c], [0, FOCAL_PX, c], [0, 0, 1]],
                        np.float64)

    def get_model(self, obj_name: str, category: str):
        """Object-name entry wins over category entry (OBJECT_MODELS vs a
        category-keyed user registry)."""
        return self.models.get(obj_name) or self.models.get(category)

    def __getitem__(self, idx):
        chunk = self.chunks[idx]
        frame_idxs = chunk["frame_idxs"]
        images = []
        for fi in frame_idxs:
            if self.load_img:
                from PIL import Image
                images.append(np.asarray(
                    Image.open(chunk["frames"][fi]).convert("RGB")))
            else:
                images.append(None)
        side = chunk["hand_side"] + "_hand"
        setup = {side: 1, "objects": 1}
        model = self.get_model(chunk["object"], chunk["class"])
        T = len(frame_idxs)
        hands = [{
            "label": side,
            # No GT: placeholder verts, like the reference (core50.py:205,218)
            "verts3d": np.zeros((T, 778, 3), np.float32),
        }]
        objects = [{
            "canverts3d": (np.tile(model["verts"][None], (T, 1, 1))
                           if model else None),
            "faces": (np.tile(model["faces"][None], (T, 1, 1))
                      if model else None),
            "name": chunk["class"],
            "obj": chunk["object"],
        }]
        # Per-frame .mat annotations (crop bbox shared by hand+object)
        annot_boxes = []
        for fi in frame_idxs:
            a = self.annotations.get((chunk["session"], chunk["object"], fi))
            annot_boxes.append(None if a is None else a["bbox"])
        if all(b is not None for b in annot_boxes):
            boxes_np = np.stack(annot_boxes).astype(np.float32)
            hands[0]["bbox"] = boxes_np
            objects[0]["bbox"] = boxes_np.copy()
        boxes = None
        if self.tracked_boxes is not None:
            key = (chunk["session"], chunk["object"])
            boxes = self.tracked_boxes.get(key)
        if boxes is not None:
            hands[0]["bbox"] = np.stack(
                [boxes[side][fi] for fi in frame_idxs]).astype(np.float32)
            objects[0]["bbox"] = np.stack(
                [boxes["objects"][fi] for fi in frame_idxs]).astype(np.float32)
        return {
            "images": images,
            "hands": hands,
            "objects": objects,
            "camera": {"K": np.tile(self.get_camintr()[None], (T, 1, 1))},
            "setup": setup,
            "frame_idxs": frame_idxs,
            "seq_idx": f"{chunk['session']}_{chunk['object']}",
        }
