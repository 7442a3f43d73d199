"""Track hand and object boxes over dataset videos
(homan_tpu/cli/track_dataset.py).

Writes {save_root}/boxes_{dataset}_{split}.pkl, which the datasets read in
their tracked-box modes. No detector network is bundled: the boxes come
from the dataset itself (--box_source gt, e.g. HO-3D's GT boxes, CORe50's
.mat crops, EPIC's HOA tracks), interpolated and smoothed forward and
backward (tracking/kalman.py).
  python -m homan_tpu_torch.cli.track_dataset --dataset core50 --split all
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from homan_tpu_torch.tracking import kalman


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="core50",
                        choices=["ho3d", "core50", "epic"])
    parser.add_argument("--split", default="val")
    parser.add_argument("--box_source", default="gt", choices=["gt", "cached"])
    parser.add_argument("--detections_root", type=str)
    parser.add_argument("--save_root", default=None,
                        help="output folder for boxes_{dataset}_{split}.pkl")
    parser.add_argument("--boxes_folder", default="data/boxes",
                        help="reference-compatible alias for --save_root "
                             "(track_dataset.py:44-47)")
    parser.add_argument("--save_folder", default="tracks",
                        help="accepted for reference CLI compatibility "
                             "(debug track dumps; unused here)")
    parser.add_argument("--use_cache", action="store_true",
                        help="accepted for reference CLI compatibility "
                             "(dataset index caches are always on)")
    parser.add_argument("--only_missing", action="store_true",
                        help="skip videos already present in the output "
                             "pickle (track_dataset.py:84-86)")
    parser.add_argument("--data_step", default=1, type=int)
    parser.add_argument("--data_offset", default=0, type=int)
    args = parser.parse_args(argv)
    if args.save_root is None:
        args.save_root = args.boxes_folder
    return args


def main(args, dataset=None, device=None):
    """Track every `data_step`-th video; `device` is where HO-3D's MANO
    runs (default `cuda`), the other datasets run none. Videos are taken
    whole, but EPIC's samples are clips of its own frame count: its
    constructor takes no `mode` (the JAX CLI passes one and raises
    TypeError there)."""
    if dataset is None:
        from homan_tpu_torch.data.factory import get_dataset
        kw = {} if args.dataset == "epic" else {"mode": "vid",
                                                 "frame_nb": -1}
        dataset, _ = get_dataset(args.dataset, split=args.split,
                                 load_img=False, device=device, **kw)
    os.makedirs(args.save_root, exist_ok=True)
    save_path = os.path.join(args.save_root,
                             f"boxes_{args.dataset}_{args.split}.pkl")
    tracked = {}
    if os.path.exists(save_path):
        with open(save_path, "rb") as f:
            tracked = pickle.load(f)
    for idx in range(args.data_offset, len(dataset), args.data_step):
        sample = dataset[idx]
        key = sample["seq_idx"]
        if args.only_missing and key in tracked:
            continue
        boxes = {}
        for hand in sample["hands"]:
            if "bbox" in hand:
                raw = np.asarray(hand["bbox"], np.float64)
                boxes[hand["label"]] = kalman.track_sequence_boxes(
                    kalman.interpolate_missing(raw))
        obj = sample["objects"][0]
        if obj.get("bbox") is not None:
            raw = np.asarray(obj["bbox"], np.float64)
            boxes["objects"] = kalman.track_sequence_boxes(
                kalman.interpolate_missing(raw))
        tracked[key] = boxes
        with open(save_path, "wb") as f:  # incremental, crash loses <=1 video
            pickle.dump(tracked, f)
        print(f"[{idx}] tracked {key}")
    print(f"saved {len(tracked)} tracks to {save_path}")
    return save_path


if __name__ == "__main__":
    main(get_args())
