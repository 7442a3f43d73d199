"""Convert a reference (hassony2/homan) results tree into the port's layout
(homan_tpu/cli/convert_reference.py).

Walks {src}/samples/*/ and writes {dst}/samples/*/ with:
  * indep_fit.pkl — the stage-1 payload converted by
                    frontend/adapters.py convert_indep_fit (person and
                    object parameters in the stacked layout);
  * joint_fit.npz — the joint-fit checkpoint converted from the torch
                    state_dict in joint_fit.pt (the parameter names match
                    one to one).

`fit_video --resume DST` then continues the reference's fit:
  python -m homan_tpu_torch.cli.convert_reference --src REF --dst OUT
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from homan_tpu_torch.frontend.adapters import (convert_indep_fit,
                                               convert_joint_fit_state)


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="reference results root")
    p.add_argument("--dst", required=True, help="output root")
    return p.parse_args(argv)


def convert_tree(src: str, dst: str):
    """Convert every sample folder of `src`; returns their names."""
    samples = os.path.join(src, "samples")
    converted = []
    for name in sorted(os.listdir(samples)) if os.path.isdir(samples) else []:
        sdir = os.path.join(samples, name)
        out_dir = os.path.join(dst, "samples", name)
        os.makedirs(out_dir, exist_ok=True)
        indep_path = os.path.join(sdir, "indep_fit.pkl")
        if os.path.exists(indep_path):
            with open(indep_path, "rb") as f:
                ref_indep = pickle.load(f)
            indep = convert_indep_fit(ref_indep)
            with open(os.path.join(out_dir, "indep_fit.pkl"), "wb") as f:
                pickle.dump(indep, f)
        joint_path = os.path.join(sdir, "joint_fit.pt")
        if os.path.exists(joint_path):
            payload = torch.load(joint_path, map_location="cpu",
                                 weights_only=False)
            state_dict = payload.get("state_dict", payload)
            state = convert_joint_fit_state(state_dict)
            np.savez(os.path.join(out_dir, "joint_fit.npz"), **state)
        converted.append(name)
    print(f"Converted {len(converted)} samples from {src} to {dst}")
    return converted


def main(args):
    return convert_tree(args.src, args.dst)


if __name__ == "__main__":
    main(get_args())
