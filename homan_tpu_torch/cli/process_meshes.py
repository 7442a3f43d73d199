"""Batch exemplar-mesh preprocessing (shapemeshprocess.py equivalent), the
port of homan_tpu/cli/process_meshes.py on the port's native library.

The reference shells out to ManifoldPlus (watertighting) + ACVD (uniform
remeshing) (meshprocess/simplifymesh.py:28-104). Here the default path is the
in-repo native QEM decimation (homan_tpu_torch/native, built with g++ at
first use); the external executables are invoked only when their paths are
supplied (same offline-asset role). Host work only: no device is used.

  python -m homan_tpu_torch.cli.process_meshes --mesh_list meshes.txt \
      --target_faces 1000 --out_root processed/
"""
from __future__ import annotations

import argparse
import os
import subprocess


def simplify_mesh(path: str, out_path: str, target_faces: int = 1000,
                  manifoldplus_bin: str | None = None,
                  acvd_bin: str | None = None) -> str:
    """Watertight (optional, external) then decimate one mesh."""
    from homan_tpu_torch import native
    from homan_tpu_torch.core.meshes import save_obj

    src = path
    if manifoldplus_bin:
        tmp = out_path + ".manifold.obj"
        subprocess.run([manifoldplus_bin, "--input", path, "--output", tmp],
                       check=True)
        src = tmp
    if acvd_bin:
        subprocess.run([acvd_bin, src, str(target_faces), "0"], check=True)

    verts, faces = native.load_obj(src)
    verts2, faces2 = native.decimate(verts, faces, target_faces)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_obj(out_path, verts2, faces2)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh_list", required=True,
                        help="text file with one mesh path per line")
    parser.add_argument("--out_root", default="processed_meshes")
    parser.add_argument("--target_faces", type=int, default=1000)
    parser.add_argument("--manifoldplus_bin")
    parser.add_argument("--acvd_bin")
    args = parser.parse_args(argv)
    with open(args.mesh_list) as f:
        paths = [line.strip() for line in f if line.strip()]
    for p in paths:
        out = os.path.join(args.out_root,
                           os.path.splitext(os.path.basename(p))[0]
                           + f"_{args.target_faces}.obj")
        print(simplify_mesh(p, out, args.target_faces,
                            args.manifoldplus_bin, args.acvd_bin))


if __name__ == "__main__":
    main()
