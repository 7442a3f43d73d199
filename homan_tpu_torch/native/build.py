"""Build the host mesh library (meshops.cpp) with g++ at first use.

    python -m homan_tpu_torch.native.build

compiles `meshops.cpp` with `g++ -O3 -shared -fPIC -std=c++17` into
`homan_tpu_torch/_build/meshops-<hash>.so`, where the hash covers the source
and the flags, as `_build.py` keys the CUDA kernels: an edited source builds
again, an unchanged one loads the library built before. The source sits
outside every `csrc/` directory, so nvcc never sees it. A failed build
raises and names the compiler; nothing falls back to Python.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys

from homan_tpu_torch._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "meshops.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the host mesh library "
                           f"({SOURCE}) cannot be built")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"meshops-{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """The library's path, compiled first when it is missing."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, SOURCE, "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
