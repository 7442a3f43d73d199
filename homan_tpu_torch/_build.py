"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every `csrc/` directory of the package holds kernel sources
(`render/csrc/shade.cu`, `render/csrc/depth.cu`, `render/csrc/prep.cu`,
`interactions/csrc/voxelize.cu`); source names are unique across them. Each
`<name>.cu` compiles on its own into `_build/<name>-<hash>.so` (plain C
interface, no PyTorch headers: seconds per file instead of the minutes a
torch extension build takes). The hash covers the source, every header in
its `csrc/` and the flags, so an edited kernel rebuilds and an unchanged one
loads the library built before. `build_all()` starts one nvcc per source,
all at once, and waits for them together.

Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false`. The kernels' exact
comparisons (the shade kernel's `cross2d == 0` and strict-< argmin ties,
the depth kernel's `e >= 0` and strict-> argmax, the voxelizer's crossing
parity, the prep kernel's row crossings and bbox tests) must agree bit for
bit with their plain PyTorch versions, which
never contract a*b+c into an FMA. A kernel writes `__fmaf_rn` itself where
a tolerance, not bit parity, holds its result (the voxelizer's distance),
or where the fused result is exact (the shade forward's correctly rounded
divide).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be "
                           "built")
    return path


def _source_dirs() -> dict:
    """Kernel name -> the `csrc/` directory that holds `<name>.cu`."""
    found = {}
    for root, dirs, files in os.walk(_PKG_DIR):
        dirs[:] = sorted(d for d in dirs if d != "_build")
        if os.path.basename(root) != "csrc":
            continue
        for f in files:
            if f.endswith(".cu"):
                name = f[:-3]
                if name in found:
                    raise RuntimeError(f"kernel source {f} appears in both "
                                       f"{found[name]} and {root}")
                found[name] = root
    return found


def sources() -> list:
    return sorted(_source_dirs())


def _source(name: str) -> str:
    dirs = _source_dirs()
    if name not in dirs:
        raise RuntimeError(f"no kernel source {name}.cu in any csrc/ of "
                           f"{_PKG_DIR}")
    return os.path.join(dirs[name], name + ".cu")


def _lib_path(name: str) -> str:
    src = _source(name)
    csrc = os.path.dirname(src)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                     if f.endswith(".cuh"))
    for path in [src] + headers:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    with open(out + ".log", "w") as fh:
        fh.write(log)
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return log


def build_all(names=None) -> dict:
    """Build every missing kernel library in parallel; returns name -> log."""
    names = sources() if names is None else list(names)
    logs, procs = {}, {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            logs[name] = "cached"
        else:
            procs[name] = (out, _start(name, out))
    for name, (out, proc) in procs.items():
        logs[name] = _finish(name, out, proc)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out = _lib_path(name)
            if not os.path.exists(out):
                build_all([name])
            lib = ctypes.CDLL(out)
            _LIBS[name] = lib
        return lib
