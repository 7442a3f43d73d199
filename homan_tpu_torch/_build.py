"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `_build/<name>-<hash>.so`
(plain C interface, no PyTorch headers: seconds per file instead of the
minutes a torch extension build takes). The hash covers the source, every
header in `csrc/` and the flags, so an edited kernel rebuilds and an
unchanged one loads the library built before. `build_all()` starts one nvcc
per source, all at once, and waits for them together.

Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false`. The shade kernel's exact
comparisons (`cross2d == 0`, strict-< argmin ties) must agree bit for bit
with its plain PyTorch version, which never contracts a*b+c into an FMA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "render", "csrc")
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


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
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
