"""Native host-side mesh and image ops (C++ via ctypes), the port of
homan_tpu/native/__init__.py.

The library is the port's own copy of meshops.cpp, built with g++ at first
use (native/build.py). Unlike the JAX module there is no Python fallback:
a failed build raises. Stage B keeps scipy's EDT (fit/poseinit.py
reference_edge_edt); `raster_phong` is a host renderer of one frame, held
against render/rasterizer.py rasterize_hard in the tests.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_FPTR = ctypes.POINTER(ctypes.c_float)
_IPTR = ctypes.POINTER(ctypes.c_int32)


def load_library() -> ctypes.CDLL:
    """The ctypes handle of the library, built on first use; the argument
    types are homan_tpu/native/__init__.py's."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from homan_tpu_torch.native.build import build
            lib = ctypes.CDLL(build())
            lib.edt2d_squared.restype = None
            lib.edt2d_squared.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), _FPTR, ctypes.c_int,
                ctypes.c_int]
            lib.decimate_qem.restype = ctypes.c_int
            lib.decimate_qem.argtypes = [
                _FPTR, ctypes.c_int, _IPTR, ctypes.c_int, ctypes.c_int,
                _FPTR, _IPTR, ctypes.POINTER(ctypes.c_int)]
            lib.obj_count.restype = ctypes.c_int
            lib.obj_count.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
            lib.obj_parse.restype = ctypes.c_int
            lib.obj_parse.argtypes = [ctypes.c_char_p, _FPTR, _IPTR]
            lib.raster_phong.restype = None
            lib.raster_phong.argtypes = [
                _FPTR, ctypes.c_int, _IPTR, ctypes.c_int, _FPTR, _FPTR,
                ctypes.c_int, ctypes.c_float, _FPTR, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, _FPTR, _FPTR,
                ctypes.POINTER(ctypes.c_uint8)]
            _LIB = lib
        return _LIB


def edt2d_squared(mask: np.ndarray) -> np.ndarray:
    """Exact squared EDT to the nearest nonzero pixel, (h, w) float64."""
    lib = load_library()
    m = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"edt2d_squared takes a 2D mask, got {m.shape}")
    h, w = m.shape
    out = np.empty((h, w), np.float32)
    lib.edt2d_squared(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      out.ctypes.data_as(_FPTR), h, w)
    return out.astype(np.float64)


def decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Quadric edge-collapse decimation to at most about `target_faces`."""
    lib = load_library()
    v = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    nv, nf = v.shape[0], f.shape[0]
    if nf and (f.min() < 0 or f.max() >= nv):
        raise ValueError("face indices outside the vertex array")
    if nf <= target_faces:
        return v, f
    v_out = np.empty_like(v)
    f_out = np.empty_like(f)
    out_nv = ctypes.c_int(0)
    nf_out = lib.decimate_qem(v.ctypes.data_as(_FPTR), nv,
                              f.ctypes.data_as(_IPTR), nf, int(target_faces),
                              v_out.ctypes.data_as(_FPTR),
                              f_out.ctypes.data_as(_IPTR),
                              ctypes.byref(out_nv))
    return v_out[: out_nv.value].copy(), f_out[:nf_out].copy()


def raster_phong(verts: np.ndarray, faces: np.ndarray, K: np.ndarray,
                 face_colors: np.ndarray | None = None, image_size: int = 256,
                 znear: float = 1e-4,
                 light_dir=(0.57735, 0.57735, -0.57735),
                 ambient: float = 0.55, diffuse: float = 0.45,
                 specular: float = 0.2, shininess: float = 32.0,
                 background: float = 1.0, shading: str = "phong"):
    """Host hard z-buffer render of ONE frame, with every face.

    The conventions of render/rasterizer.py rasterize_hard (normalized K,
    (i + 0.5) / S pixel centres, two-sided Blinn-Phong). verts (V, 3),
    faces (F, 3), K (3, 3), face_colors (F, 3) or None (white). Returns
    {"rgb" (S, S, 3) float32, "depth" (S, S) float32, "sil" (S, S) bool}.
    """
    if shading not in ("phong", "flat"):
        raise ValueError(f"shading must be 'phong' or 'flat', got {shading}")
    lib = load_library()
    v = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    k = np.ascontiguousarray(K, np.float32).reshape(3, 3)
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError("face indices outside the vertex array")
    fc = None
    if face_colors is not None:
        fc = np.ascontiguousarray(face_colors, np.float32).reshape(-1, 3)
        if fc.shape[0] != f.shape[0]:
            raise ValueError("face_colors needs one row per face")
    light = np.ascontiguousarray(light_dir, np.float32)
    S = int(image_size)
    rgb = np.empty((S, S, 3), np.float32)
    depth = np.empty((S, S), np.float32)
    sil = np.empty((S, S), np.uint8)
    lib.raster_phong(
        v.ctypes.data_as(_FPTR), v.shape[0], f.ctypes.data_as(_IPTR),
        f.shape[0], k.ctypes.data_as(_FPTR),
        fc.ctypes.data_as(_FPTR) if fc is not None else _FPTR(),
        S, znear, light.ctypes.data_as(_FPTR), ambient, diffuse, specular,
        shininess, background, 1 if shading == "phong" else 0,
        rgb.ctypes.data_as(_FPTR), depth.ctypes.data_as(_FPTR),
        sil.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return {"rgb": rgb, "depth": depth, "sil": sil.astype(bool)}


def load_obj(path: str):
    """OBJ vertices (V, 3) float32 and triangulated faces (F, 3) int32."""
    lib = load_library()
    nv = ctypes.c_int(0)
    nf = ctypes.c_int(0)
    if lib.obj_count(path.encode(), ctypes.byref(nv), ctypes.byref(nf)):
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    if lib.obj_parse(path.encode(), verts.ctypes.data_as(_FPTR),
                     faces.ctypes.data_as(_IPTR)):
        raise OSError(f"could not parse {path}")
    return verts, faces
