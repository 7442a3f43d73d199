"""Mesh files, procedural meshes and topology helpers, host-side numpy
(homan_tpu/core/meshes.py:28-250).

Kept as an exact copy of the JAX package's numpy code so both packages read,
write and build bit-identical meshes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

# Flat part colours of the viz renders (homan_tpu/core/meshes.py:16).
COLORS = {
    "blue": (0.65098039, 0.74117647, 0.85882353),
    "grey": (0.65, 0.65, 0.65),
    "green": (0.44, 0.75, 0.44),
    "gold": (0.85, 0.7, 0.2),
    "red": (251 / 255.0, 128 / 255.0, 114 / 255.0),
    "pink": (0.9, 0.7, 0.7),
    "white": (1.0, 1.0, 1.0),
    "purple": (0.7, 0.55, 0.9),
}


def load_obj(path: str):
    """Minimal OBJ reader: vertices + triangulated faces (fan triangulation).

    Returns (verts float32 (V,3), faces int32 (F,3)).
    """
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    """Write vertices and 0-based triangle faces as an OBJ file."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1:d} {face[1] + 1:d} {face[2] + 1:d}\n")


def normalize_to_inscribed_sphere(verts: np.ndarray, scale: float = 1.0):
    """Centre on the box centre and scale so that max |v| = scale / 2 (the
    mesh fits a sphere of diameter `scale` meters)."""
    verts = np.asarray(verts, np.float64)
    center = (verts.max(0) + verts.min(0)) / 2
    centered = verts - center
    radius = np.linalg.norm(centered, axis=1).max()
    return (centered / radius * (scale / 2)).astype(np.float32)


def icosphere(subdivisions: int = 2, radius: float = 1.0):
    """Procedural icosphere (V, 3) float32, (F, 3) int32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = list(verts)
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = (verts[a] + verts[b]) / 2
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(m)
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    return (np.asarray(verts, np.float32) * radius,
            np.asarray(faces, np.int32))


def bumpy_potato(subdivisions: int = 2, radius: float = 1.0, seed: int = 0):
    """Asymmetric closed blob whose silhouette pins down rotation."""
    v, f = icosphere(subdivisions, 1.0)
    rng = np.random.RandomState(seed)
    w = rng.randn(3, 3)
    bump = 0.25 * np.sin(v @ w[0]) + 0.15 * np.cos(2.0 * v @ w[1]) \
        + 0.1 * np.sin(3.0 * v @ w[2])
    v = v * (1.0 + 0.3 * bump[:, None])
    v = v * np.array([1.0, 0.75, 0.55])
    v = v / np.linalg.norm(v, axis=1).max() * radius
    return v.astype(np.float32), f


def box_mesh(half_extents=(0.5, 0.5, 0.5)):
    """Axis-aligned closed box, 8 verts / 12 triangles (outward winding)."""
    hx, hy, hz = half_extents
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2],  # -x
        [4, 6, 7], [4, 7, 5],  # +x
        [0, 4, 5], [0, 5, 1],  # -y
        [2, 3, 7], [2, 7, 6],  # +y
        [0, 2, 6], [0, 6, 4],  # -z
        [1, 5, 7], [1, 7, 3],  # +z
    ], np.int32)
    return v, f


def cylinder_mesh(radius: float = 0.5, height: float = 1.0, n_seg: int = 16):
    """Closed cylinder along z: 2*n_seg rim verts + 2 cap centers."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    top = np.concatenate([ring, np.full((n_seg, 1), height / 2)], axis=1)
    bot = np.concatenate([ring, np.full((n_seg, 1), -height / 2)], axis=1)
    v = np.concatenate([top, bot,
                        [[0, 0, height / 2]], [[0, 0, -height / 2]]],
                       axis=0).astype(np.float32)
    ct, cb = 2 * n_seg, 2 * n_seg + 1
    f = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        f += [[i, j, ct],                      # top cap
              [n_seg + j, n_seg + i, cb],      # bottom cap
              [i, n_seg + i, j], [j, n_seg + i, n_seg + j]]  # side
    return v, np.asarray(f, np.int32)


def merge_meshes(meshes):
    """Concatenate (verts, faces) pairs into one mesh with offset faces."""
    verts, faces, off = [], [], 0
    for v, f in meshes:
        verts.append(np.asarray(v, np.float32))
        faces.append(np.asarray(f, np.int64) + off)
        off += len(v)
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces).astype(np.int32))


def close_boundary_fan(faces: np.ndarray) -> np.ndarray:
    """Close every boundary loop of a consistently wound triangle mesh by
    fan triangulation (the closed-fist MANO topology of the SDF terms:
    the open wrist ring capped). Boundary directed edges (whose reverse
    never occurs) are chained into loops, each fanned from its first vertex
    with triangles (apex, v, u) that hold the reversed edge v->u, so the
    winding stays consistent. Watertight input is returned unchanged."""
    faces = np.asarray(faces)
    d_edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edge_set = set(map(tuple, d_edges.tolist()))
    nxt = {u: v for (u, v) in edge_set if (v, u) not in edge_set}
    new_faces = []
    visited = set()
    for start in sorted(nxt):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur = nxt[start]
        while cur != start:
            loop.append(cur)
            visited.add(cur)
            cur = nxt[cur]
        for i in range(1, len(loop) - 1):
            new_faces.append([loop[0], loop[i + 1], loop[i]])
    if not new_faces:
        return faces.copy()
    return np.concatenate([faces, np.asarray(new_faces, faces.dtype)])


def load_closed_hand_faces(path: str | None, open_faces: np.ndarray):
    """Closed-fist hand topology: from an (F, 3) npy file when given, else
    derived by closing the wrist ring (close_boundary_fan)."""
    if path:
        closed = np.load(path)
        if closed.ndim != 2 or closed.shape[1] != 3:
            raise ValueError(f"{path}: expected (F, 3) faces, got "
                             f"{closed.shape}")
        return closed.astype(np.int32)
    return close_boundary_fan(np.asarray(open_faces)).astype(np.int32)


def get_faces_and_textures(verts_list: Sequence[np.ndarray],
                           faces_list: Sequence[np.ndarray],
                           color_names: Sequence[str]):
    """Pack per-part meshes into one scene mesh with flat per-face colors
    (homan_tpu/core/meshes.py:267).

    Args:
      verts_list: list of (B, V_i, 3).
      faces_list: list of (F_i, 3) (or (1, F_i, 3)).
    Returns:
      faces (1, sum(B*F_i), 3) indexing the concatenated per-batch vertex
      buffer, colors (1, sum(B*F_i), 3).
    """
    all_faces, all_colors = [], []
    offset = 0
    for verts, faces, cname in zip(verts_list, faces_list, color_names):
        faces = np.asarray(faces)
        if faces.ndim == 3:
            faces = faces[0]
        B, V = verts.shape[0], verts.shape[1]
        for b in range(B):
            all_faces.append(faces + offset + b * V)
        offset += B * V
        color = np.asarray(COLORS[cname], np.float32)
        all_colors.append(np.tile(color, (B * faces.shape[0], 1)))
    return (np.concatenate(all_faces)[None].astype(np.int32),
            np.concatenate(all_colors)[None])


def decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Vertex-clustering decimation for coarse-fit meshes
    (homan_tpu/core/meshes.py:164): the finest of the grids 64, 62, ... 4
    per axis whose clusters leave at most `target_faces` faces, each
    cluster's vertices averaged and collapsed faces dropped (the coarsest
    grid's result where none does). `native.decimate` is the QEM one."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if faces.shape[0] <= target_faces:
        return verts.astype(np.float32), faces.astype(np.int32)
    lo, hi = verts.min(0), verts.max(0)
    extent = np.maximum(hi - lo, 1e-9)
    best = None
    for res in range(64, 2, -2):
        cell = np.floor((verts - lo) / extent * (res - 1e-6)).astype(np.int64)
        key = cell[:, 0] * res * res + cell[:, 1] * res + cell[:, 2]
        uniq, inverse = np.unique(key, return_inverse=True)
        inverse = inverse.reshape(-1)
        new_verts = np.zeros((len(uniq), 3))
        counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
        for c in range(3):
            new_verts[:, c] = np.bincount(
                inverse, weights=verts[:, c], minlength=len(uniq)) / counts
        new_faces = inverse[faces]
        keep = ((new_faces[:, 0] != new_faces[:, 1])
                & (new_faces[:, 1] != new_faces[:, 2])
                & (new_faces[:, 0] != new_faces[:, 2]))
        best = (new_verts.astype(np.float32),
                new_faces[keep].astype(np.int32))
        if best[1].shape[0] <= target_faces:
            break
    return best


def pad_mesh(verts: np.ndarray, faces: np.ndarray, vert_bucket: int,
             face_bucket: int):
    """Pad a mesh to static sizes so clips of different objects stack
    (parallel/clips.py): padding vertices collapse onto vertex 0, padding
    faces are degenerate (0, 0, 0) triangles, which add no contour edge,
    no crossing and no distance (their edges lie on vertex 0)."""
    v = np.zeros((vert_bucket, 3), np.float32)
    v[: verts.shape[0]] = verts
    v[verts.shape[0]:] = verts[0]
    f = np.zeros((face_bucket, 3), np.int32)
    f[: faces.shape[0]] = faces
    return v, f
