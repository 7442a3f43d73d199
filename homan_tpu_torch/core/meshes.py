"""Procedural meshes, host-side numpy (homan_tpu/core/meshes.py:67-114).

Kept as an exact copy of the JAX package's numpy code so both packages build
bit-identical test and benchmark objects.
"""
from __future__ import annotations

import numpy as np


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
