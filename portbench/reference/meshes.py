"""The object meshes (a bumpy potato on an icosphere), padding to one shape,
and the edge topology the silhouette needs, in plain NumPy."""
from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int):
    """Unit icosphere: (V, 3) float32, (F, 3) int64; 20 * 4^s faces."""
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
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = list(verts)
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = (verts[a] + verts[b]) / 2
            cache[key] = len(verts)
            verts.append(m / np.linalg.norm(m))
        return cache[key]

    for _ in range(subdivisions):
        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def bumpy_potato(subdivisions: int, radius: float, seed: int):
    """An asymmetric closed blob whose silhouette pins down its rotation
    (the object of homan_tpu's benches), largest radius `radius`."""
    v, f = icosphere(subdivisions)
    w = np.random.RandomState(seed).randn(3, 3)
    bump = 0.25 * np.sin(v @ w[0]) + 0.15 * np.cos(2.0 * v @ w[1]) \
        + 0.1 * np.sin(3.0 * v @ w[2])
    v = v * (1.0 + 0.3 * bump[:, None]) * np.array([1.0, 0.75, 0.55])
    v = v / np.linalg.norm(v, axis=1).max() * radius
    return v.astype(np.float32), f


def pad_mesh(verts, faces, n_verts: int, n_faces: int):
    """Pad to n_verts and n_faces: padding vertices sit on vertex 0 and
    padding faces are (0, 0, 0), so they add no area, edge or crossing."""
    v = np.repeat(verts[:1], n_verts, axis=0)
    v[:len(verts)] = verts
    f = np.zeros((n_faces, 3), np.int64)
    f[:len(faces)] = faces
    return v, f


def edge_topology(faces: np.ndarray) -> dict:
    """Unique undirected edges of the non-degenerate faces, sorted by
    (u, v); per edge its first two faces in face order (-1 where it has
    one) and whether it runs u->v in the first."""
    f = np.asarray(faces, np.int64)
    good = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    gid = np.nonzero(good)[0]
    directed = np.stack([f[good][:, [0, 1]], f[good][:, [1, 2]],
                         f[good][:, [2, 0]]], axis=1).reshape(-1, 2)
    face_of = np.repeat(gid, 3)
    edges, inverse = np.unique(np.sort(directed, axis=1), axis=0,
                               return_inverse=True)
    inverse = inverse.reshape(-1)
    edge_faces = np.full((len(edges), 2), -1, np.int64)
    first_dir = np.zeros(len(edges), bool)
    seen = np.zeros(len(edges), np.int64)
    for k in range(len(directed)):  # face order, then the face's edges
        e = inverse[k]
        if seen[e] == 0:
            edge_faces[e, 0] = face_of[k]
            first_dir[e] = directed[k, 0] < directed[k, 1]
        elif seen[e] == 1:
            edge_faces[e, 1] = face_of[k]
        seen[e] += 1
    return {"edges": edges, "edge_faces": edge_faces, "edge_dir": first_dir}


def pad_topology(topo: dict, n_edges: int) -> dict:
    """Pad the edge arrays to n_edges with edges that touch no face."""
    pad = n_edges - len(topo["edges"])
    return {"edges": np.concatenate([topo["edges"],
                                     np.zeros((pad, 2), np.int64)]),
            "edge_faces": np.concatenate([topo["edge_faces"],
                                          np.full((pad, 2), -1, np.int64)]),
            "edge_dir": np.concatenate([topo["edge_dir"],
                                        np.zeros(pad, bool)])}
