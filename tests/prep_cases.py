"""Scenes of the raster prep's tests, from the port alone (no jax): the
object, the hand, a flat grid whose rows project to exactly horizontal
edges, a dense mesh, frames with a vertex behind znear and with no contour
edge, and clips of padded meshes with a topology each, as
parallel/clips.py stacks them."""
from __future__ import annotations

import numpy as np
import torch

from homan_tpu_torch.core import mano as tmano
from homan_tpu_torch.core.meshes import bumpy_potato, pad_mesh
from homan_tpu_torch.render import rasterizer as tr


def flat_grid(n: int = 9):
    """An open n x n vertex grid in the plane z = 1: vertices of one row
    share y and z, so their edges project exactly horizontal (dy 0), and
    the boundary edges are contour edges."""
    jitter = np.random.RandomState(3).uniform(-0.01, 0.01, (n, n))
    ax = np.linspace(-0.3, 0.3, n)
    xs = ax[None, :] + jitter
    ys = np.broadcast_to(ax[:, None], (n, n))
    v = np.stack([xs, ys, np.ones((n, n))], -1).reshape(-1, 3)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, i * n + j + 1, (i + 1) * n + j, \
                (i + 1) * n + j + 1
            faces += [(a, b, d), (a, d, c)]
    return v.astype(np.float32), np.array(faces, np.int64)


def scene(kind: str, b: int = 3, edge_cases: bool = True):
    """verts (b, V, 3) float32, faces (F, 3), K (b, 3, 3) float32 on the
    CPU. With edge_cases (b >= 2), frame 0 has a vertex behind znear and
    frame 1 lies wholly behind the camera (no contour edge)."""
    rs = np.random.RandomState(0)
    if kind in ("object", "dense"):
        v, f = bumpy_potato(5 if kind == "dense" else 2, 0.25, seed=0)
        verts = (v[None] + np.array([0, 0, 1.0], np.float32)
                 + rs.randn(b, 1, 3).astype(np.float32) * 0.03)
        K = [[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]
    elif kind == "hand":
        p = tmano.synthetic_mano_params(0, device="cpu")
        rot = torch.from_numpy(rs.randn(b, 3).astype(np.float32) * 0.3)
        out = tmano.mano_forward(p, torch.zeros(b, 10), rot,
                                 torch.zeros(b, 45))
        verts = out["verts"].numpy() + np.array([0, 0, 0.5], np.float32)
        f = p["faces"].numpy()
        K = [[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]]
    elif kind == "flat":
        v, f = flat_grid()
        verts = np.repeat(v[None], b, 0)
        verts[:, :, :2] += rs.randn(b, 1, 2).astype(np.float32) * 0.02
        K = [[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]
    else:
        raise ValueError(kind)
    verts = np.array(verts, np.float32)
    if edge_cases and b >= 2:
        verts[0, 0, 2] = -0.2   # one vertex behind znear
        verts[1, :, 2] *= -1.0  # the whole frame behind the camera
    K = np.tile(np.array([K], np.float32), (b, 1, 1))
    return torch.from_numpy(verts), f, torch.from_numpy(K)


def clip_topologies(subdivs=(2, 1, 2), frames: int = 3):
    """Clips of bumpy potatoes padded to one vertex, face and edge count
    (core/meshes.py pad_mesh; padded edges touch no face): verts (C, frames,
    V, 3), the stacked MeshTopology's tensors (C, ...) and K (frames, 3,
    3)."""
    meshes = [bumpy_potato(s, 0.25 - 0.02 * i, seed=i)
              for i, s in enumerate(subdivs)]
    nv = max(len(v) for v, _ in meshes)
    nf = max(len(f) for _, f in meshes)
    padded = [pad_mesh(v, f, nv, nf) for v, f in meshes]
    topos = [tr.MeshTopology.from_faces(f) for _, f in padded]
    ne = max(t.edges.shape[0] for t in topos)
    rows = []
    for t in topos:
        p = ne - t.edges.shape[0]
        rows.append((t.faces,
                     torch.cat([t.edges, torch.zeros(p, 2, dtype=torch.int64)]),
                     torch.cat([t.edge_faces,
                                torch.full((p, 2), -1, dtype=torch.int64)]),
                     torch.cat([t.edge_dir_f1,
                                torch.zeros(p, dtype=torch.bool)])))
    topo = tuple(torch.stack(x) for x in zip(*rows))
    rs = np.random.RandomState(1)
    verts = torch.stack([
        torch.from_numpy(v)[None] + torch.tensor([0, 0, 1.0])
        + torch.from_numpy(rs.randn(frames, 1, 3).astype(np.float32)) * 0.03
        for v, _ in padded])
    K = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]])[None]
    return verts, topo, K.expand(frames, 3, 3).contiguous()
