"""The raster prep's card path around its kernel (render/rasterizer.py
`_shade_prep_kernel`, `_PrepKernel` and its vmap rule), on the CPU: the
launch is replaced by a stand-in that computes the kernel's outputs from
the plain version's pieces, frame by frame with each frame's topology, so
the packing, the vmap rule's folding of clips and per-clip topologies, the
endpoints' gradient and the counter are held against `_shade_prep_plain`
bit for bit. The kernel itself runs on the card only
(tests/test_torch_cuda.py)."""
import pytest
import torch

from homan_tpu_torch import utils_profiling as up
from homan_tpu_torch.render import rasterizer as tr

import torch_port_common  # noqa: F401  (caps torch's threads)
from prep_cases import clip_topologies, scene


def stand_in_launch(uv, verts, faces, edges, edge_faces, edge_dir, fpt, S,
                    tp, ke, znear, margin):
    """`_prep_launch`'s outputs from `_contour_data`, `_tile_overlap`,
    `_bin_first` and the plain anchor sum, frame by frame."""
    topo_t = (faces, edges, edge_faces, edge_dir)
    per = [t.dim() == d + 1 for t, d in zip(topo_t, (2, 2, 2, 1))]
    nt = next((t.shape[0] for t, p in zip(topo_t, per) if p), 1)
    B = uv.shape[0]
    fpt = B // nt if fpt is None else fpt
    st = tr.RasterSettings(S, tile_px=tp, edges_per_tile=ke, znear=znear)
    g = S // tp
    tiles = torch.arange(g * g)
    rows = (tiles // g)[:, None] * tp + torch.arange(tp)[None]
    ys = (torch.arange(S, dtype=torch.float32) + 0.5) / S
    outs = []
    for b in range(B):
        tb = (b // fpt) % nt
        topo = tr.MeshTopology(*(t[tb] if p else t
                                 for t, p in zip(topo_t, per)))
        p0, p1, cs, isc, flip = tr._contour_data(
            uv[b:b + 1], verts[b:b + 1, :, 2], topo, st)
        ov = tr._tile_overlap(torch.minimum(p0, p1), torch.maximum(p0, p1),
                              isc, st, margin)
        idx, hit, slot_of = tr._bin_first(ov, ke)
        c = tr._BinnedRows.apply(torch.stack([cs, flip * isc], -1), idx,
                                 hit, slot_of)
        hitf = hit.to(torch.float32)
        pack_c = torch.stack([c[..., 0], hitf, c[..., 1],
                              torch.zeros_like(hitf)], dim=-2)
        y0, y1 = p0[0, :, 1], p1[0, :, 1]
        py = ys[:, None]
        dy = y1 - y0
        t = (py - y0) / torch.where(dy.abs() > 1e-12, dy, torch.ones(()))
        x = p0[0, :, 0] + t * (p1[0, :, 0] - p0[0, :, 0])
        spans = (y0 <= py) != (y1 <= py)
        anc = torch.stack([torch.where(spans & (x > (gc + 1.0) * tp / S),
                                       cs[0], torch.zeros(())).sum(-1)
                           for gc in range(g)])  # (g, S)
        n = int(isc.sum())
        outs.append((anc[(tiles % g)[:, None], rows][..., None].expand(
                         g * g, tp, tp)[None],
                     ov.sum(-1).amax(-1), idx, hit, slot_of, pack_c,
                     (99.0 * (1.0 - hitf))[..., None],
                     torch.tensor([n], dtype=torch.int32),
                     torch.tensor([-(-n // 32) * 32], dtype=torch.int32)))
    return tuple(torch.cat(x).contiguous() for x in zip(*outs))


@pytest.fixture
def card_path(monkeypatch):
    """_shade_prep_kernel on CPU tensors, its launch the stand-in."""
    monkeypatch.setattr(tr, "_prep_launch", stand_in_launch)
    monkeypatch.setattr(tr, "_require_cuda", lambda x: None)
    return tr._shade_prep_kernel


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) and \
        a[3] == b[3]


@pytest.mark.parametrize("kind,S,tp,ke", [("object", 64, 32, 96),
                                          ("object", 48, 16, 4),
                                          ("hand", 64, 16, 8),
                                          ("flat", 40, 40, 64)])
def test_card_path_packs_and_gradient_match_plain(card_path, kind, S, tp,
                                                  ke):
    verts, faces, K = scene(kind)
    topo = tr.MeshTopology.from_faces(faces)
    st = tr.RasterSettings(S, tile_px=tp, edges_per_tile=ke)
    grads, outs = [], []
    for prep in (card_path, tr._shade_prep_plain):
        v = verts.clone().requires_grad_(True)
        out = prep(v, topo, K, st)
        w = torch.randn(out[0].shape,
                        generator=torch.Generator().manual_seed(0))
        (out[0] * w).sum().backward()
        outs.append(out)
        grads.append(v.grad)
    assert _equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1])
    assert int(outs[1][2].max()) > 0 and int(outs[1][2][1]) == 0


@pytest.mark.parametrize("shared", [(), ("edge_dir_f1",),
                                    ("faces", "edges", "edge_faces",
                                     "edge_dir_f1")])
def test_card_path_under_vmap_matches_plain(card_path, shared):
    """Clips folded into frames, with a topology per clip, some of its
    tensors shared by the clips, or all of them; and the counter."""
    verts, topo, K = clip_topologies()
    st = tr.RasterSettings(64, tile_px=32, edges_per_tile=96)
    names = ("faces", "edges", "edge_faces", "edge_dir_f1")
    args = [t[0] if n in shared else t for n, t in zip(names, topo)]
    dims = (0,) + tuple(None if n in shared else 0 for n in names)

    def run(prep):
        return torch.func.vmap(
            lambda v, *t: prep(v, tr.MeshTopology(*t), K, st)[:3],
            in_dims=dims)(verts, *args)

    with up.tracing():
        card = run(card_path)
        counted = up.counters()["raster.contour_edges"]
        plain = run(tr._shade_prep_plain)
        total = up.counters()["raster.contour_edges"]
    assert all(torch.equal(a, b) for a, b in zip(card, plain))
    for c in range(verts.shape[0]):
        one = tr._shade_prep_plain(
            verts[c], tr.MeshTopology(*(a if n in shared else a[c]
                                        for n, a in zip(names, args))), K,
            st)
        assert all(torch.equal(card[j][c], one[j]) for j in range(3))
    assert counted[0] == total[0] > 0
    assert counted[0] <= counted[1] < total[1]
