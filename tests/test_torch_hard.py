"""PyTorch port vs JAX package: the hard z-buffer render, its face budget,
the GT instance masks, and the edge-budget sizing (CPU, same inputs).

Bands: sil and the winning face equal except at pixels where rounding
decides the inside test (the JAX package's CPU path may fuse a product of
the edge function into an FMA; the port never does): there one of the two
faces has an edge within (|dx| |py - ay| + |dy| |px - ax|) 2^-20 of zero.
Depth rtol 1e-6 where the winner agrees; rgb atol 1e-6 flat, 2e-5 Phong
(the vertex normals are scatter-added and the highlight is a 32nd power).
Instance masks and edge settings: equal.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.core.meshes import merge_meshes as jmerge
from homan_tpu.frontend import gtevidence as jgt
from homan_tpu.render import rasterizer as jr
from homan_tpu_torch.frontend import gtevidence as tgt
from homan_tpu_torch.render import rasterizer as tr

from torch_port_common import ho3d_clip, ho3d_tree, raster_mesh, t2n

IMAGE = 640


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return ho3d_tree(tmp_path_factory.mktemp("ho3d_hard"), frames=4)


def _scene(tree):
    """The clip's hand and object as one mesh with one-hot instance colors,
    K normalized to the image (frames 0-1)."""
    vh, vo, fh, fo, K = ho3d_clip(tree)
    v, f = jmerge([(vh[0], fh), (vo[0], fo)])
    verts = np.concatenate([vh[:2], vo[:2]], axis=1).astype(np.float32)
    colors = np.zeros((len(f), 3), np.float32)
    colors[:len(fh), 0] = 1.0
    colors[len(fh):, 1] = 1.0
    Kn = K[:2].astype(np.float64).copy()
    Kn[:, :2] /= IMAGE
    return verts, f, Kn.astype(np.float32), colors


def _run_both(verts, faces, K, colors, settings, **kw):
    j = jr.rasterize_hard(jnp.asarray(verts), jr.MeshTopology.from_faces(
        faces), jnp.asarray(K), None if colors is None else jnp.asarray(
            colors), jr.RasterSettings(**dataclasses.asdict(settings)), **kw)
    t = tr.rasterize_hard(torch.from_numpy(verts), faces, torch.from_numpy(K),
                          None if colors is None else torch.from_numpy(
                              colors), settings, **kw)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: t2n(v) for k, v in t.items()})


def _faces_at(verts, faces, K, S, b, iy, ix):
    """Indices of the faces whose inside test at pixel (iy, ix) of frame b
    is decided by rounding."""
    uv = (verts[b] @ K[b].T)
    uv = uv[:, :2] / uv[:, 2:]
    p = np.array([(ix + 0.5) / S, (iy + 0.5) / S], np.float32)
    tri = uv[faces].astype(np.float32)
    out = set()
    for i, j in ((1, 2), (2, 0), (0, 1)):
        a, c = tri[:, i], tri[:, j]
        d = c - a
        e = d[:, 0] * (p[1] - a[:, 1]) - d[:, 1] * (p[0] - a[:, 0])
        slack = (np.abs(d[:, 0] * (p[1] - a[:, 1]))
                 + np.abs(d[:, 1] * (p[0] - a[:, 0]))) * 2.0 ** -20
        out |= set(np.nonzero(np.abs(e) <= slack)[0].tolist())
    return out


def _check_close(j, t, verts, faces, K, rgb_atol):
    """Pixels whose sil or depth (beyond rtol 1e-6) differ must be decided
    by rounding; the others agree in rgb within rgb_atol."""
    S = j["sil"].shape[-1]
    same = (j["sil"] == t["sil"]) & np.isclose(t["depth"], j["depth"],
                                               rtol=1e-6, atol=0)
    for b, iy, ix in np.argwhere(~same):
        assert _faces_at(verts, faces, K, S, b, iy, ix), (b, iy, ix)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(t["rgb"][same], j["rgb"][same], atol=rgb_atol,
                               rtol=0)
    return same


@pytest.mark.parametrize("shading", ["flat", "phong"])
def test_rasterize_hard_matches_jax(tree, shading):
    """The instance scene (hand + object, 1,872 faces) at 64^2, tile 16,
    Kf the scene's demand; flat with the evidence render's lighting, Phong
    with the default light."""
    verts, faces, K, colors = _scene(tree)
    st = tr.RasterSettings(64, tile_px=16, faces_per_tile=1 << 20)
    demand = tr.check_face_budget(torch.from_numpy(verts), faces,
                                  torch.from_numpy(K), st)["max_demand"]
    st = dataclasses.replace(st, faces_per_tile=demand)
    kw = (dict(background=0.0, ambient=1.0, diffuse=0.0, specular=0.0,
               shading="flat") if shading == "flat" else {})
    j, t = _run_both(verts, faces, K, colors if shading == "flat" else None,
                     st, **kw)
    assert t["sil"].dtype == bool and t["rgb"].shape == (2, 64, 64, 3)
    assert 0.05 < t["sil"].mean() < 0.9
    _check_close(j, t, verts, faces, K, 1e-6 if shading == "flat" else 2e-5)


@pytest.mark.parametrize("mesh", ["object", "hand"])
def test_rasterize_hard_phong_single_mesh_matches_jax(mesh):
    verts, faces, K = raster_mesh(mesh)
    st = tr.RasterSettings(32, tile_px=16, faces_per_tile=len(faces))
    j, t = _run_both(verts, faces, K, None, st, shading="phong")
    _check_close(j, t, verts, faces, K, 2e-5)


def test_rasterize_hard_does_not_depend_on_tile_or_chunk_once_kf_covers(
        tree, monkeypatch):
    """Faces stay in index order and the lowest index wins ties, so with
    Kf >= each tile's demand the render is the same at tiles 64, 32 and 16,
    and in chunks of any size."""
    verts, faces, K, colors = _scene(tree)
    v, k = torch.from_numpy(verts), torch.from_numpy(K)
    outs = []
    for tp in (64, 32, 16):
        st = tr.RasterSettings(64, tile_px=tp, faces_per_tile=1 << 20)
        st = dataclasses.replace(st, faces_per_tile=tr.check_face_budget(
            v, faces, k, st)["max_demand"])
        if tp == 16:
            monkeypatch.setattr(tr, "HARD_CHUNK_ELEMS", 1 << 18)
        outs.append(tr.rasterize_hard(v, faces, k, torch.from_numpy(colors),
                                      st))
    for o in outs[1:]:
        for key in ("rgb", "depth", "sil"):
            assert torch.equal(o[key], outs[0][key]), key


def test_hard_face_settings_sizes_kf_at_the_cheapest_tile(tree):
    verts, faces, K, _ = _scene(tree)
    st, demand = tr.hard_face_settings(
        torch.from_numpy(verts), faces, torch.from_numpy(K),
        tr.RasterSettings(64))
    assert set(demand) == {64, 32, 16}
    assert demand[64] >= demand[32] >= demand[16] > 0
    assert st.tile_px == min(demand, key=demand.get)
    assert st.faces_per_tile == demand[st.tile_px]
    # The demand is the largest per-(frame, tile) count of faces binned.
    _, _, _, overlap = tr._face_data(torch.from_numpy(verts), tr.as_topology(
        faces), torch.from_numpy(K), st)
    assert int(overlap.sum(-1).max()) == st.faces_per_tile


@functools.lru_cache(maxsize=None)
def _instance_inputs(tree, obj_only):
    vh, vo, fh, fo, K = ho3d_clip(tree)
    if obj_only:
        return [vo[:2]], [fo], K[:2]
    return [vh[:2], vo[:2]], [fh, fo], K[:2]


def test_render_instance_masks_match_jax_under_its_budget(tree):
    """The object alone stays under the JAX package's 256 faces a tile:
    the two packages' masks are equal."""
    vl, fl, K = _instance_inputs(tree, True)
    theirs = jgt.render_instance_masks(vl, fl, K, IMAGE)
    ours, budget = tgt.render_instance_masks(vl, fl, K, IMAGE, device="cpu")
    assert budget["face_demand"][64] <= 256
    assert len(ours) == 1 and ours[0].shape == (2, IMAGE, IMAGE)
    assert ours[0].any()
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_render_instance_masks_match_jax_renderer_at_the_sized_budget(
        tree, monkeypatch):
    """Hand and object overflow the JAX default at tile 64; the port's
    masks equal the JAX render_instance_masks run with faces_per_tile the
    demand at tile 64 (the port renders at its cheapest tile); the JAX
    default (256 faces a tile) loses object pixels."""
    vl, fl, K = _instance_inputs(tree, False)
    ours, budget = tgt.render_instance_masks(vl, fl, K, IMAGE, device="cpu")
    assert budget["face_demand"][64] > 256
    assert budget["faces_per_tile"] == budget["face_demand"][
        budget["tile_px"]]
    default = jgt.render_instance_masks(vl, fl, K, IMAGE)
    monkeypatch.setattr(jgt, "RasterSettings", functools.partial(
        jr.RasterSettings, faces_per_tile=budget["face_demand"][64]))
    sized = jgt.render_instance_masks(vl, fl, K, IMAGE)
    for o, s in zip(ours, sized):
        np.testing.assert_array_equal(o, s)
    lost = (sized[1] & ~default[1]).sum()
    assert lost > 0.01 * sized[1].sum(), (lost, sized[1].sum())


EDGE_CASES = [
    # (mesh, image, tile, Ke): Ke 48 overflows and buckets up at the tile;
    # the 16-pixel image covers the demand at the defaults' Ke.
    ("object", 64, 32, 48), ("hand", 64, 32, 48), ("object", 16, 16, 64),
    ("hand", 128, 128, 48)]


def _same(t, j):
    return (t.tile_px, t.edges_per_tile) == (j.tile_px, j.edges_per_tile)


@pytest.mark.parametrize("case", EDGE_CASES, ids=str)
@pytest.mark.parametrize("table", ["jax", "port"])
def test_auto_and_bump_edge_settings_match_jax_under_both_ceilings(
        case, table, monkeypatch):
    """The port sizes as the JAX package does with the card's ceiling
    (FWD_MAX_KE at every tile, so only the largest bucket caps): the JAX
    side with its table patched to it ("port") gives the same settings in
    every case. Under the JAX package's own VMEM table ("jax") the two
    agree wherever that table does not bind, and where it binds the JAX
    side ends on a smaller tile than the port."""
    mesh, S, tp, ke = case
    verts, faces, K = raster_mesh(mesh)
    card = {t: tr.FWD_MAX_KE for t in jr.EDGE_BUDGET_VMEM_CEILING}
    tables = {"jax": dict(jr.EDGE_BUDGET_VMEM_CEILING), "port": card}
    js = jr.RasterSettings(S, tile_px=tp, edges_per_tile=ke)
    ts = tr.RasterSettings(S, tile_px=tp, edges_per_tile=ke)

    def jax_side(fn):
        out = {}
        for name, ceiling in tables.items():
            monkeypatch.setattr(jr, "EDGE_BUDGET_VMEM_CEILING", ceiling)
            try:
                out[name] = fn()
            except RuntimeError:
                out[name] = None
        return out

    def check(t, j):
        if j[table] is None:
            assert t is None
        elif table == "port" or (j["jax"] is not None
                                 and _same(j["jax"], j["port"])):
            assert t is not None and _same(t, j[table])
        else:
            assert t is not None and _same(t, j["port"])
            assert j["jax"] is None or j["jax"].tile_px < t.tile_px

    j = jax_side(lambda: jr.auto_edge_settings(
        jnp.asarray(verts), jr.MeshTopology.from_faces(faces),
        jnp.asarray(K), js))
    check(tr.auto_edge_settings(torch.from_numpy(verts), faces,
                                torch.from_numpy(K), ts), j)
    for demand in (40, 90, 200, 500):
        j = jax_side(lambda: jr.bump_edge_settings(js, demand))
        try:
            tb = tr.bump_edge_settings(ts, demand)
        except RuntimeError:
            tb = None
        check(tb, j)


def test_the_card_ceiling_keeps_a_tile_the_tpu_ceiling_halves():
    """The documented difference: at tile 128 the TPU's VMEM table stops at
    96 edge slots, the card's shade pair takes up to FWD_MAX_KE, above every
    bucket; a demand needing 128 slots halves the TPU tile and keeps the
    card's."""
    assert max(tr.EDGE_BUCKETS) <= tr.FWD_MAX_KE == 3200
    assert jr.EDGE_BUDGET_VMEM_CEILING[128] == 96
    js = jr.RasterSettings(256, tile_px=128, edges_per_tile=48)
    ts = tr.RasterSettings(256, tile_px=128, edges_per_tile=48)
    jb = jr.bump_edge_settings(js, 90)
    tb = tr.bump_edge_settings(ts, 90)
    assert (jb.tile_px, jb.edges_per_tile) == (64, 128)
    assert (tb.tile_px, tb.edges_per_tile) == (128, 128)
    with pytest.raises(RuntimeError, match="unsatisfiable"):
        tr.bump_edge_settings(tr.RasterSettings(256, tile_px=16), 1000)
