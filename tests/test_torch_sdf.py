"""PyTorch port vs JAX package: the interior SDF, its voxelizer (plain
version), trilinear sampling, the contact loss and the collision and contact
terms (CPU, same numpy inputs on both sides).

The JAX voxelizer kernel runs in interpret mode, as tests/test_sdf.py runs
it. Bands: voxel grids atol 1e-5 (the JAX package's Pallas-vs-XLA band,
tests/test_sdf.py:144), sampling 1e-6, loss terms rtol 3e-4 (the iteration-0
band of tests/test_jointopt_parity.py), gradients 3e-3 of their maximum.
"""
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homan_tpu.core.meshes import icosphere
from homan_tpu.fit import losses as JL
from homan_tpu.interactions import contact as jcontact
from homan_tpu.interactions import pallas_sdf as jpallas
from homan_tpu.interactions import sdf as jsdf
from homan_tpu_torch.fit import losses as TL
from homan_tpu_torch.interactions import contact as tcontact
from homan_tpu_torch.interactions import sdf as tsdf
from homan_tpu_torch.interactions import voxelize as tvox

from torch_port_common import assert_grad_close, scene_pair, t2n


def _sphere(subdiv=2, radius=0.7):
    v, f = icosphere(subdiv, radius)
    return np.asarray(v, np.float32)[None], np.asarray(f, np.int64)


def _bumpy(b=2, seed=0):
    """A non-convex closed mesh, normalized like build_scene_sdfs does."""
    from homan_tpu.core.meshes import bumpy_potato
    v, f = bumpy_potato(2, 0.6, seed=seed)
    rng = np.random.RandomState(seed)
    offs = rng.uniform(-0.1, 0.1, (b, 1, 3)).astype(np.float32)
    return (np.asarray(v, np.float32)[None] + offs), np.asarray(f, np.int64)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("mesh", ["sphere", "bumpy"])
def test_voxelizer_plain_matches_jax(reference, mesh):
    verts, faces = _sphere() if mesh == "sphere" else _bumpy()
    jv, jf = jnp.asarray(verts), jnp.asarray(faces.astype(np.int32))
    if reference == "xla":
        ref = jsdf.voxelize_interior_sdf(jv, jf, grid_size=16)
    else:  # interpret mode off the TPU
        ref = jpallas.voxelize_interior_sdf_pallas(jv, jf, grid_size=16)
    ref = np.asarray(ref)
    n0 = tvox.voxelize_launches
    ours = t2n(tvox.voxelize(torch.from_numpy(verts),
                             torch.from_numpy(faces), 16))
    assert tvox.voxelize_launches == n0  # the CPU runs the plain version
    assert ours.shape == ref.shape == (verts.shape[0], 16, 16, 16)
    assert (ref > 0).sum() > 100
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_pack_triangles_exact():
    verts, faces = _bumpy()
    ours = t2n(tvox.pack_triangles(torch.from_numpy(verts),
                                   torch.from_numpy(faces)))
    ref = np.asarray(jpallas.pack_triangles(jnp.asarray(verts),
                                            jnp.asarray(faces)))
    assert ours.shape == ref.shape and ours.shape[2] % tvox.TF == 0
    np.testing.assert_array_equal(ours, ref)


def test_voxelizer_kernel_wrapper_refuses_cpu_tensors():
    verts, faces = _sphere()
    pack = tvox.pack_triangles(torch.from_numpy(verts),
                               torch.from_numpy(faces))
    with pytest.raises(ValueError, match="CUDA"):
        tvox.voxelize_pack(pack, 16)


def _sample_inputs(seed=0):
    rng = np.random.RandomState(seed)
    phi = rng.rand(2, 8, 8, 8).astype(np.float32)
    # Inside the box, near and past its faces (zero padding).
    coords = rng.uniform(-1.15, 1.15, (2, 300, 3)).astype(np.float32)
    return phi, coords


def test_grid_sample_3d_values_and_coordinate_gradients():
    phi, coords = _sample_inputs()
    w = np.random.RandomState(1).randn(2, 300).astype(np.float32)

    def jf(c):
        return (jsdf.grid_sample_3d(jnp.asarray(phi), c) * w).sum()

    jval = np.asarray(jsdf.grid_sample_3d(jnp.asarray(phi),
                                          jnp.asarray(coords)))
    jgrad = np.asarray(jax.grad(jf)(jnp.asarray(coords)))
    tc = torch.from_numpy(coords).requires_grad_(True)
    tval = tsdf.grid_sample_3d(torch.from_numpy(phi), tc)
    (tval * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t2n(tval), jval, atol=1e-6)
    np.testing.assert_allclose(t2n(tc.grad), jgrad, atol=1e-6)
    assert (jval == 0).any() and (jval > 0).any()


def test_grid_sample_3d_reads_the_voxelizer_layout():
    """Sampling at the voxelizer's cell centres returns each cell's value:
    phi[i, j, k] <-> (x_i, y_j, z_k), linear index (ix, iy, iz)."""
    phi, _ = _sample_inputs(2)
    g = phi.shape[-1]
    pts = tsdf.grid_points(g)[None].expand(2, -1, -1)
    ours = tsdf.grid_sample_3d(torch.from_numpy(phi), pts)
    np.testing.assert_allclose(t2n(ours), phi.reshape(2, -1), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jsdf.grid_sample_3d(jnp.asarray(phi), jnp.asarray(t2n(
            pts)))), phi.reshape(2, -1), atol=1e-6)


def _query_inputs():
    verts, faces = _bumpy(b=2)
    rng = np.random.RandomState(3)
    q = rng.uniform(-0.8, 0.8, (2, 200, 3)).astype(np.float32)
    return q, verts, faces


def test_interior_sdf_at_points_values_and_gradients():
    q, verts, faces = _query_inputs()
    w = np.random.RandomState(4).rand(2, 200).astype(np.float32)
    jf_ = jnp.asarray(faces.astype(np.int32))

    def jloss(qq):
        return (jsdf.interior_sdf_at_points(qq, jnp.asarray(verts), jf_)
                * w).sum()

    jval = np.asarray(jsdf.interior_sdf_at_points(jnp.asarray(q),
                                                  jnp.asarray(verts), jf_))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    tq = torch.from_numpy(q).requires_grad_(True)
    tv = torch.from_numpy(verts).requires_grad_(True)
    tval = tsdf.interior_sdf_at_points(tq, tv, torch.from_numpy(faces))
    (tval * torch.from_numpy(w)).sum().backward()
    assert (jval > 0).sum() > 20 and (jval == 0).sum() > 20
    np.testing.assert_array_equal(t2n(tval) > 0, jval > 0)
    np.testing.assert_allclose(t2n(tval), jval, atol=1e-6)
    assert_grad_close(t2n(tq.grad), jgrad, name="d/dquery")
    assert tv.grad is None  # the mesh gets no gradient


def test_sdf_scene_loss_direct_values_and_gradients():
    q, verts, faces = _query_inputs()
    other, ofaces = _sphere(2, 0.4)
    other = np.repeat(other, 2, axis=0) + np.float32(0.3)
    jf1 = jnp.asarray(faces.astype(np.int32))
    jf2 = jnp.asarray(ofaces.astype(np.int32))

    def jloss(a, b):
        return jsdf.sdf_scene_loss_direct([a, b], [jf1, jf2])[0]

    jval, (ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(verts), jnp.asarray(other))
    ta = torch.from_numpy(verts).requires_grad_(True)
    tb = torch.from_numpy(other).requires_grad_(True)
    tval, meta = tsdf.sdf_scene_loss_direct(
        [ta, tb], [torch.from_numpy(faces), torch.from_numpy(ofaces)])
    tval.backward()
    assert float(jval) > 0
    np.testing.assert_allclose(tval.item(), float(jval), rtol=3e-4)
    assert set(meta["dist_values"]) == {(0, 1), (1, 0)}
    assert_grad_close(t2n(ta.grad), np.asarray(ga), name="d/dmesh0")
    assert_grad_close(t2n(tb.grad), np.asarray(gb), name="d/dmesh1")


def test_sdf_scene_loss_grid_values_and_gradients():
    verts, faces = _bumpy(b=2)
    other, ofaces = _sphere(2, 0.4)
    other = np.repeat(other, 2, axis=0) + np.float32(0.3)
    jf1 = jnp.asarray(faces.astype(np.int32))
    jf2 = jnp.asarray(ofaces.astype(np.int32))

    def jloss(a, b):
        return jsdf.sdf_scene_loss([a, b], [jf1, jf2], grid_size=16)[0]

    jval, (ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(verts), jnp.asarray(other))
    ta = torch.from_numpy(verts).requires_grad_(True)
    tb = torch.from_numpy(other).requires_grad_(True)
    tval, meta = tsdf.sdf_scene_loss(
        [ta, tb], [torch.from_numpy(faces), torch.from_numpy(ofaces)],
        grid_size=16)
    tval.backward()
    assert float(jval) > 0 and len(meta["sdfs"]) == 2
    np.testing.assert_allclose(tval.item(), float(jval), rtol=3e-4)
    assert_grad_close(t2n(ta.grad), np.asarray(ga), name="d/dmesh0")
    assert_grad_close(t2n(tb.grad), np.asarray(gb), name="d/dmesh1")


def _contact_inputs(overlap: bool):
    v, f = icosphere(2, 0.2)
    v = np.asarray(v, np.float32)
    rng = np.random.RandomState(5)
    # Separated spheres 0.05 apart: nearer than tanh's saturated tail,
    # where 1 - tanh^2 is a few ulps of rounding in either framework.
    shift = 0.1 if overlap else 0.45
    hand = (v[None] + np.array([shift, 0, 0], np.float32)
            + rng.randn(2, 1, 3).astype(np.float32) * 0.01)
    obj = np.repeat(v[None], 2, axis=0)
    return hand, obj, np.asarray(f, np.int64)


_ZONES = {0: [1, 5, 9, 40], 1: [2, 3, 70, 100, 150], 2: [7]}

CONTACT_CASES = [
    # (overlap, kwargs)
    (True, {}),
    (False, {}),
    (True, {"strict_exterior": True}),
    (False, {"strict_exterior": True}),
    (False, {"strict_exterior": True, "contact_zones": "zones"}),
    (False, {"strict_exterior": True, "contact_mode": "dist",
             "collision_mode": "dist_sq", "contact_thresh": 0.4}),
    (True, {"contact_mode": "dist_sq", "collision_mode": "dist",
            "contact_target": "obj"}),
    (True, {"strict_exterior": True, "contact_target": "hand"}),
]


@pytest.mark.parametrize("overlap,kwargs", CONTACT_CASES)
def test_compute_contact_loss_modes(overlap, kwargs):
    hand, obj, f = _contact_inputs(overlap)
    kwargs = dict(kwargs, sdf_grid=16)
    if kwargs.get("contact_zones") == "zones":
        kwargs["contact_zones"] = _ZONES
    jf = jnp.asarray(f.astype(np.int32))

    def jloss(h, o):
        m, p, info, metrics = jcontact.compute_contact_loss(h, jf, o, jf,
                                                            **kwargs)
        return m + p, (m, p, info, metrics)

    (_, (jm, jp, jinfo, jmet)), (gh, go) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(hand),
                                             jnp.asarray(obj))
    th = torch.from_numpy(hand).requires_grad_(True)
    to = torch.from_numpy(obj).requires_grad_(True)
    tf = torch.from_numpy(f)
    tm, tp, tinfo, tmet = tcontact.compute_contact_loss(th, tf, to, tf,
                                                        **kwargs)
    (tm + tp).backward()
    for k in ("attraction_masks", "repulsion_masks"):
        np.testing.assert_array_equal(t2n(tinfo[k]), np.asarray(jinfo[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tm.item(), float(jm), rtol=3e-4, atol=1e-9)
    np.testing.assert_allclose(tp.item(), float(jp), rtol=3e-4, atol=1e-9)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   rtol=3e-4, atol=1e-9, err_msg=k)
    assert float(jm) + float(jp) > 0
    for name, t, j in (("d/dhand", th, gh), ("d/dobject", to, go)):
        j = np.asarray(j)
        if t.grad is None or not np.any(j):  # a detached target
            assert not np.any(j) and (t.grad is None
                                      or not bool(t.grad.any())), name
            continue
        assert_grad_close(t2n(t.grad), j, name=name)


def test_contact_tips_mode_and_reference_quirk():
    hand, obj, f = _contact_inputs(False)
    tf = torch.from_numpy(f)
    th, to = torch.from_numpy(hand), torch.from_numpy(obj)
    # The reference's quirk: exterior is never true on a clamped SDF.
    m, p, info, _ = tcontact.compute_contact_loss(th, tf, to, tf, sdf_grid=16)
    assert m.item() == 0.0 and bool(info["repulsion_masks"].all())
    # A mesh of 778 vertices has the MANO fingertip ids.
    big = np.concatenate([hand, np.repeat(hand[:, :1], 778 - hand.shape[1],
                                          axis=1)], axis=1)
    jm, _, jinfo, _ = jcontact.compute_contact_loss(
        jnp.asarray(big), jnp.asarray(f.astype(np.int32)), jnp.asarray(obj),
        jnp.asarray(f.astype(np.int32)), contact_zones="tips",
        strict_exterior=True, sdf_grid=16)
    tm, _, tinfo, _ = tcontact.compute_contact_loss(
        torch.from_numpy(big), tf, to, tf, contact_zones="tips",
        strict_exterior=True, sdf_grid=16)
    mask = t2n(tinfo["attraction_masks"])
    np.testing.assert_array_equal(mask, np.asarray(jinfo["attraction_masks"]))
    assert mask.sum() == 2 * 5
    np.testing.assert_allclose(tm.item(), float(jm), rtol=3e-4)


def test_masked_mean_loss_and_contact_zones_file(tmp_path):
    d = np.random.RandomState(6).rand(3, 7).astype(np.float32)
    for mask in (d > 0.5, np.zeros_like(d, bool)):
        np.testing.assert_allclose(
            tcontact.masked_mean_loss(torch.from_numpy(d),
                                      torch.from_numpy(mask)).item(),
            float(jcontact.masked_mean_loss(jnp.asarray(d),
                                            jnp.asarray(mask))), rtol=1e-6)
    path = tmp_path / "contact_zones.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"contact_zones": _ZONES}, fh)
    assert tcontact.load_contact_zones(str(path)) == \
        jcontact.load_contact_zones(str(path))


@functools.lru_cache(maxsize=None)
def _terms_inputs():
    """Hand (1 frame) and an object pushed into it, from the JAX scene."""
    js, ts = scene_pair()
    hand = np.array(js.gt_verts_hand)[:1]
    obj = np.array(js.gt_verts_object)[:1]
    obj = obj + (hand.mean(1, keepdims=True) - obj.mean(1, keepdims=True)
                 ) * np.float32(0.7)
    return (hand, obj.astype(np.float32), np.array(js.closed_hand_faces),
            np.array(js.consts.faces_object.faces))


@pytest.mark.parametrize("sdf_mode", ["direct", "grid"])
def test_collision_and_contact_terms_both_modes(sdf_mode):
    hand, obj, hf, of = _terms_inputs()
    jhf, jof = jnp.asarray(hf), jnp.asarray(of)

    def jloss(h, o):
        out = JL.compute_interaction_sdf_terms(
            h, o, jof, jhf, 1, with_collision=True, with_contact=True,
            sdf_mode=sdf_mode)
        return 1e-3 * out["loss_collision"] + out["loss_contact"], out

    (_, jout), (gh, go) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(hand),
                                             jnp.asarray(obj))
    th = torch.from_numpy(hand).requires_grad_(True)
    to = torch.from_numpy(obj).requires_grad_(True)
    tout = TL.compute_interaction_sdf_terms(
        th, to, torch.from_numpy(of), torch.from_numpy(hf), 1,
        with_collision=True, with_contact=True, sdf_mode=sdf_mode)
    (1e-3 * tout["loss_collision"] + tout["loss_contact"]).backward()
    assert list(tout) == list(jout) == ["loss_collision", "loss_contact"]
    assert float(jout["loss_collision"]) > 0
    for k in jout:
        np.testing.assert_allclose(tout[k].item(), float(jout[k]),
                                   rtol=3e-4, err_msg=k)
    assert_grad_close(t2n(th.grad), np.asarray(gh), name="d/dhand")
    assert_grad_close(t2n(to.grad), np.asarray(go), name="d/dobject")


def test_shared_grids_match_standalone_terms():
    """The voxelize-once hoist is exact, as in the JAX package
    (tests/test_sdf.py test_hoisted_grids_match_standalone_terms)."""
    v, f = icosphere(2, 0.2)
    f = torch.from_numpy(np.asarray(f, np.int64))
    rng = np.random.RandomState(0)
    hand = torch.from_numpy(np.asarray(v, np.float32)[None] + (
        rng.randn(3, 1, 3).astype(np.float32) * 0.05 + [[[0.1, 0, 0]]]
    ).astype(np.float32))
    obj = torch.from_numpy(np.asarray(v, np.float32)[None]).expand(3, -1, -1)
    grids, hand_list = TL.build_interaction_grids(hand, obj, f, f, hand_nb=1,
                                                  sdf_grid=16)
    kw = dict(hand_nb=1, sdf_grid=16)
    col = TL.compute_collision_loss(hand, obj, f, f, grids=grids,
                                    hand_verts=hand_list, **kw)
    con = TL.compute_contact_loss_term(hand, obj, f, f, grids=grids,
                                       hand_verts=hand_list, **kw)
    assert col["loss_collision"].item() > 0
    assert torch.equal(col["loss_collision"], TL.compute_collision_loss(
        hand, obj, f, f, **kw)["loss_collision"])
    assert torch.equal(con["loss_contact"], TL.compute_contact_loss_term(
        hand, obj, f, f, **kw)["loss_contact"])


# ---------------------------------------------------------------------------
# The voxelizer kernel's order of work, restated on the CPU
# ---------------------------------------------------------------------------
def _column_parity(tri_pack, g):
    """Inside sets (B, G, G, G) in the kernel's order of work: per xy
    column, the crossing test of every valid triangle of the pack in the
    plain version's expressions, giving the column's list of hit heights;
    then, per z cell, the count of hits above the cell's centre."""
    axis = -1.0 + (2.0 * torch.arange(g, dtype=torch.float32) + 1.0) / g
    cpx = axis.repeat_interleave(g)[:, None]  # column ix * G + iy
    cpy = axis.repeat(g)[:, None]
    out = []
    for pack in tri_pack:
        valid = pack[9] > 0.5
        ax, ay, az, bx, by, bz, cx, cy, cz = (r[None] for r in pack[:9])
        e0 = (bx - ax) * (cpy - ay) - (by - ay) * (cpx - ax)
        e1 = (cx - bx) * (cpy - by) - (cy - by) * (cpx - bx)
        e2 = (ax - cx) * (cpy - cy) - (ay - cy) * (cpx - cx)
        inside_xy = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                     | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
        area2 = e0 + e1 + e2
        hit = valid & inside_xy & (area2.abs() > 1e-12)
        counts = []
        for col in range(g * g):
            h = hit[col]
            z_hits = (e1[col, h] / area2[col, h] * az[0, h]
                      + e2[col, h] / area2[col, h] * bz[0, h]
                      + e0[col, h] / area2[col, h] * cz[0, h])
            counts.append((z_hits[None, :] > axis[:, None]).sum(1))
        out.append((torch.stack(counts) % 2 == 1).reshape(g, g, g))
    return torch.stack(out)


def _octahedron(center, radius):
    """Closed octahedron whose top and bottom vertices lie on the xy column
    through `center`: that column crosses the mesh at a shared vertex."""
    c = np.asarray(center, np.float32)
    v = c + radius * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                               [0, 0, 1], [0, 0, -1]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64)
    return v[None], f


def _nested_shells(n=6):
    """n nested closed spheres: the central columns cross the mesh 2n
    times."""
    vs, fs, off = [], [], 0
    for i in range(n):
        v, f = icosphere(2, 0.95 - 0.13 * i)
        vs.append(np.asarray(v, np.float32))
        fs.append(np.asarray(f, np.int64) + off)
        off += len(v)
    return np.concatenate(vs)[None], np.concatenate(fs)


def _synthetic_hand():
    from homan_tpu_torch.core import mano as tmano
    p = tmano.synthetic_mano_params(0, device="cpu")
    z = torch.zeros(1, 3)
    out = tmano.mano_forward(p, torch.zeros(1, 10), z, torch.zeros(1, 45))
    verts = out["verts"]
    center, scale = tsdf.normalize_to_unit_box(verts)
    return t2n((verts - center) / scale), p["faces"].numpy().astype(np.int64)


_PARITY_MESHES = {
    "bumpy": lambda: _bumpy(b=2),
    "hand": _synthetic_hand,
    "vertex_column": lambda: _octahedron([0.0625, 0.0625, 0.0], 0.6),
    "nested_shells": _nested_shells,
}


@pytest.mark.parametrize("grid", [16, 32])
@pytest.mark.parametrize("mesh", list(_PARITY_MESHES))
def test_column_parity_matches_plain_crossings(mesh, grid):
    verts, faces = _PARITY_MESHES[mesh]()
    v = torch.from_numpy(verts)
    f = torch.from_numpy(faces)
    pack = tvox.pack_triangles(v, f)
    ours = _column_parity(pack, grid)
    points = tsdf.grid_points(grid)[:, None, :]
    for b in range(v.shape[0]):
        tri = v[b][f]
        a, bb, c = tri[None, :, 0], tri[None, :, 1], tri[None, :, 2]
        ref = torch.cat([tsdf._ray_z_crossings(p, a, bb, c)
                         for p in torch.split(points, 2048)])
        assert torch.equal(ours[b].reshape(-1), ref), (mesh, grid, b)
    assert bool(ours.any()) and not bool(ours.all())


def test_vertex_column_counts_a_shared_vertex_per_face():
    """The column through the octahedron's top and bottom vertices hits
    each of the four faces that meet at each vertex (an edge function of 0
    counts on both sides), as the plain version does: an even count at
    every z cell, so the column stays outside while its neighbours do
    not."""
    verts, faces = _octahedron([0.0625, 0.0625, 0.0], 0.6)
    ours = _column_parity(tvox.pack_triangles(torch.from_numpy(verts),
                                              torch.from_numpy(faces)), 16)
    assert not bool(ours[0, 8, 8].any())  # the vertex column
    assert bool(ours[0, 9, 9, 5:11].all())  # |x|+|y|+|z| < 0.6


def test_voxelizer_op_count_two_triangles():
    """Two triangles covering the grid's xy square at z = -0.5 and 0.5, at
    G 16: 256 columns, and the 8 z cells between the triangles of every
    column inside (pz = -0.4375 ... 0.4375)."""
    big = [[-4.0, -4.0], [8.0, -4.0], [-4.0, 8.0]]
    verts = np.array([[x, y, z] for z in (-0.5, 0.5) for x, y in big],
                     np.float32)[None]
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int64)
    phi = tvox.voxelize(torch.from_numpy(verts), torch.from_numpy(faces), 16)
    n_inside = int((phi > 0).sum())
    assert n_inside == 256 * 8
    by_hand = 32 * 256 * 2 + 87 * 2048 * 2  # crossing + distance
    assert tvox.work_ops(2, n_inside, 16, 1) == by_hand == 372736
    dense = 104 * 16 ** 3 * 2
    assert tvox.DENSE_OPS_PER_POINT_FACE * 16 ** 3 * 2 == dense
