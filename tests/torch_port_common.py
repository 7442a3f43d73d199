"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: numpy extraction of JAX objects and the scenes both sides use."""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

# The suite runs in several worker processes on one machine: a full-width
# torch thread pool in each oversubscribes the cores (a 2 s test took 50 s
# under six workers). Two threads per worker keep them busy without that.
torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // 4)))


def to_numpy(x):
    """JAX dataclass / dict / array tree -> the same tree of numpy arrays."""
    if x is None:
        return None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return np.asarray(x)


def assert_same_tree(a, b, path="out"):
    """Exact equality of two trees of dicts, lists, arrays and scalars."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def inject_jax_rotations(monkeypatch, n=24, seed=0):
    """Make the port draw the JAX package's first `n` candidate rotations
    (jax.random key `seed`), as the parity tests of stage B do."""
    import jax
    from homan_tpu.core import geometry as jgeo
    from homan_tpu_torch.core import geometry as tgeo
    rots = np.array(jgeo.random_rotations(jax.random.PRNGKey(seed), n))
    monkeypatch.setattr(
        tgeo, "random_rotations",
        lambda n_, generator=None, upright=False, device=None:
        torch.from_numpy(rots[:n_]).to(device))


def host_tree(x):
    """A pickled payload with every JAX array as numpy."""
    import jax
    if isinstance(x, dict):
        return {k: host_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [host_tree(v) for v in x]
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def t2n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


def jax_obj_rot0(seed: int) -> np.ndarray:
    """The starting object rotation the JAX scene draws from jax.random."""
    import jax
    from homan_tpu.core import geometry as geo
    return np.asarray(geo.random_rotations(jax.random.PRNGKey(seed), 1))[0]


@functools.lru_cache(maxsize=None)
def scene_pair(seed=0, frame_nb=2, image_size=128, rend_size=64,
               obj_subdiv=2):
    """The same synthetic scene built by both packages (CPU), once per
    worker process."""
    from homan_tpu.frontend import gtsynth as jgs
    from homan_tpu_torch.frontend import gtsynth as tgs
    js = jgs.make_synthetic_scene(seed=seed, frame_nb=frame_nb,
                                  image_size=image_size, rend_size=rend_size,
                                  obj_subdiv=obj_subdiv)
    ts = tgs.make_synthetic_scene(jax_obj_rot0(seed), seed=seed,
                                  frame_nb=frame_nb, image_size=image_size,
                                  rend_size=rend_size, obj_subdiv=obj_subdiv,
                                  device="cpu")
    return js, ts


def port_from_jax(js):
    """The port's (state, consts, cfg) converted from a JAX scene's data."""
    from homan_tpu_torch import convert
    state = convert.state_from_numpy(to_numpy(js.init_state), device="cpu")
    consts = convert.consts_from_numpy(to_numpy(js.consts), device="cpu")
    cfg = convert.config_from_dict(dataclasses.asdict(js.cfg))
    return state, consts, cfg


def settings_pair(image_size, tile_px, edges_per_tile=48):
    """Matching raster settings: the JAX side runs its Pallas kernel in
    interpret mode, as tests/test_pallas_shade.py does."""
    from homan_tpu.render import RasterSettings as JS
    from homan_tpu_torch.render import RasterSettings as TS
    return (JS(image_size=image_size, tile_px=tile_px,
               edges_per_tile=edges_per_tile, use_pallas=True),
            TS(image_size=image_size, tile_px=tile_px,
               edges_per_tile=edges_per_tile))


def assert_grad_close(ours, theirs, rel=3e-3, name=""):
    """|ours - theirs| <= rel * max|theirs| (the JAX package's own band)."""
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    scale = max(np.abs(theirs).max(), 1e-30)
    err = np.abs(ours - theirs).max() / scale
    assert err <= rel, f"{name}: max err {err:.3g} of max > {rel}"


def _object_mesh(b=2, seed=0):
    from homan_tpu.core.meshes import bumpy_potato
    v, f = bumpy_potato(2, 0.25, seed=0)
    rng = np.random.RandomState(seed)
    offs = rng.randn(b, 1, 3).astype(np.float32) * 0.03
    verts = (v[None] + np.array([0, 0, 1.0], np.float32) + offs).astype(
        np.float32)
    K = np.tile(np.array([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]],
                         np.float32), (b, 1, 1))
    return verts, f, K


def _hand_mesh(b=2):
    import jax
    import jax.numpy as jnp
    from homan_tpu.core import mano as jmano
    p = jmano.synthetic_mano_params(0)
    out = jax.vmap(lambda r: jmano.mano_forward(
        p, jnp.zeros(10), r, jnp.zeros(45)))(jnp.zeros((b, 3)))
    verts = np.asarray(out["verts"]) + np.array([0, 0, 0.5], np.float32)
    K = np.tile(np.array([[[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]]],
                         np.float32), (b, 1, 1))
    return verts.astype(np.float32), np.asarray(p["faces"]), K


# (mesh, image size, tile, edges per tile): the headline's shape class at
# test size, and the evidence renders' tile 16.
CASES = [("object", 64, 32, 96), ("object", 32, 16, 64),
         ("hand", 64, 16, 64)]


def raster_mesh(mesh):
    """verts (2, V, 3), faces, K (2, 3, 3) of the object or the hand."""
    return _object_mesh() if mesh == "object" else _hand_mesh()


def raster_case(mesh, S, tp, ke):
    """Mesh, both packages' topologies and matching raster settings."""
    from homan_tpu.render import rasterizer as jr
    from homan_tpu_torch.render import rasterizer as tr
    verts, faces, K = raster_mesh(mesh)
    jtopo = jr.MeshTopology.from_faces(faces)
    ttopo = tr.MeshTopology.from_faces(faces, device="cpu")
    jset, tset = settings_pair(S, tp, ke)
    return verts, K, jtopo, ttopo, jset, tset


@functools.lru_cache(maxsize=None)
def depth_scene_pair(seed=0, frame_nb=2, image_size=128, rend_size=64):
    """scene_pair with the image-sized entity masks of the ordinal-depth
    loss."""
    from homan_tpu.frontend import gtsynth as jgs
    from homan_tpu_torch.frontend import gtsynth as tgs
    js = jgs.make_synthetic_scene(seed=seed, frame_nb=frame_nb,
                                  image_size=image_size, rend_size=rend_size,
                                  with_full_masks=True)
    ts = tgs.make_synthetic_scene(jax_obj_rot0(seed), seed=seed,
                                  frame_nb=frame_nb, image_size=image_size,
                                  rend_size=rend_size, with_full_masks=True,
                                  device="cpu")
    return js, ts


def overlap_state(js):
    """The JAX scene's ground-truth state with the object moved just in
    front of the (first) hand: the renders then overlap where the masks
    disagree, so the ordinal-depth pairs are active."""
    import jax.numpy as jnp
    gt = js.gt_state
    hand_nb = js.cfg.hand_nb
    t = gt.translations_hand[::hand_nb] + jnp.asarray([0.03, 0.0, -0.06])
    return dataclasses.replace(gt, translations_object=t)


def adversarial_depth_pack(tp=16, g=2, b=2, seed=0, lead=0):
    """A face pack (b, g*g, 16, kf) for the depth kernel's cull, built by
    hand in image coordinates (every tile holds every face, all valid):

    - right triangles whose two legs are axis-aligned edges through pixel
      centres on a sub-tile's boundary, so they touch a sub-tile only at
      one corner centre (e = 0 there, exactly);
    - slivers: two vertices on pixel centres and a third a hair off their
      line, so the inside band holds pixel centres only as rounding allows;
    - triangles with every vertex on a pixel centre;
    - one face with all-zero edge lines (inside everywhere, as a degenerate
      face of the prep is);
    - equal-invz ties: some faces repeated at a later slot, and some faces
      sharing one constant invz;
    - with `lead` > 0, that many faces inside nowhere (e0 = -1) before all
      the others, so the faces that win sit at slots from `lead` on.

    Returns (face_pack, DepthStatic)."""
    from homan_tpu_torch.render.depth import DepthStatic
    S = tp * g
    f32 = np.float32
    inv_s = f32(1.0 / S)

    def centre(i):  # pixel centre i in image coordinates, as the kernel
        return (f32(i) + f32(0.5)) * inv_s

    def line(a, b):  # the prep's edge line through a and b
        A = -(b[1] - a[1])
        B = b[0] - a[0]
        C = (b[1] - a[1]) * a[0] - (b[0] - a[0]) * a[1]
        return [A, B, C]

    def triangle(p0, p1, p2, rng):
        p0, p1, p2 = (np.asarray(p, f32) for p in (p0, p1, p2))
        area = f32((p1[0] - p0[0]) * (p2[1] - p0[1])
                   - (p2[0] - p0[0]) * (p1[1] - p0[1]))
        if area == 0:
            return None  # degenerate: drawn again
        sgn = f32(np.sign(area))
        rows = []
        for a, c in ((p1, p2), (p2, p0), (p0, p1)):
            rows += [f32(x) * sgn for x in line(a, c)]
        return rows + invz(rng)

    def invz(rng):
        return [f32(rng.uniform(-0.2, 0.2)), f32(rng.uniform(-0.2, 0.2)),
                f32(rng.uniform(0.8, 1.2))]

    packs = []
    for bi in range(b):
        rng = np.random.RandomState(seed * 1000 + bi)
        faces = []
        bounds = [i for m in range(1, S // 8) for i in (8 * m - 1, 8 * m)]
        for _ in range(48):  # corner-touching right triangles
            X, Y = centre(rng.choice(bounds)), centre(rng.choice(bounds))
            sx, sy = f32(rng.choice([-1, 1])), f32(rng.choice([-1, 1]))
            w = f32(rng.randint(1, 6)) * inv_s
            faces.append([sx, f32(0), -sx * X, f32(0), sy, -sy * Y,
                          -sx, -sy, sx * X + sy * Y + w] + invz(rng))
        while len(faces) < 144:  # slivers, a fraction of a pixel wide
            i0, j0 = rng.randint(0, S, 2)
            i1, j1 = np.clip([i0, j0] + rng.randint(-6, 7, 2), 0, S - 1)
            p0 = (centre(i0), centre(j0))
            p1 = (centre(i1), centre(j1))
            off = f32(rng.choice([1e-3, 0.05, 0.3])) * inv_s
            p2 = (p1[0] + off, p1[1] - off) if rng.rand() < 0.5 else (
                (p0[0] + p1[0]) / f32(2) + off, (p0[1] + p1[1]) / f32(2))
            face = triangle(p0, p1, p2, rng)
            if face is not None:
                faces.append(face)
        while len(faces) < 240:  # triangles on pixel centres
            i, j = rng.randint(0, S, 2)
            pts = [(centre(i), centre(j))] + [
                (centre(np.clip(i + di, 0, S - 1)),
                 centre(np.clip(j + dj, 0, S - 1)))
                for di, dj in rng.randint(-9, 10, (2, 2))]
            face = triangle(*pts, rng)
            if face is not None:
                faces.append(face)
        faces.append([f32(0)] * 9 + [f32(0), f32(0), f32(0.05)])
        tie = [f32(0), f32(0), f32(1.5)]
        for idx in rng.choice(len(faces) - 1, 12, replace=False):
            faces[idx][9:12] = tie  # one constant invz shared by several
        for idx in rng.choice(len(faces), 40, replace=False):
            faces.append(list(faces[idx]))  # repeated at a later slot
        nowhere = [f32(0), f32(0), f32(-1)] + [f32(0)] * 6 + invz(rng)
        packs.append(np.asarray([nowhere] * lead + faces, f32))
    kf = len(packs[0])
    T = g * g
    out = np.zeros((b, T, 16, kf), f32)
    for bi, faces in enumerate(packs):
        out[bi, :, :12] = faces.T[None]
        out[bi, :, 12] = 1.0
    return torch.from_numpy(out), DepthStatic(tp, S, g, kf)


def ho3d_tree(root, frames=4, obj_subdiv=2):
    """The synthetic HO-3D tree of chip_smoke.py (HO-3D's camera, the
    synthetic MANO hand as a MANO pickle, a turning bumpy potato) under
    `root`; returns root as a str."""
    import chip_smoke
    return chip_smoke.write_ho3d_tree(str(root), frames=frames,
                                      obj_subdiv=obj_subdiv)


def ho3d_kwargs(root):
    """The HO3D dataset's paths inside a tree written by ho3d_tree."""
    return dict(root=os.path.join(root, "local_data", "datasets"),
                ycb_root=os.path.join(root, "local_data", "datasets",
                                      "ycbmodels"),
                mano_root=os.path.join(root, "extra_data", "mano"),
                cache_folder=os.path.join(root, "cache"))


@functools.lru_cache(maxsize=None)
def ho3d_clip(root, frame_nb=3, chunk_step=1):
    """Sample 0 of the port's HO3D (CPU) on a tree written by ho3d_tree:
    (hand verts (T, 778, 3), object verts (T, V, 3), hand faces, object
    faces, pixel K (T, 3, 3))."""
    from homan_tpu_torch.data.ho3d import HO3D
    ds = HO3D(frame_nb=frame_nb, chunk_step=chunk_step, device="cpu",
              **ho3d_kwargs(root))
    s = ds[0]
    return (s["hands"][0]["verts3d"], s["objects"][0]["verts3d"],
            ds.mano.faces("right").numpy(), s["objects"][0]["faces"][0],
            s["camera"]["K"])


def box_sdf(grid, half=(0.5, 0.5, 0.5), shift=(0.0, 0.0, 0.0)):
    """A box's interior distance min_i(h_i - |x_i - c_i|) at the voxelizer's
    cell centres, 0 outside, as (1, G, G, G) float64."""
    axis = -1.0 + (2.0 * np.arange(grid) + 1.0) / grid
    d = [np.asarray(h) - np.abs(axis - c) for h, c in zip(half, shift)]
    phi = np.minimum(np.minimum(d[0][:, None, None], d[1][None, :, None]),
                     d[2][None, None, :])
    return np.maximum(phi, 0.0)[None]


# The box's top and bottom faces are split along their diagonals; a column
# through a diagonal meets both triangles of each (its edge function is 0
# on the shared edge), four crossings, so reads as outside, in the plain
# version and the JAX kernel alike. Shifting the box by a fraction of a
# cell in y moves every diagonal off the cell centres at G 16-1,024.
BOX_SHIFT = (0.0, 0.37 / 512, 0.0)


def shifted_box():
    """core/meshes.py box_mesh() moved by BOX_SHIFT."""
    from homan_tpu_torch.core.meshes import box_mesh
    v, f = box_mesh()
    return v + np.asarray(BOX_SHIFT, np.float32), f
