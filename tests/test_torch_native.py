"""PyTorch port vs JAX package: the host mesh library (native/), built from
the port's own copy of meshops.cpp with g++.

The JAX package's library is compiled here from its own source into a
temporary folder and loaded through its module (its `_LIB_PATH` patched),
so these tests never write into the JAX package. Bands: the EDT within
1e-3 of scipy's and equal to the JAX library's; decimation and OBJ parsing
equal to the JAX library's outputs; raster_phong against rasterize_hard
(every face binned): silhouettes equal but for pixels whose inside test
rounding decides, depth 1e-5 and colour 1e-4 where both cover.
"""
import os
import subprocess

import numpy as np
import pytest
import torch

import homan_tpu.native as jnative
from homan_tpu.core.meshes import bumpy_potato, save_obj
from homan_tpu_torch import _build, native
from homan_tpu_torch.core import meshes as tmeshes
from homan_tpu_torch.native import build as nbuild
from homan_tpu_torch.render import rasterizer as R

import torch_port_common  # noqa: F401  (thread cap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's meshops.cpp built into a temporary folder."""
    out = str(tmp_path_factory.mktemp("jax_native") / "libmeshops.so")
    src = os.path.join(REPO, "homan_tpu", "native", "meshops.cpp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src,
                    "-o", out], check=True)
    return out


@pytest.fixture
def jax_native(jax_lib, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB_PATH", jax_lib)
    monkeypatch.setattr(jnative, "_LIB", None)
    assert jnative.available()
    return jnative


def test_library_is_the_ports_own_build():
    """g++ builds the port's copy into _build/, keyed by its content; nvcc
    never sees it (it is no kernel source)."""
    path = nbuild.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("meshops-")
    assert nbuild.SOURCE == os.path.join(REPO, "homan_tpu_torch", "native",
                                         "meshops.cpp")
    native.load_library()
    assert os.path.exists(path)
    assert "meshops" not in _build.sources()


def test_failed_build_raises_naming_the_compiler(tmp_path, monkeypatch):
    """No silent fallback: without g++ the build raises."""
    monkeypatch.setattr(nbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        nbuild.build()


@pytest.mark.parametrize("case", ["random", "block", "empty"])
def test_edt_matches_scipy_and_the_jax_library(case, jax_native):
    from scipy.ndimage import distance_transform_edt
    rng = np.random.RandomState(0)
    mask = np.zeros((64, 48), bool)
    if case == "random":
        mask = rng.rand(64, 48) > 0.95
    if case != "empty":
        mask[20:24, 10:14] = True
    ours = native.edt2d_squared(mask)
    np.testing.assert_array_equal(ours, jax_native.edt2d_squared(mask))
    if case == "empty":
        assert (ours > 1e9).all()
    else:
        np.testing.assert_allclose(
            ours, distance_transform_edt(~mask) ** 2, atol=1e-3)


def test_decimate_equals_the_jax_library(jax_native):
    v, f = bumpy_potato(3, 1.0, seed=0)  # 1280 faces
    v2, f2 = native.decimate(v, f, 300)
    jv, jf = jax_native.decimate(v, f, 300)
    np.testing.assert_array_equal(v2, jv)
    np.testing.assert_array_equal(f2, jf)
    assert 150 < f2.shape[0] <= 320
    assert f2.min() >= 0 and f2.max() < v2.shape[0]


def test_obj_parse_equals_the_jax_library_and_python(tmp_path, jax_native):
    v, f = bumpy_potato(2, 0.5, seed=1)
    p = str(tmp_path / "m.obj")
    save_obj(p, v, f)
    v1, f1 = native.load_obj(p)
    jv, jf = jax_native.load_obj(p)
    np.testing.assert_array_equal(v1, jv)
    np.testing.assert_array_equal(f1, jf)
    pv, pf = tmeshes.load_obj(p)
    np.testing.assert_allclose(v1, pv, atol=1e-6)
    np.testing.assert_array_equal(f1, pf)
    with pytest.raises(FileNotFoundError):
        native.load_obj(str(tmp_path / "missing.obj"))


def _edge_rounding_pixels(v, f, K, S):
    """Pixels whose centre lies within rounding of an edge line of a face
    whose box holds it: there the inside test of either renderer may go
    either way."""
    uv = (v @ K.T)
    uv = uv[:, :2] / uv[:, 2:]
    c = (np.arange(S) + 0.5) / S
    px, py = np.meshgrid(c, c)
    near = np.zeros((S, S), bool)
    tri = uv[f]
    for a, b in ((0, 1), (1, 2), (2, 0)):
        pa, pb = tri[:, a], tri[:, b]
        e = ((pb[:, 0] - pa[:, 0])[:, None, None] * (py - pa[:, 1, None, None])
             - (pb[:, 1] - pa[:, 1])[:, None, None]
             * (px - pa[:, 0, None, None]))
        lo, hi = tri.min(1), tri.max(1)
        inbox = ((px >= lo[:, 0, None, None] - 1.0 / S)
                 & (px <= hi[:, 0, None, None] + 1.0 / S)
                 & (py >= lo[:, 1, None, None] - 1.0 / S)
                 & (py <= hi[:, 1, None, None] + 1.0 / S))
        near |= (inbox & (np.abs(e) < 1e-6)).any(0)
    return near


@pytest.mark.parametrize("shading", ["phong", "flat"])
def test_raster_phong_matches_rasterize_hard(shading):
    """The host renderer and the port's rasterize_hard (every face binned)
    draw the same frame; the pixels whose silhouettes differ are counted
    and each lies where rounding decides the inside test."""
    v, f = bumpy_potato(3, 0.08, seed=1)
    v = np.asarray(v, np.float32) + np.array([0.05, -0.02, 0.6], np.float32)
    K = np.array([[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)
    S = 128
    colors = np.tile(np.array([[0.8, 0.6, 0.2]], np.float32),
                     (f.shape[0], 1))
    out_t = R.rasterize_hard(
        torch.from_numpy(v)[None], torch.from_numpy(f.astype(np.int64)),
        torch.from_numpy(K)[None], torch.from_numpy(colors),
        R.RasterSettings(image_size=S, tile_px=32,
                         faces_per_tile=f.shape[0]), shading=shading)
    out_n = native.raster_phong(v, f, K, colors, image_size=S,
                                shading=shading)
    st = out_t["sil"][0].numpy()
    differ = st != out_n["sil"]
    print(f"{shading}: {int(differ.sum())} of {S * S} silhouette pixels "
          "differ")
    assert not (differ & ~_edge_rounding_pixels(v, f, K, S)).any()
    assert differ.sum() <= 4
    assert st.mean() > 0.02  # the scene is visible
    both = st & out_n["sil"]
    np.testing.assert_allclose(out_t["depth"][0].numpy()[both],
                               out_n["depth"][both], atol=1e-5)
    np.testing.assert_allclose(out_t["rgb"][0].numpy()[both],
                               out_n["rgb"][both], atol=1e-4)


def test_raster_phong_validates_its_inputs():
    v = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="face indices"):
        native.raster_phong(v, np.array([[0, 1, 3]]), np.eye(3))
    with pytest.raises(ValueError, match="shading"):
        native.raster_phong(v, np.array([[0, 1, 2]]), np.eye(3),
                            shading="gouraud")


def test_process_meshes_cli_matches_the_jax_driver(tmp_path, jax_native):
    """The batch preprocessing driver on both packages: mesh list in, the
    same decimated OBJ out."""
    from homan_tpu.cli import process_meshes as jpm
    from homan_tpu_torch.cli import process_meshes as tpm

    v, f = bumpy_potato(3, 1.0, seed=0)  # 1280 faces
    src = tmp_path / "potato.obj"
    save_obj(str(src), v, f)
    mesh_list = tmp_path / "meshes.txt"
    mesh_list.write_text(f"{src}\n")
    for pkg, out_root in ((tpm, "port"), (jpm, "jax")):
        pkg.main(["--mesh_list", str(mesh_list), "--out_root",
                  str(tmp_path / out_root), "--target_faces", "300"])
    port = (tmp_path / "port" / "potato_300.obj").read_text()
    assert port == (tmp_path / "jax" / "potato_300.obj").read_text()
    v2, f2 = tmeshes.load_obj(str(tmp_path / "port" / "potato_300.obj"))
    assert 150 < f2.shape[0] <= 320
    assert f2.min() >= 0 and f2.max() < v2.shape[0]
