"""PyTorch port vs JAX package: mesh files and topology helpers, the MANO
pickle loader, clip chunking and collation, and the HO-3D dataset on a
synthetic tree (CPU, same inputs).

Bands: exact, except the GT hand's vertices and 2D projections and the
hand box, which run MANO in each framework (atol 1e-5; pixels 1e-3).
"""
import os

import numpy as np
import pytest
import torch

from homan_tpu.core import mano as jmano
from homan_tpu.core import meshes as jm
from homan_tpu.data import chunking as jchunk
from homan_tpu.data.ho3d import HO3D as JHO3D
from homan_tpu_torch.core import mano as tmano
from homan_tpu_torch.core import meshes as tm
from homan_tpu_torch.data import chunking as tchunk
from homan_tpu_torch.data import factory
from homan_tpu_torch.data.ho3d import HO3D as THO3D

from torch_port_common import ho3d_kwargs, ho3d_tree, t2n


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return ho3d_tree(tmp_path_factory.mktemp("ho3d_data"), frames=6)


def test_obj_files_round_trip_as_in_jax(tmp_path):
    v, f = tm.bumpy_potato(2, 0.08, seed=1)
    tm.save_obj(str(tmp_path / "port.obj"), v, f)
    jm.save_obj(str(tmp_path / "jax.obj"), v, f)
    assert (tmp_path / "port.obj").read_text() == (
        tmp_path / "jax.obj").read_text()
    # Quads and v/vt/vn face records, fan-triangulated.
    with open(tmp_path / "quad.obj", "w") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\n"
                 "f 1/1/1 2/1/1 3/1/1 4/1/1\n")
    for name in ("port.obj", "quad.obj"):
        tv, tf = tm.load_obj(str(tmp_path / name))
        jv, jf = jm.load_obj(str(tmp_path / name))
        assert tv.dtype == np.float32 and tf.dtype == np.int32
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def test_merge_and_close_meshes_match_jax(tmp_path):
    pm = tmano._synthetic_arrays(0)
    open_faces = np.asarray(pm["faces"])[8:]  # a cap removed: one hole
    v, f = tm.bumpy_potato(1, 0.1)
    parts = [(v, f), (np.asarray(pm["v_template"]), open_faces)]
    for a, b in zip(tm.merge_meshes(parts), jm.merge_meshes(parts)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    closed = tm.close_boundary_fan(open_faces)
    np.testing.assert_array_equal(closed, jm.close_boundary_fan(open_faces))
    assert len(closed) > len(open_faces)
    np.testing.assert_array_equal(tm.close_boundary_fan(f), f)
    np.testing.assert_array_equal(
        tm.load_closed_hand_faces(None, open_faces),
        jm.load_closed_hand_faces(None, open_faces))
    np.save(tmp_path / "closed.npy", closed)
    np.testing.assert_array_equal(
        tm.load_closed_hand_faces(str(tmp_path / "closed.npy"), open_faces),
        closed)


def test_mano_pickle_loads_as_in_jax(tree):
    path = os.path.join(tree, "extra_data", "mano", "MANO_RIGHT.pkl")
    ours = tmano.load_mano_params(path, device="cpu")
    theirs = jmano.load_mano_params(path)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(t2n(ours[k]), np.asarray(theirs[k]),
                                      err_msg=k)
    synth = tmano.synthetic_mano_params(0, device="cpu")
    for k in ours:
        np.testing.assert_array_equal(t2n(ours[k]), t2n(synth[k]),
                                      err_msg=k)
    tl = tmano.ManoLayer.from_folder(os.path.dirname(path), device="cpu")
    jl = jmano.ManoLayer.from_folder(os.path.dirname(path))
    for side in ("right", "left"):
        for k in tl.params[side]:
            np.testing.assert_array_equal(t2n(tl.params[side][k]),
                                          np.asarray(jl.params[side][k]),
                                          err_msg=f"{side} {k}")


CHUNK_ROWS = [
    [{"seq_idx": "A", "frame_nb": 40}],
    [{"seq_idx": "A", "frame_nb": 450}, {"seq_idx": "B", "frame_nb": 7}],
    [{"seq_idx": "A", "frame_nb": 25}],   # shorter than the chunk span
]


@pytest.mark.parametrize("rows", CHUNK_ROWS, ids=["one", "two", "short"])
@pytest.mark.parametrize("size,step,spacing", [(10, 4, 200), (10, 1, 200),
                                               (3, 2, 5)])
def test_chunk_vid_index_matches_jax(rows, size, step, spacing):
    ours = tchunk.chunk_vid_index(rows, size, step, spacing)
    assert ours == jchunk.chunk_vid_index(rows, size, step, spacing)


def test_collate_matches_jax():
    samples = [{"a": np.full((2, 3), i, np.float32), "b": float(i),
                "c": {"d": np.arange(3) + i, "e": "x"}, "f": [i]}
               for i in range(4)]
    ours, theirs = tchunk.collate(samples), jchunk.collate(samples)
    np.testing.assert_array_equal(ours["a"], theirs["a"])
    np.testing.assert_array_equal(ours["b"], theirs["b"])
    np.testing.assert_array_equal(ours["c"]["d"], theirs["c"]["d"])
    assert ours["c"]["e"] == theirs["c"]["e"] and ours["f"] == theirs["f"]


@pytest.mark.parametrize("chunk_step", [1, 2])
def test_ho3d_matches_jax_field_by_field(tree, chunk_step):
    kw = ho3d_kwargs(tree)
    ours = THO3D(frame_nb=3, chunk_step=chunk_step, device="cpu", **kw)
    theirs = JHO3D(frame_nb=3, chunk_step=chunk_step,
                   **dict(kw, cache_folder=kw["cache_folder"] + "_jax"))
    assert len(ours) == len(theirs) >= 1
    for i in range(len(ours)):
        o, t = ours[i], theirs[i]
        assert o["frame_idxs"] == t["frame_idxs"] and o["seq_idx"] == "ABF11"
        np.testing.assert_array_equal(o["camera"]["K"], t["camera"]["K"])
        oh, th = o["hands"][0], t["hands"][0]
        assert oh["label"] == th["label"] == "right_hand"
        np.testing.assert_allclose(oh["verts3d"], th["verts3d"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(oh["verts2d"], th["verts2d"], atol=1e-3,
                                   rtol=0)
        np.testing.assert_allclose(oh["bbox"], th["bbox"], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(oh["joints3d"], th["joints3d"])
        oo, to = o["objects"][0], t["objects"][0]
        for k in ("canverts3d", "faces", "verts3d", "bbox"):
            np.testing.assert_array_equal(oo[k], to[k], err_msg=k)
        assert oo["name"] == to["name"]
    frame = THO3D(mode="frame", device="cpu", **kw)[1]
    assert frame["img"] is None and frame["hands"][0]["verts3d"].shape == (
        778, 3)


def test_factory_reads_ho3d_and_refuses_the_unported(tree):
    ds, size = factory.get_dataset("ho3d", frame_nb=3, chunk_step=1,
                                   device="cpu", **ho3d_kwargs(tree))
    assert size == 640 and len(ds) >= 1
    # CORe50 and EPIC are ported: the driver's HO-3D arguments (mano_root,
    # device) go to HO-3D alone, so both start (empty, with no data here).
    for name, want in (("core50", 350), ("epic", 640)):
        ds, size = factory.get_dataset(
            name, mano_root=ho3d_kwargs(tree)["mano_root"], device="cpu",
            cache_folder=os.path.join(tree, "cache_" + name))
        assert (size, len(ds)) == (want, 0)
    with pytest.raises(ValueError):
        factory.get_dataset("coco")


def test_ho3d_mano_runs_on_the_device_it_is_given(tree):
    ds = THO3D(frame_nb=3, chunk_step=1, device="cpu", **ho3d_kwargs(tree))
    assert ds.mano.params["right"]["v_template"].device == torch.device(
        "cpu")
