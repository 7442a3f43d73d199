"""PyTorch port vs JAX package: the stage-B evidence (CPU, same inputs).

Bands: `crop_and_resize` bit-equal (the numpy parity surface);
`crop_and_resize_dev` within 1e-6 of it (the JAX package's jitted twin
within 1e-5, see the test); `build_object_mask_info` equal, with and
without occluders; boxes and intrinsics equal; `render_full_mask` equal
except on pixels whose silhouette lies within 1e-4 of the 0.5 threshold.
"""
import numpy as np
import pytest
import torch

from homan_tpu.core import bbox as jbbox
from homan_tpu.core import camera as jcam
from homan_tpu.frontend import evidence as jev
from homan_tpu.frontend import gtevidence as jgt
from homan_tpu.frontend import masks as jmasks
from homan_tpu.render import rasterizer as jr
from homan_tpu_torch.core import bbox as tbbox
from homan_tpu_torch.core import camera as tcam
from homan_tpu_torch.core.meshes import bumpy_potato
from homan_tpu_torch.frontend import evidence as tev
from homan_tpu_torch.frontend import gtevidence as tgt
from homan_tpu_torch.frontend import masks as tmasks
from homan_tpu_torch.render import rasterizer as tr

from torch_port_common import t2n


def _masks_and_boxes(seed, n=5, h=48, w=40):
    """Soft and binary masks and boxes, some reaching past the image."""
    rng = np.random.RandomState(seed)
    masks = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
    masks[::2] = masks[::2] > 0.6
    lo = rng.uniform(-12, 30, (n, 2))
    side = rng.uniform(4, 40, (n, 2))
    boxes = np.concatenate([lo, lo + side], axis=1).astype(np.float32)
    return masks, boxes


@pytest.mark.parametrize("seed,size", [(0, 16), (1, 33), (2, 64)])
def test_crop_and_resize_bit_equal(seed, size):
    masks, boxes = _masks_and_boxes(seed)
    ours = tmasks.crop_and_resize(masks, boxes, size)
    theirs = jmasks.crop_and_resize(masks, boxes, size)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed,size", [(0, 16), (3, 96)])
def test_crop_and_resize_dev_matches_jax(seed, size):
    """The torch crop holds the numpy parity surface within 1e-6. The JAX
    package's jitted twin is 5.4e-6 from that surface itself on these boxes
    (XLA fuses the sample coordinate `x1 + step (x2 - x1)` into an FMA), so
    the twin is held at 1e-5, and exactly on a full-frame 2x upsample of a
    power-of-two frame, as render_full_mask runs (its coordinates are exact
    in float32)."""
    masks, boxes = _masks_and_boxes(seed)
    ours = t2n(tmasks.crop_and_resize_dev(torch.from_numpy(masks),
                                          torch.from_numpy(boxes), size))
    np.testing.assert_allclose(ours, jmasks.crop_and_resize(masks, boxes,
                                                            size),
                               atol=1e-6, rtol=0)
    theirs = np.asarray(jmasks._crop_and_resize_jax(masks, boxes, size))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    binary = (masks > 0.5).astype(np.float32)
    full = np.tile(np.array([[0, 0, 32, 32]], np.float32), (len(masks), 1))
    np.testing.assert_array_equal(
        t2n(tmasks.crop_and_resize_dev(torch.from_numpy(binary),
                                       torch.from_numpy(full), 64)),
        np.asarray(jmasks._crop_and_resize_jax(binary, full, 64)))


def test_bbox_and_crop_intrinsics_equal():
    rng = np.random.RandomState(0)
    xyxy = np.sort(rng.uniform(0, 200, (6, 2, 2)), axis=1).reshape(6, 4)
    xyxy = xyxy[:, [0, 2, 1, 3]]
    wh = jbbox.bbox_xy_to_wh(xyxy)
    np.testing.assert_array_equal(tbbox.bbox_xy_to_wh(xyxy), wh)
    np.testing.assert_array_equal(tbbox.bbox_wh_to_xy(wh),
                                  jbbox.bbox_wh_to_xy(wh))
    for e in (0.0, 0.3):
        np.testing.assert_array_equal(tbbox.make_bbox_square(wh, e),
                                      jbbox.make_bbox_square(wh, e))
        np.testing.assert_array_equal(
            tev.square_bbox_with_expansion(xyxy[0], e),
            jev.square_bbox_with_expansion(xyxy[0], e))
    K = np.tile(np.array([[[300.0, 0.5, 128], [0, 280.0, 120], [0, 0, 1]]],
                         np.float32), (6, 1, 1))
    np.testing.assert_array_equal(
        tcam.get_K_crop_resize_np(K, xyxy, 64),
        jcam.get_K_crop_resize_np(K, xyxy, 64))


@pytest.mark.parametrize("occluded", [False, True])
def test_build_object_mask_info_equal(occluded):
    full = np.zeros((128, 128), np.float32)
    full[40:80, 50:90] = 1.0
    full[60:66, 30:52] = 1.0
    occ = None
    if occluded:
        occ = np.zeros((2, 128, 128), np.float32)
        occ[0, 40:60, 50:70] = 1.0  # over part of the object
        occ[0, 0:20, 0:20] = 1.0    # outside its crop
        occ[1, 70:100, 80:110] = 1.0
    box = np.array([30, 40, 90, 80])
    ours = tev.build_object_mask_info(full, box, occ, rend_size=64)
    theirs = jev.build_object_mask_info(full, box, occ, rend_size=64)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    tm = ours["target_crop_mask"]
    assert (tm == 1).any() and ((tm == -1).any() == occluded)
    np.testing.assert_array_equal(
        tmasks.add_occlusions([ours["crop_mask"]], np.ones((1, 8, 8)),
                              [np.array([0.0, 0, 8, 8])])[0],
        jmasks.add_occlusions([theirs["crop_mask"]], np.ones((1, 8, 8)),
                              [np.array([0.0, 0, 8, 8])])[0])


def _clip(frames, image_size):
    """The bench's stage-B clip at test size: the bumpy potato turning about
    z, translated as bench.py:_synthetic_clip_annots does."""
    v, f = bumpy_potato(1, 0.08, seed=0)
    K = np.array([[image_size * 0.9, 0, image_size / 2],
                  [0, image_size * 0.9, image_size / 2], [0, 0, 1.0]],
                 np.float32)
    verts = []
    for t in range(frames):
        a = 0.04 * t
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]], np.float32)
        verts.append(v @ Rz.T + np.array([0.02 + 0.002 * t, -0.01, 0.55],
                                         np.float32))
    return np.stack(verts), f, np.tile(K[None], (frames, 1, 1))


@pytest.mark.parametrize("image_size", [128, 512])
def test_render_full_mask_matches_jax(image_size):
    verts, faces, K = _clip(2, image_size)
    ours = tgt.render_full_mask(verts, faces, K, image_size, device="cpu")
    theirs = jgt.render_full_mask(verts, jr.MeshTopology.from_faces(faces),
                                  K, image_size)
    assert ours.shape == theirs.shape == (2, image_size, image_size)
    assert ours.dtype == bool and ours.any()
    # The pixels a threshold could flip: the port's silhouette within 1e-4
    # of 0.5 at the render's resolution, and, above 256, every full-image
    # pixel whose bilinear sample reads one of them.
    S0 = min(image_size, 256)
    Kn = K.astype(np.float64).copy()
    Kn[:, :2] /= image_size
    with torch.no_grad():
        sil = tr.rasterize_soft(
            torch.from_numpy(verts), tr.MeshTopology.from_faces(faces),
            torch.as_tensor(Kn, dtype=torch.float32),
            tr.RasterSettings(S0, edges_per_tile=128))["sil"]
    near = t2n((sil - 0.5).abs() <= 1e-4)
    if S0 != image_size:
        r = image_size // S0
        near = np.pad(near, ((0, 0), (1, 1), (1, 1)))
        near = np.max([near[:, i:i + S0, j:j + S0]
                       for i in range(3) for j in range(3)], axis=0)
        near = near.repeat(r, axis=1).repeat(r, axis=2)
    assert not (ours != theirs)[~near].any()
    assert (ours != theirs).sum() <= near.sum()


def test_mask_to_bbox_equal():
    m = np.zeros((20, 30), bool)
    m[3:9, 4:17] = True
    np.testing.assert_array_equal(tgt.mask_to_bbox(m), jgt.mask_to_bbox(m))
    np.testing.assert_array_equal(tgt.mask_to_bbox(np.zeros((4, 4))),
                                  jgt.mask_to_bbox(np.zeros((4, 4))))
