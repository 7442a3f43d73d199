"""Mesh -> interior-SDF voxelization on the card: CUDA kernel wrapper.

Replaces the TPU kernel `_voxelize_kernel` (homan_tpu/interactions/
pallas_sdf.py:35, called through `voxelize_interior_sdf_pallas` :186). The
kernel lives in csrc/voxelize.cu and is built by homan_tpu_torch/_build.py;
its plain PyTorch version is interactions/sdf.py `voxelize_interior_sdf`.

Layout (as the TPU kernel's):
  tri_pack (B, 16, Fpad): rows 0-8 = [ax ay az bx by bz cx cy cz] of each
    normalized-space triangle, row 9 = validity, rows 10-15 zero; Fpad a
    multiple of 128 (the kernel's staging tile).
  phi (B, G, G, G): the interior distance at each cell centre, 0 outside.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel (or raises). Both refuse a grid size outside `GRIDS`
with ValueError, as the JAX launcher asserts. `voxelize_launches` counts
kernel launches only. Forward only: the grids carry no gradient.

Memory: phi holds 4 G^3 bytes a mesh, 4 GiB at G 1,024, so an 80 GB card
takes B 1-4 there with room for the rest of a step.
"""
from __future__ import annotations

import ctypes

import torch

from homan_tpu_torch.interactions import sdf as sdf_lib
from homan_tpu_torch.render.shade import (_require_cuda, fold_batched,
                                          unfold_batched)

# Launch count of the CUDA kernel (the plain version does not count).
voxelize_launches = 0

TF = 128  # triangles per staging tile; Fpad is a multiple of it
BIG = 1e9  # distance^2 of an invalid (padding) slot
# The grid sizes the kernel takes: those the JAX launcher takes (G^3 a
# multiple of its 1,024-point block, 1,024 a multiple of G), the powers of
# two from 16 to 1,024 (homan_tpu/interactions/pallas_sdf.py:190-191).
GRIDS = (16, 32, 64, 128, 256, 512, 1024)
# The kernel's fp32 arithmetic, compare and select operations
# (csrc/voxelize.cu), an FMA counted as two:
# per (xy column, valid triangle), the crossing test: validity 1, three
# edge functions 21, inside_xy 6, area2 and its test 4. The rare hit path
# (three divides, z_tri and one compare per z cell) is left out.
CROSS_OPS_PER_COLUMN_FACE = 32
# per (inside grid point, valid triangle), the distance: ap 3, d1/d2 10,
# d3-d6 4, va/vb/vc 9, the clamped edge distances |ap - t e|^2 46 (ab and
# ac 14 each, bc 18 with bp), their min 2, inside_face 4, the plane
# distance 7, the select and the running min 2.
DIST_OPS_PER_POINT_FACE = 87
# The dense sweep's count per (grid point, triangle) (the crossing test and
# the distance at every point, as the TPU kernel and the first CUDA
# kernel evaluate them): the yardstick `dense_bound_ms` is reckoned from.
DENSE_OPS_PER_POINT_FACE = 104


def work_ops(n_faces: int, n_inside: int, grid_size: int, batch: int):
    """The operations the kernel needs on these inputs: the crossing test
    for every (column, face) of every frame and the distance for every
    (inside point, face); `n_faces` valid triangles per frame, `n_inside`
    inside points over all frames."""
    return (CROSS_OPS_PER_COLUMN_FACE * batch * grid_size ** 2 * n_faces
            + DIST_OPS_PER_POINT_FACE * n_inside * n_faces)


def check_grid(grid_size: int) -> int:
    """`grid_size`, or ValueError where it is not one of GRIDS."""
    if grid_size not in GRIDS:
        raise ValueError(f"the voxelizer takes grid sizes {GRIDS}, "
                         f"got {grid_size}")
    return grid_size


def pack_triangles(verts, faces):
    """(B, V, 3) + (F, 3) -> (B, 16, Fpad) packed rows (see module doc)."""
    faces = torch.as_tensor(faces, device=verts.device).long()
    B = verts.shape[0]
    F = faces.shape[0]
    fpad = -(-F // TF) * TF
    tri = verts[:, faces]  # (B, F, 3, 3)
    rows = tri.reshape(B, F, 9).transpose(1, 2)  # (B, 9, F)
    pack = torch.cat([rows, torch.ones((B, 1, F), dtype=rows.dtype,
                                       device=verts.device),
                      torch.zeros((B, 6, F), dtype=rows.dtype,
                                  device=verts.device)], dim=1)
    return torch.nn.functional.pad(pack, (0, fpad - F)).contiguous()


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def _lib():
    from homan_tpu_torch import _build
    lib = _build.load("voxelize")
    if lib.voxelize.argtypes is None:
        lib.voxelize.argtypes = [_PTR] * 2 + [_INT] * 3 + [_FLT, _PTR]
        lib.voxelize.restype = ctypes.c_int
    return lib


def voxelize_pack(tri_pack, grid_size: int = 32):
    """Launch the voxelizer kernel on a CUDA tri_pack; phi (B, G, G, G)."""
    _require_cuda(tri_pack)
    global voxelize_launches
    B, rows, fpad = tri_pack.shape
    if rows != 16 or fpad % TF:
        raise ValueError(f"tri_pack must be (B, 16, Fpad) with Fpad a "
                         f"multiple of {TF}, got {tuple(tri_pack.shape)}")
    if tri_pack.dtype != torch.float32 or not tri_pack.is_contiguous():
        raise ValueError("tri_pack must be contiguous float32")
    g = check_grid(grid_size)
    phi = torch.empty((B, g, g, g), dtype=torch.float32,
                      device=tri_pack.device)
    if B == 0:
        return phi
    lib = _lib()
    with torch.cuda.device(tri_pack.device):
        stream = torch.cuda.current_stream(tri_pack.device).cuda_stream
        rc = lib.voxelize(tri_pack.data_ptr(), phi.data_ptr(), B, g, fpad,
                          BIG, stream)
    if rc != 0:
        raise RuntimeError(f"voxelize kernel launch failed: CUDA error {rc}")
    voxelize_launches += 1
    return phi


class _VoxelizePack(torch.autograd.Function):
    """voxelize_pack as an op torch.func.vmap can batch: the vmapped clip
    dim folds into the frame dim, one launch for every clip. No gradient."""

    @staticmethod
    def forward(tri_pack, grid_size):
        return voxelize_pack(tri_pack, grid_size)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, tri_pack, grid_size):
        n, (tri_pack,) = fold_batched(in_dims[:1], tri_pack)
        (phi,), dims = unfold_batched(n, (_VoxelizePack.apply(
            tri_pack.contiguous(), grid_size),))
        return phi, dims[0]


def voxelize(verts, faces, grid_size: int = 32):
    """Interior-clamped SDF (B, G, G, G) of normalized verts (B, V, 3);
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    check_grid(grid_size)
    if verts.device.type == "cpu":
        return sdf_lib.voxelize_interior_sdf(verts, faces, grid_size)
    with torch.no_grad():
        tri_pack = pack_triangles(verts.detach().to(torch.float32), faces)
        return _VoxelizePack.apply(tri_pack, grid_size)
