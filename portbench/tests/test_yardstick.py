"""The frozen yardstick: its kernel work formulas and pack layout equal
the port's today, the trace arithmetic, and the per-layer readers."""
import types

import pytest
import torch

from portbench.reference import meshes
from portbench.yardstick import peaks, trace, work


def _posed(n_frames, seed):
    g = torch.Generator().manual_seed(seed)
    v, f = meshes.bumpy_potato(2, 0.08, seed)
    v = torch.as_tensor(v)
    rot = torch.linalg.qr(torch.randn(n_frames, 3, 3, generator=g))[0]
    t = torch.tensor([0.0, 0.0, 0.5]) + 0.01 * torch.randn(
        n_frames, 1, 3, generator=g)
    verts = v[None] @ rot + t
    K = torch.tensor([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]])
    return verts, f, K.expand(n_frames, 3, 3).contiguous()


@pytest.mark.parametrize("S,tp,ke,seed", [(64, 32, 48, 0), (64, 16, 64, 1),
                                          (128, 64, 96, 2)])
def test_packs_and_forward_work_equal_the_ports(S, tp, ke, seed):
    from homan_tpu_torch.render import rasterizer as R
    from homan_tpu_torch.render import shade
    verts, f, K = _posed(3, seed)
    topo = R.MeshTopology.from_faces(f)
    s = R.RasterSettings(S, tile_px=tp, edges_per_tile=ke)
    seg, anchors, _, static = R.shade_prep(verts, topo, K, s)
    mine = meshes.edge_topology(f)
    frame = {"faces": torch.as_tensor(f).long()}
    frame.update({k: torch.as_tensor(v) for k, v in mine.items()})
    frame = {k: v[None].expand((3,) + tuple(v.shape)) for k, v in
             frame.items()}
    seg2, anchors2 = work.shade_packs(verts, K, frame, S, tp, static.ke,
                                      s.bin_margin_px)
    assert torch.equal(seg, seg2)
    assert torch.equal(anchors, anchors2)
    ref = shade.fwd_work(seg, anchors, static)
    got = work.fwd_work(seg, anchors, tp, S, S // tp, static.cap2,
                        static.ke)
    assert {k: got[k] for k in ref} == ref
    assert work.fwd_work_ops(got) == shade.fwd_work_ops(ref)
    picked = int((shade.shade_fwd_plain(seg, anchors, static)[1]
                  >= 0).sum())
    assert got["picked"] == picked


def test_constants_equal_the_ports():
    from homan_tpu_torch.interactions import voxelize
    from homan_tpu_torch.render import shade
    for name in ("FWD_PIXELS_PER_THREAD", "FWD_ROW_OPS_PER_ROW_SLOT",
                 "FWD_WINDING_OPS_PER_PIXEL_SLOT",
                 "FWD_TEST_OPS_PER_GROUP_SLOT", "FWD_DIST_OPS_PER_PIXEL_SLOT",
                 "FWD_DMAX_OPS_PER_GROUP_SLOT", "BWD_OPS_PER_PIXEL"):
        assert getattr(work, name) == getattr(shade, name), name
    assert work.VOX_TF == voxelize.TF
    assert work.CROSS_OPS_PER_COLUMN_FACE == voxelize.CROSS_OPS_PER_COLUMN_FACE
    assert work.DIST_OPS_PER_POINT_FACE == voxelize.DIST_OPS_PER_POINT_FACE
    for args in ((1280, 5000, 32, 10), (1552, 0, 16, 1), (80, 123456, 64, 7)):
        assert work.vox_work_ops(*args) == voxelize.work_ops(*args)


def test_inside_cells_equal_the_ports_plain_voxelizer():
    from homan_tpu_torch.interactions import sdf
    from portbench.reference import voxel
    v, f = meshes.bumpy_potato(2, 0.9, 4)
    v = torch.as_tensor(v)[None]
    f = torch.as_tensor(f).long()
    phi, inside = voxel.voxelize(v, f, 16)
    port = sdf.voxelize_interior_sdf(v, f, 16)
    assert torch.equal(inside, port > 0)
    assert float((phi - port).abs().max()) <= 1e-6


def test_trace_arithmetic():
    ops = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("c", 45, 46)]
    assert trace.busy_s(ops) == 31e-9
    gaps = trace.idle_gaps(ops)
    assert gaps[0] == ["before_a", 10e-9] and gaps[1] == ["before_c", 5e-9]
    assert trace.kernel_s(ops, "a") == 20e-9
    assert trace.top_ops(ops)[0] == ["a", 20e-9]
    calls = ["cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
             "cudaLaunchKernelExC"]
    assert trace.count_launches(calls) == 3


def test_readers():
    from portbench import harness
    ops = [("void shade_fwd_kernel<8>(...)", 0, 1000),
           ("void shade_bwd_strip_kernel(...)", 1000, 1500),
           ("void shade_bwd_finalize_kernel(...)", 1500, 1600),
           ("elementwise", 2000, 4000)]
    ctx = types.SimpleNamespace(
        ops=ops, launches=40, window_s=5e-6, steps=1,
        busy_s=trace.busy_s(ops),
        work={"shade_fwd": {"bytes": 335.0, "ops": 0},
              "shade_bwd": {"bytes": 0, "ops": 67.0 * 300},
              "dense_ops": 0})
    read = {n: harness.load_reader(n) for n in (
        "idle_share", "launch_calls_per_step", "shade_fwd_roofline",
        "shade_bwd_roofline", "voxelize_roofline", "voxelize_share",
        "step_mfu")}
    assert read["idle_share"](ctx) == pytest.approx(100 * (1 - 3.6 / 5))
    assert read["launch_calls_per_step"](ctx) == 40
    # 335 bytes at 3.35 TB/s is 1e-10 s against 1e-6 s of kernel time.
    assert read["shade_fwd_roofline"](ctx) == pytest.approx(1e-2)
    assert read["shade_bwd_roofline"](ctx) == pytest.approx(
        100 * 300e-12 / 600e-9)
    assert read["voxelize_roofline"](ctx) is None
    assert read["voxelize_share"](ctx) is None
    assert read["step_mfu"](ctx) == pytest.approx(
        100 * 20100 / (5e-6 * peaks.FP32_OPS_PER_S))


def test_readers_without_a_workloads_list_read_nothing_from_nothing():
    """A recipe whose work and trace hold nothing for a reader: every
    per-layer reader that any cell runs returns None and does not raise.
    Where the trace holds the shade kernels but the recipe counted no work
    for them, their rooflines raise, and the other readers return None."""
    from portbench import harness
    from portbench.tests import tiny
    bench = harness.load_benchmark(tiny.ROOT)
    names = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    assert "step_mfu" in names and "shade_fwd_roofline" in names
    empty = types.SimpleNamespace(ops=[], launches=0, window_s=1.0, steps=10,
                                  busy_s=0.0, work={}, spans=None)
    ops = [("void shade_fwd_kernel<8>(...)", 0, 1000),
           ("void shade_bwd_strip_kernel(...)", 1000, 1500)]
    uncounted = types.SimpleNamespace(
        ops=ops, launches=40, window_s=5e-6, steps=1,
        busy_s=trace.busy_s(ops), work={}, spans={
            "under": {}, "idle_under": {}, "counters": {},
            "busy_s": 1.0, "wall_s": 1.0})
    for name in names:
        read = harness.load_reader(name)
        assert read(empty) is None, name
        if name in ("shade_fwd_roofline", "shade_bwd_roofline"):
            with pytest.raises(KeyError, match="counts no"):
                read(uncounted)
        elif name not in ("idle_share", "launch_calls_per_step"):
            assert read(uncounted) is None, name
