"""The port's tracing switch (homan_tpu_torch/utils_profiling.py): program
spans and counters, off by default, recorded inside `tracing()` only, in
the single and the batched fit; and a fit's results, bit-equal with
tracing on and off (CPU, the port alone)."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from homan_tpu_torch import utils_profiling as up
from homan_tpu_torch.fit import joint as TJ
from homan_tpu_torch.fit import model as M
from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
from homan_tpu_torch.parallel import clips as par
from homan_tpu_torch.render import rasterizer as R

import torch_port_common  # noqa: F401  (caps torch's threads)

SPANS = ("fit.step", "fit.forward", "fit.backward", "fit.adam",
         "raster.prep", "interactions")
# Step 2's terms, with the interaction terms' direct SDF (no voxelizer).
LW = {"lw_collision": 1e-3, "lw_contact": 1.0}


@pytest.fixture(scope="module")
def scenes():
    return [make_synthetic_scene(np.eye(3, dtype=np.float32), seed=s,
                                 frame_nb=2, image_size=64, rend_size=32,
                                 obj_subdiv=1, device="cpu")
            for s in range(3)]


def _fit(kind, scenes, steps, lw=LW):
    s = scenes[0]
    if kind == "single":
        final, hist = TJ.optimize_hand_object(
            s.init_state, s.consts, s.cfg, loss_weights=lw,
            num_iterations=steps, roi_settings=s.roi_settings,
            closed_hand_faces=s.closed_hand_faces, device="cpu")
    else:
        final, hist = par.fit_clips_batched(
            par.stack_clips([x.init_state for x in scenes]),
            par.stack_clips([x.consts for x in scenes]), s.cfg,
            loss_weights=lw, num_iterations=steps,
            roi_settings=s.roi_settings,
            closed_hand_faces=s.closed_hand_faces, device="cpu")
    return final, hist


def _spans(prof):
    """[(name, start, end)] of the program's spans in a profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name() in SPANS]


def _inside(spans, outer):
    return [n for n, a, b in spans if outer[1] <= a and b <= outer[2]
            and (n, a, b) != outer]


def test_off_by_default(scenes):
    up.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit("single", scenes, 1)
    assert _spans(prof) == []
    assert up.counters() == {}
    up.count("raster.contour_edges", torch.ones(4, dtype=torch.bool))
    assert up.counters() == {}
    assert up.span("fit.step") is up.span("fit.adam")


@pytest.mark.parametrize("kind", ["single", "batched"])
def test_fit_spans(scenes, kind):
    with up.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fit(kind, scenes, 2)
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "fit.step"]
    assert len(steps) == 2
    for step in steps:
        inner = _inside(spans, step)
        assert {n: inner.count(n) for n in set(inner)} == {
            "fit.forward": 1, "fit.backward": 1, "fit.adam": 1,
            "raster.prep": 1, "interactions": 2}
        forward = next(s for s in spans if s[0] == "fit.forward"
                       and step[1] <= s[1] <= step[2])
        assert sorted(_inside(spans, forward)) == [
            "interactions", "interactions", "raster.prep"]
    # Without the interaction terms there is no interactions span.
    with up.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fit(kind, scenes, 1, lw={})
    assert "interactions" not in [n for n, _, _ in _spans(prof)]


def _contours(scene):
    """(contour edges, edges) of the initial object renders, computed
    directly."""
    verts, _ = M.get_verts_object(scene.init_state, scene.consts)
    topo = scene.consts.faces_object
    uv, z = R.project_ndc(verts, scene.consts.camintr_rois_object)
    mask = R._contour_data(uv, z, topo, scene.roi_settings)[3]
    return int(torch.count_nonzero(mask)), mask.numel()


@pytest.mark.parametrize("kind", ["single", "batched"])
def test_contour_counter_of_a_fit(scenes, kind):
    with up.tracing():
        _fit(kind, scenes, 1)
        got = up.counters()
    fitted = scenes[:1] if kind == "single" else scenes
    want = np.sum([_contours(s) for s in fitted], axis=0)
    assert got == {"raster.contour_edges": tuple(int(x) for x in want)}
    assert 0 < want[0] < want[1]


def test_contour_counter_under_vmap(scenes):
    """Under torch.func.vmap the counter counts every vmapped entry."""
    s = scenes[0]
    verts = torch.stack([M.get_verts_object(x.init_state, x.consts)[0]
                         for x in scenes])
    topo = s.consts.faces_object
    K = s.consts.camintr_rois_object
    with up.tracing():
        torch.func.vmap(
            lambda v: R.shade_prep(v, topo, K, s.roi_settings)[0])(verts)
        batched = up.counters()
        for v in verts:
            R.shade_prep(v, topo, K, s.roi_settings)
        one_by_one = up.counters()
    assert batched == one_by_one
    assert batched["raster.contour_edges"][1] == verts.shape[0] * \
        verts.shape[1] * topo.edges.shape[0]


@pytest.mark.parametrize("kind", ["single", "batched"])
def test_tracing_changes_no_result(scenes, kind):
    final0, hist0 = _fit(kind, scenes, 2)
    with up.tracing():
        with profile(activities=[ProfilerActivity.CPU]):
            final1, hist1 = _fit(kind, scenes, 2)
    assert set(hist0) == set(hist1)
    for k in hist0:
        assert torch.equal(hist0[k], hist1[k]), k
    for name in M.HomanState.__dataclass_fields__:
        a, b = getattr(final0, name), getattr(final1, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_counters_accumulate_and_reset():
    mask = torch.tensor([True, False, True])
    with up.tracing():
        up.count("x", mask)
        with up.tracing():  # an inner block keeps the outer counts
            up.count("x", mask.reshape(3, 1))
        assert up.counters() == {"x": (4, 6)}
        assert up.counters() == {}
        up.count("x", mask)
    with up.tracing():  # a new outermost block starts with none
        assert up.counters() == {}


def test_tally_takes_a_count_and_a_total():
    """tally, the counter entry a kernel's own per-frame counts feed: off
    while tracing is off, summed with count's entries while on, under vmap
    every vmapped entry."""
    hits = torch.tensor([3, 0, 5], dtype=torch.int32)
    total = torch.tensor([32, 0, 32], dtype=torch.int32)
    up.counters()
    up.tally("x", hits, total)
    assert up.counters() == {}
    with up.tracing():
        up.tally("x", hits, total)
        up.count("x", torch.tensor([True, False]))
        torch.func.vmap(lambda h, t: up.tally("x", h, t) or h)(
            hits.reshape(3, 1), total.reshape(3, 1))
        assert up.counters() == {"x": (17, 130)}
        assert up.counters() == {}


def test_stage_timer_opens_its_span():
    timers = up.StageTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.time("stageC_joint_fit"):
            torch.ones(3).sum()
        with up.tracing():
            with timers.time("stageC_joint_fit"):
                with up.span("fit.step"):
                    torch.ones(3).sum()
    marks = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    stage = [m for m in marks if m[0] == "stageC_joint_fit"]
    assert len(stage) == 1 and timers.counts["stageC_joint_fit"] == 2
    assert _inside(marks, stage[0]) == ["fit.step"]
