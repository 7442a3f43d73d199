"""The span arithmetic of the second traced stretch on synthetic
kineto-like events (attribution through correlation ids and sequence
numbers, idle time by span, the sums), its readers, and the events of a
real CPU profile of a traced fit."""
import types

import pytest
import torch

from portbench import harness, span_stretch
from portbench.yardstick import spans as S

MAIN, ENGINE = 1, 2


def _span(name, a, b, thread=MAIN):
    return S.Host(name, a, b, thread, 0, -1, 0)


def _op(name, a, b, thread=MAIN, corr=0, seq=-1, fwd=0):
    return S.Host(name, a, b, thread, corr, seq, fwd)


SPANS = [_span("fit.step", 0, 100), _span("fit.forward", 5, 40),
         _span("raster.prep", 10, 20), _span("fit.backward", 40, 70),
         _span("fit.adam", 70, 95)]
HOST = [
    # Two forward ops open with sequence number 7; the last made node 7.
    _op("aten::to", 6, 7, seq=7), _op("aten::sin", 12, 14, seq=7),
    _op("cudaLaunchKernel", 13, 14, corr=101),
    _op("cudaLaunchKernel", 21, 22, corr=105),
    _op(S.BACKWARD + " SinBackward0", 45, 55, ENGINE, seq=7, fwd=MAIN),
    _op("cudaLaunchKernel", 46, 47, ENGINE, corr=102),
    _op(S.BACKWARD + " torch::autograd::AccumulateGrad", 60, 65, ENGINE),
    _op("cudaLaunchKernel", 62, 63, ENGINE, corr=103),
    _op("cudaLaunchKernel", 75, 76, corr=104)]
DEVICE = [S.Device("prep_fwd", 15, 25, 101), S.Device("loss", 23, 35, 105),
          S.Device("prep_bwd", 50, 60, 102), S.Device("acc", 62, 64, 103),
          S.Device("adam", 80, 90, 104), S.Device("stray", 96, 98, 999)]


def test_attribution_by_correlation_id_and_sequence_number():
    got = [(None if s is None else s.name, engine)
           for s, engine, _ in S.attribute(SPANS, HOST, DEVICE)]
    assert got == [("raster.prep", False), ("fit.forward", False),
                   ("raster.prep", True), ("fit.backward", True),
                   ("fit.adam", False), (None, False)]


def test_idle_split_by_the_innermost_span():
    idle = S.idle_intervals(DEVICE, 0, 100)
    assert idle == [(0, 15), (35, 50), (60, 62), (64, 80), (90, 96),
                    (98, 100)]
    pieces = S.split_by_owner(S.timeline(SPANS), idle)
    by = {}
    for span, ns in pieces:
        by[span.name] = by.get(span.name, 0) + ns
    assert by == {"fit.step": 8, "fit.forward": 10, "raster.prep": 5,
                  "fit.backward": 18, "fit.adam": 15}


def test_summary_sums_to_busy_and_idle_time():
    s = S.summary(SPANS, HOST, DEVICE, 0, 100)
    assert s["busy_s"] == pytest.approx(44e-9)
    assert s["idle_s"] == pytest.approx(56e-9)
    assert s["overlap_s"] == pytest.approx(2e-9)
    assert sum(s["device_s"].values()) == pytest.approx(s["busy_s"])
    assert sum(s["idle_by"].values()) == pytest.approx(s["idle_s"])
    assert s["device_s"] == pytest.approx({
        "raster.prep": 20e-9, "fit.forward": 10e-9, "fit.adam": 10e-9,
        "fit.backward": 2e-9, "none": 2e-9})
    assert s["device_bwd_s"] == pytest.approx({"raster.prep": 10e-9,
                                               "fit.backward": 2e-9})
    assert s["under"]["fit.step"] == pytest.approx(42e-9)
    assert s["under"]["fit.forward"] == pytest.approx(30e-9)
    assert s["idle_under"]["fit.forward"] == pytest.approx(15e-9)
    assert s["idle_under"]["fit.step"] == pytest.approx(56e-9)
    assert s["early"] == 0 and s["steps"] == 1


def test_a_stretch_cut_inside_spans():
    """Operations and idle time outside [t0, t1] do not count."""
    s = S.summary(SPANS, HOST, DEVICE, 20, 85)
    assert s["wall_s"] == pytest.approx(65e-9)
    assert s["busy_s"] + s["idle_s"] == pytest.approx(s["wall_s"])
    assert s["device_s"]["raster.prep"] == pytest.approx(15e-9)


def test_an_early_device_clock_is_moved_to_the_launches():
    """A profile whose device times all sit 3 ns early: three operations
    start before their launch calls, and moved 3 ns later (the largest
    lead, the gradient accumulation's, which started at its launch) the
    accounting is the one of the true times."""
    early = [d._replace(start=d.start - 3, end=d.end - 3) for d in DEVICE]
    s = S.summary(SPANS, HOST, early, 0, 100)
    assert s["early"] == 3 and s["lead_us"] == pytest.approx(3e-3)
    want = S.summary(SPANS, HOST, DEVICE, 0, 100)
    assert want["early"] == 0 and want["lead_us"] == 0
    for key in ("busy_s", "idle_s", "device_s", "idle_by", "under",
                "idle_under"):
        assert s[key] == pytest.approx(want[key]), key


def _ctx(spans):
    return types.SimpleNamespace(spans=spans)


READERS = ("raster_prep_share", "contour_edge_fill", "interactions_share",
           "idle_forward_share", "idle_backward_share", "idle_adam_share")


def test_readers():
    s = S.summary(SPANS, HOST, DEVICE, 0, 100)
    s["counters"] = {"raster.contour_edges": (30, 1200)}
    read = {n: harness.load_reader(n) for n in READERS}
    ctx = _ctx(s)
    assert read["raster_prep_share"](ctx) == pytest.approx(100 * 20 / 44)
    assert read["contour_edge_fill"](ctx) == pytest.approx(2.5)
    assert read["idle_forward_share"](ctx) == pytest.approx(15.0)
    assert read["idle_backward_share"](ctx) == pytest.approx(18.0)
    assert read["idle_adam_share"](ctx) == pytest.approx(15.0)
    # No `interactions` span: a step-1 recipe.
    assert read["interactions_share"](ctx) is None
    s["counters"] = {}
    assert read["contour_edge_fill"](ctx) is None


def test_readers_read_nothing_without_a_stretch():
    for name in READERS:
        assert harness.load_reader(name)(_ctx(None)) is None
    if not torch.cuda.is_available():
        # No card: no stretch is run, whatever the command line.
        ctx = types.SimpleNamespace(window_s=1.0, steps=1)
        assert harness.load_reader("raster_prep_share")(ctx) is None
        assert ctx.spans is None


def test_events_of_a_traced_fit_on_the_cpu():
    """A CPU profile of two traced steps: the program's spans, the
    stretch's range and the accounting (no device operation, so the
    stretch is idle throughout, all of it inside fit.step)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from homan_tpu_torch import utils_profiling
    from homan_tpu_torch.parallel.clips import fit_clips_batched
    from portbench import scene
    from portbench.recipes import joint_fit
    from portbench.tests import tiny
    _, cfg, traffic = tiny.cell("step1_batch")
    traffic["clips"] = 2
    state, consts, info = scene.make_clips(cfg, traffic, 9, "cpu")
    ke, _ = joint_fit.edge_slots(state, consts, cfg, cfg["frames"])
    states, pconsts, pcfg, settings, hand_faces = joint_fit.program_inputs(
        state, consts, info, cfg, ke)
    with utils_profiling.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(span_stretch.MARK):
                fit_clips_batched(states, pconsts, pcfg,
                                  loss_weights=cfg["loss_weights"],
                                  num_iterations=2, lr=1e-2,
                                  roi_settings=settings,
                                  closed_hand_faces=hand_faces,
                                  device="cpu")
        counts = utils_profiling.counters()
    spans, host, device, (t0, t1) = span_stretch.events(prof)
    names = [s.name for s in spans]
    assert names.count("fit.step") == 2 and names.count("raster.prep") == 2
    assert "interactions" not in names and not device
    assert any(h.name.startswith(S.BACKWARD) for h in host)
    s = S.summary(spans, host, device, t0, t1)
    assert s["busy_s"] == 0 and s["idle_s"] == pytest.approx(s["wall_s"])
    assert s["steps"] == 2
    assert s["idle_under"]["fit.step"] <= s["wall_s"]
    assert s["idle_under"]["fit.forward"] > 0
    hits, n = counts["raster.contour_edges"]
    assert 0 < hits < n
