"""A whole run of a cell at a tiny size on the CPU, the command's refusal
without a card, and the comparison refusing a broken program and the
lower-precision control."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.tests import tiny

RUN = [sys.executable, os.path.join("portbench", "run.py"), "--workload",
       "step1_batch", "--seed", "5", "--seconds", "1", "--trace", "0"]


def test_tiny_run_is_correct():
    r = tiny.run()
    assert r["correct"], r["checks"]
    assert r["attempted"] == 2 * 6 and r["failed"] == 0
    assert set(r["metrics"]) == {"clip_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(RUN, cwd=tiny.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def _broken(monkeypatch, fault):
    """Run the tiny cell with the program's batched fit broken by
    `fault(real, states, args, kwargs)`."""
    from homan_tpu_torch.parallel import clips
    real = clips.fit_clips_batched

    def fit(states, *args, **kwargs):
        return fault(real, states, args, kwargs)
    monkeypatch.setattr(clips, "fit_clips_batched", fit)
    return tiny.run()


def _unchanged(real, states, args, kwargs):
    """Every step returns the state it was given."""
    n = kwargs["num_iterations"]
    _, hist = real(states, *args, **dict(kwargs, num_iterations=1))
    return (states.map(lambda t: t.detach().clone()),
            {k: v[:, :1].expand(-1, n).contiguous() for k, v in hist.items()})


def _half_batch(real, states, args, kwargs):
    """Half of the clips fitted; their answers stand for the rest."""
    from homan_tpu_torch.parallel.clips import tree_map
    C = states.translations_object.shape[0]
    half = (C + 1) // 2
    consts = args[0]
    final, hist = real(tree_map(lambda t: t[:half], states),
                       tree_map(lambda t: t[:half], consts), *args[1:],
                       **kwargs)
    idx = torch.arange(C) % half
    return (final.map(lambda t: t[idx.to(t.device)]),
            {k: v[idx.to(v.device)] for k, v in hist.items()})


def _half_update(real, states, args, kwargs):
    """Every optimizer step applied to half of the clips only."""
    from portbench.recipes.joint_fit import half_update
    with half_update():
        return real(states, *args, **kwargs)


def _loss_altered(real, states, args, kwargs):
    """Two clips' reported silhouette loss at step 1 off by 0.1% (the
    comparison lets one clip stand out there, as round-off moves one now
    and then)."""
    final, hist = real(states, *args, **kwargs)
    hist["loss_sil_obj"] = hist["loss_sil_obj"].clone()
    hist["loss_sil_obj"][1:3, 0] *= 1.001
    return final, hist


def _later_loss_altered(real, states, args, kwargs):
    """Every clip's reported loss at step 3 off by 0.01%."""
    final, hist = real(states, *args, **kwargs)
    if hist["loss"].shape[1] >= 3:  # not the warm-up's one step
        hist["loss"] = hist["loss"].clone()
        hist["loss"][:, 2] *= 1.0001
    return final, hist


def _silhouette_gradient_doubled(real, states, args, kwargs):
    """The shade backward returns twice its gradient."""
    from homan_tpu_torch.render import shade
    plain = shade.shade_bwd_plain
    shade.shade_bwd_plain = lambda *a: 2.0 * plain(*a)
    try:
        return real(states, *args, **kwargs)
    finally:
        shade.shade_bwd_plain = plain


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _half_update,
                                   _loss_altered,
                                   _later_loss_altered,
                                   _silhouette_gradient_doubled])
def test_a_broken_program_is_not_correct(monkeypatch, fault):
    r = _broken(monkeypatch, fault)
    assert not r["correct"], (fault.__name__, r["checks"])


def _tf32(x):
    """x rounded to TF32's 10 mantissa bits (round to nearest)."""
    if not x.is_floating_point() or x.dtype != torch.float32:
        return x
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)


def test_the_tf32_control_is_not_correct(monkeypatch):
    """The program with its matmuls' inputs rounded to TF32 (the card's
    TF32 path, which the CPU does not have) fails the comparison."""
    from homan_tpu_torch.parallel import clips
    real = clips.fit_clips_batched
    mm, ein = torch.Tensor.__matmul__, torch.einsum

    def fit(*args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "__matmul__",
                      lambda a, b: mm(_tf32(a), _tf32(b)))
            m.setattr(torch, "einsum", lambda eq, *ops: ein(
                eq, *(_tf32(o) for o in ops)))
            return real(*args, **kwargs)
    monkeypatch.setattr(clips, "fit_clips_batched", fit)
    r = tiny.run()
    assert not r["correct"], r["checks"]
    print(json.dumps(r["checks"]))
