"""rt_tpu_torch.profiling against rt_tpu.profiling: the round-robin
schedule and the keys of ``interleaved`` (driven here with fake steps and
a fake clock; the public function times the card and raises without one),
``RenderTimer``'s counters and ``trace``'s file."""

import glob
import json
import os

import pytest
import torch

import rt_tpu.profiling as jprof
import rt_tpu_torch
from rt_tpu_torch import profiling as tprof
from test_torch_common import SCENES


def _logging_steps(log, n):
    def make(k):
        def step(i):
            log.append((k, i))
        return step
    return [make(k) for k in range(n)]


@pytest.mark.parametrize("iters,windows,warmup", [(3, 9, 1), (2, 4, 0), (1, 3, 2)])
def test_interleaved_schedule_is_jax(iters, windows, warmup):
    """The port's schedule calls the steps in the order JAX's
    ``interleaved`` does, including ``(fn, iters)`` pairs, and returns its
    keys."""
    j_log, t_log = [], []
    j_steps = _logging_steps(j_log, 3)
    t_steps = _logging_steps(t_log, 3)
    j_steps[1], t_steps[1] = (j_steps[1], 5), (t_steps[1], 5)
    want = jprof.interleaved(j_steps, iters=iters, windows=windows, warmup_windows=warmup)

    ticks, syncs = [0.0], []

    def clock():  # every reading advances by the calls made since the last
        ticks[0] += 1.0 + len(t_log)
        return ticks[0]

    got = tprof._interleaved(t_steps, iters, windows, warmup, clock=clock,
                             elapsed=lambda a, b: b - a, sync=lambda: syncs.append(len(t_log)))
    assert t_log == j_log
    assert syncs == [3]  # once, after each step's first call
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [len(r["windows"]) for r in got] == [windows] * 3
    for r in got:
        assert r["windows"] == sorted(r["windows"])
        assert (r["min"], r["median"], r["max"]) == (
            r["windows"][0], r["windows"][windows // 2], r["windows"][-1])


def test_interleaved_window_times_per_call():
    """Each window is its clock span divided by its calls."""
    spans = iter([0.0, 8.0, 8.0, 14.0, 14.0, 16.0, 16.0, 22.0])
    got = tprof._interleaved([lambda i: None, (lambda i: None, 2)], 4, 2, 0,
                             clock=lambda: next(spans), elapsed=lambda a, b: b - a,
                             sync=lambda: None)
    assert got[0]["windows"] == [0.5, 2.0] and got[1]["windows"] == [3.0, 3.0]


def test_measurements_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a CUDA-less host")
    for fn in (tprof.interleaved, tprof.sustained):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn([lambda i: None] if fn is tprof.interleaved else (lambda i: None))
    assert set(jprof.__all__) <= set(tprof.__all__)


def test_render_timer_fills_counters():
    scene = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    with tprof.RenderTimer((16, 12), spp=2, name="t_basic") as t:
        img = rt_tpu_torch.renderer.create("mg_pallas")(scene, (16, 12), spp=2, max_bounces=2,
                                                        device="cpu")
        t.result = (img, {"n": [img]})
    assert t.seconds > 0
    assert tprof.counters["t_basic.seconds"] == t.seconds
    assert tprof.counters["t_basic.mrays"] == pytest.approx(16 * 12 * 2 / t.seconds / 1e6)
    with tprof.RenderTimer((4, 4), spp=1) as t2:
        pass
    assert tprof.counters["render.seconds"] == t2.seconds


def test_trace_writes_a_chrome_trace(tmp_path):
    scene = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as d:
        rt_tpu_torch.renderer.create("mg_pallas")(scene, (8, 6), spp=1, max_bounces=2,
                                                  device="cpu")
    assert d == log_dir
    files = glob.glob(os.path.join(log_dir, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # a CPU render: no device event, and no warning without a card
    assert tprof.counters["trace.device_events"] == 0


def test_trace_default_dir_and_device_events(monkeypatch, tmp_path):
    """``trace``'s default directory is read from the temporary directory
    when it is entered (so ``$TMPDIR`` holds); its device-event count
    takes the events that ran on the card."""
    import tempfile
    import warnings
    from types import SimpleNamespace

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", ".*no device event", RuntimeWarning)
        with tprof.trace() as d:
            torch.ones(4).sum()
    assert d == str(tmp_path / "rt_tpu_torch_trace")
    assert len(glob.glob(os.path.join(d, "trace_*.json"))) == 1

    def ev(kind):
        return SimpleNamespace(device_type=SimpleNamespace(name=kind))

    assert tprof._device_events([ev("CPU"), ev("CUDA"), ev("CPU"), ev("CUDA")]) == 2
    assert tprof._device_events([ev("CPU")]) == 0
