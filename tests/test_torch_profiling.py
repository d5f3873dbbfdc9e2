"""rt_tpu_torch.profiling against rt_tpu.profiling: the round-robin
schedule and the keys of ``interleaved`` (driven here with fake steps and
a fake clock; the public function times the card and raises without one),
``RenderTimer``'s counters and ``trace``'s file; and the port's own spans
and live-ray counter under a CPU profiler session."""

import glob
import json
import os
import re
import time
import tracemalloc
from pathlib import Path
from unittest import mock

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
    assert {"rt.tables", "rt.upload", "rt.assemble"} <= {e["name"] for e in events}
    assert any(re.fullmatch(r"rt\.frame/\d+", e["name"]) for e in events)
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

    def ev(kind, **kw):
        return SimpleNamespace(device_type=SimpleNamespace(name=kind), **kw)

    assert tprof._device_events([ev("CPU"), ev("CUDA"), ev("CPU"), ev("CUDA")]) == 2
    assert tprof._device_events([ev("CPU")]) == 0
    # a span's range on the card is not a device event
    assert tprof._device_events([ev("CUDA", is_user_annotation=True),
                                 ev("CUDA", is_user_annotation=False)]) == 1


# ---- the port's spans and its live-ray counter ----

def _tiny_scene():
    return rt_tpu_torch.scene.make_procedural_scene(6)


def _train_step(make):
    """Two tiny Adam steps' callable of ``make`` (make_bw_train_step or
    make_wf_train_step) on the CPU."""
    scene = _tiny_scene()
    target = torch.rand((6, 8, 3), generator=torch.Generator().manual_seed(1)) * 0.5
    params = {"materials.albedo": scene.materials.albedo.clone()}
    opt = torch.optim.Adam(list(params.values()), lr=5e-2)
    step = make(opt, scene, target, (8, 6), spp=2, max_bounces=3, device="cpu")
    return lambda seed: step(params, seed)


def _frame(name):
    scene = _tiny_scene()
    render = rt_tpu_torch.renderer.create(name)
    return lambda seed: render(scene, (8, 6), seed=seed, spp=2, max_bounces=3, device="cpu")


def _unit(case):
    from rt_tpu_torch.ops import blockwise_grad, wavefront_grad

    return {"mg_wavefront": lambda: _frame("mg_wavefront"),
            "mg_auto": lambda: _frame("mg_auto"),
            "bw_step": lambda: _train_step(blockwise_grad.make_bw_train_step),
            "wf_step": lambda: _train_step(wavefront_grad.make_wf_train_step)}[case]()


BOUNCES = {"rt.bounce/0", "rt.bounce/1", "rt.bounce/2", "rt.sort", "rt.assemble"}


@pytest.mark.parametrize("case,root,spans", [
    ("mg_wavefront", "rt.frame", {"rt.tables", "rt.upload"} | BOUNCES),
    ("mg_auto", "rt.frame", {"rt.route/pallas", "rt.tables", "rt.upload", "rt.assemble"}),
    ("bw_step", "rt.step", {"rt.tables", "rt.upload", "rt.forward", "rt.loss", "rt.reverse"}),
    ("wf_step", "rt.step", {"rt.tables", "rt.upload", "rt.forward", "rt.loss", "rt.reverse"}
     | BOUNCES),
])
def test_spans_nest_under_their_root(tmp_path, case, root, spans):
    """Two units under a CPU profiler session: each opens one root span
    whose name carries the next sequence number, and every other span of
    the unit lies inside its root, on the same thread."""
    run = _unit(case)
    with torch.profiler.profile() as prof:
        for seed in (3, 4):
            run(seed)
    tprof.live_rays()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = [e for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"].startswith("rt.")]
    roots = sorted((e for e in events if re.fullmatch(re.escape(root) + r"/\d+", e["name"])),
                   key=lambda e: e["ts"])
    assert len(roots) == 2
    n1, n2 = (int(e["name"].rsplit("/", 1)[1]) for e in roots)
    assert n2 == n1 + 1
    for r in roots:
        inside = [e for e in events if e is not r and e["tid"] == r["tid"]
                  and r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]]
        assert {e["name"] for e in inside} == spans
    assert len(events) == len(roots) + sum(
        1 for e in events if e not in roots
        and any(r["ts"] <= e["ts"] <= r["ts"] + r["dur"] for r in roots))


def test_span_is_off_without_a_session():
    """With no session every site gets the shared no-op: it allocates
    nothing, reads no clock, formats no name and takes no sequence
    number."""
    assert not tprof.recording()
    assert tprof.span("rt.sort") is tprof.OFF
    assert tprof.span("rt.bounce", 3) is tprof.OFF
    assert tprof.span("rt.frame", root=True) is tprof.OFF
    roots = repr(tprof._root_calls)

    def no_clock(*a):
        raise AssertionError("a span read a clock")

    clocks = {name: mock.patch.object(time, name, no_clock)
              for name in ("perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns",
                           "time", "time_ns")}
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for c in clocks.values():
            c.start()
        try:
            for b in range(1000):
                with tprof.span("rt.bounce", b):
                    pass
                with tprof.span("rt.frame", root=True):
                    pass
        finally:
            for c in clocks.values():
                c.stop()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == tprof.__file__ and d.size_diff > 0]
    assert not grown
    assert repr(tprof._root_calls) == roots


class _AtenLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten":
            self.ops.append(func.name())
        return func(*args, **(kwargs or {}))


def test_a_traced_frame_dispatches_the_same_aten_ops():
    """The spans and the live-ray counter add no aten operation: a frame
    dispatches the same ones under a session as without one."""
    run = _frame("mg_wavefront")
    with _AtenLog() as plain:
        want = run(3)
    with torch.profiler.profile():
        with _AtenLog() as traced:
            got = run(3)
    assert len(tprof.live_rays()) == 3
    assert plain.ops and traced.ops == plain.ops
    assert torch.equal(got, want)


def test_profiler_sessions_flip_the_span_flag(tmp_path):
    """``span`` reads the flag that ``torch.profiler.profile`` sets (a
    private attribute of torch, pinned here), and ``trace`` opens such a
    session."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with torch.profiler.profile():
        assert torch.autograd.profiler._is_profiler_enabled is True and tprof.recording()
        assert isinstance(tprof.span("rt.sort"), torch.profiler.record_function)
    assert not tprof.recording()
    with tprof.trace(str(tmp_path)):
        assert tprof.recording()
    assert not tprof.recording()


def test_live_rays_match_the_reference():
    """The live rays entering each bounce of a traced wavefront frame, summed,
    are the live rays the benchmark's reference traces at the same scene,
    seed and draws; bounce 0 counts every ray.  The read is cached; the next
    traced bounce starts a new tally; a read inside a session raises."""
    from rtbench import inputs
    from rtbench import reference as R
    from rtbench.drive import port_scene

    root = Path(__file__).resolve().parent.parent
    config = json.loads((root / "rtbench" / "configs" / "cfg5-proc5000.json").read_text())
    config.update(name="tiny", resolution=[16, 12], samples_per_pixel=2, max_bounces=4)
    config["scene"]["spheres"] = 24
    arrays = inputs.scene_arrays(config)
    scene = port_scene(arrays, config)
    size, spp, depth, seed, n_pix = (16, 12), 2, 4, 123457, 16 * 12

    def frame():
        rt_tpu_torch.renderer.create("mg_wavefront")(scene, size, seed=seed, spp=spp,
                                                     max_bounces=depth, device="cpu")

    with torch.profiler.profile():
        frame()
    counts = tprof.live_rays()
    cnt = R.new_counts()
    cam = R.camera_vector(arrays["camera_position"], arrays["camera_direction"], size,
                          inputs.VFOV, inputs.NEAR)
    R.render_sums(R.Tables(arrays, torch.device("cpu")), cam, size, depth,
                  R.frame_plan(seed, spp, n_pix), torch.arange(n_pix), cnt)
    assert len(counts) == depth and counts[0] == cnt["rays"] == n_pix * spp
    assert sum(counts) == int(cnt["live"]) and counts[1] > 0
    assert tprof.live_rays() == counts
    assert [tprof.counters[f"wf.live_rays/{b}"] for b in range(depth)] == list(counts)
    with torch.profiler.profile():
        frame()
        with pytest.raises(RuntimeError, match="after the profiler session"):
            tprof.live_rays()
    assert tprof.live_rays() == counts
    frame()  # untraced: counts nothing
    assert tprof.live_rays() == counts
