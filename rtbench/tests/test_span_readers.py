"""The readers of the program's spans and live-ray counter on made-up traces
and on a real CPU trace, and the older readers unmoved by the spans."""

import json
import types

import pytest

from rtbench import core
from rtbench.tests.tiny import ROOT

OLDER_READERS = ("enqueue_ms.serve", "enqueue_ms.train", "glue_device_ms.serve",
                 "glue_device_ms.train", "kernel_roofline.serve", "kernel_roofline.train",
                 "device_idle.serve", "device_idle.train")


def _ev(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}


def _ctx(kind, events, profiled):
    return types.SimpleNamespace(
        kind=kind, records=[(0.0, 0.001, 0.010), (0.010, 0.012, 0.020)], window_s=0.020,
        events=events, profiled=profiled,
        csrc=frozenset({"wf_gen_kernel", "wf_bounce_kernel", "blockwise_kernel"}),
        work=[(0, 33.5e12 * 4e-3)])


def _frames():
    """Two frames: each 1000 us of host, tables 0-300 (an upload nested in
    it), the device busy 400-900 (kernels overlapping) and once more after
    the span, which the span's idle leaves out."""
    ev = []
    for k, t0 in enumerate((0.0, 2000.0)):
        ev += [_ev("user_annotation", f"rt.frame/{k + 1}", t0, 1000),
               _ev("user_annotation", "rt.tables", t0, 300),
               _ev("user_annotation", "rt.upload", t0 + 100, 50),
               _ev("user_annotation", "rt.bounce/0", t0 + 350, 100),
               _ev("user_annotation", "rt.bounce/1", t0 + 600, 100),
               _ev("gpu_user_annotation", "rt.frame/1", t0 + 400, 800, tid=9),
               _ev("kernel", "void (anonymous namespace)::wf_gen_kernel(Args)", t0 + 400, 300,
                   tid=9),
               _ev("kernel", "(anonymous namespace)::wf_bounce_kernel(Args)", t0 + 650, 250,
                   tid=9),
               _ev("kernel", "elementwise_kernel", t0 + 1100, 100, tid=9)]
    return ev


def _steps():
    """Two steps of 1000 us: the device busy 0-900 in the first and 2200-3000
    in the second; a sync of 200 us inside each step on its thread, one on
    another thread and one outside the steps."""
    ev = []
    for k, t0 in enumerate((0.0, 2000.0)):
        ev += [_ev("user_annotation", f"rt.step/{k + 1}", t0, 1000),
               _ev("cuda_runtime", "cudaStreamSynchronize", t0 + 500, 200),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 100, 10),
               _ev("cuda_runtime", "cudaHostAlloc", t0 + 900, 300),
               _ev("cuda_runtime", "cudaStreamSynchronize", t0 + 300, 100, tid=2)]
    ev += [_ev("kernel", "blockwise_kernel<true, 1>(Args)", 0, 900, tid=9),
           _ev("kernel", "blockwise_kernel<true, 1>(Args)", 2200, 800, tid=9),
           _ev("cuda_runtime", "cudaDeviceSynchronize", 1500, 400)]
    return ev


@pytest.fixture
def live_counts():
    """The program's counter holding a session's counts: 40 and 10 live
    rays entering bounces 1 and 2 of the frames."""
    from rt_tpu_torch import profiling

    profiling._reset_live()
    for b, n in ((0, 100), (1, 30), (2, 10), (1, 10)):
        profiling.count_live(b, n)
    yield
    profiling._reset_live()


@pytest.mark.parametrize("metric,kind,want", [
    ("tables_host_ms.serve", "frames", 0.3),
    ("program_idle_ms.serve", "frames", 0.5),        # 1000 us less 400-900 busy
    ("live_ray_ns.serve", "frames", 2 * 250e3 / 50),  # two launches of 250 us, 50 rays
    ("host_wait_ms.train", "steps", 0.3),           # 200 us sync, 100 us of the alloc
    ("program_idle_ms.train", "steps", 0.15),       # (100 + 200) / 2
])
def test_span_readers_on_a_made_up_trace(live_counts, metric, kind, want):
    events = _frames() if kind == "frames" else _steps()
    read = core.load_reader(ROOT, metric)
    assert read(_ctx(kind, events, 2)) == pytest.approx(want)
    other = "steps" if kind == "frames" else "frames"
    assert read(_ctx(other, events, 2)) is None
    if metric != "live_ray_ns.serve":  # a program without spans: nothing to read
        bare = [e for e in events if not e["name"].startswith("rt.")]
        assert read(_ctx(kind, bare, 2)) is None


def test_live_ray_reader_without_the_counter(monkeypatch):
    """A program whose profiling module has no live-ray counter, or whose
    traced frames ran no wavefront bounce: nothing to read."""
    from rt_tpu_torch import profiling

    read = core.load_reader(ROOT, "live_ray_ns.serve")
    profiling._reset_live()
    assert read(_ctx("frames", _frames(), 2)) is None
    monkeypatch.delattr(profiling, "live_rays")
    assert read(_ctx("frames", _frames(), 2)) is None


@pytest.mark.parametrize("kind", ["frames", "steps"])
def test_older_readers_ignore_the_spans(kind):
    """The eight older readers read the same numbers from a trace with the
    program's host and device annotations as from one without them."""
    events = _frames() if kind == "frames" else _steps()
    bare = [e for e in events if not e["name"].startswith("rt.")]
    assert len(bare) < len(events)
    for metric in OLDER_READERS:
        read = core.load_reader(ROOT, metric)
        assert read(_ctx(kind, events, 2)) == read(_ctx(kind, bare, 2)), metric


def test_span_readers_on_a_real_cpu_trace(tmp_path):
    """A CPU profiler session over two tiny wavefront frames: the readers
    find the program's spans in Kineto's own output (no device events, so a
    frame's idle is its whole span)."""
    import torch

    from rt_tpu_torch import renderer
    from rt_tpu_torch.scene import make_procedural_scene

    scene = make_procedural_scene(6)
    render = renderer.create("mg_wavefront")
    with torch.profiler.profile() as prof:
        for seed in (3, 4):
            render(scene, (8, 6), seed=seed, spp=2, max_bounces=3, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    ctx = _ctx("frames", events, 2)
    frames = [e for e in events if e["name"].startswith("rt.frame/")]
    assert len(frames) == 2
    tables = core.load_reader(ROOT, "tables_host_ms.serve")(ctx)
    idle = core.load_reader(ROOT, "program_idle_ms.serve")(ctx)
    assert 0.0 < tables < idle
    assert idle == pytest.approx(sum(float(e["dur"]) for e in frames) / 2e3)


# every reader of the four one-rank cells on the made-up traces above, as
# the parent of the four-card cell read them
PRESENT = [
    ("enqueue_ms.serve", "frames", 1.5), ("enqueue_ms.train", "steps", 1.5),
    ("glue_device_ms.serve", "frames", 0.1), ("glue_device_ms.train", "steps", 0.0),
    ("kernel_roofline.serve", "frames", 363.6363636363636),
    ("kernel_roofline.train", "steps", 235.29411764705884),
    ("device_idle.serve", "frames", 94.0), ("device_idle.train", "steps", 91.5),
    ("tables_host_ms.serve", "frames", 0.3), ("host_wait_ms.train", "steps", 0.3),
    ("program_idle_ms.serve", "frames", 0.5), ("program_idle_ms.train", "steps", 0.15),
    ("live_ray_ns.serve", "frames", 10000.0),
]


@pytest.mark.parametrize("metric,kind,want", PRESENT)
def test_present_readers_read_as_before(live_counts, metric, kind, want):
    """The same value, bit for bit, whether the context carries the ranks'
    lists as a run of one rank now builds it or not."""
    events = _frames() if kind == "frames" else _steps()
    read = core.load_reader(ROOT, metric)
    ctx = _ctx(kind, events, 2)
    assert read(ctx) == want
    ctx.rank_events, ctx.rank_work = [ctx.events], [ctx.work]
    assert read(ctx) == want
