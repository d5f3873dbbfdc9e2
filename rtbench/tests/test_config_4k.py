"""Config 5 at its published 3840x2160 (``cfg5-proc5000-4k``) on the CPU:
the frame's chunk plan, the route ``mg_auto`` takes at 5,000 spheres and its
frame against the reference bit for bit, the reader of the sorts' device
time on made-up traces, and a tiny traced run of the cell."""

import json
import types

import pytest
import torch

from rtbench import core, inputs
from rtbench import reference as R
from rtbench.tests.test_harness import run_cell
from rtbench.tests.tiny import ROOT, tiny_root

CELL = "cfg5-proc5000-4k.serve"
CONFIG = core.load_config(ROOT, core.find(core.load_benchmark(ROOT)["configs"],
                                          "cfg5-proc5000-4k", "configuration"))


def test_the_config_is_config_5_at_its_published_width():
    slice_ = json.loads((ROOT / "rtbench" / "configs" / "cfg5-proc5000.json").read_text())
    assert CONFIG["scene"] == slice_["scene"]
    assert tuple(CONFIG["resolution"]) == (3840, 2160)
    assert (CONFIG["samples_per_pixel"], CONFIG["max_bounces"]) == (8, 8)
    assert CONFIG["reduced"] == ["samples_per_pixel"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2, 1_234_567_890])
def test_the_4k_frame_is_two_chunks_of_four(seed):
    """Two chunks of four samples, each 33,177,600 rays under the 2**25
    cap, on the seeds the reference draws."""
    from rt_tpu_torch.ops.render import _chunk_seeds
    from rt_tpu_torch.ops.wavefront import _HBM_RAY_CAP, _resolve_chunk

    size, spp = tuple(CONFIG["resolution"]), CONFIG["samples_per_pixel"]
    n_pix = size[0] * size[1]
    k = _resolve_chunk(size, spp, 4)
    assert k == 4 and -(-spp // k) == 2
    assert n_pix * k == 33_177_600 <= _HBM_RAY_CAP == 2**25
    plan = R.frame_plan(seed, spp, n_pix)
    assert [len(c) for c in plan] == [4, 4]
    assert [c[0][0] for c in plan] == _chunk_seeds(seed, 2)[:, 0].tolist()


@pytest.mark.parametrize("seed", [5, 2_000_000_011])
def test_mg_auto_at_5000_spheres_is_the_reference(seed):
    """``mg_auto`` routes the 5,000-sphere scene to the wavefront and its
    two-chunk frame (8 samples, depth 8) equals the reference bit for bit
    at every pixel."""
    from rt_tpu_torch import renderer
    from rtbench.drive import port_scene

    size, spp, depth = (32, 18), CONFIG["samples_per_pixel"], CONFIG["max_bounces"]
    arrays = inputs.scene_arrays(CONFIG)
    scene = port_scene(arrays, CONFIG)
    assert renderer.auto_route(scene, "cpu") == "wavefront"
    got = renderer.create("mg_auto")(scene, size, seed=seed, spp=spp, max_bounces=depth,
                                     device="cpu")
    cam = R.camera_vector(arrays["camera_position"], arrays["camera_direction"], size,
                          inputs.VFOV, inputs.NEAR)
    ref = R.frame_pixels(R.Tables(arrays, "cpu"), cam, size, spp, depth, seed,
                         torch.arange(size[0] * size[1]))
    assert torch.equal(got.reshape(-1, 3), ref)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _sorted_frames():
    """Two frames, each with a sort span (100-200 us after the frame's
    start) that launches a kernel (30 us) and a copy (20 us); a kernel
    launched before the span, and one launched inside the span's time but
    from another thread, do not count."""
    ev = []
    for k, t0 in enumerate((0.0, 1000.0)):
        c = 10 * k
        ev += [_ev("user_annotation", f"rt.frame/{k + 1}", t0, 900),
               _ev("user_annotation", "rt.sort", t0 + 100, 100),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 110, 5, corr=c + 1),
               _ev("cuda_runtime", "cudaMemcpyAsync", t0 + 150, 5, corr=c + 2),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 50, 5, corr=c + 3),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 120, 5, tid=2, corr=c + 4),
               _ev("kernel", "DeviceRadixSortOnesweepKernel", t0 + 300, 30, tid=9,
                   corr=c + 1),
               _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", t0 + 330, 20, tid=9,
                   corr=c + 2),
               _ev("kernel", "wf_bounce_kernel(Args)", t0 + 60, 200, tid=9, corr=c + 3),
               _ev("kernel", "elementwise_kernel", t0 + 350, 40, tid=9, corr=c + 4),
               _ev("gpu_user_annotation", "rt.sort", t0 + 300, 50, tid=9)]
    return ev


def _ctx(kind, events, profiled=2):
    return types.SimpleNamespace(kind=kind, events=events, profiled=profiled,
                                 records=[], window_s=0.0, csrc=frozenset(), work=[])


def test_sort_reader_counts_what_the_sort_spans_launch():
    read = core.load_reader(ROOT, "sort_device_ms.serve")
    events = _sorted_frames()
    assert read(_ctx("frames", events)) == pytest.approx((30 + 20) / 1e3)
    assert read(_ctx("frames", events, profiled=1)) == pytest.approx(2 * (30 + 20) / 1e3)
    assert read(_ctx("steps", events)) is None
    # a program without the span: nothing to read
    assert read(_ctx("frames", [e for e in events if e["name"] != "rt.sort"])) is None
    # spans, but no launch inside them
    inside = {1, 2, 11, 12}
    bare = [e for e in events if e["cat"] != "cuda_runtime"
            or e["args"]["correlation"] not in inside]
    assert read(_ctx("frames", bare)) == 0.0


def test_a_tiny_traced_run_of_the_cell_is_correct(tmp_path):
    """The cell through the harness with ``--trace 1``, its scene cut to
    2,100 spheres (past the wavefront threshold) and its frame to 32x24 at
    8 samples: two chunks a frame."""
    root = tiny_root(tmp_path, spheres={"cfg5-proc5000-4k": 2100}, spp=8)
    rc, out, err = run_cell(root, CELL, 2**31 + 21, trace=1)
    assert rc == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["frame_gap"]["value"] == 0.0
