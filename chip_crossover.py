#!/usr/bin/env python3
"""Times the blockwise and the wavefront kernel routes end to end through
their entry points on one CUDA card, over a ladder of scene sizes: the
table that the auto routers' choice (``rt_tpu_torch.renderer.auto_route``,
``rt_tpu_torch.train.make_kernel_train_step``) rests on.

    python3 chip_crossover.py [--spheres 700,1000,...] [--windows 5] [--out PATH]

Frames: ``ops.blockwise.render_forward_blockwise`` against
``ops.wavefront.render_forward_wavefront`` on ``make_procedural_scene(n)``,
``mg``, depth 8, at 960x540 2 spp, 1920x1080 4 spp and one 4K chunk
(3840x2160 4 spp, 33,177,600 rays), each frame waited for (the serving
loop's latency: table build and upload, sorts, assembly, kernels); the
two frames are checked equal (``torch.equal``).  Steps: ``ops.
blockwise_grad.make_bw_train_step`` against ``ops.wavefront_grad.
make_wf_train_step`` with Adam (lr 5e-2, ``foreach``) on
``materials.albedo``, dispatched ahead, at 960x540 2 spp.  Then the same
at 5000 spheres with the ``sm`` personality, and frames of 660 spheres and
24 boxes (``scene.box_scene_toml``) with ``include_boxes``.  Each row runs
both routes in alternating windows of the same number of calls
(``profiling.interleaved``, CUDA events) and prints their medians in ms and
the wavefront's time over the blockwise's; ``--out`` writes the rows as
JSON.  Without CUDA the script raises: it times nothing on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

SPHERES = (700, 1000, 1600, 2100, 3000, 5000, 8000, 12000, 16000)
FRAMES = (((960, 540), 2), ((1920, 1080), 4), ((3840, 2160), 4))
STEP = ((960, 540), 2)
DEPTH = 8


def card_line() -> str:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip()
    return q or torch.cuda.get_device_name(0)


def timed(pair, windows: int, budget_s: float = 0.3):
    """Median seconds a call of each of ``pair`` (blockwise, wavefront):
    one warm-up call each, one probe call each to size the windows, then
    ``windows`` rounds of a window of each."""
    from rt_tpu_torch.profiling import interleaved

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    for fn in pair:
        fn(0)
    probe = []
    for fn in pair:
        t0 = clock()
        fn(1)
        probe.append(clock() - t0)
    iters = max(1, min(16, int(budget_s / max(probe))))
    return [r["median"] for r in interleaved(list(pair), iters, windows, 1)], iters


def frame_row(scene, size, spp, windows, **kw):
    from rt_tpu_torch.ops.blockwise import render_forward_blockwise
    from rt_tpu_torch.ops.wavefront import render_forward_wavefront

    def frame(fwd):
        def call(i):
            img = fwd(scene, size, seed=i, spp=spp, max_bounces=DEPTH, device="cuda", **kw)
            torch.cuda.synchronize()
            return img
        return call

    bw, wf = frame(render_forward_blockwise), frame(render_forward_wavefront)
    equal = bool(torch.equal(bw(3), wf(3)))
    (t_bw, t_wf), iters = timed((bw, wf), windows)
    return {"blockwise_ms": t_bw * 1e3, "wavefront_ms": t_wf * 1e3, "calls": iters,
            "frames_equal": equal}


def step_row(scene, size, spp, windows, personality="mg"):
    from rt_tpu_torch.ops.blockwise import render_forward_blockwise
    from rt_tpu_torch.ops.blockwise_grad import make_bw_train_step
    from rt_tpu_torch.ops.wavefront_grad import make_wf_train_step

    target = render_forward_blockwise(scene, size, seed=0, spp=spp, max_bounces=DEPTH,
                                      gamma=False, personality=personality, device="cuda")
    steps = []
    for make in (make_bw_train_step, make_wf_train_step):
        params = {"materials.albedo":
                  torch.full_like(scene.materials.albedo, 0.5).to("cuda")}
        opt = torch.optim.Adam(list(params.values()), lr=5e-2, foreach=True)
        st = make(opt, scene, target, size, spp=spp, max_bounces=DEPTH,
                  personality=personality, device="cuda")
        steps.append(lambda i, st=st, params=params: st(params, 100 + i))
    (t_bw, t_wf), iters = timed(steps, windows)
    return {"blockwise_ms": t_bw * 1e3, "wavefront_ms": t_wf * 1e3, "calls": iters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spheres", default=",".join(map(str, SPHERES)))
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--out", help="write the card line and the rows to this JSON file")
    args = ap.parse_args(argv)

    import rt_tpu_torch
    from rt_tpu_torch.scene import box_scene_toml

    if not torch.cuda.is_available():
        raise SystemExit("chip_crossover.py times the CUDA card; none is available")
    print(f"card: {card_line()}", flush=True)

    rows = []

    def emit(kind, label, size, spp, r):
        r.update(kind=kind, scene=label, size=f"{size[0]}x{size[1]}", spp=spp,
                 ratio=r["wavefront_ms"] / r["blockwise_ms"])
        rows.append(r)
        eq = "" if "frames_equal" not in r else f"  equal={r['frames_equal']}"
        print(f"{kind:5s} {label:22s} {r['size']:>9s} {spp:2d}spp  blockwise "
              f"{r['blockwise_ms']:10.3f} ms  wavefront {r['wavefront_ms']:10.3f} ms  "
              f"wf/bw {r['ratio']:.3f}  calls/window {r['calls']}{eq}", flush=True)

    t_start = time.perf_counter()
    for n in map(int, args.spheres.split(",")):
        scene = rt_tpu_torch.scene.make_procedural_scene(n)
        for size, spp in FRAMES:
            emit("frame", f"proc{n}", size, spp,
                 frame_row(scene, size, spp, args.windows))
        emit("step", f"proc{n}", *STEP, step_row(scene, *STEP, args.windows))
    proc5000 = rt_tpu_torch.scene.make_procedural_scene(5000)
    for size, spp in FRAMES[:2]:
        emit("frame", "proc5000 sm", size, spp,
             frame_row(proc5000, size, spp, args.windows, personality="sm"))
    emit("step", "proc5000 sm", *STEP, step_row(proc5000, *STEP, args.windows, personality="sm"))
    box = rt_tpu_torch.loads(box_scene_toml(660, 24))
    for size, spp in FRAMES[:2]:
        emit("frame", "660 + 24 boxes", size, spp,
             frame_row(box, size, spp, args.windows, include_boxes=True))
    print(f"[crossover] {len(rows)} rows in {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "depth": DEPTH, "rows": rows}, f, indent=1)
    return 0 if all(r.get("frames_equal", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
