#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (rt_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (an exception in any phase exits non-zero before the result line):

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles the CUDA kernel from rt_tpu_torch/csrc with nvcc.
3. Kernel against its plain PyTorch version, both on the card, at the
   shapes of the main path: basic.toml (mg), dielectric.toml (sm) and
   basic.toml plus a box (--boxes) at 800x600, 4 spp, 8 bounces, and the
   procedural 500-sphere scene at 320x180.  They must agree bit for bit.
4. Main path through the entry points, with the launch counter reset just
   before: the CLI renders basic.toml to a PNG, and make_render_step
   renders BASELINE config 4's shape (500 spheres, 1920x1080, 8 bounces)
   at 16 spp.  Checks that the kernel ran, the frames are finite and the
   PNG decodes to the kernel's own frame.
5. Timing: CUDA events around back-to-back calls
   (rt_tpu_torch.profiling.sustained) for the kernel, its plain version and
   make_render_step, and a profiler trace (profiling.device_times) for the
   kernel's device time and the card's busy share within a step.

The last two lines are the card line and {"ok": true, "device": ...};
the line before them is the per-kernel JSON summary, and the line before
that ("[report] ...") holds every number the run measured.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel vs plain version on the card: the tolerance is zero.  The kernel is
# built with --fmad=false and writes rsqrt as 1/sqrtf, and the plain version
# on CUDA rounds sqrt and division correctly, so every operation rounds once
# in the same order and the two agree bit for bit.  (The CPU parity tests
# against JAX allow 0.5% of pixels beyond 2e-5 instead, because XLA's CPU
# backend contracts FMAs and torch's CPU sqrt is not correctly rounded.)


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def png_rgba(path: Path):
    """Decode an 8-bit RGBA, non-interlaced PNG as written by
    rt_tpu_torch.image (every row uses filter 0)."""
    import numpy as np

    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        check(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body),
              "PNG chunk CRC mismatch")
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            check((depth, ctype) == (8, 6), "PNG is not 8-bit RGBA")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    check((rows[:, 0] == 0).all(), "unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 4)


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import rt_tpu_torch
    from rt_tpu_torch import profiling
    from rt_tpu_torch.cli import main as cli_main
    from rt_tpu_torch.colour import pack_rgba8888
    from rt_tpu_torch.ops import _build
    from rt_tpu_torch.ops import render as R

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report = {"card": card, "kind": kind}

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.build("render_kernel")
    build_s = time.perf_counter() - t0
    log(f"[2] build: {lib.name} in {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"    {ln}")
    report["build_s"] = build_s
    report["ptxas"] = ptxas

    # ---- 3. kernel against plain version, on the card ----
    scenes = {
        "basic": rt_tpu_torch.load(str(ROOT / "scenes" / "basic.toml")),
        "dielectric": rt_tpu_torch.load(str(ROOT / "scenes" / "dielectric.toml")),
        "basic+box": rt_tpu_torch.loads(
            (ROOT / "scenes" / "basic.toml").read_text()
            + "\nboxes = [ { material = 2, position = [-1, 0.5, 0.3], "
              "extents = [0.3, 0.5, 0.3] } ]\n"),
        "proc500": rt_tpu_torch.scene.make_procedural_scene(500),
    }

    def tile_args(scene, personality, size, include_boxes=False, seed=11):
        s_cols, p_cols = R._flatten_primitives(scene, personality)
        b_cols = (R._flatten_boxes(scene, personality) if include_boxes
                  else np.zeros((12, 0), np.float32))
        sp, pl, bx = (torch.from_numpy(np.ascontiguousarray(c.T)).to(dev)
                      for c in (s_cols, p_cols, b_cols))
        cam = torch.from_numpy(R._pack_camera(scene.camera, size)).to(dev)
        seeds = torch.tensor([seed], dtype=torch.int32, device=dev)
        return (sp, pl, bx, cam, seeds)

    cases = [
        ("basic/mg", "basic", "mg", (800, 600), False),
        ("dielectric/sm", "dielectric", "sm", (800, 600), False),
        ("basic+box/mg --boxes", "basic+box", "mg", (800, 600), True),
        ("proc500/mg", "proc500", "mg", (320, 180), False),
    ]
    max_err = 0.0
    report["parity"] = []
    for label, key, pers, size, boxes in cases:
        args = tile_args(scenes[key], pers, size, boxes)
        kw = dict(size=size, spp=4, max_bounces=8, center_sample=True)
        got = R.render_tile(*args, **kw)
        want = R.render_tile_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        px = diff.amax(dim=-1)
        row = {
            "case": label, "size": size, "max_abs": diff.max().item(),
            "mean_abs": diff.mean().item(),
            "share_gt_1e-3": (px > 1e-3).float().mean().item(),
            "exact_share": (px == 0).float().mean().item(),
        }
        report["parity"].append(row)
        log(f"[3] {label} {size[0]}x{size[1]} 4spp d8: max|d| {row['max_abs']:.3g} "
            f"mean|d| {row['mean_abs']:.3g} px>1e-3 {row['share_gt_1e-3']:.5f} "
            f"exact {row['exact_share']:.5f}")
        check(torch.isfinite(got).all().item(), f"{label}: kernel output not finite")
        check(torch.equal(got, want), f"{label}: kernel differs from its plain version")
        max_err = max(max_err, row["max_abs"])

    # ---- 4. main path through the entry points ----
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "basic.png"
        R.render_tile.launches = 0
        rc = cli_main(["--scene", str(ROOT / "scenes" / "basic.toml"), "--renderer", "mg_auto",
                       "--size", "800x600", "--spp", "4", "--bounces", "8",
                       "--device", "cuda", "--out", str(png)])
        step4 = R.make_render_step(scenes["proc500"], (1920, 1080), spp=16, max_bounces=8,
                                   device="cuda")
        frame4 = step4(seed=0)
        torch.cuda.synchronize()
        launches = R.render_tile.launches
        log(f"[4] main path: cli rc={rc}, config-4 step frame {tuple(frame4.shape)}; "
            f"render kernel launches: {launches}")
        check(rc == 0, f"cli exited with {rc}")
        check(launches == 1 + 4, f"{launches} kernel launches, expected one per sample chunk (5)")
        check(frame4.shape == (1080, 1920, 3) and torch.isfinite(frame4).all().item(),
              "config-4 frame has the wrong shape or is not finite")
        check(0.05 < frame4.mean().item() < 2.0, f"config-4 frame mean {frame4.mean().item()}")
        rgba = png_rgba(png)
        ref = R.render_forward(scenes["basic"], (800, 600), spp=4, max_bounces=8, device="cuda")
        check(rgba.shape == (600, 800, 4), f"PNG shape {rgba.shape}")
        words = pack_rgba8888(ref)
        np.testing.assert_array_equal(rgba[..., 0], (words >> 24) & 0xFF)
        np.testing.assert_array_equal(rgba[..., 1], (words >> 16) & 0xFF)
        np.testing.assert_array_equal(rgba[..., 2], (words >> 8) & 0xFF)
        log(f"[4] PNG {png.name} decodes to the kernel's frame ({rgba.shape[1]}x{rgba.shape[0]})")
        report["main_path"] = {"cli_rc": rc, "launches": launches,
                               "config4_mean": frame4.mean().item()}

    # ---- 5. timing (CUDA events; device time by kernel from the profiler) ----
    size = (800, 600)
    args = tile_args(scenes["basic"], "mg", size)
    kw = dict(size=size, spp=4, max_bounces=8, center_sample=True)
    step1 = R.make_render_step(scenes["basic"], size, spp=4, max_bounces=8, device="cuda")
    k_s = profiling.sustained(lambda i: R.render_tile(*args, **kw), iters=32)
    p_s = profiling.sustained(lambda i: R.render_tile_plain(*args, **kw), iters=4, windows=3)
    s_s = profiling.sustained(lambda i: step1(seed=i), iters=32)
    t4 = profiling.sustained(lambda i: step4(seed=i), iters=3, windows=3)
    d1 = profiling.device_times(lambda i: step1(seed=i), iters=20)
    d4 = profiling.device_times(lambda i: step4(seed=i), iters=3)

    def kernel_ms(d):
        return sum(v for k, v in d.items() if "render_kernel" in k)

    timing = {
        "basic_800x600_4spp_d8": {
            "kernel_ms": k_s["median"] * 1e3,
            "kernel_spread_ms": [k_s["min"] * 1e3, k_s["max"] * 1e3],
            "plain_ms": p_s["median"] * 1e3,
            "plain_spread_ms": [p_s["min"] * 1e3, p_s["max"] * 1e3],
            "step_ms": s_s["median"] * 1e3,
            "step_spread_ms": [s_s["min"] * 1e3, s_s["max"] * 1e3],
            "step_mrays_s": profiling.mrays_per_sec(size, 4, s_s["median"]),
            "step_device_ms": d1, "step_kernel_device_ms": kernel_ms(d1),
            "step_busy_share": sum(d1.values()) / (s_s["median"] * 1e3),
        },
        "config4_1920x1080_16spp_d8_500spheres": {
            "step_ms": t4["median"] * 1e3,
            "step_spread_ms": [t4["min"] * 1e3, t4["max"] * 1e3],
            "step_mrays_s": profiling.mrays_per_sec((1920, 1080), 16, t4["median"]),
            "step_device_ms": d4, "step_kernel_device_ms": kernel_ms(d4),
            "step_busy_share": sum(d4.values()) / (t4["median"] * 1e3),
        },
    }
    report["timing"] = timing
    b = timing["basic_800x600_4spp_d8"]
    c4 = timing["config4_1920x1080_16spp_d8_500spheres"]
    log(f"[5] basic 800x600 4spp d8: kernel {b['kernel_ms']:.4f} ms, plain {b['plain_ms']:.2f} ms; "
        f"make_render_step {b['step_ms']:.4f} ms = {b['step_mrays_s']:.1f} Mrays/s "
        f"(kernel {b['step_kernel_device_ms']:.4f} ms of device time, device busy "
        f"{b['step_busy_share']:.3f}) | {card}")
    log(f"[5] config 4 1920x1080 16spp d8 500 spheres: make_render_step {c4['step_ms']:.2f} ms "
        f"= {c4['step_mrays_s']:.1f} Mrays/s (kernel {c4['step_kernel_device_ms']:.2f} ms of "
        f"device time, device busy {c4['step_busy_share']:.3f}) | {card}")

    check("jax" not in sys.modules and "rt_tpu" not in sys.modules, "JAX was imported")
    log("[report] " + json.dumps(report))

    log(json.dumps({"kernels": [{
        "name": "render_kernel",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rt_tpu/ops/pallas_render.py:171",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": b["kernel_ms"],
        "plain_ms": b["plain_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
