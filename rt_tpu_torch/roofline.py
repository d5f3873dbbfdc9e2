"""Roofline numbers of the port on the card (port of ``tools/roofline.py``).

Run on a machine with a CUDA card::

    python -m rt_tpu_torch.roofline

It prints three things, each beside the card's name and power limit:

1. **The measured FP32 peak**: the chained-FMA kernel
   (``csrc/fma_peak_kernel.cu``, :func:`fma_peak`) timed with CUDA events at
   k = 1024 and 4096 FMAs per element, with the JAX probe's validity check:
   4x the chain must cost 2.5-6x the time, or the reading is launch
   overhead and not a peak.
2. **The scan rates of BASELINE config 5's slice** (5000 spheres, 960x540,
   2 spp, depth 8) through the port's blockwise and wavefront forward
   routes, timed in interleaved windows: primitive tests per second, and
   the blockwise scan's FLOP/s at ``SCAN_OPS_PER_TEST`` operations per
   (sphere, ray) test, against the measured peak.  The wavefront's rate
   counts live ray-bounces only: the per-bounce live fractions come from
   the blockwise record kernel's records on a 192x108 frame (bit 16, live
   in), where the JAX tool stepped its wavefront kernel.
3. The table of both.

It writes no file: ``docs/ROOFLINE.md`` holds the JAX package's TPU figures.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys

import numpy as np
import torch

__all__ = ["SCAN_OPS_PER_TEST", "fma_peak", "fma_peak_plain", "measure_fma_peak",
           "measure_scan_rates", "main"]

TILE = (256, 128)  # the TPU kernel's resident tile
TILES = 64         # its grid
SCAN_OPS_PER_TEST = 30  # counted from the lean sphere scan (tools/roofline.py:12-16)


def _chain_constants(x: torch.Tensor, tiles: int):
    f32 = torch.float32
    step = torch.arange(tiles, dtype=f32, device=x.device).reshape(tiles, 1, 1)
    a = x.unsqueeze(0) * (1.0 + step * torch.tensor(1e-9, dtype=f32))
    m1 = a * torch.tensor(0.4999999, dtype=f32) + 0.5
    m2 = a * torch.tensor(0.5000001, dtype=f32) + 0.5
    d = a * torch.tensor(1e-7, dtype=f32)
    return a, m1, m2, d


def _fma32(a, b, c):
    """float32 a*b + c with the product exact (float64) and one final
    rounding to float32 (after a float64 rounding of the sum)."""
    return (a.double() * b.double() + c.double()).float()


def fma_peak_plain(x: torch.Tensor, k_fma: int, tiles: int = TILES) -> torch.Tensor:
    """Plain PyTorch version of the probe, on the device of ``x`` ((256,
    128) float32): ``(tiles * 256, 128)`` float32."""
    a, m1, m2, d = _chain_constants(x, tiles)
    b, c = a, a + d
    for _ in range(k_fma // 2):
        b = _fma32(b, m1, d)
        c = _fma32(c, m2, -d)
    return (b + c).reshape(tiles * TILE[0], TILE[1])


@functools.cache
def _kernel():
    from .ops._build import load_library

    fn = load_library("fma_peak_kernel").rt_fma_peak
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def fma_peak(x: torch.Tensor, k_fma: int, tiles: int = TILES) -> torch.Tensor:
    """One launch of the probe kernel; arguments and result as
    :func:`fma_peak_plain`.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel on the current stream or raises."""
    if x.shape != TILE or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fma_peak: x must be a contiguous {TILE} float32 tensor")
    if k_fma < 2 or k_fma % 2 or tiles < 1:
        raise ValueError(f"fma_peak: bad k_fma={k_fma} or tiles={tiles}")
    if x.device.type == "cpu":
        return fma_peak_plain(x, k_fma, tiles)
    if x.device.type != "cuda":
        raise ValueError(f"fma_peak: no kernel for device {x.device}")
    out = torch.empty((tiles * TILE[0], TILE[1]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), out.data_ptr(), tiles, k_fma // 2,
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma peak kernel launch failed: CUDA error {err}")
    fma_peak.launches += 1
    return out


fma_peak.launches = 0


def _window_s(fn, iters: int) -> float:
    """Seconds per call of ``fn(i)`` over ``iters`` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def measure_fma_peak(k_fma: int = 4096, reps: int = 16, windows: int = 5):
    """``(TFLOP/s, seconds per launch)`` of the probe at ``k_fma`` FMAs per
    element: the median of ``windows`` CUDA-event windows of ``reps``
    launches, eight inputs in turn (as the JAX probe)."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_fma_peak times the CUDA device; none is available")
    xs = [torch.full(TILE, 1.0 + 1e-6 * i, dtype=torch.float32, device="cuda") for i in range(8)]
    fma_peak(xs[0], k_fma)
    torch.cuda.synchronize()
    dt = sorted(_window_s(lambda i: fma_peak(xs[i % 8], k_fma), reps)
                for _ in range(windows))[windows // 2]
    return 2.0 * k_fma * TILE[0] * TILE[1] * TILES / dt / 1e12, dt


def _live_profile(scene, depth: int, size=(192, 108)) -> np.ndarray:
    """Per-bounce live fraction of ``scene``: the share of a 1-spp frame's
    rays that are alive at each bounce's entry, from the blockwise record
    kernel's records."""
    from .ops.blockwise import render_record_blockwise

    _, recs = render_record_blockwise(scene, size, 3, max_bounces=depth, device="cuda")
    return ((recs["bits"] & 16) > 0).float().mean(dim=1).cpu().numpy()


def measure_scan_rates(windows: int = 5) -> dict:
    """The config-5 slice through the blockwise and the wavefront forward
    entry points in interleaved windows: the median frame times and the
    primitive-test rates (the wavefront's per live ray-bounce)."""
    from .ops.blockwise import render_forward_blockwise
    from .ops.tables import _bucket
    from .ops.wavefront import render_forward_wavefront
    from .scene import make_procedural_scene

    scene = make_procedural_scene(5000)
    size, spp, depth = (960, 540), 2, 8
    s_pad = _bucket(scene.spheres.count)

    def bw(i):
        return render_forward_blockwise(scene, size, seed=i, spp=spp, max_bounces=depth)

    def wf(i):
        return render_forward_wavefront(scene, size, seed=i, spp=spp, max_bounces=depth)

    bw(0), wf(0)
    torch.cuda.synchronize()
    t_bw, t_wf = [], []
    for _ in range(windows):
        t_bw.append(_window_s(bw, 2))
        t_wf.append(_window_s(wf, 3))
    t_bw, t_wf = sorted(t_bw)[windows // 2], sorted(t_wf)[windows // 2]
    rays = size[0] * size[1] * spp
    live = _live_profile(scene, depth)
    eff_depth = float(live.sum())
    rate_bw = rays * depth * s_pad / t_bw
    return {"bw_ms": t_bw * 1e3, "wf_ms": t_wf * 1e3, "bw_tests_s": rate_bw,
            "bw_flops_s": rate_bw * SCAN_OPS_PER_TEST, "live_fractions": live.tolist(),
            "live_depth": eff_depth, "wf_live_tests_s": rays * eff_depth * s_pad / t_wf,
            "bw_over_wf": t_bw / t_wf}


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("rt_tpu_torch.roofline: CUDA is not available", file=sys.stderr)
        return 1
    card = _card_line()
    tf_1k, dt_1k = measure_fma_peak(1024)
    tf_4k, dt_4k = measure_fma_peak(4096)
    scaling = dt_4k / dt_1k
    valid = 2.5 <= scaling <= 6.0
    print(f"FMA probe: k=1024 {tf_1k:.2f} TFLOP/s ({dt_1k * 1e3:.4f} ms), k=4096 "
          f"{tf_4k:.2f} TFLOP/s ({dt_4k * 1e3:.4f} ms), time scaling {scaling:.2f}x "
          f"({'valid' if valid else 'INVALID: not a peak'}) | {card}", flush=True)
    r = measure_scan_rates()
    share = f" = {r['bw_flops_s'] / (tf_4k * 1e12):.1%} of the measured peak" if valid else ""
    rows = [
        ("measured FP32 peak (chained FMA, k=4096)",
         f"{tf_4k:.2f} TFLOP/s ({'valid' if valid else 'invalid'}: 4x the chain took "
         f"{scaling:.2f}x the time)"),
        ("blockwise config-5 frame (5000 spheres 960x540 2spp d8)",
         f"{r['bw_ms']:.3f} ms, {r['bw_tests_s'] / 1e12:.4f} T prim-tests/s = "
         f"{r['bw_flops_s'] / 1e12:.2f} TFLOP/s at {SCAN_OPS_PER_TEST} ops/test{share}"),
        ("wavefront, same slice",
         f"{r['wf_ms']:.3f} ms, live-weighted depth {r['live_depth']:.3f}/8, "
         f"{r['wf_live_tests_s'] / 1e12:.4f} T live prim-tests/s"),
        ("blockwise / wavefront frame time (interleaved)", f"{r['bw_over_wf']:.3f}"),
    ]
    print(f"| quantity | value ({card}) |\n|---|---|")
    for k, v in rows:
        print(f"| {k} | {v} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
