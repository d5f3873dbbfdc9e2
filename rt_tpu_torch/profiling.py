"""Timing on the card (port of ``rt_tpu.profiling``'s measurement).

:func:`sustained` is the one measurement every published number of the
port uses: the median over windows of many back-to-back calls, timed with
CUDA events on the current stream.  A window is the steady serving shape
(the host enqueues while the card works), so a step's time includes any
launch gaps the host leaves.  There is no CPU fallback: a time measured
here is a device time or nothing.
"""

from __future__ import annotations

import torch

__all__ = ["sustained", "device_times", "mrays_per_sec"]


def sustained(step, iters: int = 32, windows: int = 5, warmup_windows: int = 1) -> dict:
    """Run ``step(i)`` in ``windows`` windows of ``iters`` calls each, after
    one blocking call and ``warmup_windows`` discarded windows.

    Returns per-call seconds: ``{"median", "min", "max", "windows"}``.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("sustained() times the CUDA device; none is available")
    step(0)
    torch.cuda.synchronize()
    ws = []
    for w in range(warmup_windows + windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            step(i)
        end.record()
        end.synchronize()
        if w >= warmup_windows:
            ws.append(start.elapsed_time(end) / 1e3 / iters)
    ws.sort()
    return {"median": ws[len(ws) // 2], "min": ws[0], "max": ws[-1], "windows": ws}


def device_times(step, iters: int = 20) -> dict:
    """Where a call's device time goes: a ``torch.profiler`` (CUPTI) trace
    of ``iters`` calls of ``step(i)``, after one warm-up call.

    Returns ``{kernel or copy name: device ms per call}``.  Tracing slows
    the host's launches, so divide the summed device time by an untraced
    :func:`sustained` time, not by the traced window, to get the share of
    a step the card is busy.
    """
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_times() traces the CUDA device; none is available")
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            step(i)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        total_us = getattr(e, "device_time_total", 0)
        if e.device_type.name == "CUDA" and total_us > 0:
            ms[e.key] = total_us / 1e3 / iters
    return ms


def mrays_per_sec(size: tuple[int, int], spp: int, seconds: float) -> float:
    """Camera rays per second in millions (rays = W*H*spp)."""
    w, h = size
    return w * h * spp / seconds / 1e6
