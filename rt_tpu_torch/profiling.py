"""Timing on the card, render timers, traces and counters (port of
``rt_tpu.profiling``).

:func:`sustained` is the one measurement every published number of the
port uses: the median over windows of many back-to-back calls, timed with
CUDA events on the current stream.  A window is the steady serving shape
(the host enqueues while the card works), so a step's time includes any
launch gaps the host leaves.  :func:`interleaved` runs the windows of
several steps round-robin, so that the ratios of their medians compare
one state of the card.  There is no CPU fallback: a time measured here is
a device time or nothing.

:class:`RenderTimer` times one render on the host's clock (waiting for the
device of its result) into :data:`counters`; :func:`trace` records a
``torch.profiler`` Chrome trace around a block.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import warnings

import torch

__all__ = ["RenderTimer", "trace", "counters", "mrays_per_sec", "sustained", "interleaved",
           "device_times"]

counters: dict[str, float] = {}

# Why a profiler session on the card can come back without device events.
# On an H100 with torch 2.11, one process ran sessions of 10,000, 100,000
# and 300,000 kernels: a frame's trace of 5 device events held 3 after the
# second and none after the third (``chip_smoke.py --profiler-probe``); a
# fresh process records them all.
LOST_EVENTS = ("once this process's profiler sessions have recorded a few hundred thousand "
               "kernels, the profiler records no device event; trace in a fresh process")


def _summary(ws: list[float]) -> dict:
    ws = sorted(ws)
    return {"median": ws[len(ws) // 2], "min": ws[0], "max": ws[-1], "windows": ws}


def _interleaved(steps, iters: int, windows: int, warmup_windows: int, *, clock, elapsed,
                 sync) -> list[dict]:
    """The round-robin schedule of :func:`interleaved` on any clock: one
    call ``fn(0)`` of each step, ``sync()``, then ``warmup_windows``
    discarded and ``windows`` kept rounds, each a window of every step in
    turn.  A window is ``t0 = clock()``, ``n`` calls ``fn(0..n-1)``, ``t1 =
    clock()``, and lasts ``elapsed(t0, t1)`` seconds (``elapsed`` waits
    for ``t1``)."""
    norm = [(s, iters) if callable(s) else tuple(s) for s in steps]
    for fn, _ in norm:
        fn(0)
    sync()

    def window(fn, n):
        t0 = clock()
        for i in range(n):
            fn(i)
        return elapsed(t0, clock()) / n

    for _ in range(warmup_windows):
        for fn, n in norm:
            window(fn, n)
    ws: list[list[float]] = [[] for _ in norm]
    for _ in range(windows):
        for k, (fn, n) in enumerate(norm):
            ws[k].append(window(fn, n))
    return [_summary(w) for w in ws]


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _event_seconds(start, end) -> float:
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def interleaved(steps, iters: int = 32, windows: int = 9, warmup_windows: int = 1) -> list[dict]:
    """Same-card-state ratio measurement: N steps, round-robin windows.

    The card's rate drifts within a session; alternating the windows
    samples the same state for every step, so the ratios between the
    returned medians can be trusted (bench.py's ``ratio_step_over_fwd``).

    ``steps``: a list of ``fn(i)`` callables, or ``(fn, iters)`` pairs when
    a slow step needs a smaller window.  Returns one dict per step,
    per-call seconds: ``{"median", "min", "max", "windows"}`` over its
    ``windows`` windows, each timed with CUDA events on the current stream.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("interleaved() times the CUDA device; none is available")
    return _interleaved(steps, iters, windows, warmup_windows, clock=_event,
                        elapsed=_event_seconds, sync=torch.cuda.synchronize)


def sustained(step, iters: int = 32, windows: int = 5, warmup_windows: int = 1) -> dict:
    """Run ``step(i)`` in ``windows`` windows of ``iters`` calls each, after
    one blocking call and ``warmup_windows`` discarded windows.

    Returns per-call seconds: ``{"median", "min", "max", "windows"}``.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("sustained() times the CUDA device; none is available")
    return _interleaved([step], iters, windows, warmup_windows, clock=_event,
                        elapsed=_event_seconds, sync=torch.cuda.synchronize)[0]


def device_times(step, iters: int = 20) -> dict:
    """Where a call's device time goes: a ``torch.profiler`` (CUPTI) trace
    of ``iters`` calls of ``step(i)``, after one warm-up call.

    Returns ``{kernel or copy name: device ms per call}``.  Tracing slows
    the host's launches, so divide the summed device time by an untraced
    :func:`sustained` time, not by the traced window, to get the share of
    a step the card is busy.  Raises ``RuntimeError`` when the session
    recorded no device event: once a process's sessions have recorded a
    few hundred thousand kernels, the profiler records none in its later
    sessions (:data:`LOST_EVENTS`).
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
    if not ms:
        raise RuntimeError(f"device_times(): the profiler recorded no device event; "
                           f"{LOST_EVENTS}")
    return ms


def mrays_per_sec(size: tuple[int, int], spp: int, seconds: float) -> float:
    """Camera rays per second in millions (rays = W*H*spp)."""
    w, h = size
    return w * h * spp / seconds / 1e6


def _sync_result(result) -> None:
    """Wait for the device of every CUDA tensor in ``result`` (a tensor,
    or tuples, lists and dicts of them); CPU tensors need no wait."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, (tuple, list)):
        for r in result:
            _sync_result(r)
    elif isinstance(result, dict):
        for r in result.values():
            _sync_result(r)


class RenderTimer:
    """Context manager timing a render; waits for the result's device.

    >>> with RenderTimer((800, 600), spp=4) as t:
    ...     img = render(...)
    ...     t.result = img
    >>> t.mrays

    On exit it sets ``counters[f"{name}.seconds"]`` and
    ``counters[f"{name}.mrays"]``.
    """

    def __init__(self, size: tuple[int, int], spp: int, name: str = "render"):
        self.size = size
        self.spp = spp
        self.name = name
        self.result = None
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.result is not None:
            _sync_result(self.result)
        self.seconds = time.perf_counter() - self._t0
        counters[f"{self.name}.seconds"] = self.seconds
        counters[f"{self.name}.mrays"] = self.mrays
        return False

    @property
    def mrays(self) -> float:
        return mrays_per_sec(self.size, self.spp, max(self.seconds, 1e-12))


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace around a block: CPU activity
    always, CUDA activity when a card is present.  On exit the trace is
    written under ``log_dir`` (default ``rt_tpu_torch_trace`` in the
    temporary directory) as a Chrome trace (``trace_<pid>_<ns>.json``;
    open it in Perfetto or chrome://tracing), and
    ``counters["trace.device_events"]`` counts its device events.  A trace
    that asked for CUDA activity and holds no device event warns: either
    the block ran nothing on the card or the profiler lost its events
    (:data:`LOST_EVENTS`).
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "rt_tpu_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        n = _device_events(prof.events())
        counters["trace.device_events"] = n
        if cuda and n == 0:
            warnings.warn(f"{path}: CUDA activity was asked for but the trace holds no device "
                          f"event: the block ran nothing on the card, or {LOST_EVENTS}",
                          RuntimeWarning, stacklevel=3)


def _device_events(events) -> int:
    """The profiler events that ran on the card (kernels, copies, sets)."""
    return sum(e.device_type.name == "CUDA" for e in events)
