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

:func:`span` marks the program's layer boundaries (``rt.frame/<n>``,
``rt.step/<n>``, ``rt.route/<route>``, ``rt.tables``, ``rt.upload``,
``rt.chunk/<i>``, ``rt.bounce/<b>``, ``rt.sort``, ``rt.assemble``, ``rt.forward``,
``rt.loss``, ``rt.reverse``) as ``torch.profiler.record_function`` events,
only while a profiler session records: any ``torch.profiler`` session,
:func:`trace` among them, puts them on the device trace's clock beside the
kernels they launch.  While a session records, the wavefront kernel's
wrapper also keeps each bounce's live-ray count, which :func:`live_rays`
reads into :data:`counters` (``wf.live_rays/<b>``) once the session has
stopped.  Neither adds device work inside the session.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["RenderTimer", "trace", "counters", "mrays_per_sec", "sustained", "interleaved",
           "device_times", "span", "recording", "live_rays"]

counters: dict[str, float] = {}


# ---------------------------------------------------------------------------
# spans and the live-ray counter
# ---------------------------------------------------------------------------

class _Off:
    """The span every site gets while no profiler session records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


OFF = _Off()
_root_calls = itertools.count(1)


def recording() -> bool:
    """Whether a ``torch.profiler`` session is recording in this process
    (the flag ``torch.profiler.profile`` sets on entry and clears on
    exit)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, suffix=None, *, root: bool = False):
    """The context of one span of the program: :data:`OFF`, shared by every
    site, while no profiler session records (a site then allocates nothing,
    reads no clock and formats no name); else
    ``torch.profiler.record_function`` named ``name``, ``name/<suffix>``,
    or, with ``root``, ``name/<n>``, n this process's sequence number of
    traced units, so that the spans of one frame or step share an
    identifier."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    if root:
        suffix = next(_root_calls)
    return torch.profiler.record_function(name if suffix is None else f"{name}/{suffix}")


_LIVE = "wf.live_rays/"
_live_pending: list = []   # (bounce, int or tensor whose sum is the count), not yet read
_live_read = False         # the tally was read: the next count starts a new one


def count_live(bounce: int, n) -> None:
    """Adds ``n`` live rays entering ``bounce`` to the counter: an int, or a
    tensor whose sum is the count (the wavefront kernel's (1,) live count
    on the card, the plain version's live mask), kept as it is and summed
    by :func:`live_rays`.  Call it only while :func:`recording`; the first
    count after a read starts a new tally."""
    if _live_read:
        _reset_live()
    _live_pending.append((bounce, n))


def _reset_live() -> None:
    global _live_read
    _live_pending.clear()
    for k in [k for k in counters if k.startswith(_LIVE)]:
        del counters[k]
    _live_read = False


def live_rays() -> tuple[int, ...]:
    """The live rays that entered each bounce (index b) of the wavefront
    frames and steps traced since the counts were last read, bounce 0
    counting the rays it generated; ``()`` if none ran.  Reads the kept
    device counts with one synchronisation a device, folds them into
    :data:`counters` (``wf.live_rays/<b>``) and keeps the result until a
    later traced bounce starts a new tally.  Raises while a profiler session
    records: the read would add device work to its trace."""
    global _live_read
    if recording():
        raise RuntimeError("live_rays(): read the counts after the profiler session stops")
    by_device: dict = {}
    for _, n in _live_pending:
        if isinstance(n, torch.Tensor):
            by_device.setdefault(n.device, []).append(n)
    values = {}
    for ts in by_device.values():
        sums = torch.stack([t.sum(dtype=torch.int64) for t in ts]).tolist()
        values.update((id(t), v) for t, v in zip(ts, sums))
    for b, n in _live_pending:
        key = f"{_LIVE}{b}"
        counters[key] = counters.get(key, 0) + (values[id(n)] if isinstance(n, torch.Tensor)
                                                else int(n))
    _live_pending.clear()
    _live_read = True
    bounces = [int(k[len(_LIVE):]) for k in counters if k.startswith(_LIVE)]
    return tuple(int(counters.get(f"{_LIVE}{b}", 0)) for b in range(max(bounces, default=-1) + 1))


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
        if _on_device(e) and total_us > 0:
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
    (:data:`LOST_EVENTS`).  The trace holds the program's spans
    (:func:`span`), and ``counters["wf.live_rays/<b>"]`` the block's
    live-ray counts (:func:`live_rays`).
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "rt_tpu_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    _reset_live()
    prof.start()
    try:
        yield log_dir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        live_rays()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        n = _device_events(prof.events())
        counters["trace.device_events"] = n
        if cuda and n == 0:
            warnings.warn(f"{path}: CUDA activity was asked for but the trace holds no device "
                          f"event: the block ran nothing on the card, or {LOST_EVENTS}",
                          RuntimeWarning, stacklevel=3)


def _on_device(e) -> bool:
    """Whether a profiler event ran on the card: a kernel, copy or set, and
    not the device-side range of a span (:func:`span`)."""
    return e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)


def _device_events(events) -> int:
    """The profiler events that ran on the card (kernels, copies, sets)."""
    return sum(_on_device(e) for e in events)
