"""Device milliseconds a profiled frame in the operations that the program's
``rt.sort`` spans launch (the wavefront's compaction sorts: the key, the
sort, the gathers of the state and ids, the live count), from the profiled
frames' CUPTI trace.

A device operation (kernel, copy or set) is matched to the host call that
launched it, a ``cuda_runtime`` event, by the trace's ``correlation`` id;
it counts where that call lies inside an ``rt.sort`` span, on the span's
own thread.  The operations' durations are summed, not the spans' wall
range, which holds host time."""

from rtbench.devtrace import device_events
from rtbench.spans import host_spans


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def read(ctx):
    if ctx.kind != "frames" or not ctx.events:
        return None
    spans = host_spans(ctx.events, "rt.sort")
    if not spans:
        return None
    by_thread = {}
    for a, b, pid, tid in spans:
        by_thread.setdefault((pid, tid), []).append((a, b))
    launched = set()
    for e in ctx.events:
        if e.get("cat") != "cuda_runtime" or _correlation(e) is None:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        if any(a <= t0 and t1 <= b for a, b in by_thread.get((e.get("pid"), e.get("tid")), ())):
            launched.add(_correlation(e))
    us = sum(float(e["dur"]) for e in device_events(ctx.events) if _correlation(e) in launched)
    return us / 1e3 / ctx.profiled
