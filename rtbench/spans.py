"""The program's own spans in a profiled trace: ``rt_tpu_torch``'s ``rt.*``
``record_function`` events (category ``user_annotation``, on the host
thread that opened them), on the clock of the device events beside them.

A trace of a program without such spans yields none, and the readers that
use them return None.
"""

from __future__ import annotations

from rtbench.devtrace import device_events


def host_spans(events, name: str) -> list:
    """The host spans named ``name`` or ``name/<suffix>``: ``(start, end,
    pid, tid)`` in microseconds, by start."""
    prefix = name + "/"
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("pid"), e.get("tid"))
                  for e in events if e.get("cat") == "user_annotation"
                  and (e["name"] == name or e["name"].startswith(prefix)))


def covered_us(intervals, start: float, end: float) -> float:
    """Microseconds of ``[start, end]`` that the union of ``intervals``
    (``(a, b)`` pairs) covers."""
    total, reach = 0.0, start
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, end)
        if b > a:
            total += b - a
            reach = b
    return total


def device_idle_in_spans_us(events, name: str) -> list:
    """Per host span named ``name`` (:func:`host_spans`), the microseconds
    of it in which the device ran nothing: its length less the union of
    device activity clipped to it."""
    busy = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device_events(events)]
    return [(b - a) - covered_us(busy, a, b) for a, b, _, _ in host_spans(events, name)]
