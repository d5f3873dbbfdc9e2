"""The traced part of a ``--trace 1`` run: a ``torch.profiler`` (CUPTI)
session over a few units of work, read back from its Chrome trace.

The session starts and ends on a synchronised device, so every device
event in it belongs to the profiled units.  The trace is written under
``TMPDIR`` (``tempfile``), read, and deleted.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")


def csrc_kernels(csrc: Path = None) -> frozenset:
    """The names of the ``__global__`` functions in the program's
    hand-written CUDA sources (``rt_tpu_torch/csrc/*.cu``), read from the
    sources, so that a kernel a later source adds is counted as the
    program's own."""
    if csrc is None:
        import rt_tpu_torch

        csrc = Path(rt_tpu_torch.__file__).resolve().parent / "csrc"
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    for path in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(path.read_text()))
    return frozenset(names)


def kernel_base(name: str) -> str:
    """A trace's kernel name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::
    blockwise_kernel<true, 1>(float const*, ...)`` -> ``blockwise_kernel``."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def profile(fn, device, ready=None) -> tuple[str, float]:
    """Run ``fn()`` under the profiler: ``(path, seconds)``, the path of
    the session's Chrome trace (a new file under ``TMPDIR``, which
    :func:`read_trace` deletes) and the session's host seconds, from after
    ``ready()`` (called once the session records) to the end of ``fn``'s
    work on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize(device)
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if ready is not None:
            ready()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="rtbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
    except BaseException:
        os.unlink(path)
        raise
    return path, seconds


def read_trace(path: str) -> list:
    """The complete events of the Chrome trace at ``path`` (dicts with
    ``cat``, ``name``, ``ts`` and ``dur`` in microseconds); deletes the
    file."""
    try:
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and "ts" in e]


def device_events(events) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def union_us(events) -> float:
    """Microseconds in which at least one of these events ran."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    total, end = 0.0, None
    start = None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def split_ms(events, csrc, units: int) -> str:
    """The device milliseconds a unit in the program's own kernels, in the
    collectives' (``nccl*``) and in the rest, and the busy union, as one
    line for the log."""
    own = comm = rest = 0.0
    dev = device_events(events)
    for e in dev:
        base = kernel_base(e["name"])
        if base in csrc:
            own += float(e["dur"])
        elif base.startswith("nccl"):
            comm += float(e["dur"])
        else:
            rest += float(e["dur"])
    return (f"own kernels {own / 1e3 / units:.3f}, nccl {comm / 1e3 / units:.3f}, "
            f"other {rest / 1e3 / units:.3f}, busy {union_us(dev) / 1e3 / units:.3f}")


def busy_gaps(events) -> list:
    """The idle gaps between the device's busy intervals: ``(start, end)``
    in microseconds."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def breakdown(events, limit: int = 10, width: int = 160) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the host operation that was running through each (the latest
    started host event that covers the gap's middle), in seconds; names cut
    to ``width`` characters."""
    dev = device_events(events)
    by_name = {}
    for e in dev:
        key = e["name"][:width]
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    gaps = sorted(busy_gaps(dev), key=lambda g: g[0] - g[1])[:limit]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = (max(cover, key=lambda e: float(e["ts"]))["name"][:width] if cover
                 else "(no host event)")
        named.append([label, (b - a) * 1e-6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
