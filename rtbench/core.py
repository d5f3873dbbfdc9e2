"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name from ``BENCHMARK.json``:

* ``configs[].file`` — the configuration (``rtbench/configs/<name>.json``);
* ``rtbench/traffic/<traffic>.json`` — the traffic mix, whose ``kind``
  picks the generator in :data:`rtbench.drive.GENERATORS`;
* ``rtbench/metrics/<metric>.py`` — a per-layer metric's reader,
  ``read(ctx) -> float | None`` (None: nothing to read in this cell);
* ``rtbench/limits/<workload>.json`` — the cell's limit on each number
  the check compares.

The last line of standard output is the result's JSON object; the numbers
compared by the check are printed beside their limits as the last lines of
standard error and under the result's last key, ``checks``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rt_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"rtbench: no {what} named {name!r} in BENCHMARK.json")


def load_config(root: Path, entry: dict) -> dict:
    cfg = json.loads((root / entry["file"]).read_text())
    cfg["name"] = entry["name"]
    return cfg


def load_traffic(root: Path, name: str) -> dict:
    return json.loads((root / "rtbench" / "traffic" / f"{name}.json").read_text())


def load_limits(root: Path, cell: str) -> dict:
    return json.loads((root / "rtbench" / "limits" / f"{cell}.json").read_text())


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """``(benchmark, cell, configuration, traffic)`` of the cell named
    ``workload``."""
    bench = load_benchmark(root)
    cell = find(bench["workloads"], workload, "workload")
    config = load_config(root, find(bench["configs"], cell["config"], "configuration"))
    return bench, cell, config, load_traffic(root, cell["traffic"])


def load_reader(root: Path, metric: str):
    """The ``read`` function of ``rtbench/metrics/<metric>.py``."""
    path = root / "rtbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"rtbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that the cell reports: those listing it,
    or listing no cells, which every cell reports (a per-layer metric
    without a list is reported where its end-to-end metric is)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in list(modules)} & set(FORBIDDEN))


def refused_modules() -> bool:
    """Whether JAX or the JAX package is loaded; names what it found on
    standard error."""
    found = forbidden_modules()
    if found:
        print(f"rtbench: modules loaded that the run must not load: {', '.join(found)}",
              file=sys.stderr)
    return bool(found)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def rate_mrays(units: int, rays_per_unit: int, seconds: float) -> float:
    """Millions of rays a second: every unit completed in the window, over
    the whole window."""
    return units * rays_per_unit / seconds / 1e6


def p95(values) -> float:
    """The 95th percentile of all the values (nearest rank)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def idle_share(busy_ms_per_unit: float, wall_ms_per_unit: float) -> float:
    """Per cent of a unit's wall time in which the device ran nothing."""
    return 100.0 * (1.0 - busy_ms_per_unit / wall_ms_per_unit)


def end_to_end(names, gen, setup_s: float) -> dict:
    """The end-to-end metrics of a window."""
    out = {}
    done = len(gen.records)
    for n in names:
        if n == "setup_s":
            out[n] = setup_s
        elif n in ("frame_mrays_s", "train_mrays_s"):
            out[n] = rate_mrays(done, gen.rays_per_unit, gen.window_s)
        elif n == "frame_ms_p95":
            out[n] = 1e3 * p95([d - q for q, _, d in gen.records])
        else:
            raise SystemExit(f"rtbench: no end-to-end metric named {n!r}")
    return out


def result_line(correct, attempted, failed, metrics: dict, units: dict, device: dict,
                checks: list, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return json.dumps(out)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 rtbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t_start: float, *, root: Path = ROOT, device=None, chips_check=True,
        rank_entry=None) -> int:
    """One run; returns the exit code.  ``device`` and ``chips_check`` let
    the CPU tests drive a run without a card, ``rank_entry`` the function
    that the other ranks of a cell of several run (:mod:`rtbench.ranks`)."""
    args = parse(argv)
    bench, cell, config, traffic = load_cell(root, args.workload)
    world = None
    if traffic.get("ranks", 1) > 1:
        from .ranks import World

        # the other ranks import and set up while this one does
        world = World(traffic["ranks"], argv, root, "cuda" if chips_check else str(device),
                      rank_entry)
    try:
        return _run(args, t_start, root, bench, cell, config, traffic, device, chips_check,
                    world)
    finally:
        if world is not None:
            world.close()


def _run(args, t_start, root, bench, cell, config, traffic, device, chips_check, world) -> int:
    import torch

    from . import devtrace
    from .drive import GENERATORS

    t_imports = time.perf_counter()

    if chips_check:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"rtbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    gen = GENERATORS[traffic["kind"]](config, traffic, args.seed, device)
    gen.setup()
    gen.count_window(args.seconds)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    prev = t_imports
    phases = [f"imports {t_imports - t_start:.3f}"]
    for label, t in gen.marks:
        phases.append(f"{label} {t - prev:.3f}")
        prev = t
    print("rtbench: set-up s: " + ", ".join(phases), file=sys.stderr)

    gen.window(args.seconds)
    if refused_modules():
        return 3

    trace, traced_s = None, 0.0
    if args.trace:
        k = traffic["profile_units"]
        if on_card:
            trace, traced_s = devtrace.profile(lambda: gen.profiled(k), device, gen.meet)
        else:
            t0 = time.perf_counter()
            gen.profiled(k)
            traced_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    reports = gen.reports(peak, trace)
    gen.release()
    if world is not None and not world.join():
        print("rtbench: a rank did not end cleanly", file=sys.stderr)
        return 4
    rank_events = [devtrace.read_trace(r["trace"]) if r["trace"] else [] for r in reports]
    for r, rep in enumerate(reports):
        if rep["refused"]:
            print(f"rtbench: rank {r} loaded modules that the run must not load: "
                  f"{', '.join(rep['refused'])}", file=sys.stderr)
            return 3
    if len(reports) > 1:
        for r, rep in enumerate(reports):
            print(f"rtbench: rank {r}: {rep['units']} {gen.units_name}, first losses "
                  f"{rep['losses']!r}, peak {rep['peak']} bytes, parameter gap to rank 0 "
                  f"{rep['gap']!r}", file=sys.stderr)

    limits = load_limits(root, cell["name"])
    t_check = time.perf_counter()
    checks = [(name, value, limits[name]) for name, value in gen.check()]
    check_s = time.perf_counter() - t_check
    correct = all(value <= lim for _, value, lim in checks) and not gen.failed

    per_layer = cell_metrics(bench, cell["name"], "per_layer")
    e2e = cell_metrics(bench, cell["name"], "end_to_end")
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": max(r["peak"] for r in reports)}
    breakdown = None
    if args.trace:
        events = rank_events[0]
        dev["busy_s"] = sum(devtrace.union_us(devtrace.device_events(ev))
                            for ev in rank_events) / len(rank_events) * 1e-6
        dev["window_s"] = traced_s
        rank_work = gen.profiled_rank_work()
        csrc = devtrace.csrc_kernels()
        if len(rank_events) > 1:
            for r, ev in enumerate(rank_events):
                print(f"rtbench: rank {r} traced, device ms a {gen.units_name[:-1]}: "
                      + devtrace.split_ms(ev, csrc, traffic["profile_units"]), file=sys.stderr)
        ctx = types.SimpleNamespace(
            kind=gen.units_name, records=gen.records, window_s=gen.window_s,
            events=events, profiled=traffic["profile_units"],
            csrc=csrc, work=rank_work[0], rank_events=rank_events, rank_work=rank_work)
        print(f"rtbench: live work of {len(ctx.work)} profiled {gen.units_name} counted "
              f"in {time.perf_counter() - t_check - check_s:.3f} s", file=sys.stderr)
        metrics = {}
        for m in per_layer:
            value = load_reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = value
        units = {m["name"]: m["unit"] for m in per_layer}
        breakdown = devtrace.breakdown(events)
    else:
        metrics = end_to_end([m["name"] for m in e2e], gen, setup_s)
        units = {m["name"]: m["unit"] for m in e2e}

    if refused_modules():
        return 3
    print(f"rtbench: {cell['name']} seed {args.seed}: {len(gen.records)} {gen.units_name} "
          f"in {gen.window_s:.3f} s, set-up {setup_s:.3f} s, check {check_s:.3f} s",
          file=sys.stderr)
    for name, value, lim in checks:
        print(f"check {name} {value!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(correct, gen.attempted, gen.failed, metrics, units, dev, checks,
                      breakdown), flush=True)
    return 0


def main(argv=None, t_start: float = None) -> int:
    return run(sys.argv[1:] if argv is None else argv,
               time.perf_counter() if t_start is None else t_start)
