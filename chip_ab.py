#!/usr/bin/env python3
"""Times the port's forward kernels as built from several source trees, in
interleaved windows on one CUDA card.

    python3 chip_ab.py --tree parent=OTHER_CHECKOUT/rt_tpu_torch/csrc \
        [--tree NAME=CSRC_DIR ...] [--windows 7] [--out ab.json]

Each tree is a ``csrc`` directory holding ``render_kernel.cu`` and
``blockwise_kernel.cu`` with this tree's C interface (the one the wrappers
of ``rt_tpu_torch.ops.render`` and ``ops.blockwise`` bind).  This tree's
own ``csrc`` is always the first, as ``this``.  Every tree's library is
built with ``_build.NVCC_FLAGS`` into a temporary directory, and the script
prints per tree and kernel nvcc's register and spill report, the counts of
local-memory stores, loads and calls in the SASS (``cuobjdump``), whether
the output equals this tree's (``torch.equal``), and the milliseconds per
call (median of the windows; each window times ``iters`` back-to-back
calls with CUDA events, the trees' order reversed in every other window).
The shapes are those of ``PERF.md``'s kernel table: the render kernel on
basic.toml 800x600 4 spp depth 8, the blockwise kernel on 500 procedural
spheres at 320x180 4 spp and on the config-5 slice (5000 spheres, 960x540,
2 spp), depth 8.  The last line of standard output is one JSON object with
every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {"render_kernel": "rt_render_forward", "blockwise_kernel": "rt_blockwise_forward"}


def build(csrc: Path, name: str, out_dir: Path, nvcc: str, flags) -> tuple[Path, list[str]]:
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(csrc / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return lib, report


def sass_counts(lib: Path, cuobjdump: Path) -> dict:
    if not cuobjdump.exists():
        return {}
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("STL", "LDL", "CALL")}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=CSRC_DIR")
    ap.add_argument("--windows", type=int, default=7)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_ab: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import rt_tpu_torch
    from rt_tpu_torch.ops import _build
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import render as R

    trees = {"this": _build.CSRC_DIR}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # the wrappers' own bindings give the argument types
    modules = {"render_kernel": R, "blockwise_kernel": BW}
    argtypes = {k: m._kernel().argtypes for k, m in modules.items()}
    nvcc = _build._nvcc()
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "build": {},
              "cases": {}}
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for t, csrc in trees.items():
            out_dir = Path(tmp) / t
            out_dir.mkdir()
            for k, sym in KERNELS.items():
                lib, report = build(csrc, k, out_dir, nvcc, _build.NVCC_FLAGS)
                fn = getattr(ctypes.CDLL(str(lib)), sym)
                fn.argtypes, fn.restype = argtypes[k], ctypes.c_int
                fns[t, k] = fn
                result["build"][f"{t}/{k}"] = {"ptxas": report,
                                               "sass": sass_counts(lib, cuobjdump)}
                print(f"{t}/{k}: {report} sass {result['build'][f'{t}/{k}']['sass']}",
                      flush=True)

        dev = torch.device("cuda")
        seeds = torch.tensor([11], dtype=torch.int32, device=dev)
        basic = rt_tpu_torch.load(str(ROOT / "scenes" / "basic.toml"))

        def render_args(scene, size):
            s_cols, p_cols = R._flatten_primitives(scene, "mg")
            tabs = [torch.from_numpy(c.T.copy()).to(dev) for c in (s_cols, p_cols)]
            tabs.append(torch.zeros((0, 12), dtype=torch.float32, device=dev))
            return (*tabs, torch.from_numpy(R._pack_camera(scene.camera, size)).to(dev), seeds)

        def bw_args(scene, size):
            tables = BW._device_tables(scene, "mg", False, dev)
            return (*tables, torch.from_numpy(R._pack_camera(scene.camera, size)).to(dev),
                    seeds)

        cases = [  # name, kernel, wrapper, args, keywords, calls per window
            ("render_kernel basic 800x600 4spp d8", "render_kernel", R.render_tile,
             render_args(basic, (800, 600)), dict(size=(800, 600), spp=4), 64),
            ("blockwise_kernel proc500 320x180 4spp d8", "blockwise_kernel",
             BW.render_blockwise_tile,
             bw_args(rt_tpu_torch.scene.make_procedural_scene(500), (320, 180)),
             dict(size=(320, 180), spp=4), 16),
            ("blockwise_kernel proc5000 960x540 2spp d8", "blockwise_kernel",
             BW.render_blockwise_tile,
             bw_args(rt_tpu_torch.scene.make_procedural_scene(5000), (960, 540)),
             dict(size=(960, 540), spp=2), 2),
        ]
        names = list(trees)
        for label, k, wrapper, a, kw, iters in cases:
            mod = modules[k]
            own = mod._kernel
            kw = dict(kw, max_bounces=8, center_sample=True)

            def run(t, n):
                mod._kernel = lambda: fns[t, k]
                out = None
                for _ in range(n):
                    out = wrapper(*a, **kw)
                return out

            ref = run("this", 1)
            torch.cuda.synchronize()
            equal = {}
            for t in names:
                equal[t] = bool(torch.equal(run(t, 1), ref))
            ms = {t: [] for t in names}
            for w in range(args.windows + 1):
                for t in (names if w % 2 == 0 else names[::-1]):
                    run(t, 1)
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    start.record()
                    run(t, iters)
                    end.record()
                    end.synchronize()
                    if w > 0:  # the first window warms up
                        ms[t].append(start.elapsed_time(end) / iters)
            mod._kernel = own
            row = {t: {"ms": statistics.median(v), "windows_ms": v, "equal_to_this": equal[t]}
                   for t, v in ms.items()}
            for t in names:
                row[t]["over_this"] = row[t]["ms"] / row["this"]["ms"]
            result["cases"][label] = row
            print(f"{label}: " + "; ".join(
                f"{t} {r['ms']:.4f} ms ({r['over_this']:.4f} of this, windows "
                f"{min(r['windows_ms']):.4f}-{max(r['windows_ms']):.4f}, equal {r['equal_to_this']})"
                for t, r in row.items()) + f" | {card}", flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if all(r["equal_to_this"] for c in result["cases"].values()
                    for r in c.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
