#!/usr/bin/env python3
"""Times the port's render, blockwise and gradient kernels as built from
several source trees, in interleaved windows on one CUDA card.

    python3 chip_ab.py --tree parent=OTHER_CHECKOUT/rt_tpu_torch/csrc \
        [--tree NAME=CSRC_DIR ...] [--ablate ABLATION=TREE ...] \
        [--windows 7] [--out ab.json]

Each tree is a ``csrc`` directory holding ``render_kernel.cu``,
``blockwise_kernel.cu``, ``grad_kernel.cu`` and ``bw_grad_kernel.cu`` with
this tree's C interface (the one the wrappers of ``rt_tpu_torch.ops.render``,
``ops.blockwise``, ``ops.grad`` and ``ops.blockwise_grad`` bind).  This
tree's own ``csrc`` is always the first, as ``this``.  ``--ablate
NAME=TREE`` adds a tree ``TREE-NAME`` made from a copy of TREE's ``csrc``
with the text edits of ``ABLATIONS[NAME]`` (each edit must match as often
as it says): ablation builds exist to split a kernel's time between its
parts or to try a variant, may give wrong results and are never kept.

Every tree's libraries are built with ``_build.NVCC_FLAGS`` into a
temporary directory, one nvcc per source, all at once.  The script prints
per tree and kernel nvcc's register and spill report, per kernel function
the counts of local-memory stores, loads and calls, shared-memory atomics
(and those that compile to a compare-and-swap loop), global reductions,
shuffles and matches in the SASS (``cuobjdump``), whether the output
agrees with this tree's, and the milliseconds per wrapper call (median of
the windows; each window times ``iters`` back-to-back calls with CUDA
events, the trees' order reversed in every other window, and the stream
held by a spin kernel while the host queues the window, so that the time
is the card's even where the wrapper's host work is longer).  Forward
kernels must equal this tree's output (``torch.equal``); gradient kernels,
which sum per-primitive gradients in a different order, must agree within
1e-5 of each entry's L1 (the sum of its per-(pixel, sample) contributions'
magnitudes, from the plain version's ``with_l1`` output).

The shapes are those of ``PERF.md``'s kernel table: the render kernel on
basic.toml 800x600 4 spp, the blockwise kernel on 500 procedural spheres
at 320x180 4 spp and on the config-5 slice (5000 spheres, 960x540, 2 spp),
the mono gradient kernel at the headline shape (basic.toml 800x600 4 spp),
the per-sample kernel at config 3's (dielectric.toml, sm, 800x600, one
sample) and the blockwise gradient kernel on 500 spheres at 320x180 (one
sample), all at depth 8.  The last line of standard output is one JSON
object with every number; the exit code is 1 if a tree that is not an
ablation disagrees with this tree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {"render_kernel": "rt_render_forward", "blockwise_kernel": "rt_blockwise_forward",
           "grad_kernel": "rt_grad_fused", "bw_grad_kernel": "rt_bw_grad"}
SASS_OPS = ("STL", "LDL", "CALL", "ATOMS", "CAST.SPIN", "REDG", "SHFL", "MATCH")
GRAD_TOL = 1e-5
HOLD_CYCLES = 100_000_000  # ~50 ms at the H100's 1.98 GHz

# Ablations of the gradient kernels: (file, pattern, replacement, matches).
# A value is kept alive by a store behind a test that never passes, so
# that the arithmetic feeding a removed sum still runs.
_NEVER = "1.2345e-37f"
ABLATIONS = {
    # the per-primitive sums of the mono and per-sample kernels (the warp
    # aggregation and the slot adds) removed
    "no_prim_sums": [
        ("grad_kernel.cu",
         r"warp_add_prim_grad<!kMono>\(g, acc_s, acc_p, A\.n_spheres, A\.n_planes\);",
         "if (g.key >= 0 && g.g[0] + g.g[1] + g.g[2] + g.g[3] + g.g[4] + g.g[5] + g.g[6] + g.g[7] "
         f"+ g.g[8] == {_NEVER}) acc_s[0] = g.g[0];", 1),
    ],
    # at least 6 blocks (24 warps) per SM for the mono and per-sample kernels
    "launch_bounds_6": [
        ("grad_kernel.cu", r"__launch_bounds__\(kThreads\) (mse_step_kernel|grad_kernel)\b",
         r"__launch_bounds__(kThreads, 6) \1", 2),
    ],
    # the per-sample kernel with a slot set per warp, as the mono kernel
    "per_sample_warp_slots": [
        ("grad_kernel.cu", r"const int n_sets = kMono \? kWarps : 1;", "const int n_sets = kWarps;",
         1),
        ("grad_kernel.cu", r"acc \+ \(kMono \? warp \* \(ns \+ np\) : 0\)",
         "acc + warp * (ns + np)", 1),
        ("grad_kernel.cu", r"warp_add_prim_grad<!kMono>", "warp_add_prim_grad<false>", 1),
        ("grad_kernel.cu", r"static_cast<size_t>\(mono \? kWarps : 1\)",
         "static_cast<size_t>(kWarps)", 1),
    ],
}


def ablate(src: Path, dst: Path, edits) -> None:
    shutil.copytree(src, dst)
    for name, pattern, repl, count in edits:
        path = dst / name
        text, n = re.subn(pattern, repl, path.read_text())
        if n != count:
            raise RuntimeError(f"ablation edit {pattern!r} matched {n} times in {path}, "
                               f"expected {count}")
        path.write_text(text)


def build(csrc: Path, name: str, out_dir: Path, nvcc: str, flags) -> tuple[Path, list[str]]:
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(csrc / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "entry function" in ln]
    return lib, report


def sass_counts(lib: Path, cuobjdump: Path) -> dict:
    """Per kernel function, the count of each of SASS_OPS."""
    if not cuobjdump.exists():
        return {}
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out = {}
    for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        short = re.findall(r"[A-Za-z]\w*?_kernel", fn)
        out[short[-1] if short else fn] = {
            op: len(re.findall(rf"\b{re.escape(op)}\b", body)) for op in SASS_OPS}
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=CSRC_DIR")
    ap.add_argument("--ablate", action="append", default=[], metavar="ABLATION=TREE",
                    help=f"one of {sorted(ABLATIONS)}, applied to a copy of TREE")
    ap.add_argument("--windows", type=int, default=7)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_ab: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import rt_tpu_torch
    from rt_tpu_torch.ops import _build
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import grad as G
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
    modules = {"render_kernel": R, "blockwise_kernel": BW, "grad_kernel": G,
               "bw_grad_kernel": BG}
    argtypes = {k: m._kernel().argtypes for k, m in modules.items()}
    nvcc = _build._nvcc()
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        ablations = set()
        for spec in args.ablate:
            name, _, base = spec.partition("=")
            if name not in ABLATIONS or base not in trees:
                raise ValueError(f"--ablate {spec}: unknown ablation or tree")
            tree = f"{base}-{name}"
            ablate(trees[base], Path(tmp) / f"src-{tree}", ABLATIONS[name])
            trees[tree] = Path(tmp) / f"src-{tree}"
            ablations.add(tree)
        result = {"card": card, "trees": {k: str(v) for k, v in trees.items()},
                  "ablations": sorted(ablations), "build": {}, "cases": {}}
        jobs = [(t, k) for t in trees for k in KERNELS]
        for t in trees:
            (Path(tmp) / t).mkdir()
        with ThreadPoolExecutor(len(jobs)) as ex:
            built = list(ex.map(lambda j: build(trees[j[0]], j[1], Path(tmp) / j[0], nvcc,
                                                _build.NVCC_FLAGS), jobs))
        for (t, k), (lib, report) in zip(jobs, built):
            fn = getattr(ctypes.CDLL(str(lib)), KERNELS[k])
            fn.argtypes, fn.restype = argtypes[k], ctypes.c_int
            fns[t, k] = fn
            result["build"][f"{t}/{k}"] = {"ptxas": report, "sass": sass_counts(lib, cuobjdump)}
            print(f"{t}/{k}: {report} sass {result['build'][f'{t}/{k}']['sass']}", flush=True)

        dev = torch.device("cuda")
        seeds = torch.tensor([11], dtype=torch.int32, device=dev)
        basic = rt_tpu_torch.load(str(ROOT / "scenes" / "basic.toml"))
        dielectric = rt_tpu_torch.load(str(ROOT / "scenes" / "dielectric.toml"))
        proc500 = rt_tpu_torch.scene.make_procedural_scene(500)

        def camera(scene, size):
            return torch.from_numpy(R._pack_camera(scene.camera, size)).to(dev)

        def render_args(scene, personality="mg"):
            s_cols, p_cols = R._flatten_primitives(scene, personality)
            return [torch.from_numpy(c.T.copy()).to(dev) for c in (s_cols, p_cols)]

        def bw_args(scene, size):
            return (*BW._device_tables(scene, "mg", False, dev), camera(scene, size), seeds)

        def pixels(size, scale=1.0):  # chip_smoke.grad_inputs' target
            w, h = size
            pix = np.random.default_rng(1).uniform(0.0, 0.5, (h, w, 3)).astype(np.float32)
            return torch.from_numpy(pix * np.float32(scale)).to(dev)

        hd = (800, 600)
        no_boxes = torch.zeros((0, 12), dtype=torch.float32, device=dev)
        mono_args = (*render_args(basic), camera(basic, hd),
                     torch.from_numpy(G._sample_seeds(11, 4)).to(dev), pixels(hd))
        ps_args = (*render_args(dielectric, "sm"), camera(dielectric, hd),
                   torch.from_numpy(G._sample_seeds(0, 2)[1:]).to(dev), pixels(hd, 1e-6))
        bw500 = BW._device_tables(proc500, "mg", False, dev)
        bwg_args = (bw500[0], bw500[1], bw500[3][:2], camera(proc500, (320, 180)), seeds,
                    torch.full((180, 320, 3), 1e-6, device=dev))
        d8 = dict(max_bounces=8)
        cases = [  # name, kernel, wrapper, args, keywords, calls per window, plain with L1
            ("render_kernel basic 800x600 4spp d8", "render_kernel", R.render_tile,
             (*render_args(basic), no_boxes, camera(basic, hd), seeds),
             dict(d8, size=hd, spp=4, center_sample=True), 64, None),
            ("blockwise_kernel proc500 320x180 4spp d8", "blockwise_kernel",
             BW.render_blockwise_tile, bw_args(proc500, (320, 180)),
             dict(d8, size=(320, 180), spp=4, center_sample=True), 16, None),
            ("blockwise_kernel proc5000 960x540 2spp d8", "blockwise_kernel",
             BW.render_blockwise_tile,
             bw_args(rt_tpu_torch.scene.make_procedural_scene(5000), (960, 540)),
             dict(d8, size=(960, 540), spp=2, center_sample=True), 2, None),
            ("mse_step_kernel basic 800x600 4spp d8", "grad_kernel", G.mse_step_tile, mono_args,
             dict(d8, size=hd), 32, G.mse_step_tile_plain),
            ("grad_kernel dielectric/sm 800x600 1 sample d8", "grad_kernel", G.grad_tile,
             ps_args, dict(d8, size=hd, center_sample=False), 64, G.grad_tile_plain),
            ("grad_kernel proc500 320x180 1 sample d8", "grad_kernel", G.grad_tile,
             (bw500[0][:500, :10].contiguous(), bw500[1][:0, :10].contiguous(),
              *bwg_args[3:]), dict(d8, size=(320, 180), center_sample=False), 32,
             G.grad_tile_plain),
            ("bw_grad_kernel proc500 320x180 1 sample d8", "bw_grad_kernel", BG.bw_grad_tile,
             bwg_args, dict(d8, size=(320, 180), center_sample=False), 32,
             BG.bw_grad_tile_plain),
        ]
        names = list(trees)
        for label, k, wrapper, a, kw, iters, plain in cases:
            mod = modules[k]
            own = mod._kernel

            def run(t, n):
                mod._kernel = lambda: fns[t, k]
                out = None
                for _ in range(n):
                    out = wrapper(*a, **kw)
                return out

            ref = run("this", 1)
            if plain is None:
                agree = lambda got: bool(torch.equal(got, ref))
            else:
                _, l1 = plain(*a, with_l1=True, **kw)
                agree = lambda got: all(
                    bool(((g.double() - r.double()).abs() <= GRAD_TOL * l.double()).all())
                    for g, r, l in zip(got, ref, l1))
            torch.cuda.synchronize()
            agrees = {t: agree(run(t, 1)) for t in names}
            ms = {t: [] for t in names}
            for w in range(args.windows + 1):
                for t in (names if w % 2 == 0 else names[::-1]):
                    run(t, 1)
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    # hold the stream while the host queues the window, so that
                    # the events time the card's work and not the host's launches
                    torch.cuda._sleep(HOLD_CYCLES)
                    start.record()
                    run(t, iters)
                    end.record()
                    end.synchronize()
                    if w > 0:  # the first window warms up
                        ms[t].append(start.elapsed_time(end) / iters)
            mod._kernel = own
            row = {t: {"ms": statistics.median(v), "windows_ms": v, "agrees_with_this": agrees[t]}
                   for t, v in ms.items()}
            for t in names:
                row[t]["over_this"] = row[t]["ms"] / row["this"]["ms"]
            result["cases"][label] = row
            print(f"{label}: " + "; ".join(
                f"{t} {r['ms']:.4f} ms ({r['over_this']:.4f} of this, windows "
                f"{min(r['windows_ms']):.4f}-{max(r['windows_ms']):.4f}, agrees "
                f"{r['agrees_with_this']})" for t, r in row.items()) + f" | {card}", flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if all(r["agrees_with_this"] for c in result["cases"].values()
                    for t, r in c.items() if t not in ablations) else 1


if __name__ == "__main__":
    sys.exit(main())
