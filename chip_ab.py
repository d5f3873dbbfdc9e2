#!/usr/bin/env python3
"""Times the port's kernels as built from several source trees, and its
main paths as loaded from several checkouts, in interleaved windows on one
CUDA card.

    python3 chip_ab.py --tree parent=OTHER_CHECKOUT/rt_tpu_torch/csrc \
        [--tree NAME=CSRC_DIR ...] [--ablate ABLATION=TREE ...] \
        [--package parent=OTHER_CHECKOUT ...] [--only TEXT ...] [--sass DIR] \
        [--smoke NAME=CHECKOUT[+ABLATION] ...] [--windows 7] [--out ab.json]

Kernels.  Each tree is a ``csrc`` directory holding ``render_kernel.cu``,
``blockwise_kernel.cu``, ``grad_kernel.cu``, ``bw_grad_kernel.cu``,
``wavefront_kernel.cu``, ``wf_grad_kernel.cu`` and ``fma_peak_kernel.cu``
with the C interface that the wrappers of ``rt_tpu_torch.ops.render``,
``ops.blockwise``, ``ops.grad``, ``ops.blockwise_grad``, ``ops.wavefront``,
``ops.wavefront_grad`` and ``rt_tpu_torch.roofline`` bind.  A tree whose blockwise
library lacks ``rt_blockwise_forward_words`` has the older interface of
the blockwise gradient kernel (it scanned again instead of reading the
forward launch's winner words), and one whose wavefront library lacks
``rt_wf_split_lanes`` the older wavefront kernel (without the live count):
the cases that need the new interfaces skip such a tree, and
``--package`` compares those routes at the level of their steps and of
each wavefront launch instead.  This tree's own
``csrc`` is always the first, as ``this``.  ``--ablate NAME=TREE`` adds a
tree ``TREE-NAME`` made from a copy of TREE's ``csrc`` with the text edits
of ``ABLATIONS[NAME]`` (each edit must match as often as it says, or
one of the counts it names: the wavefront reverse's edits match the
parent's per-ray atomics or this tree's per-warp sums):
ablation builds exist to split a kernel's time between its parts or to
try a variant, may give wrong results and are never kept.

Every tree's libraries are built with ``_build.NVCC_FLAGS`` into a
temporary directory, one nvcc per source, all at once.  The script prints
per tree and kernel nvcc's register and spill report, per kernel function
its count of SASS instructions and the counts of local-memory stores,
loads and calls, shared-memory atomics (and those that compile to a
compare-and-swap loop), global reductions, shuffles, matches, MUFU
(square roots and reciprocals), device- and shared-memory loads and
branches in the SASS (``cuobjdump``; ``--sass DIR`` also writes the SASS
of the render and blockwise kernels, to read the instructions of one scan
row by hand), whether the output
agrees with this tree's, and the milliseconds per wrapper call (median of
the windows; each window times ``iters`` back-to-back calls with CUDA
events, the trees' order reversed in every other window, and the stream
held by a spin kernel while the host queues the window, so that the time
is the card's even where the wrapper's host work is longer), and beside
it the same calls' wall time without the hold (``wall``: the wrapper's
host work where that is the longer, as ``profiling.sustained`` and
``chip_smoke.py`` time a wrapper).  Forward
kernels must equal this tree's output (``torch.equal``); gradient kernels,
which sum per-primitive gradients in a different order, must agree within
1e-5 of each entry's L1 (the sum of its per-(pixel, sample) contributions'
magnitudes, from the plain version's ``with_l1`` output).

The kernel shapes are those of ``PERF.md``'s kernel table: the render
kernel on basic.toml 800x600 4 spp and on 500 procedural spheres at
1920x1080 4 spp (one launch of the config-4 frame); the blockwise kernel on
500 procedural spheres at 320x180 4 spp, at 1920x1080 1 sample (a config-4
train-step launch: the serving form, and the words form the step runs), on
1000 spheres at 1920x1080 4 spp (a chunk of the 1000-sphere frame) and on
the config-5 slice (5000 spheres, 960x540, 2 spp); the mono gradient kernel at
the headline shape (basic.toml 800x600 4 spp); the per-sample kernel at
config 3's (dielectric.toml, sm, 800x600, one sample) and on 500 spheres;
the blockwise gradient kernel on 500 spheres at 320x180 and at 1920x1080
(one sample, along its forward launch's words); the wavefront kernel on
the config-5 slice's 2-spp chunk, its bounce-0 launch and its bounces 1-7
(each launch on a copy of the table it entered, with its limit), and the
same chunk's reverse launches (``wf_rev``, into one set of float64
gradient tables): its bounce-0 launch (the gen kernel, on the cotangents
that the plain reverse of bounces 7-1 leaves) and its bounces 7-1; the
unrolled record kernel at the headline shape (basic.toml 800x600, one
sample: a launch of the headline records step); the blockwise record
kernel on the box scene (660 spheres, 24 boxes, 960x540, one sample) and
on 2100 spheres and 24 boxes (its rows from device memory); all at depth
8; and the FMA probe at k = 4096.

Main paths.  ``--package NAME=ROOT`` loads another checkout's
``ROOT/rt_tpu_torch`` beside this one (as the module
``rt_tpu_torch_NAME``; the package imports itself only relatively, and
builds its kernels into its own ``_build``), and times each package's
steps in interleaved windows (CUDA events around back-to-back calls, as
``profiling.sustained``; the order reversed in every other window): the
headline step (``make_mse_step``, basic.toml 800x600 4 spp), config 3's
step (dielectric.toml, sm, 64 spp), ``make_render_step`` on basic.toml
800x600 4 spp and at config 4's serving shape (500 spheres 1920x1080 16
spp), the config-4 train step (``train.make_kernel_train_step``, Adam on
the albedo), the 1000-sphere frame (``render_forward_blockwise``, 1920x1080
8 spp), on the config-5 slice the wavefront and blockwise frames and
the wavefront train step, and the box-scene records step
(``records_loss_and_grad``, 660 spheres + 24 boxes, 960x540, 2 spp); and,
per package, the device ms of each
launch of a config-5 2-spp record chunk (events around each launch, the
stream held while the host queues it), whose bounces 1-7 sum is printed.

Scripts.  ``--smoke NAME=CHECKOUT[+ABLATION]`` runs a checkout's whole
``chip_smoke.py`` from a copy (its ``csrc`` ablated, and its checks then
logged instead of raised) and reads the device ms per kernel of its
config-5 reverse chunk: the same launches timed inside another script.

The last line of standard output is one JSON object with every number;
the exit code is 1 if a tree that is not an ablation disagrees with this
tree.
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# per source: its C entry points (the first is the one every tree has)
KERNELS = {"render_kernel": ("rt_render_forward", "rt_render_record"),
           "blockwise_kernel": ("rt_blockwise_forward", "rt_blockwise_forward_words",
                                "rt_blockwise_record"),
           "grad_kernel": ("rt_grad_fused",), "bw_grad_kernel": ("rt_bw_grad",),
           "wavefront_kernel": ("rt_wf_bounce",), "wf_grad_kernel": ("rt_wf_rev",),
           "fma_peak_kernel": ("rt_fma_peak",)}
# the sources whose SASS --sass writes out (the scan's kernels)
SASS_SOURCES = ("render_kernel", "blockwise_kernel")
# entry points whose C signature changed in this tree, with the (library,
# symbol) that marks a tree built with the new one: the blockwise gradient
# kernel takes the forward launch's winner words, the wavefront kernel the
# live count
INTERFACE = {"rt_bw_grad": ("blockwise_kernel", "rt_blockwise_forward_words"),
             "rt_wf_bounce": ("wavefront_kernel", "rt_wf_split_lanes")}
SASS_OPS = ("STL", "LDL", "CALL", "ATOMS", "CAST.SPIN", "REDG", "SHFL", "MATCH", "MUFU", "LDG",
            "LDS", "BRA")
GRAD_TOL = 1e-5
HOLD_CYCLES = 100_000_000  # ~50 ms at the H100's 1.98 GHz

# Ablations: (file, pattern, replacement, matches).  A value is kept alive
# by a store behind a test that never passes, so that the arithmetic
# feeding a removed sum still runs.
_NEVER = "1.2345e-37f"
# the rejecting scan's row loop with one branch per row (scan_per_row)
_PER_ROW_SCAN = """#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float4 g = geo[i * kStep];
    const float rr = kGeo == kGeoHead16 ? g.w * g.w : g.w;
    const float ocx = ox - g.x, ocy = oy - g.y, ocz = oz - g.z;
    const float bq = ocx * dx + ocy * dy + ocz * dz;
    const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - rr;
    const float disc = bq * bq - c0;
    if (disc >= 0.0f) {
      const float sq = sqrtf(disc);
      const float t0 = -bq - sq;
      const float t1 = -bq + sq;
      const float t = t0 >= kMinHit ? t0 : t1;
      if (t >= kMinHit && (t < best || (t == best && kind == kPlane))) {
        best = t; kind = kSphere; win = i;
      }
    }
  }
"""
_REC_NO_WRITES = [
    ("trace.cuh", r"  P\.jitter\[pix\] = jx;\n  P\.jitter\[n \+ pix\] = jy;\n", "", 1),
    ("trace.cuh", r"    P\.kind\[o\] = rec\.kind;\n.*?    P\.coin\[o\] = rec\.coin;\n",
     "    if ((rec.kind ^ rec.idx ^ rec.bits) == 0x7fffffff && rec.ux + rec.uy + rec.uz + rec.coin "
     f"== {_NEVER}) P.kind[o] = rec.kind;\n", 1),
]
_PRIM_GRAD_KEPT = ("if (g.key >= 0 && g.g[0] + g.g[1] + g.g[2] + g.g[3] + g.g[4] + g.g[5] + g.g[6] "
                   f"+ g.g[7] + g.g[8] == {_NEVER}) A.sg[0] = g.g[0];")
_CAM_KEPT = f"for (int i = 0; i < kCam; ++i) if (cam_acc[i] == {_NEVER}) A.cg[i] = cam_acc[i];"
# The wavefront reverse's edits match its first form (one float64 atomic
# per slot per ray, the camera by block_sum trees) or its per-warp form,
# whichever the tree holds.
_WF_REV_NO_ATOMICS = [
    ("wf_grad_kernel.cu",
     r"add_prim_grad\(bounce_adjoint<kCols>\((.*?)\),\s*A\.sg, A\.pg, A\.n_spheres, "
     r"A\.n_planes\);", r"const PrimGrad g = bounce_adjoint<kCols>(\1); " + _PRIM_GRAD_KEPT,
     (0, 1)),
    ("wf_grad_kernel.cu", r"warp_add_prim_grad<true>\(g, A\.sg, A\.pg, A\.n_spheres, A\.n_planes\);",
     _PRIM_GRAD_KEPT, (0, 2)),
]
_WF_REV_NO_CAM = [
    ("wf_grad_kernel.cu",
     r"  for \(int i = 0; i < kCam; \+\+i\) \{\n    const float c = block_sum\(red, "
     r"cam_acc\[i\]\);\n.*?\n  \}\n", f"  {_CAM_KEPT}\n", (0, 1)),
    ("wf_grad_kernel.cu", r"block_add_cam\(red, cam_acc, A\.cg\);", _CAM_KEPT, (0, 1)),
]
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
    # the blockwise gradient kernel's per-row sums (the warp aggregation and
    # the leaders' float64 atomics) removed
    "bw_no_prim_sums": [
        ("bw_grad_kernel.cu",
         r"warp_add_prim_grad<true>\(g, A\.sg, A\.pg, A\.n_spheres, A\.n_planes\);",
         "if (g.key >= 0 && g.g[0] + g.g[1] + g.g[2] + g.g[3] + g.g[4] + g.g[5] + g.g[6] + g.g[7] "
         f"+ g.g[8] == {_NEVER}) A.sg[0] = g.g[0];", 1),
    ],
    # the blockwise gradient kernel's camera sums (warp, block and the
    # float64 atomics) removed
    "bw_no_cam_sums": [
        ("bw_grad_kernel.cu", r"block_add_cam\(red, cam_acc, A\.cg\);", _CAM_KEPT, 1),
    ],
    # the blockwise gradient kernel without its launch bound (ptxas picks
    # the registers)
    "bw_launch_bounds_free": [
        ("bw_grad_kernel.cu", r"__launch_bounds__\(kThreads, 4\) bw_grad_kernel",
         "__launch_bounds__(kThreads) bw_grad_kernel", 1),
    ],
    # the wavefront kernel's later bounces on one lane per ray (its
    # persistent grid kept): what the split scan buys
    "wf_one_lane": [
        ("wavefront_kernel.cu", r"const int G = split_lanes\(live, threads\);",
         "const int G = 1;", 1),
    ],
    # the rejecting scan with one branch per row (its first form): the
    # row loop unrolled by 4, each row's root work behind its own disc >= 0
    "scan_per_row": [
        ("trace.cuh", r"  int i = 0;\n  for \(; i \+ kRejectGroup <= n; i \+= kRejectGroup\) \{"
         r".*?\n  \}\n  for \(; i < n; \+\+i\) \{.*?\n  \}\n",
         _PER_ROW_SCAN, 1),
    ],
    # the rejecting scan's branch per group of 2, 4, 8 or 12 rows instead
    # of 16
    **{f"scan_group_{g}": [("trace.cuh", r"constexpr int kRejectGroup = 16;",
                            f"constexpr int kRejectGroup = {g};", 1)] for g in (2, 4, 8, 12)},
    # the group's branch on the lane's own rows instead of a warp vote (a
    # divergent branch, with its reconvergence barrier)
    "scan_no_vote": [("trace.cuh", r"if \(__any_sync\(__activemask\(\), any\)\) \{", "if (any) {", 1)],

    # the blockwise and blockwise record kernels' rows read from device
    # memory at every size: what staging them in shared memory buys
    "bw_no_stage": [("blockwise_kernel.cu", r"bool staged\(int n_spheres\) \{ return n_spheres <= "
                     r"kStageRows; \}", "bool staged(int n_spheres) { return false; }", 1)],
    # the record kernels' seven record stores per bounce and their jitter
    # stores removed (the radiance still written), each value kept alive
    "rec_no_writes": _REC_NO_WRITES,
    # the record form's table-row scan without its root work (sqrtf, the
    # roots and the select): t0 = t = -bq
    "rec_no_scan_root": [
        ("trace.cuh", r"      const float sq = sqrtf\(fmaxf\(disc, 0\.0f\)\);\n"
         r"      const float t0 = -bq - sq;\n      const float t1 = -bq \+ sq;\n"
         r"      const float t = t0 >= kMinHit \? t0 : t1;",
         "      const float t0 = -bq;\n      const float t = t0;", 1),
    ],
    # the wavefront reverse's per-row sums removed (the per-ray float64
    # atomics, or the per-warp sums and their leaders' atomics), the
    # PrimGrad kept alive
    "wf_rev_no_atomics": _WF_REV_NO_ATOMICS,
    # the gen launch's camera sums (block_sum trees or shuffles, and their
    # float64 atomics) removed
    "wf_rev_no_cam": _WF_REV_NO_CAM,
    "wf_rev_no_atomics_cam": _WF_REV_NO_ATOMICS + _WF_REV_NO_CAM,
    # the later reverse launches' cotangents read and written at the ray's
    # slot in the sorted table instead of its id: coalesced, wrong; what the
    # scattered cot[id] accesses cost
    "wf_rev_cot_coalesced": [("wf_grad_kernel.cu", r"float\* cot = A\.cot \+ id;",
                              "float* cot = A.cot + j;", 1)],
}


def ablate(src: Path, dst: Path, edits) -> None:
    """A copy of ``src`` at ``dst`` with ``edits`` applied; an edit's count
    is how often it must match, or a tuple of the counts it may match (an
    edit for one form of a kernel), and the copy must differ from src."""
    shutil.copytree(src, dst)
    changed = 0
    for name, pattern, repl, count in edits:
        path = dst / name
        text, n = re.subn(pattern, repl, path.read_text(), flags=re.S)
        if n not in (count if isinstance(count, tuple) else (count,)):
            raise RuntimeError(f"ablation edit {pattern!r} matched {n} times in {path}, "
                               f"expected {count}")
        changed += n
        path.write_text(text)
    if not changed:
        raise RuntimeError(f"no ablation edit matched in {dst}")


def build(csrc: Path, name: str, out_dir: Path, nvcc: str, flags) -> tuple[Path, list[str]]:
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(csrc / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{proc.stderr}")
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "entry function" in ln]
    return lib, report


def sass_counts(lib: Path, cuobjdump: Path, dump: Path | None = None) -> dict:
    """Per kernel function (a template's instances apart), the count of its
    instructions and of each of SASS_OPS; ``dump``: a file to write the
    SASS to."""
    if not cuobjdump.exists():
        return {}
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(sass)
    out = {}
    for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        counts = {"instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", body))}
        counts.update({op: len(re.findall(rf"\b{re.escape(op)}\b", body)) for op in SASS_OPS})
        out[kernel_name(fn)] = counts
    return out


def kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled symbol (the last length-prefixed
    identifier ending in ``_kernel``), with its template arguments on bools
    and ints (``<1,2>``)."""
    name = mangled
    for m in re.finditer(r"_kernel", mangled):
        end = m.end()
        for start in range(end - len("_kernel"), 0, -1):
            digits = str(end - start)
            if mangled[start - len(digits):start] == digits and mangled[start].isalpha():
                args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[end:])
                name = mangled[start:end] + (
                    "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1))) + ">"
                    if args else "")
                break
    return name


def load_package(name: str, root: Path):
    """Another checkout's ``rt_tpu_torch`` as the module
    ``rt_tpu_torch_<name>``."""
    import importlib.util

    pkg = root / "rt_tpu_torch"
    spec = importlib.util.spec_from_file_location(f"rt_tpu_torch_{name}", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def hold():
    """Holds the current stream (a spin kernel) while the host queues work."""
    import torch

    torch.cuda._sleep(HOLD_CYCLES)


def kernel_cases(trees, fns, windows, result, ablations, card, only=()):
    """The per-kernel A/B (see the module note); ``only``: label filters."""
    import numpy as np
    import torch

    import rt_tpu_torch
    from rt_tpu_torch import roofline
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R
    from rt_tpu_torch.ops import wavefront as WF
    from rt_tpu_torch.ops import wavefront_grad as WG

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_common import box_scene_toml

    # (module, attribute) that each C entry point is bound through
    binds = {"rt_render_forward": (R, "_kernel"), "rt_render_record": (R, "_record_kernel"),
             "rt_blockwise_forward": (BW, "_kernel"),
             "rt_blockwise_forward_words": (BW, "_words_kernel"),
             "rt_blockwise_record": (BW, "_record_kernel"),
             "rt_grad_fused": (G, "_kernel"), "rt_bw_grad": (BG, "_kernel"),
             "rt_wf_bounce": (WF, "_kernel"), "rt_wf_rev": (WG, "_kernel"),
             "rt_fma_peak": (roofline, "_kernel")}
    dev = torch.device("cuda")
    seeds = torch.tensor([11], dtype=torch.int32, device=dev)
    basic = rt_tpu_torch.load(str(ROOT / "scenes" / "basic.toml"))
    dielectric = rt_tpu_torch.load(str(ROOT / "scenes" / "dielectric.toml"))
    proc500 = rt_tpu_torch.scene.make_procedural_scene(500)
    proc5000 = rt_tpu_torch.scene.make_procedural_scene(5000)

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

    hd, fhd, small = (800, 600), (1920, 1080), (320, 180)
    no_boxes = torch.zeros((0, 12), dtype=torch.float32, device=dev)
    mono_args = (*render_args(basic), camera(basic, hd),
                 torch.from_numpy(G._sample_seeds(11, 4)).to(dev), pixels(hd))
    ps_args = (*render_args(dielectric, "sm"), camera(dielectric, hd),
               torch.from_numpy(G._sample_seeds(0, 2)[1:]).to(dev), pixels(hd, 1e-6))
    bw500 = BW._device_tables(proc500, "mg", False, dev)
    d8 = dict(max_bounces=8)
    one = dict(d8, spp=1, center_sample=False)

    def words_of(size):  # this tree's words form: the one sample's winner words
        return BW.render_blockwise_tile(*bw500, camera(proc500, size), seeds, size=size,
                                        words=True, **one)[1]

    bwg_small = (bw500[0], bw500[1], bw500[3][:2], camera(proc500, small), seeds,
                 torch.full((180, 320, 3), 1e-6, device=dev), words_of(small))
    bwg_fhd = (bw500[0], bw500[1], bw500[3][:2], camera(proc500, fhd), seeds,
               torch.full((1080, 1920, 3), 2.0 / (3 * 1920 * 1080 * 16), device=dev),
               words_of(fhd))

    # the config-5 slice's 2-spp chunk: the tables each bounce entered
    wf_tables = BW._device_tables(proc5000, "mg", False, dev)
    wf_size, wf_depth = (960, 540), 8
    wf_cam = camera(proc5000, wf_size)
    wf_n = wf_size[0] * wf_size[1] * 2
    wkw = dict(size=wf_size, max_bounces=wf_depth, center_sample=True, record=True)
    sched, shrink = WF._schedule(wf_depth, None, -1)
    _, _, saved = WF._forward_chunk(
        lambda b, st, ii, lim: WF.wf_bounce(*wf_tables, wf_cam, seeds, st, ii, lim, bounce=b,
                                            **wkw),
        wf_n, dev, max_bounces=wf_depth, sched=sched, shrink_at=shrink, cell_bits=2,
        record=True)
    gen_state = torch.empty((WF.STATE_ROWS, wf_n), device=dev)
    gen_ids = torch.empty(wf_n, dtype=torch.int32, device=dev)

    def wf_bounce0():
        words = WF.wf_bounce(*wf_tables, wf_cam, seeds, gen_state, gen_ids, bounce=0, **wkw)
        return gen_state, gen_ids, words

    def wf_later():  # each later launch on a copy of the table it entered
        out = []
        for b in range(1, wf_depth):
            entering, ids, _, limit = saved[b]
            st = entering.clone()
            out += [st, WF.wf_bounce(*wf_tables, wf_cam, seeds, st, ids, limit, bounce=b,
                                     **wkw)]
        return out

    # the reverse of that chunk, bounces 7..0 (pixel cotangents made as chip_smoke.py's)
    wf_sp, wf_pl, _, wf_counts = wf_tables
    wf_cot_pix = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (wf_n // 2, 3))
                                  .astype(np.float32)).to(dev) * (2.0 / (3 * wf_n))
    rkw = dict(size=wf_size, max_bounces=wf_depth, center_sample=True)

    # the cotangents that reach bounce 0: those left by the plain reverse
    # of bounces 7..1 (the gen launch reads them and writes none)
    wf_cot0 = torch.zeros((9, wf_n), device=dev)
    for b in reversed(range(1, wf_depth)):
        WG.wf_rev_plain(wf_sp, wf_pl, wf_counts[:2], wf_cam, seeds, *saved[b], wf_cot0,
                        wf_cot_pix, bounce=b, **rkw)

    def wf_rev_chunk(bounces):
        """(sg, pg, cg) of the chunk's reverse launches ``bounces`` (from
        the last down), adding into one set of tables as the pipeline's do;
        bounces 7..1 start from zero cotangents, bounce 0 alone from
        ``wf_cot0``."""
        cot = torch.zeros((9, wf_n), device=dev) if bounces[-1] > 0 else wf_cot0
        out = tuple(torch.zeros(s, dtype=torch.float64, device=dev)
                    for s in ((9, wf_counts[0]), (5, wf_counts[1]), (16,)))
        for b in bounces:
            st, ii, ww, lim = saved[b]
            WG.wf_rev(wf_sp, wf_pl, wf_counts[:2], wf_cam, seeds, st, ii, ww, lim, cot,
                      wf_cot_pix, bounce=b, out=out, **rkw)
        return out

    def wf_rev_chunk_plain(bounces, with_l1):
        """The same through the plain version: ((sg, pg, cg), their L1s)."""
        cot = torch.zeros((9, wf_n), device=dev) if bounces[-1] > 0 else wf_cot0.clone()
        sums = l1s = None
        for b in bounces:
            st, ii, ww, lim = saved[b]
            vals, l1 = WG.wf_rev_plain(wf_sp, wf_pl, wf_counts[:2], wf_cam, seeds, st, ii, ww,
                                       lim, cot, wf_cot_pix, bounce=b, with_l1=with_l1, **rkw)
            sums = vals if sums is None else [s + v for s, v in zip(sums, vals)]
            l1s = l1 if l1s is None else [s + v for s, v in zip(l1s, l1)]
        return sums, l1s

    rev0, rev17 = (0,), tuple(range(wf_depth - 1, 0, -1))

    # row 6's main path: the box scene of the blockwise records step; and
    # past the 2048 sphere rows its scan stages in shared memory
    bigbox = rt_tpu_torch.loads(box_scene_toml(660, 24))
    box2100 = rt_tpu_torch.loads(box_scene_toml(2100, 24))
    fma_x = torch.full(roofline.TILE, 1.0 + 1e-6, device=dev)

    proc1000 = rt_tpu_torch.scene.make_procedural_scene(1000)
    cases = [  # name, entry points, wrapper, args, keywords, calls per window, plain with L1
        ("render_kernel basic 800x600 4spp d8", ("rt_render_forward",), R.render_tile,
         (*render_args(basic), no_boxes, camera(basic, hd), seeds),
         dict(d8, size=hd, spp=4, center_sample=True), 64, None),
        ("render_kernel proc500 1920x1080 4spp d8 (one launch of the config-4 frame)",
         ("rt_render_forward",), R.render_tile,
         (*render_args(proc500), no_boxes, camera(proc500, fhd), seeds),
         dict(d8, size=fhd, spp=4, center_sample=True), 2, None),
        ("blockwise_kernel proc500 320x180 4spp d8", ("rt_blockwise_forward",),
         BW.render_blockwise_tile, bw_args(proc500, small),
         dict(d8, size=small, spp=4, center_sample=True), 16, None),
        ("blockwise_kernel proc500 1920x1080 1 sample d8 (serving form)",
         ("rt_blockwise_forward",), BW.render_blockwise_tile, bw_args(proc500, fhd),
         dict(one, size=fhd), 8, None),
        ("blockwise_kernel proc500 1920x1080 1 sample d8 (words form: a config-4 train-step "
         "launch)", ("rt_blockwise_forward_words",), BW.render_blockwise_tile,
         bw_args(proc500, fhd), dict(one, size=fhd, words=True), 8, None),
        ("blockwise_kernel proc1000 1920x1080 4spp d8 (a chunk of the 1000-sphere frame)",
         ("rt_blockwise_forward",), BW.render_blockwise_tile, bw_args(proc1000, fhd),
         dict(d8, size=fhd, spp=4, center_sample=True), 2, None),
        ("blockwise_kernel proc5000 960x540 2spp d8", ("rt_blockwise_forward",),
         BW.render_blockwise_tile, bw_args(proc5000, wf_size),
         dict(d8, size=wf_size, spp=2, center_sample=True), 2, None),
        ("mse_step_kernel basic 800x600 4spp d8", ("rt_grad_fused",), G.mse_step_tile,
         mono_args, dict(d8, size=hd), 32, G.mse_step_tile_plain),
        ("grad_kernel dielectric/sm 800x600 1 sample d8", ("rt_grad_fused",), G.grad_tile,
         ps_args, dict(d8, size=hd, center_sample=False), 64, G.grad_tile_plain),
        ("grad_kernel proc500 320x180 1 sample d8", ("rt_grad_fused",), G.grad_tile,
         (bw500[0][:500, :10].contiguous(), bw500[1][:0, :10].contiguous(),
          *bwg_small[3:6]), dict(d8, size=small, center_sample=False), 32, G.grad_tile_plain),
        ("bw_grad_kernel proc500 320x180 1 sample d8", ("rt_bw_grad",), BG.bw_grad_tile,
         bwg_small, dict(d8, size=small, center_sample=False), 32, BG.bw_grad_tile_plain),
        ("bw_grad_kernel proc500 1920x1080 1 sample d8 (a config-4 train-step launch)",
         ("rt_bw_grad",), BG.bw_grad_tile, bwg_fhd, dict(d8, size=fhd, center_sample=False),
         8, BG.bw_grad_tile_plain),
        ("wf_bounce proc5000 960x540 2spp d8 chunk: bounce 0", ("rt_wf_bounce",),
         lambda: wf_bounce0(), (), {}, 4, None),
        ("wf_bounce proc5000 960x540 2spp d8 chunk: bounces 1-7", ("rt_wf_bounce",),
         lambda: wf_later(), (), {}, 4, None),
        ("render_record_kernel basic 800x600 1 sample d8 (a headline records-step launch)",
         ("rt_render_record",), R.render_record_tile,
         (*render_args(basic), no_boxes, camera(basic, hd), seeds),
         dict(d8, size=hd, center_sample=False), 64, None),
        ("blockwise_record_kernel 660 spheres + 24 boxes 960x540 1 sample d8 (a box-scene "
         "records-step launch)", ("rt_blockwise_record",), BW.render_record_blockwise_tile,
         (*BW._device_tables(bigbox, "mg", True, dev), camera(bigbox, wf_size), seeds),
         dict(d8, size=wf_size, center_sample=False), 4, None),
        ("blockwise_record_kernel 2100 spheres + 24 boxes 960x540 1 sample d8 (rows from device "
         "memory)", ("rt_blockwise_record",), BW.render_record_blockwise_tile,
         (*BW._device_tables(box2100, "mg", True, dev), camera(box2100, wf_size), seeds),
         dict(d8, size=wf_size, center_sample=False), 2, None),
        ("wf_rev proc5000 960x540 2spp d8 chunk: bounce 0", ("rt_wf_rev",),
         lambda: wf_rev_chunk(rev0), (), {}, 8,
         lambda with_l1: wf_rev_chunk_plain(rev0, with_l1)),
        ("wf_rev proc5000 960x540 2spp d8 chunk: bounces 7-1", ("rt_wf_rev",),
         lambda: wf_rev_chunk(rev17), (), {}, 4,
         lambda with_l1: wf_rev_chunk_plain(rev17, with_l1)),
        ("fma_peak_kernel k=4096", ("rt_fma_peak",), roofline.fma_peak, (fma_x, 4096), {}, 16,
         None),
    ]
    for label, entries, wrapper, a, kw, iters, plain in cases:
        if only and not any(o in label for o in only):
            continue
        names = [t for t in trees if all((t, e) in fns for e in entries)]
        own = {e: getattr(*binds[e]) for e in entries}

        def run(t, n):
            for e in entries:
                setattr(*binds[e], lambda t=t, e=e: fns[t, e])
            out = None
            for _ in range(n):
                out = wrapper(*a, **kw)
            return out

        def snapshot(out):
            flat = []
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                flat += list(x.values()) if isinstance(x, dict) else [x]
            return [x.clone() for x in flat]

        ref = snapshot(run("this", 1))
        if plain is None:
            agree = lambda got: all(bool(torch.equal(g, r)) for g, r in zip(snapshot(got), ref))
        else:
            _, l1 = plain(*a, with_l1=True, **kw)
            agree = lambda got: all(
                bool(((g.double() - r.double()).abs() <= GRAD_TOL * l.double()).all())
                for g, r, l in zip(got, ref, l1))
        torch.cuda.synchronize()
        agrees = {t: agree(run(t, 1)) for t in names}
        ms = {t: [] for t in names}
        wall = {t: [] for t in names}

        def window(t, held):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            if held:
                # hold the stream while the host queues the window, so that
                # the events time the card's work and not the host's launches
                hold()
            start.record()
            run(t, iters)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters

        for w in range(windows + 1):
            for t in (names if w % 2 == 0 else names[::-1]):
                run(t, 1)
                card_ms, wall_ms = window(t, True), window(t, False)
                if w > 0:  # the first window warms up
                    ms[t].append(card_ms)
                    wall[t].append(wall_ms)
        for e, f in own.items():
            setattr(*binds[e], f)
        row = {t: {"ms": statistics.median(v), "windows_ms": v,
                   "wall_ms": statistics.median(wall[t]), "wall_windows_ms": wall[t],
                   "agrees_with_this": agrees[t]} for t, v in ms.items()}
        for t in names:
            row[t]["over_this"] = row[t]["ms"] / row["this"]["ms"]
        result["cases"][label] = row
        skipped = [t for t in trees if t not in names]
        print(f"{label}: " + "; ".join(
            f"{t} {r['ms']:.4f} ms ({r['over_this']:.4f} of this, windows "
            f"{min(r['windows_ms']):.4f}-{max(r['windows_ms']):.4f}; wall {r['wall_ms']:.4f}, "
            f"windows {min(r['wall_windows_ms']):.4f}-{max(r['wall_windows_ms']):.4f}; agrees "
            f"{r['agrees_with_this']})" for t, r in row.items())
            + (f"; not built with this interface: {skipped}" if skipped else "")
            + f" | {card}", flush=True)


def package_cases(packages, windows, result, card):
    """The main paths of each package in interleaved windows (see the module
    note)."""
    import importlib
    import statistics

    import numpy as np
    import torch

    def mod(pkg, name):
        return importlib.import_module(f"{pkg.__name__}.{name}")

    def cells(pkg):
        """{cell: (step(i), calls per window)} for one package."""
        R, G, BW, WF = (mod(pkg, f"ops.{m}") for m in ("render", "grad", "blockwise",
                                                         "wavefront"))
        train, diff = mod(pkg, "train"), mod(pkg, "diff")
        load = lambda name: pkg.load(str(ROOT / "scenes" / name))
        basic, dielectric = load("basic.toml"), load("dielectric.toml")
        proc500 = pkg.scene.make_procedural_scene(500)
        proc5000 = pkg.scene.make_procedural_scene(5000)
        hd = (800, 600)
        rng = np.random.default_rng(0)
        t_hd = rng.uniform(0.0, 0.5, (600, 800, 3)).astype(np.float32)
        headline = G.make_mse_step(diff.extract_params(basic), basic, t_hd, hd, spp=4,
                                   max_bounces=8, device="cuda")
        config3 = G.make_mse_step(diff.extract_params(dielectric), dielectric, t_hd, hd, spp=64,
                                  max_bounces=8, personality="sm", mode="multi", device="cuda")
        serve1 = R.make_render_step(basic, hd, spp=4, max_bounces=8, device="cuda")
        serve4 = R.make_render_step(proc500, (1920, 1080), spp=16, max_bounces=8, device="cuda")
        out = {"headline step (basic 800x600 4spp d8, mono)": (lambda i: headline(i), 32),
               "config-3 step (dielectric/sm 800x600 64spp d8)": (lambda i: config3(i), 2),
               "basic frame (make_render_step 800x600 4spp d8)": (lambda i: serve1(seed=i), 32),
               "config-4 frame (make_render_step 500 spheres 1920x1080 16spp d8)":
                   (lambda i: serve4(seed=i), 2)}
        for label, scene, size, spp in (
                ("config-4 train step (500 spheres 1920x1080 16spp d8, Adam)", proc500,
                 (1920, 1080), 16),
                ("config-5 train step (wavefront, 5000 spheres 960x540 2spp d8, Adam)",
                 proc5000, (960, 540), 2)):
            target = BW.render_forward_blockwise(scene, size, seed=0, spp=spp, max_bounces=8,
                                                 gamma=False, device="cuda")
            params = {"materials.albedo": torch.full_like(scene.materials.albedo, 0.5).cuda()}
            opt = torch.optim.Adam(list(params.values()), lr=5e-2, foreach=True)
            st = train.make_kernel_train_step(opt, scene, target, size, spp=spp, max_bounces=8,
                                              device="cuda")
            out[label] = (lambda i, st=st, params=params: st(params, 100 + i), 2)
        # the records route on the box scene (the blockwise record kernel)
        sys.path.insert(0, str(ROOT / "tests"))
        from test_torch_common import box_scene_toml

        bigbox = pkg.loads(box_scene_toml(660, 24))
        box_tgt = torch.full((540, 960, 3), 0.2, device="cuda")
        box_params = diff.extract_params(bigbox)
        out["box-scene records step (660 spheres + 24 boxes 960x540 2spp d8)"] = (
            lambda i: diff.records_loss_and_grad(box_params, bigbox, box_tgt, (960, 540), seed=i,
                                                 spp=2, max_bounces=8, include_boxes=True,
                                                 device="cuda"), 2)
        proc1000 = pkg.scene.make_procedural_scene(1000)
        out["1000-sphere frame (render_forward_blockwise 1000 spheres 1920x1080 8spp d8)"] = (
            lambda i: BW.render_forward_blockwise(proc1000, (1920, 1080), seed=i, spp=8,
                                                  max_bounces=8, device="cuda"), 2)
        out["config-5 frame (render_forward_wavefront 5000 spheres 960x540 2spp d8)"] = (
            lambda i: WF.render_forward_wavefront(proc5000, (960, 540), seed=i, spp=2,
                                                  max_bounces=8, device="cuda"), 3)
        out["config-5 frame (render_forward_blockwise, the same slice)"] = (
            lambda i: BW.render_forward_blockwise(proc5000, (960, 540), seed=i, spp=2,
                                                  max_bounces=8, device="cuda"), 3)

        # the device ms of each launch of one config-5 record chunk
        tables = BW._device_tables(proc5000, "mg", False, torch.device("cuda"))
        cam = torch.from_numpy(R._pack_camera(proc5000.camera, (960, 540))).cuda()
        seeds = torch.tensor([21], dtype=torch.int32, device="cuda")
        sched, shrink = WF._schedule(8, None, -1)

        def per_launch_ms():
            marks = []

            def launch(b, state, ids, limit):
                a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                words = WF.wf_bounce(*tables, cam, seeds, state, ids, limit, size=(960, 540),
                                     bounce=b, max_bounces=8, center_sample=True, record=True)
                e.record()
                marks.append((a, e))
                return words

            torch.cuda.synchronize()
            hold()
            WF._forward_chunk(launch, 960 * 540 * 2, cam.device, max_bounces=8, sched=sched,
                              shrink_at=shrink, cell_bits=2, record=True)
            torch.cuda.synchronize()
            return [a.elapsed_time(e) for a, e in marks]

        return out, per_launch_ms

    names = list(packages)
    built = {p: cells(pkg) for p, pkg in packages.items()}
    steps = {p: b[0] for p, b in built.items()}
    for p in names:  # warm up
        for fn, _ in steps[p].values():
            fn(0)
    torch.cuda.synchronize()
    rows = {}
    for label in steps[names[0]]:
        ms = {p: [] for p in names}
        for w in range(windows):
            for p in (names if w % 2 == 0 else names[::-1]):
                fn, iters = steps[p][label]
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                for i in range(iters):
                    fn(i)
                end.record()
                end.synchronize()
                ms[p].append(start.elapsed_time(end) / iters)
        rows[label] = {p: {"ms": statistics.median(v), "windows_ms": v,
                           "over_this": statistics.median(v) / statistics.median(ms["this"])}
                       for p, v in ms.items()}
        print(f"{label}: " + "; ".join(
            f"{p} {r['ms']:.4f} ms ({r['over_this']:.4f} of this, windows "
            f"{min(r['windows_ms']):.4f}-{max(r['windows_ms']):.4f})" for p, r in rows[label].items())
            + f" | {card}", flush=True)
    per = {p: [] for p in names}
    for w in range(windows + 1):
        for p in (names if w % 2 == 0 else names[::-1]):
            got = built[p][1]()
            if w > 0:
                per[p].append(got)
    launches = {}
    for p in names:
        med = [statistics.median(x[b] for x in per[p]) for b in range(len(per[p][0]))]
        launches[p] = {"per_launch_ms": med, "bounce0_ms": med[0],
                       "bounces_1_7_ms": sum(med[1:]),
                       "bounces_1_7_windows_ms": [sum(x[1:]) for x in per[p]]}
        print(f"config-5 chunk (2spp) per launch, {p}: bounce 0 {med[0]:.4f} ms, bounces 1-7 "
              f"{sum(med[1:]):.4f} ms (" + ", ".join(f"{m:.4f}" for m in med[1:]) + f") | {card}",
              flush=True)
    result["packages"] = {"cells": rows, "config5_chunk_launches": launches}


def smoke_runs(specs, tmp: Path, result, card):
    """``--smoke NAME=CHECKOUT[+ABLATION]``: each checkout's ``chip_smoke.py``
    run whole, one after another, from a copy (with ``ABLATIONS[ABLATION]``
    applied to the copy's ``rt_tpu_torch/csrc``; an ablated build's failed
    checks are logged instead of raised).  Reads from its ``[report]`` line
    the device ms per kernel of the config-5 chunk's reverse (CUPTI,
    ``wf_timing.wf_rev.chunk_device_ms``): the same launches, timed inside
    the script that surrounds them."""
    rows = {}
    for spec in specs:
        name, _, rest = spec.partition("=")
        path, _, abl = rest.partition("+")
        if abl and abl not in ABLATIONS:
            raise ValueError(f"--smoke {spec}: unknown ablation")
        root = tmp / f"smoke-{name}"
        shutil.copytree(Path(path), root, ignore=shutil.ignore_patterns(
            ".git", "_build", "chiprun_out", "chip_checkout", "docs", "__pycache__"))
        if abl:
            csrc = root / "rt_tpu_torch" / "csrc"
            shutil.move(csrc, root / "csrc-orig")
            ablate(root / "csrc-orig", csrc, ABLATIONS[abl])
        code = ("import sys\nsys.argv = ['chip_smoke.py']\nimport chip_smoke as s\n"
                + ("s.check = lambda c, m: c or s.log('[chip_ab] check not held (ablated build): '"
                   " + m)\n" if abl else "") + "sys.exit(s.main())\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        report = next((json.loads(ln[len("[report] "):]) for ln in proc.stdout.splitlines()
                       if ln.startswith("[report] ")), {})
        rev = report.get("wf_timing", {}).get("wf_rev", {}).get("chunk_device_ms", {})
        rows[name] = {"checkout": path, "ablation": abl or None, "rc": proc.returncode,
                      "seconds": seconds, "wf_rev_chunk_device_ms": rev,
                      "not_held": [ln for ln in proc.stdout.splitlines()
                                   if ln.startswith("[chip_ab]")],
                      "tail": (proc.stdout + proc.stderr)[-3000:]}
        print(f"smoke {name} ({path}{' + ' + abl if abl else ''}): rc {proc.returncode} in "
              f"{seconds:.0f} s; wf_rev chunk device ms per kernel {rev} | {card}", flush=True)
        if proc.returncode != 0:
            print(rows[name]["tail"], flush=True)
    result["smoke"] = rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=CSRC_DIR")
    ap.add_argument("--ablate", action="append", default=[], metavar="ABLATION=TREE",
                    help=f"one of {sorted(ABLATIONS)}, applied to a copy of TREE")
    ap.add_argument("--package", action="append", default=[], metavar="NAME=CHECKOUT")
    ap.add_argument("--no-kernels", action="store_true", help="only the --package cells")
    ap.add_argument("--smoke", action="append", default=[], metavar="NAME=CHECKOUT[+ABLATION]",
                    help="run CHECKOUT's chip_smoke.py whole (on an ablated build) and read its "
                         "wf_rev device times")
    ap.add_argument("--only", action="append", default=[], metavar="TEXT",
                    help="only the kernel cases whose label holds TEXT (repeatable)")
    ap.add_argument("--sass", type=Path, metavar="DIR",
                    help="write each tree's SASS of the scan's kernels to DIR/<tree>/<source>.sass")
    ap.add_argument("--windows", type=int, default=7)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_ab: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import rt_tpu_torch
    from rt_tpu_torch import roofline
    from rt_tpu_torch.ops import _build
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R
    from rt_tpu_torch.ops import wavefront as WF
    from rt_tpu_torch.ops import wavefront_grad as WG

    trees = {"this": _build.CSRC_DIR}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "ablations": [],
              "build": {}, "cases": {}}
    ablations = set()
    if not args.no_kernels:
        # the wrappers' own bindings give the argument types
        argtypes = {"rt_render_forward": R._kernel().argtypes,
                    "rt_render_record": R._record_kernel().argtypes,
                    "rt_blockwise_forward": BW._kernel().argtypes,
                    "rt_blockwise_forward_words": BW._words_kernel().argtypes,
                    "rt_blockwise_record": BW._record_kernel().argtypes,
                    "rt_grad_fused": G._kernel().argtypes, "rt_bw_grad": BG._kernel().argtypes,
                    "rt_wf_bounce": WF._kernel().argtypes, "rt_wf_rev": WG._kernel().argtypes,
                    "rt_fma_peak": roofline._kernel().argtypes}
        nvcc = _build._nvcc()
        cuobjdump = Path(nvcc).with_name("cuobjdump")
        fns = {}
        with tempfile.TemporaryDirectory() as tmp:
            for spec in args.ablate:
                name, _, base = spec.partition("=")
                if name not in ABLATIONS or base not in trees:
                    raise ValueError(f"--ablate {spec}: unknown ablation or tree")
                tree = f"{base}-{name}"
                ablate(trees[base], Path(tmp) / f"src-{tree}", ABLATIONS[name])
                trees[tree] = Path(tmp) / f"src-{tree}"
                ablations.add(tree)
            result["trees"] = {k: str(v) for k, v in trees.items()}
            result["ablations"] = sorted(ablations)
            jobs = [(t, k) for t in trees for k in KERNELS]
            for t in trees:
                (Path(tmp) / t).mkdir()
            with ThreadPoolExecutor(len(jobs)) as ex:
                built = list(ex.map(lambda j: build(trees[j[0]], j[1], Path(tmp) / j[0], nvcc,
                                                    _build.NVCC_FLAGS), jobs))
            for (t, k), (lib, report) in zip(jobs, built):
                cdll = ctypes.CDLL(str(lib))
                for sym in KERNELS[k]:
                    # an entry point whose tree lacks this interface's marker
                    # has another C signature
                    marker = INTERFACE.get(sym)
                    if not hasattr(cdll, sym) or (marker and not hasattr(
                            ctypes.CDLL(str(Path(tmp) / t / f"lib{marker[0]}.so")), marker[1])):
                        continue
                    fn = getattr(cdll, sym)
                    fn.argtypes, fn.restype = argtypes[sym], ctypes.c_int
                    fns[t, sym] = fn
                dump = (args.sass / t / f"{k}.sass" if args.sass and k in SASS_SOURCES
                        else None)
                result["build"][f"{t}/{k}"] = {"ptxas": report,
                                               "sass": sass_counts(lib, cuobjdump, dump)}
                print(f"{t}/{k}: {report} sass {result['build'][f'{t}/{k}']['sass']}",
                      flush=True)
            kernel_cases(trees, fns, args.windows, result, ablations, card, args.only)
    if args.package:
        packages = {"this": rt_tpu_torch}
        for spec in args.package:
            name, _, path = spec.partition("=")
            packages[name] = load_package(name, Path(path).resolve())
        package_cases(packages, args.windows, result, card)
    if args.smoke:
        with tempfile.TemporaryDirectory() as tmp:
            smoke_runs(args.smoke, Path(tmp), result, card)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if all(r["agrees_with_this"] for c in result["cases"].values()
                    for t, r in c.items() if t not in ablations) else 1


if __name__ == "__main__":
    sys.exit(main())
