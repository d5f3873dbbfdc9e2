#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (rt_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (an exception in any phase exits non-zero before the result line):

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles the CUDA kernels from rt_tpu_torch/csrc with nvcc, one
   nvcc per source, all at once; prints ptxas registers, spills and stack.
3. Kernels against their plain PyTorch versions, both on the card, at the
   shapes of the main paths.  Render kernel: basic.toml (mg),
   dielectric.toml (sm) and basic.toml plus a box (--boxes) at 800x600,
   4 spp, 8 bounces, and the procedural 500-sphere scene at 320x180; they
   must agree bit for bit.  Gradient kernels: the mono step on basic.toml
   (mg) at 800x600 4 spp and cornell_spheres.toml (sm, planes and
   dielectrics) at 320x240 2 spp, the per-sample kernel on dielectric.toml
   (sm) at 800x600 (2 samples) and on 500 spheres at 320x180, all at depth
   8 and again at 64x48; every output within 1e-5 of the sum of the
   magnitudes of its per-(pixel, sample) contributions (the kernels sum
   per-primitive gradients with atomics; the run-to-run spread of two
   launches is printed).  Blockwise forward kernel, depth 8, bit for bit:
   4 spp on basic.toml at 800x600, cornell_spheres.toml (sm) and basic+box
   (--boxes) at 320x240, 500 spheres at 320x180 and 1000 spheres (past the
   render kernel's 640) at 160x90; at the main paths' shapes, 500 spheres
   at 1920x1080 1 spp (a train-step launch) and 1000 spheres at 1920x1080
   4 spp (a CLI chunk); and against the render kernel on basic and cornell
   at the same seeds.  Blockwise gradient kernel, one sample, depth 8,
   within 1e-5 x L1 with the run-to-run spread: 500 spheres at 320x180 and
   at 1920x1080 (a train-step launch), cornell (sm) at 160x120; and the
   blockwise step against make_mse_step(mode="multi") on basic.toml at the
   same seeds.
4. Main paths through the entry points, each with the launch counters
   reset just before and read just after: the CLI renders basic.toml to a
   PNG and make_render_step renders BASELINE config 4's shape (500
   spheres, 1920x1080, 8 bounces) at 16 spp; make_mse_step takes steps at
   the headline shape (basic.toml 800x600, 4 spp, depth 8: one mono launch
   per step), at config 2's 16 spp (mono) and at config 3's shape
   (dielectric.toml/sm 800x600, 64 spp: the per-sample route, 64 render
   and 64 gradient launches); bench.py's gradient check (central finite
   difference on materials.reflectivity[0]) through mse_loss_and_grad;
   and 5 steps of gradient descent on materials.albedo towards a frame
   rendered at perturbed albedo, which must lower the loss.  The blockwise
   route: the CLI (mg_auto) renders the procedural 1000-sphere scene at
   1920x1080 (one blockwise launch per 4-sample chunk); 6 steps of
   train.make_kernel_train_step at BASELINE config 4's training shape (500
   spheres, 1920x1080, depth 8; 16 spp, cut from 128 for run time), Adam
   on materials.albedo at lr 5e-2 as in examples/big_scene_training.py:
   the loss must fall, each step must launch 16 forward and 16 gradient
   kernels, copy nothing to the card but the seeds and build nothing; and
   bench.py's gradient check through bw_mse_loss_and_grad.
5. Timing: CUDA events around back-to-back calls
   (rt_tpu_torch.profiling.sustained) for every kernel, its plain version,
   make_render_step and make_mse_step (fwd+bwd Mrays/s), the step over the
   same-shape forward in interleaved windows (ratio_step_over_fwd, as
   bench.py measures it), config 3's step, the blockwise kernels (beside
   the render and per-sample kernels on the same 500-sphere inputs) and
   the config-4 train step, and a profiler trace (profiling.device_times)
   for the kernels' device time and the card's busy share within a step.
   Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
   FP32 operations over 33.5 Top/s, the operations counted from the kernel
   sources (OPS below) times the live bounces of this run's inputs (the
   scan's share grows with the table).

The last two lines are the card line and {"ok": true, "device": ...};
the line before them is the per-kernel JSON summary, and the line before
that ("[report] ...") holds every number the run measured.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCES = ("render_kernel", "grad_kernel", "blockwise_kernel", "bw_grad_kernel")

# Render kernel vs plain version on the card: the tolerance is zero.  The kernel is
# built with --fmad=false and writes rsqrt as 1/sqrtf, and the plain version
# on CUDA rounds sqrt and division correctly, so every operation rounds once
# in the same order and the two agree bit for bit.  (The CPU parity tests
# against JAX allow 0.5% of pixels beyond 2e-5 instead, because XLA's CPU
# backend contracts FMAs and torch's CPU sqrt is not correctly rounded.)


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def png_rgba(path: Path):
    """Decode an 8-bit RGBA, non-interlaced PNG as written by
    rt_tpu_torch.image (every row uses filter 0)."""
    import numpy as np

    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        check(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body),
              "PNG chunk CRC mismatch")
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            check((depth, ctype) == (8, 6), "PNG is not 8-bit RGBA")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    check((rows[:, 0] == 0).all(), "unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 4)


# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; FP32 67 TFLOP/s counting
# an FMA as two operations, i.e. 33.5 T operations/s without FMAs (the
# kernels are built with --fmad=false).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 33.5e12

# FP32 operations per unit of work, counted by hand from
# rt_tpu_torch/csrc/trace.cuh (the render and blockwise kernels) and
# bounce.cuh (the gradient kernels) (rounded; an add,
# multiply, compare, select, min/max, conversion, division or square root
# counts one; the integer hash is not FP32 work).  Forward, per live
# bounce: the scan of every plane and sphere, then the miss (sky) or hit
# work (hit point, draws, throughput, class tests) plus the sphere normal
# and the material's scatter.  Reverse, per live bounce: the pass-through
# and throughput transpose, the sky term on a miss, and on a hit the
# winner's t/normal recompute and transpose plus the material's.
OPS = dict(raygen=40, scan_plane=20, scan_sphere=30, fwd_miss=12, fwd_hit=35, fwd_sphere=14,
           fwd_lambert=14, fwd_metal=37, fwd_dielectric=71, rev_live=50, rev_miss=20,
           rev_sphere=128, rev_plane=60, rev_lambert=34, rev_metal=83, rev_dielectric=166,
           raygen_adjoint=70, loss=15)

# Gradient kernels against their plain versions on the card: the per-ray
# arithmetic is the same (--fmad=false, the same expressions in the same
# order), so only the order of the sums over pixels and samples differs,
# and the kernels add per-primitive gradients with shared-memory atomics.
# Every output must agree within GRAD_TOL times the sum of the magnitudes of
# its per-(pixel, sample) contributions (the plain version's l1 output).
GRAD_TOL = 1e-5


def live_work(spheres, planes, cam, seeds, bases, centers, size, max_bounces, rng_mode):
    """Live work of these inputs, counted from the plain forward's
    per-bounce masks (rt_tpu_torch.ops._grad_math): rays, live bounces,
    misses, sphere and plane hits, and hits per material class.  ``seeds``,
    ``bases`` (counter offsets) and ``centers`` give each sample's draws.
    ``warp_live`` counts the bounce slots the kernels' warps issue: per warp
    of 32 consecutive pixels and per sample, 32 times the most live bounces
    of any of its pixels (a lane whose ray died waits for the others)."""
    import torch
    from rt_tpu_torch.ops import _grad_math as gm
    from rt_tpu_torch.ops.render import _inv_size, hash_u01

    w, h = size
    n = w * h
    dev = cam.device
    idx = torch.arange(n, device=dev, dtype=torch.int64)
    px, py = (idx % w).float(), (idx // w).float()
    inv_w, inv_h = _inv_size(w, h)
    c = cam.tolist()
    keys = ("live", "miss", "sphere", "plane", "lambert", "metal", "dielectric")
    counts = dict.fromkeys(keys + ("warp_live",), 0)
    counts["rays"] = n * len(seeds)
    for seed, base, center in zip(seeds, bases, centers):
        jx, jy = (0.5, 0.5) if center else (hash_u01(idx, seed, base + 1),
                                            hash_u01(idx, seed, base + 2))
        o3, d3 = gm.raygen(c, px, py, jx, jy, inv_w, inv_h)
        thr3 = (torch.ones(n, device=dev),) * 3
        live = torch.ones(n, dtype=torch.bool, device=dev)
        nb = torch.zeros(n + (-n) % 32, dtype=torch.int64, device=dev)
        for b in range(max_bounces):
            nb[:n] += live
            u3 = gm.unit_draws(idx, seed, base + 3 + 4 * b, rng_mode == "sphere")
            coin = hash_u01(idx, seed, base + 6 + 4 * b)
            best, bidx, ispl, root = gm.scan(spheres, planes, o3, d3)
            pay, cls = gm.payload(spheres, planes, best < 1e37, ispl, bidx)
            lv = live
            o3, d3, thr3, _, bits = gm.bounce_forward(o3, d3, thr3, best, pay, cls, ispl, root,
                                                      live, u3, coin)
            lh = bits["live_h"]
            for k, m in (("live", lv), ("miss", bits["miss"]), ("sphere", lh & ~ispl),
                         ("plane", lh & ispl), ("metal", lh & (cls == 1.0)),
                         ("dielectric", lh & (cls == 2.0)),
                         ("lambert", lh & (cls != 1.0) & (cls != 2.0))):
                counts[k] += int(m.sum())
            live = bits["alive"]
        counts["warp_live"] += 32 * int(nb.view(-1, 32).amax(dim=1).sum())
    return counts


def forward_ops(work, n_spheres, n_planes):
    hits = work["sphere"] + work["plane"]
    return (work["rays"] * OPS["raygen"]
            + work["live"] * (n_planes * OPS["scan_plane"] + n_spheres * OPS["scan_sphere"])
            + work["miss"] * OPS["fwd_miss"] + hits * OPS["fwd_hit"]
            + work["sphere"] * OPS["fwd_sphere"] + work["lambert"] * OPS["fwd_lambert"]
            + work["metal"] * OPS["fwd_metal"] + work["dielectric"] * OPS["fwd_dielectric"])


def reverse_ops(work):
    return (work["rays"] * (OPS["raygen"] + OPS["raygen_adjoint"])
            + work["live"] * OPS["rev_live"] + work["miss"] * OPS["rev_miss"]
            + work["sphere"] * OPS["rev_sphere"] + work["plane"] * OPS["rev_plane"]
            + work["lambert"] * OPS["rev_lambert"] + work["metal"] * OPS["rev_metal"]
            + work["dielectric"] * OPS["rev_dielectric"])


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for these bytes and operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def window_s(fn, iters):
    """Seconds per call of ``fn(i)`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def card_tables(scene, personality, size, include_boxes=False):
    """The kernels' tables (spheres, planes, boxes) and camera vector, on the card."""
    import numpy as np
    import torch
    from rt_tpu_torch.ops import render as R

    s_cols, p_cols = R._flatten_primitives(scene, personality)
    b_cols = (R._flatten_boxes(scene, personality) if include_boxes
              else np.zeros((12, 0), np.float32))
    sp, pl, bx = (torch.from_numpy(np.ascontiguousarray(c.T)).cuda()
                  for c in (s_cols, p_cols, b_cols))
    return sp, pl, bx, torch.from_numpy(R._pack_camera(scene.camera, size)).cuda()


def grad_inputs(scene, personality, size, seed=1):
    """Card tensors for the gradient kernels: tables, camera and a (H, W, 3)
    target drawn from a numpy seed."""
    import numpy as np
    import torch

    sp, pl, _, cam = card_tables(scene, personality, size)
    w, h = size
    pix = np.random.default_rng(seed).uniform(0.0, 0.5, (h, w, 3)).astype(np.float32)
    return sp, pl, cam, torch.from_numpy(pix).cuda()


def grad_parity(scenes, report):
    """Phase 3 for the gradient kernels.  Returns max |kernel - plain| per kernel."""
    import torch
    from rt_tpu_torch.ops import grad as G

    cases = [  # label, scene, personality, size, spp, mono
        ("mono basic/mg", "basic", "mg", (800, 600), 4, True),
        ("mono cornell_spheres/sm", "cornell", "sm", (320, 240), 2, True),
        ("per-sample dielectric/sm", "dielectric", "sm", (800, 600), 2, False),
        ("per-sample proc500/mg", "proc500", "mg", (320, 180), 1, False),
    ]
    cases += [(label, key, pers, (64, 48), spp, mono) for label, key, pers, _, spp, mono in cases]
    errs = {"mse_step_kernel": 0.0, "grad_kernel": 0.0}
    report["grad_parity"] = []
    for label, key, pers, size, spp, mono in cases:
        sp, pl, cam, pix = grad_inputs(scenes[key], pers, size)
        seeds = torch.from_numpy(G._sample_seeds(11, spp)).to(cam.device)
        kw = dict(size=size, max_bounces=8)
        if mono:
            runs = [(lambda: G.mse_step_tile(sp, pl, cam, seeds, pix, **kw),
                     lambda: G.mse_step_tile_plain(sp, pl, cam, seeds, pix, with_l1=True, **kw))]
        else:
            cot = pix * 1e-6  # the scale of 2 (img - target) / (3 W H spp)
            runs = [(lambda s=s: G.grad_tile(sp, pl, cam, seeds[s:s + 1], cot,
                                             center_sample=(s == 0), **kw),
                     lambda s=s: G.grad_tile_plain(sp, pl, cam, seeds[s:s + 1], cot,
                                                   center_sample=(s == 0), with_l1=True, **kw))
                    for s in range(spp)]
        for s, (kernel, plain) in enumerate(runs):
            got, again = kernel(), kernel()
            want, l1 = plain()
            torch.cuda.synchronize()
            outs = [(g, a, w, l) for g, a, w, l in zip(got, again, want, l1) if g.numel()]
            for g, a, w, l in outs:
                check(torch.isfinite(g).all().item(), f"{label}: kernel output not finite")
            row = {
                "case": label, "size": size, "spp": spp, "sample": None if mono else s,
                "max_abs": max((g - w).abs().max().item() for g, a, w, l in outs),
                "max_ratio_l1": max(((g - w).abs() / l.clamp_min(1e-30)).max().item()
                                    for g, a, w, l in outs),
                "run_to_run_ratio_l1": max(((g - a).abs() / l.clamp_min(1e-30)).max().item()
                                           for g, a, w, l in outs),
            }
            report["grad_parity"].append(row)
            log(f"[3] {label} {size[0]}x{size[1]} {spp}spp d8"
                f"{'' if mono else f' sample {s}'}: max|d| {row['max_abs']:.3g}, "
                f"max |d|/L1 {row['max_ratio_l1']:.3g} (tolerance {GRAD_TOL}), run-to-run "
                f"|d|/L1 {row['run_to_run_ratio_l1']:.3g}")
            for g, a, w, l in outs:
                check(((g - w).abs() <= GRAD_TOL * l).all().item(),
                      f"{label}: kernel differs from its plain version beyond {GRAD_TOL} x L1")
            name = "mse_step_kernel" if mono else "grad_kernel"
            errs[name] = max(errs[name], row["max_abs"])
    return errs


def grad_main_paths(scenes, report):
    """Phase 4 for make_mse_step.  Returns (launches per kernel, the
    headline step, config 3's step, the training target)."""
    import torch
    from rt_tpu_torch import diff
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R

    def reset():
        G.mse_step_tile.launches = R.render_tile.launches = G.grad_tile.launches = 0

    def counts():
        return (G.mse_step_tile.launches, R.render_tile.launches, G.grad_tile.launches)

    total = {"mse_step_kernel": 0, "render_kernel": 0, "grad_kernel": 0}

    def read(label, want):
        torch.cuda.synchronize()
        got = counts()
        for k, v in zip(total, got):
            total[k] += v
        log(f"[4] {label}: launches (mono, render, per-sample) = {got}")
        check(got == want, f"{label}: launches {got}, expected {want}")

    def finite(loss, grads, params):
        check(set(grads) == set(params), "gradient keys differ from extract_params")
        check(torch.isfinite(loss).item() and all(torch.isfinite(g).all().item()
                                                   for g in grads.values()),
              "loss or gradients not finite")

    size = (800, 600)
    basic, diel = scenes["basic"], scenes["dielectric"]
    params = diff.extract_params(basic)
    # the training target: a pre-gamma frame at perturbed albedo
    p_tgt = dict(params)
    p_tgt["materials.albedo"] = params["materials.albedo"] * torch.tensor([0.8, 1.0, 0.9, 1.0])
    target = R.render_forward(diff.apply_params(basic, p_tgt), size, seed=5, spp=4,
                              max_bounces=8, gamma=False, device="cuda")
    target3 = R.render_forward(diel, size, seed=9, spp=4, max_bounces=8, gamma=False,
                               personality="sm", device="cuda")
    out = {}

    reset()
    step = G.make_mse_step(params, basic, target, size, spp=4, max_bounces=8, device="cuda")
    for i in range(3):
        loss, grads = step(i)
    read("headline make_mse_step (basic 800x600 4spp d8), 3 steps", (3, 0, 0))
    check(step.mode == "mono", "headline step is not mono")
    finite(loss, grads, params)
    out["headline_loss"] = loss.item()

    reset()
    step16 = G.make_mse_step(params, basic, target, size, spp=16, max_bounces=8, device="cuda")
    loss16, grads16 = step16(0)
    read("config 2 make_mse_step (basic 800x600 16spp d8), 1 step", (1, 0, 0))
    check(step16.mode == "mono", "config 2 step is not mono")
    finite(loss16, grads16, params)

    reset()
    params3 = diff.extract_params(diel)
    step3 = G.make_mse_step(params3, diel, target3, size, spp=64, max_bounces=8,
                            personality="sm", device="cuda")
    loss3, grads3 = step3(0)
    read("config 3 make_mse_step (dielectric/sm 800x600 64spp d8), 1 step", (0, 64, 64))
    check(step3.mode == "multi", "config 3 step is not per-sample")
    finite(loss3, grads3, params3)

    # bench.py's gradient check through the port's own loss
    reset()
    name, eps, small = "materials.reflectivity", 1e-3, (200, 150)
    tgt_s = torch.zeros((150, 200, 3), device="cuda")
    kw = dict(seed=17, spp=2, max_bounces=4, device="cuda")
    _, g_small = G.mse_loss_and_grad(params, basic, tgt_s, small, **kw)
    fd_losses = []
    for sign in (1, -1):
        p = dict(params)
        p[name] = params[name].clone()
        p[name][0] += sign * eps
        fd_losses.append(float(G.mse_loss_and_grad(p, basic, tgt_s, small, **kw)[0]))
    read("gradient check (200x150 2spp d4)", (3, 0, 0))
    fd = (fd_losses[0] - fd_losses[1]) / (2 * eps)
    an = float(g_small[name][0])
    grad_ok = abs(an - fd) <= max(2e-2 * abs(fd), 1e-4)
    log(f"[4] grad check: analytic {an:.6g}, central FD {fd:.6g}: grad_ok={grad_ok}")
    check(grad_ok, "the analytic gradient disagrees with finite differences")
    out.update(grad_ok=grad_ok, grad_an=an, grad_fd=fd)

    # 5 steps of plain gradient descent on the albedo
    reset()
    lr, p, losses = 30.0, dict(params), []
    for i in range(6):
        loss_i, g = G.make_mse_step(p, basic, target, size, spp=4, max_bounces=8,
                                    device="cuda")(i)
        losses.append(loss_i.item())
        step_alb = p["materials.albedo"] - lr * g["materials.albedo"].cpu()
        p = dict(p, **{"materials.albedo": step_alb})
    read("training (5 descent steps on materials.albedo, 6 evaluations)", (6, 0, 0))
    log(f"[4] training losses: {losses}")
    check(losses[5] < losses[0], "gradient descent did not lower the loss")
    out["train_losses"] = losses
    report["grad_main_path"] = dict(out, launches=total)
    return total, step, step3


def grad_timing(scenes, step, step3, card, report):
    """Phase 5 for the gradient kernels and make_mse_step.  Returns per-kernel
    timing rows for the kernels' JSON line."""
    import torch
    from rt_tpu_torch import profiling
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R

    size = (800, 600)
    w, h = size
    n = w * h
    # the mono kernel at the headline shape
    sp, pl, cam, tgt = grad_inputs(scenes["basic"], "mg", size)
    seeds = G._sample_seeds(11, 4)
    seeds_t = torch.from_numpy(seeds).to(cam.device)
    kw = dict(size=size, max_bounces=8)
    mk = profiling.sustained(lambda i: G.mse_step_tile(sp, pl, cam, seeds_t, tgt, **kw), iters=16)
    mp = profiling.sustained(lambda i: G.mse_step_tile_plain(sp, pl, cam, seeds_t, tgt, **kw),
                             iters=1, windows=3)
    work = live_work(sp, pl, cam, seeds.tolist(), [0] * 4, [True, False, False, False], size, 8,
                     "reference")
    table_bytes = 4 * 10 * (sp.shape[0] + pl.shape[0])
    blocks = -(-n // 128)
    out_bytes = 4 * blocks * (9 * sp.shape[0] + 5 * pl.shape[0] + 16)
    m_bound = bound(table_bytes + 4 * (16 + 4 + 3 * n) + out_bytes + 4 * blocks,
                    forward_ops(work, sp.shape[0], pl.shape[0]) + reverse_ops(work)
                    + n * OPS["loss"])
    mono = {"ms": mk["median"] * 1e3, "spread_ms": [mk["min"] * 1e3, mk["max"] * 1e3],
            "plain_ms": mp["median"] * 1e3, "bound_ms": m_bound[0], "bound_by": m_bound[1],
            "live_work": work, "stash_bytes": 4 * 4 * 8 * 10 * n}

    # the per-sample kernel at config 3's shape (one sample, not the centre one)
    sp3, pl3, cam3, pix3 = grad_inputs(scenes["dielectric"], "sm", size)
    seeds3 = G._sample_seeds(0, 2)
    s1 = torch.from_numpy(seeds3[1:]).to(cam3.device)
    cot3 = pix3 * 1e-6
    gk = profiling.sustained(lambda i: G.grad_tile(sp3, pl3, cam3, s1, cot3, center_sample=False,
                                                   **kw), iters=32)
    gp = profiling.sustained(lambda i: G.grad_tile_plain(sp3, pl3, cam3, s1, cot3,
                                                         center_sample=False, **kw),
                             iters=1, windows=3)
    work3 = live_work(sp3, pl3, cam3, [int(seeds3[1])], [0], [False], size, 8, "reference")
    g_bound = bound(4 * 10 * (sp3.shape[0] + pl3.shape[0]) + 4 * (16 + 1 + 3 * n)
                    + 4 * blocks * (9 * sp3.shape[0] + 5 * pl3.shape[0] + 16),
                    forward_ops(work3, sp3.shape[0], pl3.shape[0]) + reverse_ops(work3))
    per_sample = {"ms": gk["median"] * 1e3, "spread_ms": [gk["min"] * 1e3, gk["max"] * 1e3],
                  "plain_ms": gp["median"] * 1e3, "bound_ms": g_bound[0],
                  "bound_by": g_bound[1], "live_work": work3, "stash_bytes": 4 * 8 * 10 * n}

    # the steps: headline fwd+bwd rate, step over forward (interleaved
    # windows, as bench.py), config 3, busy share
    st = profiling.sustained(lambda i: step(i), iters=16)
    fwd = R.make_render_step(scenes["basic"], size, spp=4, max_bounces=8, device="cuda")
    fwd(0)
    s_ws, f_ws = [], []
    for _ in range(9):
        s_ws.append(window_s(lambda i: step(i), 16))
        f_ws.append(window_s(lambda i: fwd(seed=i), 16))
    s_med, f_med = sorted(s_ws)[4], sorted(f_ws)[4]
    t3 = profiling.sustained(lambda i: step3(i), iters=2, windows=3)
    dt = profiling.device_times(lambda i: step(i), iters=10)
    dt3 = profiling.device_times(lambda i: step3(i), iters=2)
    headline = {
        "step_ms": st["median"] * 1e3, "step_spread_ms": [st["min"] * 1e3, st["max"] * 1e3],
        "fwd_bwd_mrays_s": profiling.mrays_per_sec(size, 4, st["median"]),
        "interleaved_step_ms": s_med * 1e3, "interleaved_fwd_ms": f_med * 1e3,
        "fwd_ref_mrays_s": profiling.mrays_per_sec(size, 4, f_med),
        "ratio_step_over_fwd": s_med / f_med,
        "step_device_ms": dt,
        "step_busy_share": sum(dt.values()) / (st["median"] * 1e3),
    }
    config3 = {"step_ms": t3["median"] * 1e3, "step_spread_ms": [t3["min"] * 1e3, t3["max"] * 1e3],
               "fwd_bwd_mrays_s": profiling.mrays_per_sec(size, 64, t3["median"]),
               "step_device_ms": dt3,
               "kernel_device_ms": {k: sum(v for e, v in dt3.items() if k in e)
                                    for k in ("render_kernel", "grad_kernel")},
               "step_busy_share": sum(dt3.values()) / (t3["median"] * 1e3)}
    report["grad_timing"] = {"mse_step_kernel": mono, "grad_kernel": per_sample,
                             "headline_step": headline, "config3_step": config3}
    log(f"[5] mse_step_kernel basic 800x600 4spp d8: kernel {mono['ms']:.4f} ms, plain "
        f"{mono['plain_ms']:.1f} ms, bound {mono['bound_ms']:.4f} ms ({mono['bound_by']}); "
        f"live bounces {work['live']} of {work['rays'] * 8}, warp slots {work['warp_live']} "
        f"| {card}")
    log(f"[5] grad_kernel dielectric/sm 800x600 1 sample d8: kernel {per_sample['ms']:.4f} ms, "
        f"plain {per_sample['plain_ms']:.1f} ms, bound {per_sample['bound_ms']:.4f} ms "
        f"({per_sample['bound_by']}); live bounces {work3['live']} of {work3['rays'] * 8}, "
        f"warp slots {work3['warp_live']} | {card}")
    log(f"[5] headline make_mse_step basic 800x600 4spp d8: {headline['step_ms']:.4f} ms = "
        f"{headline['fwd_bwd_mrays_s']:.1f} Mrays/s fwd+bwd; forward make_render_step "
        f"{headline['interleaved_fwd_ms']:.4f} ms, ratio_step_over_fwd "
        f"{headline['ratio_step_over_fwd']:.3f} (interleaved); device busy "
        f"{headline['step_busy_share']:.3f} | {card}")
    log(f"[5] config 3 make_mse_step dielectric/sm 800x600 64spp d8: {config3['step_ms']:.3f} ms "
        f"= {config3['fwd_bwd_mrays_s']:.1f} Mrays/s fwd+bwd; device ms per step "
        f"{config3['kernel_device_ms']}, device busy {config3['step_busy_share']:.3f} | {card}")
    return {"mse_step_kernel": mono, "grad_kernel": per_sample}


def bw_tables(scene, personality, include_boxes=False):
    """The blockwise kernels' padded tables and counts, on the card."""
    import torch
    from rt_tpu_torch.ops import blockwise as BW

    return BW._device_tables(scene, personality, include_boxes, torch.device("cuda"))


def blockwise_parity(scenes, report):
    """Phase 3 for the blockwise kernels.  Returns max |kernel - plain| per
    kernel."""
    import numpy as np
    import torch
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R

    errs = {"blockwise_kernel": 0.0, "bw_grad_kernel": 0.0}
    report["bw_parity"], report["bw_grad_parity"] = [], []
    seeds = torch.tensor([11], dtype=torch.int32, device="cuda")
    cases = [  # label, scene, personality, size, --boxes, spp, centre sample
        ("basic/mg", "basic", "mg", (800, 600), False, 4, True),
        ("cornell_spheres/sm", "cornell", "sm", (320, 240), False, 4, True),
        ("basic+box/mg --boxes", "basic+box", "mg", (320, 240), True, 4, True),
        ("proc500/mg", "proc500", "mg", (320, 180), False, 4, True),
        ("proc1000/mg", "proc1000", "mg", (160, 90), False, 4, True),
        # the main paths' launches: one sample of the config-4 train step,
        # and one 4-sample chunk of the CLI's 1000-sphere frame
        ("proc500/mg train-step launch", "proc500", "mg", (1920, 1080), False, 1, False),
        ("proc1000/mg cli chunk", "proc1000", "mg", (1920, 1080), False, 4, True),
    ]
    for label, key, pers, size, boxes, spp, center in cases:
        sp, pl, bx, counts = bw_tables(scenes[key], pers, boxes)
        cam = torch.from_numpy(R._pack_camera(scenes[key].camera, size)).cuda()
        kw = dict(size=size, spp=spp, max_bounces=8, center_sample=center)
        got = BW.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, **kw)
        want = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, **kw)
        # the render kernel on the same scene, where it takes it
        unrolled = (R.render_tile(*card_tables(scenes[key], pers, size, boxes)[:3], cam, seeds,
                                  **kw)[0] if sum(counts) <= R.MAX_UNROLL_PRIMS else None)
        torch.cuda.synchronize()
        d = (got - want).abs()
        row = {"case": label, "size": size, "spp": spp, "counts": counts,
               "max_abs": d.max().item(),
               "exact_share": (d.amax(-1) == 0).float().mean().item()}
        if unrolled is not None:
            du = (got - unrolled).abs()
            row.update(vs_render_kernel_max_abs=du.max().item(),
                       vs_render_kernel_exact_share=(du.amax(-1) == 0).float().mean().item())
        report["bw_parity"].append(row)
        log(f"[3] blockwise {label} {size[0]}x{size[1]} {spp}spp d8 ({counts} rows): max|d| "
            f"{row['max_abs']:.3g}, exact {row['exact_share']:.5f}"
            + (f"; vs render kernel max|d| {row['vs_render_kernel_max_abs']:.3g}, exact "
               f"{row['vs_render_kernel_exact_share']:.5f}" if "vs_render_kernel_max_abs" in row
               else ""))
        check(torch.isfinite(got).all().item(), f"blockwise {label}: output not finite")
        check(torch.equal(got, want), f"blockwise {label}: kernel differs from its plain version")
        if "vs_render_kernel_max_abs" in row and key in ("basic", "cornell"):
            check(row["vs_render_kernel_max_abs"] == 0.0,
                  f"blockwise {label}: differs from the render kernel at the same seeds")
        errs["blockwise_kernel"] = max(errs["blockwise_kernel"], row["max_abs"])

    # label, scene, personality, size, centre sample, cotangent scale (that
    # of 2 (img - target) / (3 W H spp)); the last case is one sample of the
    # config-4 train step (16 spp), 2,073,600 rays on the same 500 rows
    grad_cases = [("proc500/mg", "proc500", "mg", (320, 180), False, 1e-6),
                  ("cornell_spheres/sm", "cornell", "sm", (160, 120), True, 1e-6),
                  ("proc500/mg train-step launch", "proc500", "mg", (1920, 1080), False,
                   2.0 / (3 * 1920 * 1080 * 16))]
    for label, key, pers, size, center, scale in grad_cases:
        sp, pl, _, counts = bw_tables(scenes[key], pers)
        cam = torch.from_numpy(R._pack_camera(scenes[key].camera, size)).cuda()
        w, h = size
        cot = torch.from_numpy(np.random.default_rng(3).uniform(0.0, 0.5, (h, w, 3))
                               .astype(np.float32)).cuda() * scale
        kw = dict(size=size, max_bounces=8, center_sample=center)
        got = BG.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, **kw)
        again = BG.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, **kw)
        want, l1 = BG.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot, with_l1=True, **kw)
        torch.cuda.synchronize()
        outs = [(g, a, w_, l) for g, a, w_, l in zip(got, again, want, l1) if g.numel()]
        row = {
            "case": label, "size": size, "counts": counts, "center_sample": center,
            "max_abs": max((g - w_).abs().max().item() for g, a, w_, l in outs),
            "max_ratio_l1": max(((g - w_).abs() / l.clamp_min(1e-30)).max().item()
                                for g, a, w_, l in outs),
            "run_to_run_ratio_l1": max(((g - a).abs() / l.clamp_min(1e-30)).max().item()
                                       for g, a, w_, l in outs),
        }
        report["bw_grad_parity"].append(row)
        log(f"[3] bw_grad {label} {w}x{h} 1 sample d8: max|d| {row['max_abs']:.3g}, max |d|/L1 "
            f"{row['max_ratio_l1']:.3g} (tolerance {GRAD_TOL}), run-to-run |d|/L1 "
            f"{row['run_to_run_ratio_l1']:.3g}")
        for g, a, w_, l in outs:
            check(torch.isfinite(g).all().item(), f"bw_grad {label}: output not finite")
            check(((g - w_).abs() <= GRAD_TOL * l).all().item(),
                  f"bw_grad {label}: kernel differs from its plain version beyond {GRAD_TOL} x L1")
        errs["bw_grad_kernel"] = max(errs["bw_grad_kernel"], row["max_abs"])

    # the blockwise step against the per-sample step at the same seeds: the
    # same function (the render kernel's and the blockwise kernel's frames
    # are equal, the gradient kernels' forward and adjoint too), summed in
    # another order
    from rt_tpu_torch import diff

    size = (200, 150)
    tgt = torch.from_numpy(np.random.default_rng(5).uniform(0.0, 0.5, (150, 200, 3))
                           .astype(np.float32)).cuda()
    params = diff.extract_params(scenes["basic"])
    kw = dict(spp=4, max_bounces=8, device="cuda")
    l_bw, g_bw = BG.bw_mse_loss_and_grad(params, scenes["basic"], tgt, size, seed=21, **kw)
    l_ms, g_ms = G.mse_loss_and_grad(params, scenes["basic"], tgt, size, seed=21, mode="multi",
                                     **kw)
    rel = {k: ((g_bw[k] - g_ms[k]).abs().max() / g_ms[k].abs().max().clamp_min(1e-30)).item()
           for k in g_bw}
    cross = {"loss_blockwise": l_bw.item(), "loss_multi": l_ms.item(),
             "loss_rel_diff": abs(l_bw.item() - l_ms.item()) / l_ms.item(),
             "grad_max_diff_over_max": rel}
    report["bw_vs_multi"] = cross
    log(f"[3] blockwise step vs make_mse_step(multi), basic 200x150 4spp d8: loss "
        f"{cross['loss_blockwise']:.8g} vs {cross['loss_multi']:.8g}; max |d|/max|g| per key "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }")
    check(cross["loss_rel_diff"] <= 1e-5 and max(rel.values()) <= 2e-4,
          "the blockwise step and the per-sample step disagree")
    return errs


def htod_copies(fn):
    """Host-to-device copies made by ``fn()``, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "HtoD" in e.key)


def blockwise_main_paths(scenes, report):
    """Phase 4 for the blockwise route.  Returns (launches per kernel, the
    config-4 train step and its params)."""
    import torch
    from rt_tpu_torch import train
    from rt_tpu_torch.cli import main as cli_main
    from rt_tpu_torch.ops import _build
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R

    wrappers = {"render_kernel": R.render_tile, "mse_step_kernel": G.mse_step_tile,
                "grad_kernel": G.grad_tile, "blockwise_kernel": BW.render_blockwise_tile,
                "bw_grad_kernel": BG.bw_grad_tile}
    total = dict.fromkeys(wrappers, 0)

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def read(label, **want):
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in wrappers.items()}
        for k, v in got.items():
            total[k] += v
        log(f"[4] {label}: launches {got}")
        check(got == dict(dict.fromkeys(wrappers, 0), **want),
              f"{label}: launches {got}, expected {want}")

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        npy = Path(tmp) / "proc1000.npy"
        reset()
        rc = cli_main(["--procedural", "1000", "--renderer", "mg_auto", "--size", "1920x1080",
                       "--spp", "8", "--bounces", "8", "--device", "cuda", "--out", str(npy)])
        read("cli mg_auto --procedural 1000 1920x1080 8spp d8", blockwise_kernel=2)
        check(rc == 0, f"cli exited with {rc}")
        import numpy as np

        frame = np.load(npy)
        check(frame.shape == (1080, 1920, 3) and np.isfinite(frame).all(),
              "the 1000-sphere frame has the wrong shape or is not finite")
        ref = BW.render_forward_blockwise(scenes["proc1000"], (1920, 1080), spp=8,
                                          max_bounces=8, device="cuda").cpu().numpy()
        check(np.array_equal(frame, ref), "the CLI's frame is not render_forward_blockwise's")
        out["cli_1000_mean"] = float(frame.mean())
        log(f"[4] 1000-sphere 1920x1080 frame through the blockwise route, mean {frame.mean():.4f}")

    # BASELINE config 4's training shape through the JAX package's router
    scene, size, spp = scenes["proc500"], (1920, 1080), 16
    target = BW.render_forward_blockwise(scene, size, seed=0, spp=spp, max_bounces=8,
                                         gamma=False, device="cuda")
    params = {"materials.albedo": torch.full_like(scene.materials.albedo, 0.5).cuda()}
    opt = torch.optim.Adam(list(params.values()), lr=5e-2, foreach=True)
    step = train.make_kernel_train_step(opt, scene, target, size, spp=spp, max_bounces=8,
                                        device="cuda")
    built = _build.load_library.cache_info().misses
    reset()
    losses = [step(params, i).item() for i in range(6)]
    read("config-4 train step (500 spheres 1920x1080 16spp d8), 6 steps",
         blockwise_kernel=6 * spp, bw_grad_kernel=6 * spp)
    reset()
    copies = htod_copies(lambda: step(params, 6))
    read("config-4 train step under the profiler, 1 step", blockwise_kernel=spp,
         bw_grad_kernel=spp)
    log(f"[4] config-4 train losses {losses}; host-to-device copies in a step: {copies}")
    check(losses[-1] < losses[0], "the train step did not lower the loss")
    check(copies == 1, f"{copies} host-to-device copies in a train step, expected 1 (the seeds)")
    check(_build.load_library.cache_info().misses == built, "a train step built a library")
    out.update(train_losses=losses, train_htod_copies=copies)

    # bench.py's gradient check through the blockwise step's own loss
    reset()
    name, eps, small = "materials.reflectivity", 1e-3, (200, 150)
    basic = scenes["basic"]
    from rt_tpu_torch import diff

    p0 = diff.extract_params(basic)
    tgt_s = torch.zeros((150, 200, 3), device="cuda")
    kw = dict(seed=17, spp=2, max_bounces=4, device="cuda")
    _, g_small = BG.bw_mse_loss_and_grad(p0, basic, tgt_s, small, **kw)
    fd_losses = []
    for sign in (1, -1):
        p = dict(p0)
        p[name] = p0[name].clone()
        p[name][0] += sign * eps
        fd_losses.append(float(BG.bw_mse_loss_and_grad(p, basic, tgt_s, small, **kw)[0]))
    read("blockwise gradient check (200x150 2spp d4)", blockwise_kernel=6, bw_grad_kernel=6)
    fd = (fd_losses[0] - fd_losses[1]) / (2 * eps)
    an = float(g_small[name][0])
    grad_ok = abs(an - fd) <= max(2e-2 * abs(fd), 1e-4)
    log(f"[4] blockwise grad check: analytic {an:.6g}, central FD {fd:.6g}: grad_ok={grad_ok}")
    check(grad_ok, "the blockwise gradient disagrees with finite differences")
    out.update(grad_ok=grad_ok, grad_an=an, grad_fd=fd)
    report["bw_main_path"] = dict(out, launches=total)
    return total, step, params


def blockwise_timing(scenes, step, params, card, report):
    """Phase 5 for the blockwise kernels and the config-4 train step.
    Returns per-kernel timing rows for the kernels' JSON line."""
    import torch
    from rt_tpu_torch import profiling
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R

    scene, size = scenes["proc500"], (320, 180)
    w, h = size
    n = w * h
    sp, pl, bx, counts = bw_tables(scene, "mg")
    ns, npl = counts[:2]
    cam = torch.from_numpy(R._pack_camera(scene.camera, size)).cuda()
    seeds = torch.tensor([11], dtype=torch.int32, device="cuda")
    kw = dict(size=size, spp=4, max_bounces=8, center_sample=True)
    fk = profiling.sustained(lambda i: BW.render_blockwise_tile(sp, pl, bx, counts, cam, seeds,
                                                                **kw), iters=16)
    # one timed call (plus the untimed first): the plain version takes seconds here
    fp = profiling.sustained(lambda i: BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam,
                                                                      seeds, **kw),
                             iters=1, windows=1, warmup_windows=0)
    r_args = card_tables(scene, "mg", size)[:3]
    fr = profiling.sustained(lambda i: R.render_tile(*r_args, cam, seeds, **kw), iters=16)
    f_work = live_work(sp[:ns, :10], pl[:npl, :10], cam, [11] * 4,
                       [s * (2 + 4 * 8) for s in range(4)], [True, False, False, False], size, 8,
                       "reference")
    table_bytes = 4 * 16 * (ns + npl)
    f_bound = bound(table_bytes + 4 * (16 + 1 + 3 * n), forward_ops(f_work, ns, npl))
    fwd = {"ms": fk["median"] * 1e3, "spread_ms": [fk["min"] * 1e3, fk["max"] * 1e3],
           "plain_ms": fp["median"] * 1e3, "render_kernel_ms": fr["median"] * 1e3,
           "bound_ms": f_bound[0], "bound_by": f_bound[1], "live_work": f_work}

    # the gradient kernel on the same inputs, one sample (not the centre one)
    cot = torch.full((h, w, 3), 1e-6, device="cuda")
    gkw = dict(size=size, max_bounces=8, center_sample=False)
    gk = profiling.sustained(lambda i: BG.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot,
                                                       **gkw), iters=16)
    gp = profiling.sustained(lambda i: BG.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot,
                                                             **gkw), iters=1, windows=3)
    sp10, pl10 = sp[:ns, :10].contiguous(), pl[:npl, :10].contiguous()
    gs = profiling.sustained(lambda i: G.grad_tile(sp10, pl10, cam, seeds, cot, **gkw), iters=16)
    g_work = live_work(sp10, pl10, cam, [11], [0], [False], size, 8, "reference")
    g_bound = bound(table_bytes + 4 * (16 + 1 + 3 * n) + 4 * (9 * ns + 5 * npl + 16),
                    forward_ops(g_work, ns, npl) + reverse_ops(g_work))
    grad = {"ms": gk["median"] * 1e3, "spread_ms": [gk["min"] * 1e3, gk["max"] * 1e3],
            "plain_ms": gp["median"] * 1e3, "grad_kernel_ms": gs["median"] * 1e3,
            "bound_ms": g_bound[0], "bound_by": g_bound[1], "live_work": g_work,
            "stash_bytes_1080p_d8": 4 * 8 * 10 * 1920 * 1080}

    # the 1000-sphere frame the CLI renders, through the entry point (which
    # flattens and uploads the tables on every call, as JAX's does)
    big, big_size = scenes["proc1000"], (1920, 1080)
    serve = lambda i: BW.render_forward_blockwise(big, big_size, seed=i, spp=8, max_bounces=8,
                                                  device="cuda")
    sv = profiling.sustained(serve, iters=2, windows=3)
    dv = profiling.device_times(serve, iters=2)
    serve_row = {
        "frame_ms": sv["median"] * 1e3, "frame_spread_ms": [sv["min"] * 1e3, sv["max"] * 1e3],
        "mrays_s": profiling.mrays_per_sec(big_size, 8, sv["median"]),
        "frame_device_ms": dv,
        "kernel_device_ms": sum(v for e, v in dv.items() if "blockwise_kernel" in e),
        "frame_busy_share": sum(dv.values()) / (sv["median"] * 1e3),
    }

    # the config-4 train step (it keeps training the params)
    st = profiling.sustained(lambda i: step(params, 100 + i), iters=2, windows=3)
    dt = profiling.device_times(lambda i: step(params, 200 + i), iters=2)
    t_size, t_spp = (1920, 1080), 16
    train_row = {
        "step_ms": st["median"] * 1e3, "step_spread_ms": [st["min"] * 1e3, st["max"] * 1e3],
        "fwd_bwd_mrays_s": profiling.mrays_per_sec(t_size, t_spp, st["median"]),
        "step_device_ms": dt,
        "kernel_device_ms": {k: sum(v for e, v in dt.items() if k in e)
                             for k in ("blockwise_kernel", "bw_grad_kernel")},
        "step_busy_share": sum(dt.values()) / (st["median"] * 1e3),
    }
    report["bw_timing"] = {"blockwise_kernel": fwd, "bw_grad_kernel": grad,
                           "serve_1000_1920x1080_8spp_d8": serve_row,
                           "config4_train_step": train_row}
    log(f"[5] blockwise_kernel proc500 320x180 4spp d8: kernel {fwd['ms']:.4f} ms (render kernel "
        f"on the same inputs {fwd['render_kernel_ms']:.4f} ms), plain {fwd['plain_ms']:.1f} ms, "
        f"bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}) | {card}")
    log(f"[5] bw_grad_kernel proc500 320x180 1 sample d8: kernel {grad['ms']:.4f} ms (per-sample "
        f"kernel on the same inputs {grad['grad_kernel_ms']:.4f} ms), plain "
        f"{grad['plain_ms']:.1f} ms, bound {grad['bound_ms']:.4f} ms ({grad['bound_by']}) | {card}")
    log(f"[5] 1000-sphere frame 1920x1080 8spp d8 (render_forward_blockwise): "
        f"{serve_row['frame_ms']:.2f} ms = {serve_row['mrays_s']:.1f} Mrays/s (kernel "
        f"{serve_row['kernel_device_ms']:.2f} ms of device time, device busy "
        f"{serve_row['frame_busy_share']:.3f}) | {card}")
    log(f"[5] config-4 train step (500 spheres 1920x1080 16spp d8, Adam): "
        f"{train_row['step_ms']:.2f} ms = {train_row['fwd_bwd_mrays_s']:.1f} Mrays/s fwd+bwd; "
        f"device ms per step {train_row['kernel_device_ms']}, device busy "
        f"{train_row['step_busy_share']:.3f} | {card}")
    return {"blockwise_kernel": fwd, "bw_grad_kernel": grad}


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import rt_tpu_torch
    from rt_tpu_torch import profiling
    from rt_tpu_torch.cli import main as cli_main
    from rt_tpu_torch.colour import pack_rgba8888
    from rt_tpu_torch.ops import _build
    from rt_tpu_torch.ops import render as R

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report = {"card": card, "kind": kind}

    # ---- 2. build ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        libs = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    build_s = time.perf_counter() - t0
    log(f"[2] build: {', '.join(lib.name for lib in libs.values())} in {build_s:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    report["build_s"] = build_s
    report["ptxas"] = {}
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln or "stack" in ln]
        for ln in ptxas:
            log(f"    {name}: {ln}")
        report["ptxas"][name] = ptxas

    # ---- 3. kernel against plain version, on the card ----
    scenes = {
        "basic": rt_tpu_torch.load(str(ROOT / "scenes" / "basic.toml")),
        "dielectric": rt_tpu_torch.load(str(ROOT / "scenes" / "dielectric.toml")),
        "basic+box": rt_tpu_torch.loads(
            (ROOT / "scenes" / "basic.toml").read_text()
            + "\nboxes = [ { material = 2, position = [-1, 0.5, 0.3], "
              "extents = [0.3, 0.5, 0.3] } ]\n"),
        "proc500": rt_tpu_torch.scene.make_procedural_scene(500),
        "proc1000": rt_tpu_torch.scene.make_procedural_scene(1000),
    }

    def tile_args(scene, personality, size, include_boxes=False, seed=11):
        seeds = torch.tensor([seed], dtype=torch.int32, device=dev)
        return (*card_tables(scene, personality, size, include_boxes), seeds)

    cases = [
        ("basic/mg", "basic", "mg", (800, 600), False),
        ("dielectric/sm", "dielectric", "sm", (800, 600), False),
        ("basic+box/mg --boxes", "basic+box", "mg", (800, 600), True),
        ("proc500/mg", "proc500", "mg", (320, 180), False),
    ]
    max_err = 0.0
    report["parity"] = []
    for label, key, pers, size, boxes in cases:
        args = tile_args(scenes[key], pers, size, boxes)
        kw = dict(size=size, spp=4, max_bounces=8, center_sample=True)
        got = R.render_tile(*args, **kw)
        want = R.render_tile_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        px = diff.amax(dim=-1)
        row = {
            "case": label, "size": size, "max_abs": diff.max().item(),
            "mean_abs": diff.mean().item(),
            "share_gt_1e-3": (px > 1e-3).float().mean().item(),
            "exact_share": (px == 0).float().mean().item(),
        }
        report["parity"].append(row)
        log(f"[3] {label} {size[0]}x{size[1]} 4spp d8: max|d| {row['max_abs']:.3g} "
            f"mean|d| {row['mean_abs']:.3g} px>1e-3 {row['share_gt_1e-3']:.5f} "
            f"exact {row['exact_share']:.5f}")
        check(torch.isfinite(got).all().item(), f"{label}: kernel output not finite")
        check(torch.equal(got, want), f"{label}: kernel differs from its plain version")
        max_err = max(max_err, row["max_abs"])
    scenes["cornell"] = rt_tpu_torch.load(str(ROOT / "scenes" / "cornell_spheres.toml"))
    grad_errs = grad_parity(scenes, report)
    bw_errs = blockwise_parity(scenes, report)

    # ---- 4. main path through the entry points ----
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "basic.png"
        R.render_tile.launches = 0
        rc = cli_main(["--scene", str(ROOT / "scenes" / "basic.toml"), "--renderer", "mg_auto",
                       "--size", "800x600", "--spp", "4", "--bounces", "8",
                       "--device", "cuda", "--out", str(png)])
        step4 = R.make_render_step(scenes["proc500"], (1920, 1080), spp=16, max_bounces=8,
                                   device="cuda")
        frame4 = step4(seed=0)
        torch.cuda.synchronize()
        launches = R.render_tile.launches
        log(f"[4] main path: cli rc={rc}, config-4 step frame {tuple(frame4.shape)}; "
            f"render kernel launches: {launches}")
        check(rc == 0, f"cli exited with {rc}")
        check(launches == 1 + 4, f"{launches} kernel launches, expected one per sample chunk (5)")
        check(frame4.shape == (1080, 1920, 3) and torch.isfinite(frame4).all().item(),
              "config-4 frame has the wrong shape or is not finite")
        check(0.05 < frame4.mean().item() < 2.0, f"config-4 frame mean {frame4.mean().item()}")
        rgba = png_rgba(png)
        ref = R.render_forward(scenes["basic"], (800, 600), spp=4, max_bounces=8, device="cuda")
        check(rgba.shape == (600, 800, 4), f"PNG shape {rgba.shape}")
        words = pack_rgba8888(ref)
        np.testing.assert_array_equal(rgba[..., 0], (words >> 24) & 0xFF)
        np.testing.assert_array_equal(rgba[..., 1], (words >> 16) & 0xFF)
        np.testing.assert_array_equal(rgba[..., 2], (words >> 8) & 0xFF)
        log(f"[4] PNG {png.name} decodes to the kernel's frame ({rgba.shape[1]}x{rgba.shape[0]})")
        report["main_path"] = {"cli_rc": rc, "launches": launches,
                               "config4_mean": frame4.mean().item()}
    grad_launches, step_mse, step_c3 = grad_main_paths(scenes, report)
    bw_launches, step_bw, params_bw = blockwise_main_paths(scenes, report)

    # ---- 5. timing (CUDA events; device time by kernel from the profiler) ----
    size = (800, 600)
    args = tile_args(scenes["basic"], "mg", size)
    kw = dict(size=size, spp=4, max_bounces=8, center_sample=True)
    step1 = R.make_render_step(scenes["basic"], size, spp=4, max_bounces=8, device="cuda")
    k_s = profiling.sustained(lambda i: R.render_tile(*args, **kw), iters=32)
    p_s = profiling.sustained(lambda i: R.render_tile_plain(*args, **kw), iters=4, windows=3)
    s_s = profiling.sustained(lambda i: step1(seed=i), iters=32)
    t4 = profiling.sustained(lambda i: step4(seed=i), iters=3, windows=3)
    d1 = profiling.device_times(lambda i: step1(seed=i), iters=20)
    d4 = profiling.device_times(lambda i: step4(seed=i), iters=3)

    def kernel_ms(d):
        return sum(v for k, v in d.items() if "render_kernel" in k)

    timing = {
        "basic_800x600_4spp_d8": {
            "kernel_ms": k_s["median"] * 1e3,
            "kernel_spread_ms": [k_s["min"] * 1e3, k_s["max"] * 1e3],
            "plain_ms": p_s["median"] * 1e3,
            "plain_spread_ms": [p_s["min"] * 1e3, p_s["max"] * 1e3],
            "step_ms": s_s["median"] * 1e3,
            "step_spread_ms": [s_s["min"] * 1e3, s_s["max"] * 1e3],
            "step_mrays_s": profiling.mrays_per_sec(size, 4, s_s["median"]),
            "step_device_ms": d1, "step_kernel_device_ms": kernel_ms(d1),
            "step_busy_share": sum(d1.values()) / (s_s["median"] * 1e3),
        },
        "config4_1920x1080_16spp_d8_500spheres": {
            "step_ms": t4["median"] * 1e3,
            "step_spread_ms": [t4["min"] * 1e3, t4["max"] * 1e3],
            "step_mrays_s": profiling.mrays_per_sec((1920, 1080), 16, t4["median"]),
            "step_device_ms": d4, "step_kernel_device_ms": kernel_ms(d4),
            "step_busy_share": sum(d4.values()) / (t4["median"] * 1e3),
        },
    }
    report["timing"] = timing
    b = timing["basic_800x600_4spp_d8"]
    c4 = timing["config4_1920x1080_16spp_d8_500spheres"]
    log(f"[5] basic 800x600 4spp d8: kernel {b['kernel_ms']:.4f} ms, plain {b['plain_ms']:.2f} ms; "
        f"make_render_step {b['step_ms']:.4f} ms = {b['step_mrays_s']:.1f} Mrays/s "
        f"(kernel {b['step_kernel_device_ms']:.4f} ms of device time, device busy "
        f"{b['step_busy_share']:.3f}) | {card}")
    log(f"[5] config 4 1920x1080 16spp d8 500 spheres: make_render_step {c4['step_ms']:.2f} ms "
        f"= {c4['step_mrays_s']:.1f} Mrays/s (kernel {c4['step_kernel_device_ms']:.2f} ms of "
        f"device time, device busy {c4['step_busy_share']:.3f}) | {card}")
    sp_b, pl_b = args[0], args[1]
    r_work = live_work(sp_b, pl_b, args[3], [11] * 4, [s * (2 + 4 * 8) for s in range(4)],
                       [True, False, False, False], size, 8, "reference")
    n_px = size[0] * size[1]
    r_bound = bound(4 * (10 * (sp_b.shape[0] + pl_b.shape[0]) + 16 + 1 + 3 * n_px),
                    forward_ops(r_work, sp_b.shape[0], pl_b.shape[0]))
    b.update(bound_ms=r_bound[0], bound_by=r_bound[1], live_work=r_work)
    log(f"[5] render_kernel bound {r_bound[0]:.4f} ms ({r_bound[1]}); live bounces "
        f"{r_work['live']} of {r_work['rays'] * 8}, warp slots {r_work['warp_live']} | {card}")
    g_rows = grad_timing(scenes, step_mse, step_c3, card, report)
    bw_rows = blockwise_timing(scenes, step_bw, params_bw, card, report)

    check("jax" not in sys.modules and "rt_tpu" not in sys.modules, "JAX was imported")
    log("[report] " + json.dumps(report))

    kernels = [{
        "name": "render_kernel",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rt_tpu/ops/pallas_render.py:171",
        "launches": launches + grad_launches["render_kernel"],
        "max_abs_err": max_err,
        "ms": b["kernel_ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
    }]
    for name, replaces in (("mse_step_kernel", "rt_tpu/ops/pallas_grad.py:1249"),
                           ("grad_kernel", "rt_tpu/ops/pallas_grad.py:207")):
        row = g_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "rt_tpu_torch/csrc/grad_kernel.cu",
            "replaces": replaces, "launches": grad_launches[name],
            "max_abs_err": grad_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    for name, replaces in (("blockwise_kernel", "rt_tpu/ops/pallas_blockwise.py:1073"),
                           ("bw_grad_kernel", "rt_tpu/ops/pallas_blockwise_grad.py:92")):
        row = bw_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"rt_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": bw_launches[name],
            "max_abs_err": bw_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
