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
   4 spp, 8 bounces, the procedural 500-sphere scene at 320x180, the
   tie-heavy scene (--boxes) and a grazing one (a camera along a radius-1000
   sphere, small spheres on it) at 320x240, and one 4-spp launch of the
   config-4 frame (500 spheres, 1920 wide, 540 high for the plain
   version's time); they must agree bit for bit.  Gradient kernels: the mono step on basic.toml
   (mg) at 800x600 4 spp and cornell_spheres.toml (sm, planes and
   dielectrics) at 320x240 2 spp, the per-sample kernel on dielectric.toml
   (sm) at 800x600 (2 samples) and on 500 spheres at 320x180, all at depth
   8 and again at 64x48, and what the warp-level sums could get wrong: a
   ragged 37x23 frame (mono, 4 spp, and per-sample), 90 spheres at 64x48
   2 spp (many winners in a warp, still the mono route) and 640 spheres
   per-sample at 320x180; every output within 1e-5 of the sum of the
   magnitudes of its per-(pixel, sample) contributions (the kernels sum
   per-primitive gradients per warp, then per block, the per-sample
   kernel's blocks with atomics; the run-to-run spread of two launches is
   printed, and whether they are equal).  Blockwise forward kernel, depth
   8, bit for bit: 4 spp on basic.toml at 800x600, cornell_spheres.toml
   (sm) and basic+box (--boxes) at 320x240, 500 spheres at 320x180 and
   1000 spheres (past the render kernel's 640) at 160x90, the tie-heavy
   (--boxes) and grazing scenes at 320x240 (4 spp, and one sample in the
   words form), 2100 spheres (past the 2048 rows staged in shared
   memory: rows from device memory) at 64x36 in the words form; at the main
   paths' shapes, 500 spheres at 1920x1080 1 spp (a train-step launch)
   and 1000 spheres at 1920x1080 4 spp (a CLI chunk); and against the
   render kernel on basic and cornell at the same seeds; at 1 spp also
   the words form (the train step's launch: frame and winner words) bit for
   bit.  Blockwise gradient kernel, one sample, depth 8, along its forward
   launch's winner words, within 1e-5 x L1 with the run-to-run spread: 500
   spheres at 320x180 and at 1920x1080 (a train-step launch), cornell and
   dielectric (sm) at 160x120, each with the count of refractions with
   sin2 == 1 (where the render bounce and the gradient sweep could part);
   and the blockwise step against make_mse_step(mode="multi") on basic.toml
   at the same seeds.  Wavefront kernels, depth 8: every launch of a sample chunk
   (gen, then bounces 1-7 with the compaction sorts and the live-prefix
   limit), in plain and record mode, bit for bit with wf_bounce_plain on
   basic.toml (mg), cornell_spheres.toml (sm) and basic+box (--boxes) at
   320x240 2 spp and 2000 spheres (past 1536) at 160x90 2 spp, each chunk
   equal to the blockwise kernel's; every reverse launch of the cornell and
   2000-sphere chunks within 1e-5 x L1 of wf_rev_plain, with the
   run-to-run spread, and what the reverse's per-warp sums by winner could
   get wrong: the 2000-sphere chunk with one winner for every lane of a
   warp, with a winner per lane, with the live prefix ending mid-warp, and
   a ragged 37x23 one-sample chunk (851 rays); and at the main path's shape, one 2-spp chunk of
   BASELINE config 5's slice (5000 spheres, 960x540), both kernels against
   their plain versions (the plain times are printed); the split scan of
   the later bounces on a tie-heavy scene (sphere rows duplicated side by
   side and across the table, two equal boxes, --boxes) and a mostly-sky
   one at 640x480, every launch of a chunk bit for bit and the chunk equal
   to the blockwise kernel's, and bounce 1 at live-prefix limits that give
   each ray 1, 2, 4, 8, 16 and 32 lanes.  Record kernels,
   depth 8, both centre-sample settings, bit for bit (every record array
   and the radiance) with their plain versions and their radiance equal to
   the 1-spp frame at the same seed: the render kernel's record form and
   the blockwise one on basic.toml (mg), dielectric.toml (sm) and
   basic+box (--boxes) at 800x600, the blockwise one also on 660 spheres +
   24 boxes (past 640 primitives) at 320x240, 2100 spheres + 24 boxes (past
   the 2048 sphere rows its rejecting scan stages in shared memory) at
   160x120, and the tie-heavy (--boxes) and grazing scenes at 320x240.
   The FMA probe at k = 1024 and 4096 within 1e-5 of its plain version.
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
   kernels, copy nothing to the card but the seeds and build nothing (its
   peak device memory is printed); and bench.py's gradient check through
   bw_mse_loss_and_grad.  The wavefront
   route, on BASELINE config 5's slice (5000 spheres, 960x540, 2 spp,
   depth 8): the CLI (mg_auto) renders it with 8 wavefront launches, equal
   to render_forward_blockwise's frame at the same seed (torch.equal); the
   wavefront step at 1 spp and seed S*100003 against the blockwise step at
   seed S (matched draws): equal loss, gradients within 2e-4 x max|g|; 6
   steps of train.make_kernel_train_step (Adam on materials.albedo at lr
   5e-2 from 0.5, the target rendered at the true albedo): the loss must
   fall, each step must launch 8 forward and 8 reverse kernels, copy
   nothing to the card but the chunk seeds and build nothing.  The records
   route (diff.records_loss_and_grad; TF32 must be off): (a) at the
   headline shape (basic.toml 800x600, 4 spp, depth 8; 4 record launches)
   against mse_loss_and_grad at the same seed (the mono kernel; the same
   paths and draws): the loss to rel 1e-5, each gradient to 2e-4 x max|g|
   with rtol 2e-3; (b) 5 steps of descent on camera.position alone for
   dielectric.toml (sm) towards a frame rendered at a shifted camera: the
   loss must fall; (c) 660 spheres + 24 boxes at 960x540, 2 spp, depth 8
   through the blockwise record kernel: non-zero box gradients, and
   central finite differences on materials.albedo[0, 0] (through the
   route) and on the boxes.center entry with the largest gradient (on the
   replay with the records held: moving a box moves its silhouette, a
   term the detached-sampling gradient leaves out; the full-pipeline
   difference is printed beside it) within 3e-2, and the box-centre
   gradient split by ray (each ray that reaches the box replays with its
   own copy of the box table): the shares must sum to the route's
   gradient, the largest are printed (``--box-rays NPZ`` writes them, for
   tests/test_torch_box_centre.py); peak device memory printed; (d) the
   roofline probe at k = 1024 and 4096.
5. Timing: CUDA events around back-to-back calls
   (rt_tpu_torch.profiling.sustained) for every kernel (the mono and
   per-sample gradient kernels also by their CUPTI device time, which the
   kernels line adds as device_ms: their wrappers' host work is as long as
   the per-sample kernel; the blockwise kernels at 320x180 and, as the
   kernels line gives them, at a config-4 train-step launch, 1920x1080 one
   sample: the forward's words and serving forms and the gradient kernel,
   with a whole step's count of sin2 == 1 refractions), its plain version,
   make_render_step and make_mse_step (fwd+bwd Mrays/s), the step over the
   same-shape forward in interleaved windows (ratio_step_over_fwd, as
   bench.py measures it), config 3's step, the blockwise kernels (beside
   the render and per-sample kernels on the same 500-sphere inputs) and
   the config-4 train step, and a profiler trace (profiling.device_times)
   for the kernels' device time and the card's busy share within a step.
   The wavefront kernels per launch on the 2-spp config-5 chunk (CUPTI
   device time), and per bounce (CUDA events around each launch, the stream
   held while the host queues the chunk) with each bounce's live rays,
   lanes per ray and bound, the reverse's bounce-0 and bounces 1-7 device
   time each beside its bound (whose bytes count the float64 atomics the
   kernel issues, 8 B each, counted from the saved winner words);
   the config-5 slice's frame and train step each beside
   the blockwise route's in 5 interleaved windows (and the frame with a
   sort before every bounce, which must be the same frame).  Each record
   kernel per launch (the render kernel's at the headline shape, the
   blockwise one on the 684-primitive box scene at 960x540), the (a) step
   beside the mono step in interleaved windows with its device time split
   between the record kernels and the replay's autograd, the (c) box-scene
   step (960x540, 2 spp) with the same split, and the FMA probe
   in TFLOP/s at k = 1024 and 4096 with its K-scaling verdict.
   Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
   FP32 operations over 33.5 Top/s, the operations counted from the kernel
   sources (OPS below) times the live bounces of this run's inputs (the
   scan's share grows with the table): each live (ray, sphere row) pair
   pays the reject part of the row test, and only the pairs with disc >= 0
   (counted on the card from the serial scan's disc) its root part.  The
   render kernel is timed and bounded at one 4-spp launch of the config-4
   frame too, with the live bounces, the warps' bounce slots (warp_live)
   and the disc >= 0 pairs beside its bound, as for the blockwise kernel's
   config-4 train-step launch.

6. The jnp-style path (rt_tpu's own front door: torch ops, no kernel;
   every kernel counter is reset before it and read after, and none may
   have launched).  (a) The threefry bits (``random_bits`` and ``uniform``)
   equal on the card and the CPU for 2 seeds x 3 fold chains x 65536x3
   counters, and ``closest_hit`` on 2^17 random rays of basic+box
   (--boxes), cornell, 500 spheres and the tie-heavy scene (--boxes):
   every winner equal to the CPU's, the largest |dt| printed.  (b) The CLI
   without --renderer on basic.toml at 800x600 with the scene's 30 spp and
   10 bounces: ``mg`` resolves to mg_ray_tracer and writes its PNG; the
   frame time, Mrays/s and the card's busy share of a 1-spp frame; the
   card's 96x64 4-spp frame against the CPU's (2e-5 on >= 99.5% of
   pixels); the rasterizer and null renderers at 800x600.  (c) mg_auto on
   17000 procedural spheres at 320x240, 1 spp, depth 4: route "jnp", its
   warning, the frame time.  (d) ``diff.loss_and_grad`` at the README's
   shape (basic, 800x600, 4 spp, depth 4) in both grad modes: the losses
   to rel 1e-5, the gradients within atol 3e-4 x max|g| and rtol 3e-3, a
   central FD on materials.reflectivity[0] within 2e-2 (bench.py's rule),
   each mode's time and peak memory.  (e) ``train.fit`` on
   examples/inverse_rendering.py's set-up (96x64, 4 spp, depth 4, lr 3e-2,
   albedo) for 30 steps must lower the loss; 4 steps against 2 steps and a
   resume from the step-2 checkpoint, within 1e-6 relative; a step of the
   README's fit at 400x300 timed.

The last two lines are the card line and {"ok": true, "device": ...};
the line before them is the per-kernel JSON summary, and the line before
that ("[report] ...") holds every number the run measured.
"""

from __future__ import annotations

import argparse
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
KERNEL_SOURCES = ("render_kernel", "grad_kernel", "blockwise_kernel", "bw_grad_kernel",
                  "wavefront_kernel", "wf_grad_kernel", "fma_peak_kernel")

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
# counts one; the integer hash and integer compares are not FP32 work).
# Forward, per live bounce: the scan of every plane and sphere, then the
# miss (sky) or hit work (hit point, draws, throughput, class tests) plus
# the sphere normal and the material's scatter.  A sphere row is two
# counts, from trace.cuh's scan_spheres_rejecting: scan_sphere_reject, paid
# by every (live ray, row) pair (ocx, ocy, ocz: 3; bq: 3 multiplies, 2 adds;
# c0: 3 multiplies, 3 adds, rr = r * r being a row constant; disc: 2; the
# disc >= 0 compare: 1), and scan_sphere_hit, paid only by the pairs with
# disc >= 0 (the square root, t0, t1, the t0 >= kMinHit compare and select,
# t >= kMinHit, t < best, t == best, the select of best).  Reverse, per
# live bounce: the pass-through and throughput transpose, the sky term on
# a miss, and on a hit the winner's t/normal recompute and transpose plus
# the material's.
OPS = dict(raygen=40, scan_plane=20, scan_sphere_reject=17, scan_sphere_hit=9, fwd_miss=12,
           fwd_hit=35, fwd_sphere=14,
           fwd_lambert=14, fwd_metal=37, fwd_dielectric=71, rev_live=50, rev_miss=20,
           rev_sphere=128, rev_plane=60, rev_lambert=34, rev_metal=83, rev_dielectric=166,
           raygen_adjoint=70, loss=15, scan_box=33, box_setup=6, fwd_box=22, record=40,
           record_miss=55, record_draws=12)

# Gradient kernels against their plain versions on the card: the per-ray
# arithmetic is the same (--fmad=false, the same expressions in the same
# order), so only the order of the sums over pixels and samples differs,
# and the kernels add per-primitive gradients with shared-memory atomics.
# Every output must agree within GRAD_TOL times the sum of the magnitudes of
# its per-(pixel, sample) contributions (the plain version's l1 output).
GRAD_TOL = 1e-5


def camera_rays(cam, size, seed, base, center):
    """The camera rays of one sample (counter base ``base``; the pixel
    centre if ``center``), in pixel order: (o3, d3), as the kernels make
    them (rt_tpu_torch.ops._grad_math.raygen)."""
    import torch
    from rt_tpu_torch.ops import _grad_math as gm
    from rt_tpu_torch.ops.render import _inv_size, hash_u01

    w, h = size
    idx = torch.arange(w * h, device=cam.device, dtype=torch.int64)
    px, py = (idx % w).float(), (idx // w).float()
    inv_w, inv_h = _inv_size(w, h)
    jx, jy = (0.5, 0.5) if center else (hash_u01(idx, seed, base + 1),
                                        hash_u01(idx, seed, base + 2))
    return gm.raygen(cam.tolist(), px, py, jx, jy, inv_w, inv_h)


def disc_counts(spheres, o3, d3, live):
    """``(pairs, warp_rows)`` of one bounce: the (live ray, sphere row)
    pairs whose disc is >= 0 (the serial scan's disc, with its expressions
    in its order: the pairs that pay the rejecting scan's root work), and,
    per warp of 32 consecutive rays, the rows on which some live lane passes
    (the rows on which the warp runs that work).  Counted on the device of
    the rays, in chunks of about 2^24 pairs."""
    import torch

    cx, cy, cz, r = (spheres[:, j] for j in range(4))
    rr = r * r
    n, rows = o3[0].shape[0], spheres.shape[0]
    chunk = max(32, ((1 << 24) // max(rows, 1)) // 32 * 32)
    pairs = warp_rows = 0
    for s in range(0, n if rows else 0, chunk):
        e = min(s + chunk, n)
        lv = live[s:e]
        if not bool(lv.any()):
            continue
        ox, oy, oz, dx, dy, dz = (t[s:e, None] for t in (*o3, *d3))
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        bq = ocx * dx + ocy * dy + ocz * dz
        c0 = ocx * ocx + ocy * ocy + ocz * ocz - rr
        passed = ((bq * bq - c0) >= 0.0) & lv[:, None]
        pairs += int(passed.sum())
        pad = (-(e - s)) % 32
        if pad:
            passed = torch.cat([passed, passed.new_zeros((pad, rows))])
        warp_rows += int(passed.view(-1, 32, rows).any(dim=1).sum())
    return pairs, warp_rows


def live_work(spheres, planes, cam, seeds, bases, centers, size, max_bounces, rng_mode,
              words=None, pairs=True):
    """Live work of these inputs, counted from the plain forward's
    per-bounce masks (rt_tpu_torch.ops._grad_math): rays, live bounces,
    misses, sphere and plane hits, and hits per material class.  ``seeds``,
    ``bases`` (counter offsets) and ``centers`` give each sample's draws.
    ``warp_live`` counts the bounce slots the kernels' warps issue: per warp
    of 32 consecutive pixels and per sample, 32 times the most live bounces
    of any of its pixels (a lane whose ray died waits for the others).
    With ``pairs`` (disc_counts, per bounce), ``disc_pairs`` counts the
    (live ray, sphere row) pairs with disc >= 0 and ``disc_warp_rows`` the
    (warp, row) slots in which some lane has one.
    ``words`` (per sample, the forward kernel's (max_bounces, N) winner
    words, one-sample calls at counter base 0) replays each bounce's winner
    (``_grad_math.replay_winner``, as the blockwise gradient kernel does)
    in place of the scan, which is far cheaper at 1080p; the sweep is the
    gradient's (``_bounce_forward``).  ``refractions`` counts the live
    dielectric hits that refract and ``sin2_one`` those of them with sin2
    == 1.0f exactly, the one case where the render bounce and the gradient
    sweep part (csrc/bw_grad_kernel.cu)."""
    import torch
    from rt_tpu_torch.ops import _grad_math as gm
    from rt_tpu_torch.ops.render import hash_u01

    w, h = size
    n = w * h
    dev = cam.device
    idx = torch.arange(n, device=dev, dtype=torch.int64)
    keys = ("live", "miss", "sphere", "plane", "lambert", "metal", "dielectric")
    extra = ("warp_live", "refractions", "sin2_one") + (("disc_pairs", "disc_warp_rows")
                                                        if pairs else ())
    counts = dict.fromkeys(keys + extra, 0)
    counts["rays"] = n * len(seeds)
    for si, (seed, base, center) in enumerate(zip(seeds, bases, centers)):
        o3, d3 = camera_rays(cam, size, seed, base, center)
        thr3 = (torch.ones(n, device=dev),) * 3
        live = torch.ones(n, dtype=torch.bool, device=dev)
        nb = torch.zeros(n + (-n) % 32, dtype=torch.int64, device=dev)
        for b in range(max_bounces):
            nb[:n] += live
            if pairs:
                p, wr = disc_counts(spheres, o3, d3, live)
                counts["disc_pairs"] += p
                counts["disc_warp_rows"] += wr
            u3 = gm.unit_draws(idx, seed, base + 3 + 4 * b, rng_mode == "sphere")
            coin = hash_u01(idx, seed, base + 6 + 4 * b)
            if words is None:
                best, bidx, ispl, root = gm.scan(spheres, planes, o3, d3)
            else:
                best, bidx, ispl, root = gm.replay_winner(spheres, planes, o3, d3, words[si][b])
            pay, cls = gm.payload(spheres, planes, best < 1e37, ispl, bidx)
            lv = live
            bits, geo = gm._decide(o3, d3, live, best, pay, cls, ispl, root, u3, coin)
            refract = bits["live_h"] & bits["is_die"] & ~bits["refl"]
            counts["refractions"] += int(refract.sum())
            counts["sin2_one"] += int((refract & (geo["sin2"] == 1.0)).sum())
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
            + work["live"] * (n_planes * OPS["scan_plane"] + n_spheres * OPS["scan_sphere_reject"])
            + (work["disc_pairs"] * OPS["scan_sphere_hit"] if n_spheres else 0)
            + work["miss"] * OPS["fwd_miss"] + hits * OPS["fwd_hit"]
            + work["sphere"] * OPS["fwd_sphere"] + work["lambert"] * OPS["fwd_lambert"]
            + work["metal"] * OPS["fwd_metal"] + work["dielectric"] * OPS["fwd_dielectric"])


def reverse_ops(work):
    return (work["rays"] * (OPS["raygen"] + OPS["raygen_adjoint"])
            + work["live"] * OPS["rev_live"] + work["miss"] * OPS["rev_miss"]
            + work["sphere"] * OPS["rev_sphere"] + work["plane"] * OPS["rev_plane"]
            + work["lambert"] * OPS["rev_lambert"] + work["metal"] * OPS["rev_metal"]
            + work["dielectric"] * OPS["rev_dielectric"])


def grad_ops(work):
    """FP32 operations of the blockwise gradient kernel on this live work:
    per live hit its winner's own test (replay_winner: one sphere or plane
    row, no scan; a miss needs none), the rest of the forward bounce and
    the reverse."""
    return (forward_ops(work, 0, 0)
            + work["sphere"] * (OPS["scan_sphere_reject"] + OPS["scan_sphere_hit"])
            + work["plane"] * OPS["scan_plane"] + reverse_ops(work))


def grad_bytes(work, n, n_spheres, n_planes):
    """Bytes the blockwise gradient kernel must move on this live work,
    each input read once and each output written once: the used rows of the
    tables, the camera and seed, the pixel cotangent, the winner word of
    every live bounce, and the float64 gradient tables (read and written:
    they are added to)."""
    return (64 * (n_spheres + n_planes) + 4 * (16 + 1) + 12 * n + 4 * work["live"]
            + 2 * 8 * (9 * n_spheres + 5 * n_planes + 16))


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


def kernel_device_ms(fn, name, iters=16):
    """The device ms per call of fn(i) spent in kernels whose name holds
    `name` (a CUPTI trace): a kernel's own time, where its wrapper's host
    work may be as long as the kernel."""
    from rt_tpu_torch import profiling

    return sum(v for k, v in profiling.device_times(fn, iters=iters).items()
               if name in k and "bw_" not in k)


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
    # what the warp-level aggregation could get wrong: a ragged last warp
    # (37x23 = 851 pixels, no multiple of 32), many winners in one warp on
    # the mono route (90 spheres, which the router keeps there) and the
    # per-sample route's largest table (640 primitives)
    cases += [
        ("mono basic/mg ragged", "basic", "mg", (37, 23), 4, True),
        ("mono proc90/mg", "proc90", "mg", (64, 48), 2, True),
        ("per-sample dielectric/sm ragged", "dielectric", "sm", (37, 23), 2, False),
        ("per-sample proc640/mg", "proc640", "mg", (320, 180), 1, False),
    ]
    check(G.route(90, 2, 8) == "mono", "the router no longer keeps 90 spheres on the mono route")
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
                "run_to_run_equal": all(torch.equal(g, a) for g, a, w, l in outs),
            }
            report["grad_parity"].append(row)
            log(f"[3] {label} {size[0]}x{size[1]} {spp}spp d8"
                f"{'' if mono else f' sample {s}'}: max|d| {row['max_abs']:.3g}, "
                f"max |d|/L1 {row['max_ratio_l1']:.3g} (tolerance {GRAD_TOL}), run-to-run "
                f"|d|/L1 {row['run_to_run_ratio_l1']:.3g} (equal {row['run_to_run_equal']})")
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
    md = kernel_device_ms(lambda i: G.mse_step_tile(sp, pl, cam, seeds_t, tgt, **kw),
                          "mse_step_kernel")
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
            "device_ms": md,
            "plain_ms": mp["median"] * 1e3, "bound_ms": m_bound[0], "bound_by": m_bound[1],
            "live_work": work, "stash_bytes": 4 * 4 * 8 * 10 * n}

    # the per-sample kernel at config 3's shape (one sample, not the centre one)
    sp3, pl3, cam3, pix3 = grad_inputs(scenes["dielectric"], "sm", size)
    seeds3 = G._sample_seeds(0, 2)
    s1 = torch.from_numpy(seeds3[1:]).to(cam3.device)
    cot3 = pix3 * 1e-6
    gk = profiling.sustained(lambda i: G.grad_tile(sp3, pl3, cam3, s1, cot3, center_sample=False,
                                                   **kw), iters=32)
    gd = kernel_device_ms(lambda i: G.grad_tile(sp3, pl3, cam3, s1, cot3, center_sample=False,
                                                **kw), "grad_kernel")
    gp = profiling.sustained(lambda i: G.grad_tile_plain(sp3, pl3, cam3, s1, cot3,
                                                         center_sample=False, **kw),
                             iters=1, windows=3)
    work3 = live_work(sp3, pl3, cam3, [int(seeds3[1])], [0], [False], size, 8, "reference")
    g_bound = bound(4 * 10 * (sp3.shape[0] + pl3.shape[0]) + 4 * (16 + 1 + 3 * n)
                    + 4 * blocks * (9 * sp3.shape[0] + 5 * pl3.shape[0] + 16),
                    forward_ops(work3, sp3.shape[0], pl3.shape[0]) + reverse_ops(work3))
    per_sample = {"ms": gk["median"] * 1e3, "spread_ms": [gk["min"] * 1e3, gk["max"] * 1e3],
                  "device_ms": gd,
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
    log(f"[5] mse_step_kernel basic 800x600 4spp d8: kernel {mono['ms']:.4f} ms (device "
        f"{mono['device_ms']:.4f} ms), plain "
        f"{mono['plain_ms']:.1f} ms, bound {mono['bound_ms']:.4f} ms ({mono['bound_by']}); "
        f"live bounces {work['live']} of {work['rays'] * 8}, warp slots {work['warp_live']} "
        f"| {card}")
    log(f"[5] grad_kernel dielectric/sm 800x600 1 sample d8: kernel {per_sample['ms']:.4f} ms "
        f"(device {per_sample['device_ms']:.4f} ms), "
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
        # the rejecting scan's edges (exact ties, grazing rays), also in the
        # words form; past the 2048 staged rows (rows from device memory)
        ("ties/mg --boxes", "ties", "mg", (320, 240), True, 4, True),
        ("ties/mg --boxes one sample", "ties", "mg", (320, 240), True, 1, False),
        ("grazing/mg", "grazing", "mg", (320, 240), False, 4, True),
        ("grazing/mg one sample", "grazing", "mg", (320, 240), False, 1, False),
        ("proc2100/mg one sample", "proc2100", "mg", (64, 36), False, 1, False),
        # the main paths' launches: one sample of the config-4 train step,
        # and one 4-sample chunk of the CLI's 1000-sphere frame
        ("proc500/mg train-step launch", "proc500", "mg", (1920, 1080), False, 1, False),
        ("proc1000/mg cli chunk", "proc1000", "mg", (1920, 1080), False, 4, True),
    ]
    words_of = {}  # (scene, size, centre) -> the words form's winner words, checked
    for label, key, pers, size, boxes, spp, center in cases:
        sp, pl, bx, counts = bw_tables(scenes[key], pers, boxes)
        cam = torch.from_numpy(R._pack_camera(scenes[key].camera, size)).cuda()
        kw = dict(size=size, spp=spp, max_bounces=8, center_sample=center)
        got = BW.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, **kw)
        if spp == 1:  # the train step's launch: its words form too, frame and words
            want, w_want = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds,
                                                          words=True, **kw)
            got_w, w_got = BW.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, words=True,
                                                    **kw)
            torch.cuda.synchronize()
            check(torch.equal(got_w, want) and torch.equal(w_got, w_want),
                  f"blockwise {label}: the words form differs from its plain version")
            words_of[key, size, center] = w_got
        else:
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
            + ("; words form (frame and winner words) bit for bit" if spp == 1 else "")
            + (f"; vs render kernel max|d| {row['vs_render_kernel_max_abs']:.3g}, exact "
               f"{row['vs_render_kernel_exact_share']:.5f}" if "vs_render_kernel_max_abs" in row
               else ""))
        check(torch.isfinite(got).all().item(), f"blockwise {label}: output not finite")
        check(torch.equal(got, want), f"blockwise {label}: kernel differs from its plain version")
        if "vs_render_kernel_max_abs" in row and key in ("basic", "cornell", "ties", "grazing"):
            check(row["vs_render_kernel_max_abs"] == 0.0,
                  f"blockwise {label}: differs from the render kernel at the same seeds")
        errs["blockwise_kernel"] = max(errs["blockwise_kernel"], row["max_abs"])

    # label, scene, personality, size, centre sample, cotangent scale (that
    # of 2 (img - target) / (3 W H spp)); the last case is one sample of the
    # config-4 train step (16 spp), 2,073,600 rays on the same 500 rows
    grad_cases = [("proc500/mg", "proc500", "mg", (320, 180), False, 1e-6),
                  ("cornell_spheres/sm", "cornell", "sm", (160, 120), True, 1e-6),
                  ("dielectric/sm", "dielectric", "sm", (160, 120), False, 1e-6),
                  ("proc500/mg train-step launch", "proc500", "mg", (1920, 1080), False,
                   2.0 / (3 * 1920 * 1080 * 16))]
    for label, key, pers, size, center, scale in grad_cases:
        sp, pl, bx, counts = bw_tables(scenes[key], pers)
        cam = torch.from_numpy(R._pack_camera(scenes[key].camera, size)).cuda()
        w, h = size
        cot = torch.from_numpy(np.random.default_rng(3).uniform(0.0, 0.5, (h, w, 3))
                               .astype(np.float32)).cuda() * scale
        kw = dict(size=size, max_bounces=8, center_sample=center)
        words = words_of.get((key, size, center))
        if words is None:  # the sample's forward launch in its words form
            _, words = BW.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=1,
                                                words=True, **kw)
            _, w_want = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1,
                                                       words=True, **kw)
            check(torch.equal(words, w_want), f"bw_grad {label}: the forward's words differ "
                                              "from the plain version's")
        got = BG.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words, **kw)
        again = BG.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words, **kw)
        want, l1 = BG.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot, words,
                                         with_l1=True, **kw)
        work = live_work(sp[:counts[0], :10], pl[:counts[1], :10], cam, [11], [0], [center],
                         size, 8, "reference", words=[words], pairs=False)
        torch.cuda.synchronize()
        outs = [(g, a, w_, l) for g, a, w_, l in zip(got, again, want, l1) if g.numel()]
        row = {
            "case": label, "size": size, "counts": counts, "center_sample": center,
            "max_abs": max((g - w_).abs().max().item() for g, a, w_, l in outs),
            "max_ratio_l1": max(((g - w_).abs() / l.clamp_min(1e-30)).max().item()
                                for g, a, w_, l in outs),
            "run_to_run_ratio_l1": max(((g - a).abs() / l.clamp_min(1e-30)).max().item()
                                       for g, a, w_, l in outs),
            "refractions": work["refractions"], "sin2_one": work["sin2_one"],
        }
        report["bw_grad_parity"].append(row)
        log(f"[3] bw_grad {label} {w}x{h} 1 sample d8 (the forward's winner words): max|d| "
            f"{row['max_abs']:.3g}, max |d|/L1 {row['max_ratio_l1']:.3g} (tolerance "
            f"{GRAD_TOL}), run-to-run |d|/L1 {row['run_to_run_ratio_l1']:.3g}; refractions with "
            f"sin2 == 1: {row['sin2_one']} of {row['refractions']}")
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
    # the step's peak device memory (its 16 samples' winner words, 66 MB each
    # at depth 8, live together between the forward and gradient launches)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(params, 7)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[4] config-4 train losses {losses}; host-to-device copies in a step: {copies}; peak "
        f"device memory {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before the step)")
    check(losses[-1] < losses[0], "the train step did not lower the loss")
    check(copies == 1, f"{copies} host-to-device copies in a train step, expected 1 (the seeds)")
    check(_build.load_library.cache_info().misses == built, "a train step built a library")
    out.update(train_losses=losses, train_htod_copies=copies, train_peak_bytes=peak,
               train_held_bytes=held)

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

    # the gradient kernel on the same inputs, one sample (not the centre
    # one), along its forward launch's winner words
    cot = torch.full((h, w, 3), 1e-6, device="cuda")
    gkw = dict(size=size, max_bounces=8, center_sample=False)
    _, words = BW.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=1, words=True, **gkw)
    gk = profiling.sustained(lambda i: BG.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words,
                                                       **gkw), iters=16)
    gp = profiling.sustained(lambda i: BG.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot,
                                                             words, **gkw), iters=1, windows=3)
    sp10, pl10 = sp[:ns, :10].contiguous(), pl[:npl, :10].contiguous()
    gs = profiling.sustained(lambda i: G.grad_tile(sp10, pl10, cam, seeds, cot, **gkw), iters=16)
    g_work = live_work(sp10, pl10, cam, [11], [0], [False], size, 8, "reference", words=[words],
                       pairs=False)
    g_bound = bound(grad_bytes(g_work, n, ns, npl), grad_ops(g_work))
    grad = {"ms": gk["median"] * 1e3, "spread_ms": [gk["min"] * 1e3, gk["max"] * 1e3],
            "plain_ms": gp["median"] * 1e3, "grad_kernel_ms": gs["median"] * 1e3,
            "bound_ms": g_bound[0], "bound_by": g_bound[1], "live_work": g_work}

    # rows 5 and 7 at their main-path shape: one sample of the config-4 train
    # step (500 spheres, 1920x1080, depth 8), the forward in its words form
    # (and the serving form at the same shape beside it), then the gradient
    # kernel along those words; the plain versions are timed above, at
    # 320x180 (at 1080p they take tens of seconds)
    m_size = (1920, 1080)
    mw, mh = m_size
    m_n = mw * mh
    m_cam = torch.from_numpy(R._pack_camera(scene.camera, m_size)).cuda()
    m_kw = dict(size=m_size, max_bounces=8, center_sample=False)
    m_seeds = torch.from_numpy(G._sample_seeds(100, 16)).cuda()
    s1 = m_seeds[1:2]
    mf = profiling.sustained(lambda i: BW.render_blockwise_tile(sp, pl, bx, counts, m_cam, s1,
                                                                spp=1, words=True, **m_kw),
                             iters=8)
    ms_ = profiling.sustained(lambda i: BW.render_blockwise_tile(sp, pl, bx, counts, m_cam, s1,
                                                                 spp=1, **m_kw), iters=8)
    _, m_words = BW.render_blockwise_tile(sp, pl, bx, counts, m_cam, s1, spp=1, words=True,
                                          **m_kw)
    m_cot = torch.full((mh, mw, 3), 2.0 / (3 * m_n * 16), device="cuda")
    mg = profiling.sustained(lambda i: BG.bw_grad_tile(sp, pl, counts[:2], m_cam, s1, m_cot,
                                                       m_words, **m_kw), iters=8)
    m_work = live_work(sp10, pl10, m_cam, [int(s1)], [0], [False], m_size, 8, "reference",
                       words=[m_words])
    mf_bound = bound(table_bytes + 4 * (16 + 1 + 3 * m_n) + 4 * m_work["live"],
                     forward_ops(m_work, ns, npl))
    mg_bound = bound(grad_bytes(m_work, m_n, ns, npl), grad_ops(m_work))
    fwd.update(ms_320x180=fwd["ms"], bound_ms_320x180=fwd["bound_ms"], plain_shape="320x180 4spp",
               ms=mf["median"] * 1e3, spread_ms=[mf["min"] * 1e3, mf["max"] * 1e3],
               serving_form_ms=ms_["median"] * 1e3, bound_ms=mf_bound[0], bound_by=mf_bound[1],
               shape="proc500 1920x1080 1 sample d8, words form (a config-4 train-step launch)",
               live_work_1080p=m_work)
    grad.update(ms_320x180=grad["ms"], bound_ms_320x180=grad["bound_ms"],
                plain_shape="320x180 1 sample", ms=mg["median"] * 1e3,
                spread_ms=[mg["min"] * 1e3, mg["max"] * 1e3], bound_ms=mg_bound[0],
                bound_by=mg_bound[1],
                shape="proc500 1920x1080 1 sample d8 (a config-4 train-step launch)",
                live_work_1080p=m_work)

    # a whole config-4 step's samples: the words' refractions with sin2 == 1
    c4_words = []
    for s in range(16):
        c4_words.append(BW.render_blockwise_tile(sp, pl, bx, counts, m_cam, m_seeds[s:s + 1],
                                                 spp=1, words=True, size=m_size, max_bounces=8,
                                                 center_sample=(s == 0))[1])
    c4_work = live_work(sp10, pl10, m_cam, m_seeds.tolist(), [0] * 16,
                        [True] + [False] * 15, m_size, 8, "reference", words=c4_words,
                        pairs=False)
    del c4_words
    grad["config4_step_sin2_one"] = c4_work["sin2_one"]
    grad["config4_step_refractions"] = c4_work["refractions"]

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
    log(f"[5] blockwise_kernel proc500 320x180 4spp d8: kernel {fwd['ms_320x180']:.4f} ms "
        f"(render kernel on the same inputs {fwd['render_kernel_ms']:.4f} ms), plain "
        f"{fwd['plain_ms']:.1f} ms, bound {fwd['bound_ms_320x180']:.4f} ms | {card}")
    log(f"[5] blockwise_kernel proc500 1920x1080 1 sample d8 (config-4 train-step launch): words "
        f"form {fwd['ms']:.4f} ms, serving form {fwd['serving_form_ms']:.4f} ms, bound "
        f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); live bounces {m_work['live']} of "
        f"{m_n * 8}, warp slots {m_work['warp_live']}, sphere pairs with disc >= 0 "
        f"{m_work['disc_pairs']} of {m_work['live'] * ns} (warp rows {m_work['disc_warp_rows']} "
        f"of {m_work['warp_live'] // 32 * ns}) | {card}")
    log(f"[5] bw_grad_kernel proc500 320x180 1 sample d8: kernel {grad['ms_320x180']:.4f} ms "
        f"(per-sample kernel, which scans, on the same inputs {grad['grad_kernel_ms']:.4f} ms), "
        f"plain {grad['plain_ms']:.1f} ms, bound {grad['bound_ms_320x180']:.4f} ms | {card}")
    log(f"[5] bw_grad_kernel proc500 1920x1080 1 sample d8 (config-4 train-step launch): "
        f"{grad['ms']:.4f} ms, bound {grad['bound_ms']:.4f} ms ({grad['bound_by']}); over a "
        f"config-4 step's 16 samples, refractions with sin2 == 1: "
        f"{grad['config4_step_sin2_one']} of {grad['config4_step_refractions']} | {card}")
    log(f"[5] 1000-sphere frame 1920x1080 8spp d8 (render_forward_blockwise): "
        f"{serve_row['frame_ms']:.2f} ms = {serve_row['mrays_s']:.1f} Mrays/s (kernel "
        f"{serve_row['kernel_device_ms']:.2f} ms of device time, device busy "
        f"{serve_row['frame_busy_share']:.3f}) | {card}")
    log(f"[5] config-4 train step (500 spheres 1920x1080 16spp d8, Adam): "
        f"{train_row['step_ms']:.2f} ms = {train_row['fwd_bwd_mrays_s']:.1f} Mrays/s fwd+bwd; "
        f"device ms per step {train_row['kernel_device_ms']}, device busy "
        f"{train_row['step_busy_share']:.3f} | {card}")
    return {"blockwise_kernel": fwd, "bw_grad_kernel": grad}


# ---- the wavefront route (queue 2 rows 8 and 9) ----

# BASELINE config 5's slice (5000 spheres; BASELINE.md, the round-4 and round-5 tables)
WF_SLICE = dict(size=(960, 540), spp=2, max_bounces=8)


def wf_checked_chunk(tables, cam, seeds, size, spp, depth, record):
    """One sample chunk through the wavefront kernel (gen, then the later
    bounces with the sorts and the live-prefix limit), every launch held bit
    for bit against wf_bounce_plain on a copy of its input.  Returns
    (state, ids, saved, plain seconds, max |kernel - plain| over the
    launches' states)."""
    import torch
    from rt_tpu_torch.ops import wavefront as WF

    sp, pl, bx, counts = tables
    kw = dict(size=size, max_bounces=depth, center_sample=True, record=record)
    plain_s = [0.0]
    worst = [0.0]

    def launch(b, state, ids, limit):
        st, ii = state.clone(), ids.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = WF.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st, ii, limit, bounce=b, **kw)
        torch.cuda.synchronize()
        plain_s[0] += time.perf_counter() - t0
        got = WF.wf_bounce(sp, pl, bx, counts, cam, seeds, state, ids, limit, bounce=b, **kw)
        torch.cuda.synchronize()
        err = (state - st).abs().max().item()
        worst[0] = max(worst[0], err)
        if not (torch.equal(state, st) and torch.equal(ids, ii)):
            check(False, f"wf_bounce bounce {b}: state differs from the plain version by "
                         f"{err:.3g}")
        check(not record or torch.equal(got, want), f"wf_bounce bounce {b}: winner words differ")
        return got

    sched, shrink = WF._schedule(depth, None, -1)
    state, ids, saved = WF._forward_chunk(launch, size[0] * size[1] * spp, cam.device,
                                          max_bounces=depth, sched=sched, shrink_at=shrink,
                                          cell_bits=2, record=record)
    return state, ids, saved, plain_s[0], worst[0]


def wf_rev_checked(tables, cam, seeds, size, depth, saved, cot_pix, label, report):
    """Every reverse launch of a recorded chunk against wf_rev_plain on the
    same inputs, the kernel twice (run-to-run spread).  Returns (max |d|,
    plain seconds)."""
    import torch
    from rt_tpu_torch.ops import wavefront_grad as WG

    sp, pl, _, counts = tables
    n = saved[0][2].shape[0]
    cot = torch.zeros((9, n), device="cuda")
    kw = dict(size=size, max_bounces=depth, center_sample=True)
    worst = {"max_abs": 0.0, "max_ratio_l1": 0.0, "run_to_run_ratio_l1": 0.0, "cot_ratio": 0.0,
             "l1": 0.0}
    plain_s = 0.0
    for b in reversed(range(depth)):
        state, ids, words, limit = saved[b]
        c1, c2, cp = cot.clone(), cot.clone(), cot.clone()
        got = WG.wf_rev(sp, pl, counts[:2], cam, seeds, state, ids, words, limit, c1, cot_pix,
                        bounce=b, **kw)
        again = WG.wf_rev(sp, pl, counts[:2], cam, seeds, state, ids, words, limit, c2, cot_pix,
                          bounce=b, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, l1 = WG.wf_rev_plain(sp, pl, counts[:2], cam, seeds, state, ids, words, limit, cp,
                                   cot_pix, bounce=b, with_l1=True, **kw)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        outs = [(g, a, w_, l) for g, a, w_, l in zip(got, again, want, l1) if g.numel()]
        for g, a, w_, l in outs:
            check(torch.isfinite(g).all().item(), f"wf_rev {label} bounce {b}: not finite")
            check(((g - w_).abs() <= GRAD_TOL * l).all().item(),
                  f"wf_rev {label} bounce {b}: differs from its plain version beyond "
                  f"{GRAD_TOL} x L1")
        cot_ratio = ((c1 - cp).abs().max() / cp.abs().max().clamp_min(1e-30)).item()
        check(cot_ratio <= GRAD_TOL, f"wf_rev {label} bounce {b}: cotangents differ "
                                     f"({cot_ratio:.3g} of their largest)")
        worst["max_abs"] = max(worst["max_abs"], max((g - w_).abs().max().item()
                                                     for g, a, w_, l in outs))
        worst["max_ratio_l1"] = max(worst["max_ratio_l1"], max(
            ((g - w_).abs() / l.clamp_min(1e-30)).max().item() for g, a, w_, l in outs))
        worst["run_to_run_ratio_l1"] = max(worst["run_to_run_ratio_l1"], max(
            ((g - a).abs() / l.clamp_min(1e-30)).max().item() for g, a, w_, l in outs))
        worst["cot_ratio"] = max(worst["cot_ratio"], cot_ratio)
        worst["l1"] += sum(l.sum().item() for _, _, _, l in outs)
        cot = cp
    report.setdefault("wf_rev_parity", []).append(dict(worst, case=label, size=size))
    log(f"[3] wf_rev {label} {size[0]}x{size[1]} d{depth}: max|d| {worst['max_abs']:.3g}, max "
        f"|d|/L1 {worst['max_ratio_l1']:.3g} (tolerance {GRAD_TOL}), run-to-run |d|/L1 "
        f"{worst['run_to_run_ratio_l1']:.3g}, cotangents {worst['cot_ratio']:.3g} of their "
        f"largest; plain {plain_s:.2f} s")
    return worst["max_abs"], plain_s


def wf_rev_warp_cases(saved, n_spheres):
    """A recorded chunk's saved bounces, edited for what the reverse's
    per-warp sums by winner could get wrong: every lane of a warp that hit
    with the same winner (sphere row 7 at every bounce), every such lane
    with its own (row = the lane's ray index modulo the rows), and the live
    prefix ending mid-warp (at 32k + 13, k from half the bounce's live
    rays).  Misses stay misses: the sky's cotangent reaches the earlier
    bounces, so the sums are not all zero."""
    import torch
    from rt_tpu_torch.ops.render import WORD_MISS

    def one(words):
        return torch.where((words & WORD_MISS) != 0, words, 7)

    def own(words):
        row = (torch.arange(words.numel(), device=words.device) % n_spheres).to(torch.int32)
        return torch.where((words & WORD_MISS) != 0, words, row)

    def mid(state):
        live = int((state[12] > 0).sum())
        return torch.tensor([32 * max(live // 64, 1) + 13], dtype=torch.int32,
                            device=state.device)

    return {
        "one winner per warp": [(st, ii, one(ww), lim) for st, ii, ww, lim in saved],
        "a winner per lane": [(st, ii, own(ww), lim) for st, ii, ww, lim in saved],
        "live prefix ending mid-warp": [(st, ii, ww, lim if st is None else mid(st))
                                        for st, ii, ww, lim in saved],
    }


def wf_rev_atomics(state, words, limit):
    """The float64 atomics of one reverse launch, counted from its saved
    words as wf_grad_kernel.cu adds: per warp (32 consecutive rays of the
    launch's table), one per slot of each distinct winner among its live
    hits (9 for a sphere, 5 for a plane); and for the gen launch (state
    None) 16 per block of 128 threads, the camera sums."""
    import torch
    from rt_tpu_torch.ops.render import WORD_MISS, WORD_PLANE, WORD_ROW

    n = words.numel()
    j = torch.arange(n, device=words.device)
    live = torch.ones(n, dtype=torch.bool, device=words.device) if state is None else (
        (state[12] > 0) & (j < limit[0] if limit is not None else True))
    w = words.long()
    hit = live & ((w & WORD_MISS) == 0)
    groups = torch.unique((j[hit] // 32) * (1 << 26) + (w[hit] & (WORD_ROW | WORD_PLANE)))
    plane = int(((groups & WORD_PLANE) != 0).sum())
    return 9 * (groups.numel() - plane) + 5 * plane + (16 * -(-n // 128) if state is None else 0)


def wf_work(tables, saved, rays0, per_bounce=False):
    """Live work of a recorded chunk, counted from its saved tables and
    winner words (the keys of live_work): rays, live bounces, misses,
    sphere and plane hits, hits per material class, ``disc_pairs`` (the
    live (ray, sphere row) pairs with disc >= 0, disc_counts on the rays
    entering each bounce: ``rays0``, the chunk's camera rays in ray order,
    then the saved states) and `rows`: the distinct winner rows of each
    bounce, summed over the bounces; with ``per_bounce`` a list of one such
    dict per bounce."""
    import torch
    from rt_tpu_torch.ops.render import WORD_MISS, WORD_PLANE, WORD_ROW

    sp, pl, _, counts = tables
    n = saved[0][2].shape[0]
    keys = ("live", "miss", "sphere", "plane", "lambert", "metal", "dielectric", "rows",
            "disc_pairs")
    work = dict.fromkeys(keys, 0)
    work["rays"] = n
    each = []
    for state, ids, words, limit in saved:
        if per_bounce:
            work = dict.fromkeys(keys, 0)
            work["rays"] = n
            each.append(work)
        live = (torch.ones(n, dtype=torch.bool, device=words.device) if state is None
                else state[12] > 0)
        o3, d3 = rays0 if state is None else ((state[0], state[1], state[2]),
                                               (state[3], state[4], state[5]))
        work["disc_pairs"] += disc_counts(sp[:counts[0]], o3, d3, live)[0]
        w = words.long()
        hit = live & ((w & WORD_MISS) == 0)
        ispl = hit & ((w & WORD_PLANE) != 0)
        row = w & WORD_ROW
        cls = torch.where(ispl, pl[row.clamp(max=pl.shape[0] - 1), 9] if pl.shape[0] else 0.0,
                          sp[row.clamp(max=sp.shape[0] - 1), 9])
        work["rows"] += int(row[hit & ~ispl].unique().numel() + row[ispl].unique().numel())
        for k, m in (("live", live), ("miss", live & ~hit), ("sphere", hit & ~ispl),
                     ("plane", ispl), ("metal", hit & (cls == 1.0)),
                     ("dielectric", hit & (cls == 2.0)),
                     ("lambert", hit & (cls != 1.0) & (cls != 2.0))):
            work[k] += int(m.sum())
    return each if per_bounce else work


def chunk_rays(cam, size, seed, spp, depth, center):
    """The camera rays of a sample chunk in ray order (sample-major, as the
    wavefront kernel's bounce 0 makes them): (o3, d3)."""
    import torch

    per = [camera_rays(cam, size, seed, s * (2 + 4 * depth), center and s == 0)
           for s in range(spp)]
    return tuple(tuple(torch.cat([r[g][j] for r in per]) for j in range(3)) for g in range(2))


def launch_disc_pairs(tables, cam, seed, size, depth, center):
    """disc_pairs of one one-sample launch at counter base 0 (a record
    kernel's), boxes included: the same paths traced as a one-sample
    wavefront record chunk (its frame equals the blockwise kernel's), its
    entering states saved, counted by wf_work."""
    import torch
    from rt_tpu_torch.ops import wavefront as WF

    seeds = torch.tensor([seed], dtype=torch.int32, device=cam.device)
    kw = dict(size=size, max_bounces=depth, center_sample=center, record=True)
    sched, shrink = WF._schedule(depth, None, -1)
    _, _, saved = WF._forward_chunk(
        lambda b, st, ii, lim: WF.wf_bounce(*tables, cam, seeds, st, ii, lim, bounce=b, **kw),
        size[0] * size[1], cam.device, max_bounces=depth, sched=sched, shrink_at=shrink,
        cell_bits=2, record=True)
    return wf_work(tables, saved, chunk_rays(cam, size, seed, 1, depth, center))["disc_pairs"]


def wf_bounce_ms(tables, cam, seeds, size, n, depth, sched, shrink, reps=5):
    """Device ms of each launch of one record chunk (gen, then bounces 1 to
    depth-1 with the sorts and the live-prefix limit): CUDA events around
    every launch, the stream held by a spin kernel while the host queues
    the chunk (so that no launch waits for the host); the median of
    ``reps`` chunks per bounce."""
    import statistics

    import torch
    from rt_tpu_torch.ops import wavefront as WF

    times = [[] for _ in range(depth)]
    for rep in range(reps + 1):
        marks = []

        def launch(b, state, ids, limit):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            words = WF.wf_bounce(*tables, cam, seeds, state, ids, limit, size=size, bounce=b,
                                 max_bounces=depth, center_sample=True, record=True)
            end.record()
            marks.append((start, end))
            return words

        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        WF._forward_chunk(launch, n, cam.device, max_bounces=depth, sched=sched,
                          shrink_at=shrink, cell_bits=2, record=True)
        torch.cuda.synchronize()
        if rep:  # the first chunk warms up
            for b, (a, e) in enumerate(marks):
                times[b].append(a.elapsed_time(e))
    return [statistics.median(t) for t in times]


def wavefront_parity(scenes, report):
    """Phase 3 for the wavefront kernels.  Returns max |kernel - plain| per
    kernel."""
    import numpy as np
    import torch
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import render as R
    from rt_tpu_torch.ops import wavefront as WF

    errs = {"wf_bounce": 0.0, "wf_rev": 0.0}
    seeds = torch.tensor([11], dtype=torch.int32, device="cuda")
    cases = [  # label, scene, personality, size, --boxes, reverse checked
        ("basic/mg", "basic", "mg", (320, 240), False, False),
        ("cornell_spheres/sm", "cornell", "sm", (320, 240), False, True),
        ("basic+box/mg --boxes", "basic+box", "mg", (320, 240), True, False),
        ("proc2000/mg", "proc2000", "mg", (160, 90), False, True),
    ]
    for label, key, pers, size, boxes, rev in cases:
        tables = bw_tables(scenes[key], pers, boxes)
        cam = torch.from_numpy(R._pack_camera(scenes[key].camera, size)).cuda()
        for record in (False, True):
            state, ids, saved, plain_s, err = wf_checked_chunk(tables, cam, seeds, size, 2, 8,
                                                               record)
            errs["wf_bounce"] = max(errs["wf_bounce"], err)
            img = WF._assemble(state, ids, size[0] * size[1], 2).reshape(size[1], size[0], 3)
            ref = BW.render_blockwise_tile(*tables, cam, seeds, size=size, spp=2, max_bounces=8,
                                           center_sample=True)
            torch.cuda.synchronize()
            check(torch.equal(img, ref), f"wavefront {label}: the chunk is not the blockwise "
                                         "kernel's")
        log(f"[3] wf_bounce {label} {size[0]}x{size[1]} 2spp d8: gen, 7 bounces, plain and "
            f"record modes bit for bit with the plain version (plain {plain_s:.2f} s per "
            "chunk); chunk == blockwise kernel's")
        report.setdefault("wf_parity", []).append({"case": label, "size": size,
                                                   "plain_s": plain_s})
        if rev:
            n_pix = size[0] * size[1]
            cot_pix = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (n_pix, 3))
                                       .astype(np.float32)).cuda() * (2.0 / (3 * n_pix * 2))
            err, _ = wf_rev_checked(tables, cam, seeds, size, 8, saved, cot_pix, label, report)
            errs["wf_rev"] = max(errs["wf_rev"], err)
            if key == "proc2000":
                for case, edited in wf_rev_warp_cases(saved, tables[3][0]).items():
                    err, _ = wf_rev_checked(tables, cam, seeds, size, 8, edited, cot_pix,
                                            f"{label} ({case})", report)
                    errs["wf_rev"] = max(errs["wf_rev"], err)
                    check(report["wf_rev_parity"][-1]["l1"] > 0,
                          f"wf_rev {label} ({case}): no gradient to compare")
    # the reverse's per-warp sums on a ragged table: 37x23, one sample, 851
    # rays (not a multiple of 32)
    size = (37, 23)
    tables = bw_tables(scenes["proc2000"], "mg")
    cam = torch.from_numpy(R._pack_camera(scenes["proc2000"].camera, size)).cuda()
    _, _, saved, _, err = wf_checked_chunk(tables, cam, seeds, size, 1, 8, True)
    errs["wf_bounce"] = max(errs["wf_bounce"], err)
    cot_pix = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (37 * 23, 3))
                               .astype(np.float32)).cuda() * (2.0 / (3 * 37 * 23))
    err, _ = wf_rev_checked(tables, cam, seeds, size, 8, saved, cot_pix,
                            "proc2000/mg (ragged: 851 rays)", report)
    errs["wf_rev"] = max(errs["wf_rev"], err)

    # the split scan of the later bounces (G lanes per live ray, G from the
    # live count): a tie-heavy scene (sphere rows duplicated side by side
    # and across the table, two equal boxes, --boxes) and a mostly-sky one
    # (few live rays), a whole 1-spp chunk each at 640x480, and bounce 1
    # from the same bounce-0 table at live-prefix limits that leave live
    # counts for every G
    size, depth = (640, 480), 6
    n = size[0] * size[1]
    limits = lane_limits(n)
    for key, boxes in (("ties", True), ("sky", False)):
        tables = bw_tables(scenes[key], "sm", boxes)
        cam = torch.from_numpy(R._pack_camera(scenes[key].camera, size)).cuda()
        state, ids, saved, _, err = wf_checked_chunk(tables, cam, seeds, size, 1, depth, True)
        errs["wf_bounce"] = max(errs["wf_bounce"], err)
        img = WF._assemble(state, ids, n, 1).reshape(size[1], size[0], 3)
        ref = BW.render_blockwise_tile(*tables, cam, seeds, size=size, spp=1, max_bounces=depth,
                                       center_sample=True)
        torch.cuda.synchronize()
        check(torch.equal(img, ref), f"wavefront {key}: the chunk is not the blockwise kernel's")
        live = [n] + [int((st[12] > 0).sum()) for st, _, _, _ in saved[1:]]
        lanes = [WF._split_lanes(v) for v in live[1:]]
        kw = dict(size=size, max_bounces=depth, center_sample=True, record=True)
        gen_state = torch.empty((WF.STATE_ROWS, n), device="cuda")
        gen_ids = torch.empty(n, dtype=torch.int32, device="cuda")
        WF.wf_bounce(*tables, cam, seeds, gen_state, gen_ids, bounce=0, **kw)
        alive = int((gen_state[12] > 0).sum())
        seen = []
        for g, lim in limits.items():
            limit = torch.tensor([lim], dtype=torch.int32, device="cuda")
            st, ii, st_p, ii_p = gen_state.clone(), gen_ids.clone(), gen_state.clone(), \
                gen_ids.clone()
            got = WF.wf_bounce(*tables, cam, seeds, st, ii, limit, bounce=1, **kw)
            want = WF.wf_bounce_plain(*tables, cam, seeds, st_p, ii_p, limit, bounce=1, **kw)
            torch.cuda.synchronize()
            check(torch.equal(st, st_p) and torch.equal(ii, ii_p) and torch.equal(got, want),
                  f"wf_bounce {key}: bounce 1 at {g} lanes per ray differs from the plain "
                  "version")
            seen.append(WF._split_lanes(min(alive, lim)))
        # the tie-heavy scene keeps enough rays alive for every G; on the
        # mostly-sky one every limit leaves its few live rays 32 lanes each
        check(key != "ties" or seen == list(limits),
              f"wf_bounce {key}: the limits gave lanes {seen}")
        report.setdefault("wf_split_parity", []).append(
            {"case": key, "size": size, "live_per_bounce": live, "lanes_per_bounce": lanes,
             "limits_per_lanes": limits})
        log(f"[3] wf_bounce {key} 640x480 1spp d{depth} (split scan): every launch bit for bit "
            f"with the plain version, chunk == blockwise kernel's; live rays per bounce {live}, "
            f"lanes per ray of bounces 1-{depth - 1} {lanes}; bounce 1 at limits {limits} (lanes "
            f"{seen}) bit for bit")
    return errs


def lane_limits(n):
    """{G: a live-prefix length at which a later wavefront bounce gives each
    ray G lanes}, G = 1, 2, ..., 32, from the card's rule
    (``wavefront._split_lanes``): ceil(R / G), R the resident threads (the
    least live count that gets one lane), which must not exceed n."""
    from rt_tpu_torch.ops import wavefront as WF

    check(WF._split_lanes(n) == 1, f"{n} rays are fewer than the wavefront kernel's resident "
                                   "threads")
    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if WF._split_lanes(mid) == 1 else (mid + 1, hi)
    return {g: -(-lo // g) for g in (1, 2, 4, 8, 16, 32)}


def wavefront_main_shape(scenes, report, errs):
    """Phase 3 at the main path's shape: the config-5 slice's one 2-spp
    chunk (960x540x2 = 1,036,800 rays: the chunk that render_forward_wavefront
    and the train step launch there) through both kernels, each launch
    against its plain version; `errs` takes the largest differences.
    Returns the per-launch timing inputs for phase 5."""
    import numpy as np
    import torch
    from rt_tpu_torch.ops import render as R

    scene, size = scenes["proc5000"], WF_SLICE["size"]
    spp, depth = WF_SLICE["spp"], WF_SLICE["max_bounces"]
    tables = bw_tables(scene, "mg")
    cam = torch.from_numpy(R._pack_camera(scene.camera, size)).cuda()
    seeds = torch.tensor([21], dtype=torch.int32, device="cuda")
    state, ids, saved, fwd_plain_s, err = wf_checked_chunk(tables, cam, seeds, size, spp, depth,
                                                           True)
    errs["wf_bounce"] = max(errs["wf_bounce"], err)
    log(f"[3] wf_bounce proc5000 {size[0]}x{size[1]} {spp}spp d{depth} (the config-5 chunk, "
        f"{saved[0][2].shape[0]} rays): 8 launches bit for bit with the plain version (plain "
        f"{fwd_plain_s:.2f} s)")
    n_pix = size[0] * size[1]
    cot_pix = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (n_pix, 3))
                               .astype(np.float32)).cuda() * (2.0 / (3 * n_pix * spp))
    err, rev_plain_s = wf_rev_checked(tables, cam, seeds, size, depth, saved, cot_pix,
                                      "proc5000 config-5 chunk", report)
    errs["wf_rev"] = max(errs["wf_rev"], err)
    report["wf_main_shape"] = {"spp": spp, "rays": saved[0][2].shape[0],
                               "fwd_plain_s": fwd_plain_s, "rev_plain_s": rev_plain_s}
    return dict(tables=tables, cam=cam, seeds=seeds, saved=saved, cot_pix=cot_pix,
                fwd_plain_s=fwd_plain_s, rev_plain_s=rev_plain_s)


def wavefront_main_paths(scenes, report):
    """Phase 4 for the wavefront route.  Returns (launches per kernel, the
    config-5 train step and its params)."""
    import numpy as np
    import torch
    from rt_tpu_torch import diff, train
    from rt_tpu_torch.cli import main as cli_main
    from rt_tpu_torch.ops import _build
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R
    from rt_tpu_torch.ops import wavefront as WF
    from rt_tpu_torch.ops import wavefront_grad as WG

    wrappers = {"render_kernel": R.render_tile, "mse_step_kernel": G.mse_step_tile,
                "grad_kernel": G.grad_tile, "blockwise_kernel": BW.render_blockwise_tile,
                "bw_grad_kernel": BG.bw_grad_tile, "wf_bounce": WF.wf_bounce,
                "wf_rev": WG.wf_rev}
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

    scene = scenes["proc5000"]
    size, spp, depth = WF_SLICE["size"], WF_SLICE["spp"], WF_SLICE["max_bounces"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        npy = Path(tmp) / "proc5000.npy"
        reset()
        rc = cli_main(["--procedural", "5000", "--renderer", "mg_auto", "--size", "960x540",
                       "--spp", str(spp), "--bounces", str(depth), "--device", "cuda", "--out",
                       str(npy)])
        read("cli mg_auto --procedural 5000 960x540 2spp d8", wf_bounce=depth)
        check(rc == 0, f"cli exited with {rc}")
        frame = np.load(npy)
        check(frame.shape == (540, 960, 3) and np.isfinite(frame).all(),
              "the 5000-sphere frame has the wrong shape or is not finite")
        ref = BW.render_forward_blockwise(scene, size, spp=spp, max_bounces=depth,
                                          device="cuda").cpu().numpy()
        check(np.array_equal(frame, ref),
              "the wavefront frame is not the blockwise kernel's at the same seed")
        out["cli_5000_mean"] = float(frame.mean())
        log(f"[4] 5000-sphere 960x540 frame through the wavefront route (mg_auto), mean "
            f"{frame.mean():.4f}: equal to render_forward_blockwise's (torch.equal)")

    # the training target and start of examples/big_scene_training.py
    target = WF.render_forward_wavefront(scene, size, seed=0, spp=spp, max_bounces=depth,
                                         gamma=False, device="cuda")
    params = {"materials.albedo": torch.full_like(scene.materials.albedo, 0.5).cuda()}

    # the wavefront step against the blockwise step at matched draws (1 spp):
    # seed S * 100003 against S
    full = dict(diff.extract_params(scene), **params)
    kw = dict(spp=1, max_bounces=depth, device="cuda")
    lw, gw = WG.wf_mse_loss_and_grad(full, scene, target, size, seed=5 * 100003, **kw)
    lb, gb = BG.bw_mse_loss_and_grad(full, scene, target, size, seed=5, **kw)
    rel = {k: ((gw[k] - gb[k]).abs().max() / gb[k].abs().max().clamp_min(1e-30)).item()
           for k in gb}
    reset()
    log(f"[4] wavefront step vs blockwise step at matched draws (5000 spheres 960x540 1spp d8): "
        f"loss {lw.item():.9g} vs {lb.item():.9g}; max |d|/max|g| per key "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }")
    check(lw.item() == lb.item(), "the wavefront and blockwise steps' losses differ")
    check(max(rel.values()) <= 2e-4, "the wavefront and blockwise steps' gradients differ")
    out.update(matched_loss=lw.item(), matched_grad_rel=rel)

    # the config-5 train step through the JAX package's router
    opt = torch.optim.Adam(list(params.values()), lr=5e-2, foreach=True)
    step = train.make_kernel_train_step(opt, scene, target, size, spp=spp, max_bounces=depth,
                                        device="cuda")
    built = _build.load_library.cache_info().misses
    reset()
    losses = [step(params, i).item() for i in range(5)]
    read("config-5 train step (5000 spheres 960x540 2spp d8), 5 steps",
         wf_bounce=5 * depth, wf_rev=5 * depth)
    reset()
    copies = htod_copies(lambda: step(params, 5))
    read("config-5 train step under the profiler, 1 step", wf_bounce=depth, wf_rev=depth)
    log(f"[4] config-5 train losses {losses}; host-to-device copies in a step: {copies}")
    check(losses[-1] < losses[0], "the wavefront train step did not lower the loss")
    check(copies == 1, f"{copies} host-to-device copies in a train step, expected 1 (the seeds)")
    check(_build.load_library.cache_info().misses == built, "a train step built a library")
    out.update(train_losses=losses, train_htod_copies=copies)
    report["wf_main_path"] = dict(out, launches=total)
    return total, step, params, target


def wavefront_timing(scenes, step, params, target, shape, card, report):
    """Phase 5 for the wavefront kernels and the config-5 slice, with the
    blockwise route on the same slice in interleaved windows.  Returns
    per-kernel timing rows for the kernels' JSON line."""
    import torch
    from rt_tpu_torch import profiling
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BG
    from rt_tpu_torch.ops import wavefront as WF
    from rt_tpu_torch.ops import wavefront_grad as WG

    scene = scenes["proc5000"]
    size, spp, depth = WF_SLICE["size"], WF_SLICE["spp"], WF_SLICE["max_bounces"]
    n_pix = size[0] * size[1]
    n = n_pix * spp

    # per launch, on the 2-spp chunk of phase 3 (kernels only, CUPTI time)
    tables, cam, seeds, saved = shape["tables"], shape["cam"], shape["seeds"], shape["saved"]
    sp, pl, _, counts = tables
    ns, npl = counts[:2]
    sched, shrink = WF._schedule(depth, None, -1)

    def fwd_chunk(i):
        def launch(b, state, ids, limit):
            return WF.wf_bounce(*tables, cam, seeds, state, ids, limit, size=size, bounce=b,
                                max_bounces=depth, center_sample=True, record=True)
        WF._forward_chunk(launch, n, cam.device, max_bounces=depth, sched=sched,
                          shrink_at=shrink, cell_bits=2, record=True)

    def rev_chunk(i):
        cot = torch.zeros((9, n), device="cuda")
        for b in reversed(range(depth)):
            st, ii, ww, lim = saved[b]
            WG.wf_rev(sp, pl, counts[:2], cam, seeds, st, ii, ww, lim, cot, shape["cot_pix"],
                      size=size, bounce=b, max_bounces=depth, center_sample=True)

    df = profiling.device_times(fwd_chunk, iters=5)
    dr = profiling.device_times(rev_chunk, iters=5)
    per_bounce = wf_bounce_ms(tables, cam, seeds, size, n, depth, sched, shrink)
    f_ms = sum(v for k, v in df.items() if "wf_gen_kernel" in k or "wf_bounce_kernel" in k)
    r_ms = sum(v for k, v in dr.items() if "wf_rev_kernel" in k or "wf_rev_gen_kernel" in k)
    rays0 = chunk_rays(cam, size, int(seeds[0]), spp, depth, True)
    work = wf_work(tables, saved, rays0)
    tab = 64 * (ns + npl)
    live_in = work["live"] - work["rays"]  # rays entering bounces 1..7 alive
    f_bound = bound(depth * tab + 60 * work["rays"] + (56 + 56) * live_in,
                    forward_ops(work, ns, npl))
    # the reverse's bytes by kind of launch: the gen launch reads each ray's
    # word, cotangent and pixel cotangent (4 + 36 + 12 B) and writes no
    # cotangent back; a later bounce's live ray reads its state, id and word
    # (40 + 4 + 4 B), its cotangent and pixel cotangent (36 + 12 B) and
    # writes its cotangent (36 B); every launch reads the 10 used floats of
    # each distinct winner row; and each float64 atomic the kernels issue
    # moves 8 B (wf_rev_atomics: per warp, one per slot of each distinct
    # winner, and the gen launch's camera sums)
    atomics = [wf_rev_atomics(st, ww, lim) for st, _, ww, lim in saved]
    work_b = wf_work(tables, saved, rays0, per_bounce=True)
    r_parts = []
    for b, w_b in enumerate(work_b):
        w_b = dict(w_b, rays=w_b["rays"] if b == 0 else 0)
        r_parts.append(bound((52 * w_b["rays"] if b == 0 else 132 * w_b["live"])
                             + 40 * w_b["rows"] + 8 * atomics[b],
                             reverse_ops(w_b) + 70 * (w_b["sphere"] + w_b["plane"])))
    r_bound = (sum(t for t, _ in r_parts),
               max(("bytes", "operations"), key=lambda k: sum(t for t, by in r_parts if by == k)))
    r0_ms = sum(v for k, v in dr.items() if "wf_rev_gen_kernel" in k)
    r17_ms = sum(v for k, v in dr.items() if "wf_rev_kernel" in k)
    # per bounce: device time, live rays entering it, lanes per ray, bound
    bounces = []
    for b, w_b in enumerate(work_b):
        live_b = w_b["live"]
        b_bytes = tab + (60 * w_b["rays"] if b == 0 else (56 + 56) * live_b)
        b_ops = forward_ops(dict(w_b, rays=w_b["rays"] if b == 0 else 0), ns, npl)
        bounces.append({"bounce": b, "ms": per_bounce[b], "live": live_b,
                        "lanes": 1 if b == 0 else WF._split_lanes(live_b),
                        "bound_ms": bound(b_bytes, b_ops)[0]})
    later = bounces[1:]
    rows = {  # per launch: the chunk's figures over its `depth` launches
        "wf_bounce": {"ms": f_ms / depth, "plain_ms": shape["fwd_plain_s"] * 1e3 / depth,
                      "bound_ms": f_bound[0] / depth, "bound_by": f_bound[1],
                      "chunk_device_ms": df, "live_work": work,
                      "bounce0_ms": bounces[0]["ms"], "bounce0_bound_ms": bounces[0]["bound_ms"],
                      "bounces_1_7_ms": sum(r["ms"] for r in later),
                      "bounces_1_7_bound_ms": sum(r["bound_ms"] for r in later),
                      "per_bounce": bounces},
        "wf_rev": {"ms": r_ms / depth, "plain_ms": shape["rev_plain_s"] * 1e3 / depth,
                   "bound_ms": r_bound[0] / depth, "bound_by": r_bound[1],
                   "chunk_device_ms": dr, "bounce0_ms": r0_ms, "bounces_1_7_ms": r17_ms,
                   "bounce0_bound_ms": r_parts[0][0],
                   "bounces_1_7_bound_ms": sum(t for t, _ in r_parts[1:]),
                   "atomics_per_launch": atomics},
    }

    # the frame and the train step on the slice, each beside the blockwise
    # route's, in interleaved windows
    def wf_frame(i):
        return WF.render_forward_wavefront(scene, size, seed=i, spp=spp, max_bounces=depth,
                                           device="cuda")

    def bw_frame(i):
        return BW.render_forward_blockwise(scene, size, seed=i, spp=spp, max_bounces=depth,
                                           device="cuda")

    def wf_frame_every(i):  # a sort before every bounce, the live prefix from the first
        return WF.render_forward_wavefront(scene, size, seed=i, spp=spp, max_bounces=depth,
                                           sort_schedule=tuple(range(1, depth)), shrink_at=1,
                                           device="cuda")

    bw_params = {"materials.albedo": params["materials.albedo"].clone()}
    bw_step = BG.make_bw_train_step(torch.optim.Adam(list(bw_params.values()), lr=5e-2,
                                                     foreach=True),
                                    scene, target, size, spp=spp, max_bounces=depth,
                                    device="cuda")

    def wf_train(i):
        return step(params, 100 + i)

    def bw_train(i):
        return bw_step(bw_params, 100 + i)

    check(torch.equal(wf_frame_every(0), wf_frame(0)), "the sort schedule changed the frame")
    for fn in (wf_frame, bw_frame, wf_train, bw_train):
        fn(0)
    torch.cuda.synchronize()
    ws = {"wf_frame": [], "bw_frame": [], "wf_every": [], "wf_step": [], "bw_step": []}
    for _ in range(5):
        ws["wf_frame"].append(window_s(wf_frame, 3))
        ws["bw_frame"].append(window_s(bw_frame, 3))
        ws["wf_every"].append(window_s(wf_frame_every, 3))
        ws["bw_step"].append(window_s(bw_train, 2))
        ws["wf_step"].append(window_s(wf_train, 2))
    med = {k: sorted(v)[2] for k, v in ws.items()}
    dfr = profiling.device_times(wf_frame, iters=3)
    dst = profiling.device_times(wf_train, iters=3)

    def kern(d, names):
        return sum(v for k, v in d.items() if any(n in k for n in names))

    slice_row = {
        "frame_ms": med["wf_frame"] * 1e3, "frame_windows_ms": [x * 1e3 for x in ws["wf_frame"]],
        "frame_mrays_s": profiling.mrays_per_sec(size, spp, med["wf_frame"]),
        "bw_frame_ms": med["bw_frame"] * 1e3,
        "bw_frame_windows_ms": [x * 1e3 for x in ws["bw_frame"]],
        "frame_bw_over_wf": med["bw_frame"] / med["wf_frame"],
        "sort_every_bounce_frame_ms": med["wf_every"] * 1e3,
        "sort_every_bounce_windows_ms": [x * 1e3 for x in ws["wf_every"]],
        "frame_device_ms": dfr,
        "frame_kernel_device_ms": kern(dfr, ("wf_gen_kernel", "wf_bounce_kernel")),
        "frame_busy_share": sum(dfr.values()) / (med["wf_frame"] * 1e3),
        "step_ms": med["wf_step"] * 1e3, "step_windows_ms": [x * 1e3 for x in ws["wf_step"]],
        "step_mrays_s": profiling.mrays_per_sec(size, spp, med["wf_step"]),
        "bw_step_ms": med["bw_step"] * 1e3, "bw_step_windows_ms": [x * 1e3 for x in ws["bw_step"]],
        "step_bw_over_wf": med["bw_step"] / med["wf_step"],
        "step_over_frame": med["wf_step"] / med["wf_frame"],
        "step_device_ms": dst,
        "step_kernel_device_ms": {
            "wf_bounce": kern(dst, ("wf_gen_kernel", "wf_bounce_kernel")),
            "wf_rev": kern(dst, ("wf_rev_kernel", "wf_rev_gen_kernel"))},
        "step_busy_share": sum(dst.values()) / (med["wf_step"] * 1e3),
        "launches_per_step": {"wf_bounce": depth, "wf_rev": depth},
    }
    report["wf_timing"] = dict(rows, config5_slice=slice_row)
    for name, r in rows.items():
        log(f"[5] {name} proc5000 960x540 {spp}spp d8 chunk: {r['ms']:.4f} ms per launch (8 per "
            f"chunk), plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | {card}")
    wr = rows["wf_rev"]
    log(f"[5] wf_rev per launch kind of the chunk (CUPTI device time): bounce 0 "
        f"(wf_rev_gen_kernel) {wr['bounce0_ms']:.4f} ms (bound {wr['bounce0_bound_ms']:.4f}), "
        f"bounces 1-7 (wf_rev_kernel) {wr['bounces_1_7_ms']:.4f} ms (bound "
        f"{wr['bounces_1_7_bound_ms']:.4f}); float64 atomics per launch {atomics} | {card}")
    wb = rows["wf_bounce"]
    log(f"[5] wf_bounce per bounce of the chunk (CUDA events, the stream held while queued): "
        f"bounce 0 {wb['bounce0_ms']:.4f} ms (bound {wb['bounce0_bound_ms']:.4f}), bounces 1-7 "
        f"{wb['bounces_1_7_ms']:.4f} ms (bound {wb['bounces_1_7_bound_ms']:.4f}); "
        + ", ".join(f"b{r['bounce']} {r['ms']:.4f} ms {r['live']} live x{r['lanes']}"
                    for r in wb["per_bounce"]) + f" | {card}")
    log(f"[5] config-5 slice frame (render_forward_wavefront, 5000 spheres 960x540 2spp d8): "
        f"{slice_row['frame_ms']:.3f} ms = {slice_row['frame_mrays_s']:.1f} Mrays/s, kernels "
        f"{slice_row['frame_kernel_device_ms']:.3f} ms of device time, busy "
        f"{slice_row['frame_busy_share']:.3f}; blockwise frame {slice_row['bw_frame_ms']:.3f} ms "
        f"(blockwise/wavefront {slice_row['frame_bw_over_wf']:.3f}, interleaved); sorting before "
        f"every bounce {slice_row['sort_every_bounce_frame_ms']:.3f} ms, the same frame | {card}")
    log(f"[5] config-5 slice train step (wavefront, Adam): {slice_row['step_ms']:.3f} ms = "
        f"{slice_row['step_mrays_s']:.1f} Mrays/s fwd+bwd, device ms "
        f"{slice_row['step_kernel_device_ms']}, busy {slice_row['step_busy_share']:.3f}, step/"
        f"frame {slice_row['step_over_frame']:.3f}; blockwise step {slice_row['bw_step_ms']:.3f} "
        f"ms (blockwise/wavefront {slice_row['step_bw_over_wf']:.3f}, interleaved) | {card}")
    return rows


def tie_scene_toml() -> str:
    """A scene whose closest-hit scans tie often (tests/test_torch_common.py
    has the same): a ground plane, 12 spheres each on two adjacent rows and
    all 12 again at the end of the table, a ground sphere whose top touches
    the plane, and two equal boxes."""
    import numpy as np

    rng = np.random.default_rng(11)
    sph = ["{ material = %d, position = [%.3f, %.3f, %.3f], radius = %.3f }" % (i % 3, x, y, z, r)
           for i, (x, y, z, r) in enumerate(zip(
               rng.uniform(-2, 2, 12), rng.uniform(0.3, 1.2, 12), rng.uniform(-4, -1, 12),
               rng.uniform(0.2, 0.5, 12)))]
    rows = [s for s in sph for _ in (0, 1)] + sph
    rows.append("{ material = 0, position = [0, -1000, 0], radius = 1000 }")
    box = "{ material = 1, position = [1.2, 0.4, -2.0], extents = [0.3, 0.4, 0.3] }"
    return "\n".join([
        "camera = { position = [0, 1, 3], direction = 'forward' }",
        "materials = [ { type = 'lambert', albedo = 'gray' },",
        "              { type = 'metal', albedo = 'white', roughness = 0.05 },",
        "              { type = 'dielectric', albedo = 'white' } ]",
        "planes = [ { material = 0, position = [0, 0, 0], normal = 'up' } ]",
        "spheres = [ " + ",\n  ".join(rows) + " ]",
        f"boxes = [ {box}, {box} ]",
    ])


def grazing_scene_toml() -> str:
    """A scene whose rays graze spheres often (tests/test_torch_common.py
    has the same): the camera 5 cm above the top of a radius-1000 ground
    sphere, looking along it, and 40 small spheres resting on it."""
    import numpy as np

    rng = np.random.default_rng(13)
    rows = ["{ material = %d, position = [%.4f, %.4f, %.4f], radius = %.4f }" % (i % 2, x, r, z, r)
            for i, (x, z, r) in enumerate(zip(rng.uniform(-2, 2, 40), rng.uniform(-8, -1, 40),
                                              rng.uniform(0.01, 0.06, 40)))]
    rows.append("{ material = 1, position = [0, -1000, 0], radius = 1000 }")
    return "\n".join([
        "camera = { position = [0, 0.05, 3], direction = 'forward' }",
        "materials = [ { type = 'lambert', albedo = 'gray' },",
        "              { type = 'metal', albedo = 'white', roughness = 0.02 } ]",
        "spheres = [ " + ",\n  ".join(rows) + " ]",
    ])


# most camera rays miss: few rays live after bounce 0
SKY_TOML = """
camera = { position = [0, 1, 3], direction = 'forward' }
materials = [ { type = 'lambert', albedo = 'gray' }, { type = 'metal', albedo = 'white' } ]
spheres = [ { material = 0, position = [0, 0.8, -4], radius = 0.3 },
            { material = 1, position = [0.5, 1.0, -4.5], radius = 0.2 } ]
"""


# ---- the records-and-replay route (queue 2 rows 2 and 6) and the FMA probe (row 10) ----

REC_SHAPE = dict(size=(800, 600), spp=4, max_bounces=8)    # the headline shape
BIG_BOX_SHAPE = dict(size=(960, 540), spp=2, max_bounces=8)  # the config-5 slice's


def box_scene_toml(n_spheres, n_boxes):
    """tests/test_pallas_blockwise.py's box scene generator (the port's
    copy, tests/test_torch_common.py)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_common import box_scene_toml as toml

    return toml(n_spheres, n_boxes)


def big_box_scene():
    """660 spheres and 24 boxes (box_scene_toml)."""
    import rt_tpu_torch

    return rt_tpu_torch.loads(box_scene_toml(660, 24))


def record_tables(scene, personality, size, include_boxes, blockwise):
    """(tables..., cam) for the unrolled or the blockwise record kernel, on the card."""
    import torch
    from rt_tpu_torch.ops import render as R

    cam = torch.from_numpy(R._pack_camera(scene.camera, size)).cuda()
    if blockwise:
        return (*bw_tables(scene, personality, include_boxes), cam)
    return card_tables(scene, personality, size, include_boxes)


def record_work(recs, tables, blockwise):
    """Live work of a record launch, counted from its records: rays, live
    bounces, misses, hits per kind and per material class, and the dead
    bounces (draws only)."""
    import torch

    if blockwise:
        sp, pl, bx, (ns, npl, nb) = tables
    else:
        sp, pl, bx = tables
        ns, npl, nb = sp.shape[0], pl.shape[0], bx.shape[0]
    bits, kind, idx = recs["bits"], recs["kind"].long(), recs["idx"].long()
    live = (bits & 16) > 0
    cls = torch.zeros_like(idx, dtype=torch.float32)
    for k, t, col in ((1, sp, 9), (2, pl, 9), (3, bx, 11)):
        if t.shape[0]:
            m = live & (kind == k)
            cls[m] = t[idx[m], col]
    hit = live & (kind > 0)
    work = {"rays": bits.shape[1], "live": int(live.sum()), "miss": int((live & (kind == 0)).sum()),
            "sphere": int((hit & (kind == 1)).sum()), "plane": int((hit & (kind == 2)).sum()),
            "box": int((hit & (kind == 3)).sum()),
            "lambert": int((hit & (cls != 1.0) & (cls != 2.0)).sum()),
            "metal": int((hit & (cls == 1.0)).sum()), "dielectric": int((hit & (cls == 2.0)).sum()),
            "dead": int((~live).sum()), "counts": (ns, npl, nb)}
    return work


def record_bound(work, depth, row_floats):
    """(bound_ms, bound_by) of a record launch: bytes of the used table rows
    (``row_floats`` floats per sphere, plane and box row), camera, seed and
    every output written once (rad, 7 record arrays of (B, N), jitter), and
    the FP32 operations of this launch's live work."""
    n = work["rays"]
    ns, npl, nb = work["counts"]
    n_bytes = (4 * sum(c * f for c, f in zip((ns, npl, nb), row_floats)) + 4 * (16 + 1)
               + 4 * n * (3 + 7 * depth + 2))
    ops = (forward_ops(work, ns, npl) + work["live"] * (nb * OPS["scan_box"]
                                                        + (OPS["box_setup"] if nb else 0))
           + work["box"] * (OPS["fwd_hit"] + OPS["fwd_box"])
           + (work["live"] - work["miss"]) * OPS["record"]
           + work["miss"] * OPS["record_miss"] + work["dead"] * OPS["record_draws"])
    return bound(n_bytes, ops)


def records_parity(scenes, report):
    """Phase 3 for the record kernels and the FMA probe: each record kernel
    bit for bit with its plain version (every record array and the
    radiance) at depth 8 with both centre-sample settings, and its radiance
    equal to the render kernel's 1-spp frame at the same seed; the probe at
    the main path's k within 1e-5 of its plain version.  Returns max
    |kernel - plain| per kernel."""
    import torch
    from rt_tpu_torch import roofline
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import render as R

    errs = {"render_record_kernel": 0.0, "blockwise_record_kernel": 0.0, "fma_peak_kernel": 0.0}
    report["record_parity"] = []
    seeds = torch.tensor([11], dtype=torch.int32, device="cuda")
    cases = [  # label, scene, personality, size, --boxes, blockwise
        ("basic/mg", "basic", "mg", (800, 600), False),
        ("dielectric/sm", "dielectric", "sm", (800, 600), False),
        ("basic+box/mg --boxes", "basic+box", "mg", (800, 600), True),
    ]
    runs = [(c, False) for c in cases] + [(c, True) for c in cases]
    # the blockwise record kernel's rejecting scan: rows staged in shared
    # memory (660 spheres), rows from device memory (2100, past 2048), and
    # the scan's edges (exact ties, grazing rays)
    runs += [((label, key, "mg", size, boxes), True) for label, key, size, boxes in (
        ("660 spheres + 24 boxes --boxes", "bigbox", (320, 240), True),
        ("2100 spheres + 24 boxes --boxes", "box2100", (160, 120), True),
        ("ties/mg --boxes", "ties", (320, 240), True),
        ("grazing/mg", "grazing", (320, 240), False))]
    for (label, key, pers, size, boxes), blockwise in runs:
        scene = scenes[key]
        args = record_tables(scene, pers, size, boxes, blockwise)
        kernel = BW.render_record_blockwise_tile if blockwise else R.render_record_tile
        plain = BW.render_record_blockwise_tile_plain if blockwise else R.render_record_tile_plain
        name = "blockwise_record_kernel" if blockwise else "render_record_kernel"
        for center in (True, False):
            kw = dict(size=size, max_bounces=8, center_sample=center)
            rad, recs = kernel(*args, seeds, **kw)
            want_rad, want = plain(*args, seeds, **kw)
            # the 1-spp frame at the same seed: the render kernel's, or past
            # its 640 primitives the blockwise kernel's
            if blockwise and sum(args[3]) > R.MAX_UNROLL_PRIMS:
                frame = BW.render_blockwise_tile(*args, seeds, spp=1, **kw)
            else:
                r_args = card_tables(scene, pers, size, boxes)
                frame = R.render_tile(*r_args[:3], args[-1], seeds, spp=1, **kw)[0]
            torch.cuda.synchronize()
            err = (rad - want_rad).abs().max().item()
            for k in want:
                err = max(err, (recs[k].float() - want[k].float()).abs().max().item())
            errs[name] = max(errs[name], err)
            live = ((recs["bits"] & 16) > 0).sum().item()
            report["record_parity"].append({"kernel": name, "case": label, "size": size,
                                            "center_sample": center, "max_abs": err,
                                            "live_bounces": live})
            log(f"[3] {name} {label} {size[0]}x{size[1]} d8 centre={center}: max|d| {err:.3g} "
                f"over the radiance and the 7 record arrays ({live} live bounces); radiance == "
                f"the 1-spp frame: {torch.equal(rad, frame)}")
            check(torch.isfinite(rad).all().item(), f"{name} {label}: radiance not finite")
            check(torch.equal(rad, want_rad) and all(torch.equal(recs[k], want[k]) for k in want),
                  f"{name} {label}: kernel differs from its plain version")
            check(torch.equal(rad, frame), f"{name} {label}: the record radiance is not the 1-spp "
                                           "frame")
            if boxes:
                check(bool((recs["kind"] == 3).any()), f"{name} {label}: no box winner recorded")

    # the probe at the main path's (the roofline's) two chain lengths
    x = torch.full((256, 128), 1.0 + 1e-6, device="cuda")
    for k in (1024, 4096):
        got, want = roofline.fma_peak(x, k), roofline.fma_peak_plain(x, k)
        torch.cuda.synchronize()
        rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        errs["fma_peak_kernel"] = max(errs["fma_peak_kernel"], (got - want).abs().max().item())
        log(f"[3] fma_peak_kernel k={k}: max |d|/max(|plain|, 1) {rel:.3g} (tolerance 1e-5: "
            f"the plain version rounds each FMA through float64)")
        check(torch.isfinite(got).all().item() and rel <= 1e-5,
              f"fma_peak_kernel k={k} differs from its plain version")
    return errs


def _grads_close(got, want):
    """(ok, per-key max |d| / max |want|): within atol 2e-4 x max|want| and
    rtol 2e-3 (the JAX package's tolerances between its fused and replay
    paths)."""
    import torch

    rel, ok = {}, True
    for k, w in want.items():
        g = got[k]
        scale = max(w.abs().max().item(), 1e-6)
        ok &= bool(torch.isfinite(g).all()) and bool(
            ((g - w).abs() <= 2e-4 * scale + 2e-3 * w.abs()).all())
        rel[k] = (g - w).abs().max().item() / scale
    return ok, rel


def records_main_paths(scenes, report, box_rays=None):
    """Phase 4 for the records route and the roofline probe, each path with
    the launch counters reset just before and read just after.  Returns
    (launches per kernel, the (a) inputs for phase 5)."""
    import torch
    from rt_tpu_torch import diff, roofline
    from rt_tpu_torch.integrator import _pixel_grid
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R
    from rt_tpu_torch.replay import PathRecords, replay_radiance

    wrappers = {"render_kernel": R.render_tile, "mse_step_kernel": G.mse_step_tile,
                "grad_kernel": G.grad_tile, "blockwise_kernel": BW.render_blockwise_tile,
                "render_record_kernel": R.render_record_tile,
                "blockwise_record_kernel": BW.render_record_blockwise_tile,
                "fma_peak_kernel": roofline.fma_peak}
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
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 matmuls")

    # (a) the headline shape through the records route against the mono step
    basic = scenes["basic"]
    size, spp, depth = REC_SHAPE["size"], REC_SHAPE["spp"], REC_SHAPE["max_bounces"]
    params = diff.extract_params(basic)
    p_tgt = dict(params)
    p_tgt["materials.albedo"] = params["materials.albedo"] * torch.tensor([0.8, 1.0, 0.9, 1.0])
    target = R.render_forward(diff.apply_params(basic, p_tgt), size, seed=5, spp=spp,
                              max_bounces=depth, gamma=False, device="cuda")
    kw = dict(spp=spp, max_bounces=depth, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset()
    loss_r, g_r = diff.records_loss_and_grad(params, basic, target, size, seed=7, **kw)
    read("(a) records_loss_and_grad basic 800x600 4spp d8", render_record_kernel=spp)
    peak_a = torch.cuda.max_memory_allocated()
    reset()
    loss_m, g_m = G.mse_loss_and_grad(params, basic, target, size, seed=7, **kw)
    read("(a) mse_loss_and_grad (mono) at the same seed", mse_step_kernel=1)
    ok, rel = _grads_close(g_r, g_m)
    loss_rel = abs(loss_r.item() - loss_m.item()) / loss_m.item()
    log(f"[4] (a) records route vs the mono step, basic 800x600 4spp d8 seed 7: loss "
        f"{loss_r.item():.9g} vs {loss_m.item():.9g} (rel {loss_rel:.3g}); max |d|/max|g| per key "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }; peak device memory "
        f"{peak_a / 2**30:.2f} GiB")
    check(loss_rel <= 1e-5 and ok, "the records route and the mono step disagree")
    out["a"] = {"loss_records": loss_r.item(), "loss_mono": loss_m.item(), "loss_rel": loss_rel,
                "grad_rel": rel, "peak_bytes": peak_a}

    # (b) camera-only descent on dielectric/sm towards a frame rendered at a
    # shifted camera, at a fixed seed: each of 5 steps moves along -g/|g| by
    # the first of 0.02, 0.01, 0.005, 0.0025 that lowers the loss (a
    # backtracking line search; the detached-sampling camera gradient has no
    # silhouette term, so a long step can overshoot)
    diel = scenes["dielectric"]
    pos0 = diel.camera.position.clone()
    shift = torch.tensor([0.1, 0.0, 0.0])
    tgt_b = R.render_forward(diff.apply_params(diel, {"camera.position": pos0 + shift}), size,
                             seed=5, spp=spp, max_bounces=depth, gamma=False, personality="sm",
                             device="cuda")

    def cam_eval(pos):
        loss_i, g = diff.records_loss_and_grad({"camera.position": pos}, diel, tgt_b, size, seed=1,
                                               personality="sm", **kw)
        gp = g["camera.position"].cpu()
        check(set(g) == {"camera.position"} and bool(torch.isfinite(gp).all()),
              "camera gradient missing or not finite")
        return loss_i.item(), gp

    reset()
    pos = pos0.clone()
    loss_b, gp = cam_eval(pos)
    losses, dists, evals = [loss_b], [float((pos - pos0 - shift).norm())], 1
    for _ in range(5):
        for step in (0.02, 0.01, 0.005, 0.0025):
            trial = pos - step * gp / gp.norm().clamp_min(1e-30)
            loss_t, g_t = cam_eval(trial)
            evals += 1
            if loss_t < losses[-1]:
                pos, gp = trial, g_t
                losses.append(loss_t)
                dists.append(float((pos - pos0 - shift).norm()))
                break
        else:
            break
    read(f"(b) descent on camera.position, dielectric/sm 800x600 4spp d8 ({evals} evaluations)",
         render_record_kernel=evals * spp)
    log(f"[4] (b) camera-only descent: losses {losses}; distance to the target camera {dists}")
    check(losses[-1] < losses[0], "the camera-only descent did not lower the loss")
    out["b"] = {"losses": losses, "distances": dists, "evaluations": evals}

    # (c) past the unrolled cap: 660 spheres + 24 boxes through the
    # blockwise record kernel at the config-5 slice's shape
    big = scenes["bigbox"]
    size_c, spp_c = BIG_BOX_SHAPE["size"], BIG_BOX_SHAPE["spp"]
    check(not R.supported(big, include_boxes=True), "the box scene fits the render kernel")
    params_c = diff.extract_params(big)
    tgt_c = torch.full((size_c[1], size_c[0], 3), 0.2, device="cuda")
    kw_c = dict(seed=3, spp=spp_c, max_bounces=depth, include_boxes=True, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset()
    loss_c, g_c = diff.records_loss_and_grad(params_c, big, tgt_c, size_c, **kw_c)
    read("(c) records_loss_and_grad 660 spheres + 24 boxes 960x540 2spp d8",
         blockwise_record_kernel=spp_c)
    peak_c = torch.cuda.max_memory_allocated()
    gb, ge = g_c["boxes.center"], g_c["boxes.extents"]
    log(f"[4] (c) loss {loss_c.item():.9g}; max |grad| boxes.center {gb.abs().max().item():.4g}, "
        f"boxes.extents {ge.abs().max().item():.4g}; peak device memory {peak_c / 2**30:.2f} GiB")
    check(all(bool(torch.isfinite(g).all()) for g in g_c.values()), "(c) gradient not finite")
    check(gb.abs().max().item() > 0 and ge.abs().max().item() > 0, "(c) box gradients are zero")

    eps = 1e-3
    reset()
    fd_alb = []
    for sign in (1, -1):
        p = dict(params_c)
        p["materials.albedo"] = params_c["materials.albedo"].clone()
        p["materials.albedo"][0, 0] += sign * eps
        fd_alb.append(diff.records_loss_and_grad(p, big, tgt_c, size_c, **kw_c)[0].item())
    read("(c) central FD on materials.albedo[0, 0] (2 evaluations)",
         blockwise_record_kernel=2 * spp_c)
    fd_a = (fd_alb[0] - fd_alb[1]) / (2 * eps)
    an_a = g_c["materials.albedo"][0, 0].item()

    # A box centre moves the hit points on the box, and from there the
    # later bounces' origins: where such a ray grazes a sphere its t has
    # an infinite derivative (1/sqrt of the discriminant), so one ray can
    # carry most of the gradient and a +-1e-3 step jumps across it; the
    # box also moves its silhouette, a term the detached-sampling gradient
    # leaves out by design (rt_tpu.diff).  Both differences, on the replay
    # with the records held and through the whole route, are printed for
    # the coordinate with the largest gradient; neither is held to a
    # tolerance (tests/test_torch_records_grad.py holds a box centre's
    # difference at the JAX test's well-conditioned shape).
    i_box, c_box = divmod(int(gb.abs().argmax()), 3)
    big_dev = big.to("cuda")
    recs = [R.records_to_flat(BW.render_record_blockwise_tile(
        *record_tables(big, "mg", size_c, True, True), torch.from_numpy(
            G._sample_seeds(3, spp_c)[s:s + 1]).cuda(), size=size_c, max_bounces=depth,
        center_sample=(s == 0))[1]) for s in range(spp_c)]
    grid = _pixel_grid(size_c, "cuda")

    @torch.no_grad()
    def pinned_loss(center):
        sc = diff.apply_params(big_dev, {"boxes.center": center})
        acc = None
        for r in recs:
            o, d = diff._record_rays(sc.camera, size_c, grid, r["jitter"])
            names = ("kind", "idx", "root_lo", "live_in", "miss", "alive_out", "reflect_bit",
                     "lam_deg")
            rad = replay_radiance(sc, o, d, None, PathRecords(*(r[k] for k in names)),
                                  max_bounces=depth, draws=(r["ur"], r["coin"]),
                                  include_boxes=True)
            acc = rad if acc is None else acc + rad
        img = (acc / spp_c).reshape(size_c[1], size_c[0], 3).double()
        return torch.mean((img - tgt_c.double()) ** 2).item()

    fd_box, fd_full = [], []
    for sign in (1, -1):
        c = params_c["boxes.center"].clone().cuda()
        c[i_box, c_box] += sign * eps
        fd_box.append(pinned_loss(c))
        p = dict(params_c, **{"boxes.center": c})
        fd_full.append(diff.records_loss_and_grad(p, big, tgt_c, size_c, **kw_c)[0].item())
    fd_b = (fd_box[0] - fd_box[1]) / (2 * eps)
    fd_bf = (fd_full[0] - fd_full[1]) / (2 * eps)
    an_b = gb[i_box, c_box].item()
    rel_a = abs(an_a - fd_a) / max(abs(fd_a), 1e-12)
    rel_b = abs(an_b - fd_b) / max(abs(fd_b), 1e-12)
    reset()
    log(f"[4] (c) materials.albedo[0, 0]: analytic {an_a:.6g}, central FD {fd_a:.6g} (rel "
        f"{rel_a:.3g}, tolerance 3e-2); boxes.center[{i_box}, {c_box}]: analytic {an_b:.6g}, "
        f"central FD on the held records {fd_b:.6g} (rel {rel_b:.3g}), through the route "
        f"{fd_bf:.6g} (not held to a tolerance)")
    check(rel_a <= 3e-2, "(c) the albedo gradient disagrees with its finite difference")
    total_b, top = box_gradient_rays(big_dev, recs, tgt_c, size_c, depth, i_box, c_box)
    log(f"[4] (c) boxes.center[{i_box}, {c_box}] by ray: the rays that reach box {i_box} sum to "
        f"{total_b:.6g} (the route's analytic {an_b:.6g}); the largest: "
        + "; ".join(f"sample {t['sample']} pixel ({t['x']}, {t['y']}) {t['contribution']:.4g} "
                    f"({t['contribution'] / total_b:.1%}), kinds {t['kind']}, root bits "
                    f"{t['root_lo']}" for t in top[:5]))
    check(abs(total_b - an_b) <= 1e-3 * abs(an_b) + 1e-9, "(c) the rays' box-centre gradients do "
                                                        "not sum to the route's")
    if box_rays:
        save_box_rays(box_rays, top, dict(i_box=i_box, c_box=c_box, analytic=an_b, rays_sum=total_b,
                                          size=size_c, depth=depth, scene=(660, 24)))
        log(f"[4] (c) the {len(top)} largest rays' records written to {box_rays}")
    out["c"] = {"loss": loss_c.item(), "box_center_max": gb.abs().max().item(),
                "box_extents_max": ge.abs().max().item(), "peak_bytes": peak_c,
                "fd_albedo": [an_a, fd_a, rel_a], "fd_box_center": [i_box, c_box, an_b, fd_b, rel_b],
                "fd_box_center_full_pipeline": fd_bf, "box_center_rays_sum": total_b,
                "box_center_top_rays": [{k: v for k, v in t.items() if k not in ("arrays",)}
                                        for t in top[:8]]}

    # (d) the roofline path: the probe at its two chain lengths
    reset()
    tf_1k, dt_1k = roofline.measure_fma_peak(1024, windows=3)
    tf_4k, dt_4k = roofline.measure_fma_peak(4096, windows=3)
    read("(d) roofline.measure_fma_peak k=1024 and 4096", fma_peak_kernel=2 * (1 + 3 * 16))
    out["d"] = {"tflops_1k": tf_1k, "tflops_4k": tf_4k, "scaling": dt_4k / dt_1k}
    report["records_main_path"] = dict(out, launches=total)
    return total, {"params": params, "target": target,
                   "box": dict(params=params_c, scene=big, target=tgt_c, size=size_c, kw=kw_c)}


REC_NAMES = ("kind", "idx", "root_lo", "live_in", "miss", "alive_out", "reflect_bit", "lam_deg")


def box_gradient_rays(scene, recs, target, size, depth, i_box, c_box, top=8):
    """The records route's gradient of boxes.center[i_box, c_box] split by
    ray: each ray that reaches box i_box at a live bounce replays with its
    own copy of the box table (its kind-3 records point into it), so the
    gradient of sum(w * radiance) with w the loss's weight of each ray
    (dL/drad, from the replayed image) lands in that ray's copy.  Returns
    (the rays' sum, the ``top`` largest by magnitude, each with its sample,
    pixel, contribution, kinds and root bits per bounce, and its arrays)."""
    import dataclasses

    import torch
    from rt_tpu_torch import diff
    from rt_tpu_torch.integrator import _pixel_grid
    from rt_tpu_torch.replay import PathRecords, replay_radiance

    w, h = size
    n, spp = w * h, len(recs)
    grid = _pixel_grid(size, target.device)
    with torch.no_grad():
        img = 0.0
        for r in recs:
            o, d = diff._record_rays(scene.camera, size, grid, r["jitter"])
            img = img + replay_radiance(scene, o, d, None, PathRecords(*(r[k] for k in REC_NAMES)),
                                        max_bounces=depth, draws=(r["ur"], r["coin"]),
                                        include_boxes=True)
        wgt = 2.0 * (img / spp - target.reshape(n, 3)) / (3 * n * spp)
    nb = scene.boxes.center.shape[0]  # the table's rows (count <= rows)
    per_sample = []
    for s, r in enumerate(recs):
        rays = ((r["kind"] == 3) & (r["idx"] == i_box) & r["live_in"]).any(0).nonzero()[:, 0]
        m = rays.numel()
        if m == 0:
            continue
        center = scene.boxes.center.repeat(m, 1).requires_grad_(True)
        boxes = dataclasses.replace(scene.boxes, center=center,
                                    extents=scene.boxes.extents.repeat(m, 1),
                                    material=scene.boxes.material.repeat(m),
                                    count=(m - 1) * nb + scene.boxes.count)
        sub = {k: r[k][:, rays] for k in REC_NAMES}
        sub["idx"] = torch.where(sub["kind"] == 3,
                                 sub["idx"] + nb * torch.arange(m, device=rays.device), sub["idx"])
        o, d = diff._record_rays(scene.camera, size, grid[rays], r["jitter"][rays])
        rad = replay_radiance(dataclasses.replace(scene, boxes=boxes), o, d, None,
                              PathRecords(*(sub[k] for k in REC_NAMES)), max_bounces=depth,
                              draws=(r["ur"][:, rays], r["coin"][:, rays]), include_boxes=True)
        (g,) = torch.autograd.grad((rad * wgt[rays]).sum(), center)
        per_sample.append((s, rays, o.detach(), d.detach(),
                           g.reshape(m, nb, 3)[:, i_box, c_box].double()))
    contrib = torch.cat([c for *_, c in per_sample])
    total = contrib.sum().item()
    out = []
    for k in contrib.abs().argsort(descending=True)[:top].tolist():
        for s, rays, o, d, c in per_sample:  # the sample holding ray k
            if k < rays.numel():
                break
            k -= rays.numel()
        ray, r = int(rays[k]), recs[s]
        arrays = {"o": o[k], "d": d[k], "weight": wgt[ray], "ur": r["ur"][:, ray],
                  "coin": r["coin"][:, ray], **{name: r[name][:, ray] for name in REC_NAMES}}
        out.append({"contribution": c[k].item(), "sample": s, "x": ray % w, "y": ray // w,
                    "kind": arrays["kind"].tolist(), "root_lo": arrays["root_lo"].int().tolist(),
                    "arrays": arrays})
    return total, out


def save_box_rays(path, top, meta):
    """The rays of box_gradient_rays as one .npz: per ray its camera ray,
    loss weight, records and draws, stacked, with ``meta``."""
    import numpy as np

    arrays = {k: np.stack([t["arrays"][k].cpu().numpy() for t in top])
              for k in top[0]["arrays"]}
    arrays.update(contribution=np.asarray([t["contribution"] for t in top]),
                  sample=np.asarray([t["sample"] for t in top]),
                  pixel=np.asarray([[t["x"], t["y"]] for t in top]),
                  meta=np.asarray(json.dumps(meta)))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def records_timing(scenes, shape_a, card, report):
    """Phase 5 for the record kernels, the records route and the probe.
    Returns per-kernel timing rows for the kernels' JSON line."""
    import torch
    from rt_tpu_torch import diff, profiling, roofline
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R

    rows = {}
    seeds = torch.tensor([11], dtype=torch.int32, device="cuda")
    for name, key, size, boxes, blockwise in (
            ("render_record_kernel", "basic", REC_SHAPE["size"], False, False),
            ("blockwise_record_kernel", "bigbox", BIG_BOX_SHAPE["size"], True, True)):
        args = record_tables(scenes[key], "mg", size, boxes, blockwise)
        kernel = BW.render_record_blockwise_tile if blockwise else R.render_record_tile
        plain = BW.render_record_blockwise_tile_plain if blockwise else R.render_record_tile_plain
        kw = dict(size=size, max_bounces=8, center_sample=False)
        k_s = profiling.sustained(lambda i: kernel(*args, seeds, **kw), iters=16)
        p_s = profiling.sustained(lambda i: plain(*args, seeds, **kw), iters=1, windows=1,
                                  warmup_windows=0)
        work = record_work(kernel(*args, seeds, **kw)[1], args[:-1], blockwise)
        work["disc_pairs"] = launch_disc_pairs(bw_tables(scenes[key], "mg", boxes), args[-1], 11,
                                               size, 8, False)
        b_ms, b_by = record_bound(work, 8, (16, 16, 16) if blockwise else (10, 10, 12))
        rows[name] = {"ms": k_s["median"] * 1e3, "spread_ms": [k_s["min"] * 1e3, k_s["max"] * 1e3],
                      "plain_ms": p_s["median"] * 1e3, "bound_ms": b_ms, "bound_by": b_by,
                      "live_work": {k: v for k, v in work.items() if k != "counts"},
                      "case": f"{key} {size[0]}x{size[1]} 1 sample d8"}
        log(f"[5] {name} {key} {size[0]}x{size[1]} 1 sample d8: kernel {rows[name]['ms']:.4f} ms, "
            f"plain {rows[name]['plain_ms']:.1f} ms, bound {b_ms:.4f} ms ({b_by}); live bounces "
            f"{work['live']} of {work['rays'] * 8} | {card}")

    # the (a) step against the mono step, interleaved windows
    basic = scenes["basic"]
    size, spp, depth = REC_SHAPE["size"], REC_SHAPE["spp"], REC_SHAPE["max_bounces"]
    params, target = shape_a["params"], shape_a["target"]
    mono = G.make_mse_step(params, basic, target, size, spp=spp, max_bounces=depth,
                           device="cuda")

    def rec_step(i):
        return diff.records_loss_and_grad(params, basic, target, size, seed=i, spp=spp,
                                          max_bounces=depth, device="cuda")

    rec_step(0), mono(0)
    torch.cuda.synchronize()
    ws_r, ws_m = [], []
    for _ in range(5):
        ws_r.append(window_s(rec_step, 2))
        ws_m.append(window_s(lambda i: mono(i), 16))
    med_r, med_m = sorted(ws_r)[2], sorted(ws_m)[2]
    dr = profiling.device_times(rec_step, iters=2)
    rec_ms = sum(v for k, v in dr.items() if "render_record_kernel" in k)
    dev_ms = sum(dr.values())
    step_row = {
        "step_ms": med_r * 1e3, "step_windows_ms": [x * 1e3 for x in ws_r],
        "fwd_bwd_mrays_s": profiling.mrays_per_sec(size, spp, med_r),
        "mono_step_ms": med_m * 1e3, "mono_windows_ms": [x * 1e3 for x in ws_m],
        "mono_fwd_bwd_mrays_s": profiling.mrays_per_sec(size, spp, med_m),
        "records_over_mono": med_r / med_m,
        "device_ms": {"record_kernels": rec_ms, "replay_autograd_and_rest": dev_ms - rec_ms},
        "busy_share": dev_ms / (med_r * 1e3),
        "step_device_ms_top": dict(sorted(dr.items(), key=lambda kv: -kv[1])[:12]),
    }
    log(f"[5] records_loss_and_grad basic 800x600 4spp d8: {step_row['step_ms']:.2f} ms = "
        f"{step_row['fwd_bwd_mrays_s']:.1f} Mrays/s fwd+bwd; the mono step "
        f"{step_row['mono_step_ms']:.4f} ms = {step_row['mono_fwd_bwd_mrays_s']:.1f} Mrays/s "
        f"(records/mono {step_row['records_over_mono']:.1f}, interleaved); device ms per step: "
        f"record kernels {rec_ms:.3f}, replay autograd and the rest {dev_ms - rec_ms:.2f}; busy "
        f"{step_row['busy_share']:.3f} | {card}")

    # the box-scene step (c): 2 blockwise record launches, then the replay's
    # autograd; its device time split between the record kernels and the rest
    bx = shape_a["box"]

    def box_step(i):
        return diff.records_loss_and_grad(bx["params"], bx["scene"], bx["target"], bx["size"],
                                          **dict(bx["kw"], seed=i))

    box_step(0)
    torch.cuda.synchronize()
    ws_b = [window_s(box_step, 2) for _ in range(5)]
    med_b = sorted(ws_b)[2]
    db = profiling.device_times(box_step, iters=2)
    brec_ms = sum(v for k, v in db.items() if "blockwise_record_kernel" in k)
    bdev_ms = sum(db.values())
    box_row = {
        "step_ms": med_b * 1e3, "step_windows_ms": [x * 1e3 for x in ws_b],
        "fwd_bwd_mrays_s": profiling.mrays_per_sec(bx["size"], bx["kw"]["spp"], med_b),
        "device_ms": {"record_kernels": brec_ms, "replay_autograd_and_rest": bdev_ms - brec_ms},
        "busy_share": bdev_ms / (med_b * 1e3),
        "step_device_ms_top": dict(sorted(db.items(), key=lambda kv: -kv[1])[:12]),
    }
    log(f"[5] records_loss_and_grad box scene (660 spheres + 24 boxes) 960x540 2spp d8: "
        f"{box_row['step_ms']:.2f} ms = {box_row['fwd_bwd_mrays_s']:.2f} Mrays/s fwd+bwd; device "
        f"ms per step: record kernels {brec_ms:.3f} (2 launches), replay autograd and the rest "
        f"{bdev_ms - brec_ms:.2f}; busy {box_row['busy_share']:.3f} | {card}")

    # the probe: TFLOP/s at both chain lengths and the scaling verdict
    x = torch.full((256, 128), 1.0 + 1e-6, device="cuda")
    tf_1k, dt_1k = roofline.measure_fma_peak(1024)
    tf_4k, dt_4k = roofline.measure_fma_peak(4096)
    scaling = dt_4k / dt_1k
    valid = 2.5 <= scaling <= 6.0
    p_s = profiling.sustained(lambda i: roofline.fma_peak_plain(x, 4096), iters=1, windows=1,
                              warmup_windows=0)
    elems = 256 * 128 * roofline.TILES
    f_bound = bound(4 * (256 * 128 + elems), 4096 * elems)  # one FMA = one issued operation
    rows["fma_peak_kernel"] = {"ms": dt_4k * 1e3, "plain_ms": p_s["median"] * 1e3,
                               "bound_ms": f_bound[0], "bound_by": f_bound[1],
                               "tflops_1k": tf_1k, "tflops_4k": tf_4k, "ms_1k": dt_1k * 1e3,
                               "scaling": scaling, "valid": valid}
    log(f"[5] fma_peak_kernel: k=1024 {tf_1k:.2f} TFLOP/s ({dt_1k * 1e3:.4f} ms), k=4096 "
        f"{tf_4k:.2f} TFLOP/s ({dt_4k * 1e3:.4f} ms, bound {f_bound[0]:.4f} ms at 67 TFLOP/s), "
        f"scaling {scaling:.2f}x: {'valid' if valid else 'INVALID'}; plain "
        f"{rows['fma_peak_kernel']['plain_ms']:.1f} ms | {card}")
    check(valid, f"the FMA probe's K-scaling check failed ({scaling:.2f}x)")
    report["records_timing"] = dict(rows, records_step=step_row, box_records_step=box_row)
    return rows


# ---- the jnp-style path (rt_tpu's own front door): the threefry rng,
# closest_hit, the integrator, loss_and_grad and fit.  It is PyTorch on the
# card from end to end and launches none of the ten kernels. ----

# examples/inverse_rendering.py's scene
INVERSE_TOML = """
materials = [ { type = 'lambert', albedo = [0.85, 0.85, 0.85] },
              { type = 'lambert', albedo = [0.2, 0.45, 0.85] },
              { type = 'metal',   albedo = [0.9, 0.9, 0.9], roughness = 0.1 } ]
spheres = [ { material = 0, position = [0, -1000, 0], radius = 1000 },
            { material = 1, position = [-0.7, 0.5, 0] },
            { material = 2, position = [0.7, 0.5, 0] } ]
camera = { position = [0, 1, 3], direction = 'forward' }
"""


def kernel_wrappers():
    """Every kernel wrapper of the port (each counts its launches)."""
    from rt_tpu_torch import roofline
    from rt_tpu_torch.ops import blockwise as BW
    from rt_tpu_torch.ops import blockwise_grad as BWG
    from rt_tpu_torch.ops import grad as G
    from rt_tpu_torch.ops import render as R
    from rt_tpu_torch.ops import wavefront as WF
    from rt_tpu_torch.ops import wavefront_grad as WFG

    return (R.render_tile, R.render_record_tile, G.mse_step_tile, G.grad_tile,
            BW.render_blockwise_tile, BW.render_record_blockwise_tile, BWG.bw_grad_tile,
            WF.wf_bounce, WFG.wf_rev, roofline.fma_peak)


def frame_gap(got, want):
    """(share of pixels beyond 2e-5, largest |difference|) of two frames."""
    d = (got.float().cpu() - want.float().cpu()).abs()
    return (d > 2e-5).any(dim=-1).float().mean().item(), d.max().item()


def grads_gap(got, want):
    """The largest |g - w| / (3e-4 max|w| + 3e-3 |w|) over every gradient
    entry (inf if one is not finite): <= 1 holds the gradients to atol
    3e-4 x max|g| and rtol 3e-3."""
    import torch

    worst = 0.0
    for k, w in want.items():
        w, g = w.cpu(), got[k].cpu()
        if not torch.isfinite(g).all().item():
            return float("inf")
        lim = 3e-4 * max(w.abs().max().item(), 1e-12) + 3e-3 * w.abs()
        worst = max(worst, ((g - w).abs() / lim).max().item())
    return worst


def cli_render_s(text):
    """The render time the CLI prints ("rendered WxH@Nspp on DEV in T s")."""
    import re

    return float(re.search(r" in ([0-9.]+)s ", text).group(1))


def jnp_parity(scenes, report):
    """Phase 6 (a): the threefry bits and the closest hit on the card
    against the CPU."""
    import numpy as np
    import torch
    from rt_tpu_torch import rng
    from rt_tpu_torch.ops.intersect import closest_hit

    for seed in (0, -3):
        for chain in ((0,), (3, 1), (7, 2, 5)):
            key = rng.fold(rng.make_key(seed), *chain)
            for fn, shape in ((rng.random_bits, 65536 * 3), (rng.uniform, (65536, 3))):
                got = fn(key, shape, device="cuda").cpu()
                check(torch.equal(got, fn(key, shape, device="cpu")),
                      f"{fn.__name__} seed {seed} chain {chain}: the card differs from the CPU")
    log("[6] threefry: random_bits and uniform equal (torch.equal) on the card and the CPU, "
        "2 seeds x 3 fold chains x 65536x3 counters")
    rows = []
    n, piece = 1 << 17, 1 << 14
    for name, include_boxes in (("basic+box", True), ("cornell", False), ("proc500", False),
                                ("ties", True)):
        scene, card = scenes[name], scenes[name].to("cuda")
        g = np.random.default_rng(7)
        o = (scene.camera.position.numpy() + g.normal(size=(n, 3)) * 1.5).astype(np.float32)
        d = g.normal(size=(n, 3)) - [0.0, 0.3, 1.0]
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        differ, hits, dt = 0, 0, 0.0
        for lo in range(0, n, piece):
            oo, dd = o[lo:lo + piece], d[lo:lo + piece]
            want = closest_hit(scene.spheres, scene.planes, scene.boxes, oo, dd,
                               include_boxes=include_boxes)
            got = closest_hit(card.spheres, card.planes, card.boxes, oo.cuda(), dd.cuda(),
                              include_boxes=include_boxes)
            same = torch.ones(oo.shape[0], dtype=torch.bool)
            for k in ("kind", "idx", "root_lo", "material", "hit"):
                same &= getattr(got, k).cpu() == getattr(want, k)
            differ += int((~same).sum())
            hits += int(want.hit.sum())
            both = want.hit & got.hit.cpu()
            if both.any():
                dt = max(dt, (got.t.cpu() - want.t)[both].abs().max().item())
        rows.append({"scene": name, "rays": n, "hits": hits, "winners_differ": differ,
                     "max_abs_dt": dt})
        log(f"[6] closest_hit {name}{' --boxes' if include_boxes else ''}: {n} rays, {hits} hits, "
            f"winners differing from the CPU: {differ}, largest |dt| {dt:.3g}")
        check(differ == 0, f"closest_hit {name}: {differ} winners differ from the CPU")
    report["jnp_parity"] = {"closest_hit": rows}


def jnp_main_paths(scenes, card, report):
    """Phase 6 (b)-(e): the CLI's default renderer, the integrator past the
    kernels' limits, loss_and_grad at the README's shape in both modes, and
    fit, with every kernel counter reset before and read after (the path
    launches none).  Times are host clocks around work that ends in a
    synchronise."""
    import contextlib
    import io

    import numpy as np
    import torch
    import rt_tpu_torch
    from rt_tpu_torch import diff, integrator, log as tlog, profiling, renderer, rng, train
    from rt_tpu_torch.cli import main as cli_main

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matrix products are on")
    wrappers = kernel_wrappers()
    for fn in wrappers:
        fn.launches = 0
    out = {}
    basic = scenes["basic"]
    size = (800, 600)

    def cli(argv):
        so, se = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for ln in (so.getvalue() + se.getvalue()).splitlines():
            log(f"    cli: {ln}")
        check(rc == 0, f"cli {' '.join(argv)} exited with {rc}")
        return so.getvalue(), se.getvalue(), wall

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the JAX CLI's default: mg -> mg_ray_tracer, the scene's 30 spp, 10 bounces
        png = Path(tmp) / "default.png"
        text, _, wall = cli(["--scene", str(ROOT / "scenes" / "basic.toml"), "--size", "800x600",
                             "--device", "cuda", "--out", str(png)])
        check("created renderer: mg_ray_tracer" in text, "the CLI default is not mg_ray_tracer")
        check(png_rgba(png).shape == (600, 800, 4), "the default frame's PNG has the wrong shape")
        spp, depth = basic.samples_per_pixel, basic.max_bounces
        render_s = cli_render_s(text)
        one = lambda i: integrator.render_image(basic, size, rng.make_key(i), spp=1)  # noqa: E731
        t1 = profiling.sustained(one, iters=1, windows=3)
        busy = sum(profiling.device_times(one, iters=1).values()) / (t1["median"] * 1e3)
        out["cli_default"] = {"renderer": "mg_ray_tracer", "spp": spp, "max_bounces": depth,
                              "cli_wall_s": wall, "render_s": render_s,
                              "mrays_s": profiling.mrays_per_sec(size, spp, render_s),
                              "one_spp_frame_ms": t1["median"] * 1e3,
                              "one_spp_busy_share": busy}
        log(f"[6] (b) CLI default (mg_ray_tracer) basic 800x600 {spp}spp d{depth}: frame "
            f"{render_s:.2f} s = {out['cli_default']['mrays_s']:.2f} Mrays/s (command "
            f"{wall:.2f} s); one 1-spp frame {t1['median'] * 1e3:.1f} ms, card busy "
            f"{busy:.3f} of it | {card}")
        got = integrator.render_image(basic, (96, 64), rng.make_key(0), spp=4, device="cuda")
        want = integrator.render_image(basic, (96, 64), rng.make_key(0), spp=4, device="cpu")
        share, mx = frame_gap(got, want)
        log(f"[6] (b) 96x64 4spp d{depth}, card against CPU: {share:.5f} of pixels beyond 2e-5, "
            f"max |d| {mx:.3g}")
        check(share <= 0.005, f"the card's 96x64 frame differs from the CPU's on {share} of pixels")
        out["cli_default"].update(parity_share=share, parity_max_abs=mx)
        for name in ("rasterizer", "null_renderer"):
            text, _, wall = cli(["--scene", str(ROOT / "scenes" / "basic.toml"), "--renderer", name,
                                 "--size", "800x600", "--device", "cuda",
                                 "--out", str(Path(tmp) / f"{name}.png")])
            check(f"created renderer: {name}" in text, f"--renderer {name}")
            out[name] = {"cli_wall_s": wall, "render_s": cli_render_s(text)}
            log(f"[6] (b) {name} 800x600: {out[name]['render_s']:.2f} s (command {wall:.2f} s)")
        share, mx = frame_gap(integrator.render_rasterizer(basic, size),
                              integrator.render_rasterizer(basic, size, device="cpu"))
        check(share <= 0.005, f"the rasterizer's card frame differs from the CPU's on {share}")

        # (c) past the kernels' 16384 primitives: mg_auto takes the integrator
        big = rt_tpu_torch.scene.make_procedural_scene(17000)
        route = renderer.auto_route(big, "cuda")
        check(route == "jnp", f"17000 spheres route to {route}")
        tlog.reset_warnings()
        npy = Path(tmp) / "big.npy"
        text, err, wall = cli(["--procedural", "17000", "--renderer", "mg_auto", "--size",
                               "320x240", "--spp", "1", "--bounces", "4", "--device", "cuda",
                               "--out", str(npy)])
        check("falling back to the jnp-style integrator" in err, "no warning for the jnp route")
        img = np.load(npy)
        check(img.shape == (240, 320, 3) and np.isfinite(img).all(), "the 17000-sphere frame")
        out["past_kernels"] = {"route": route, "spheres": 17000, "render_s": cli_render_s(text),
                               "cli_wall_s": wall, "ray_chunk": integrator.default_ray_chunk(big)}
        log(f"[6] (c) mg_auto procedural 17000 320x240 1spp d4: route {route}, warned; frame "
            f"{out['past_kernels']['render_s']:.2f} s (chunks of "
            f"{out['past_kernels']['ray_chunk']} rays) | {card}")

        # (d) gradients at the README's shape, both grad modes
        kw = dict(spp=4, max_bounces=4, device="cuda")
        params = {k: v.cuda() for k, v in diff.extract_params(basic).items()}
        p_tgt = dict(params, **{"materials.albedo": params["materials.albedo"]
                                * torch.tensor([0.8, 1.0, 0.9, 1.0], device="cuda")})
        with torch.no_grad():
            target = diff.render_for_loss(p_tgt, basic, size, rng.make_key(5), **kw)
        res = {}
        diff.loss_and_grad(params, basic, target[::10, ::10], (80, 60), rng.make_key(1),
                           **kw)  # a small call first: one-time set-up
        for mode in ("replay", "autodiff"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, grads = diff.loss_and_grad(params, basic, target, size, rng.make_key(1),
                                             grad_mode=mode, **kw)
            torch.cuda.synchronize()
            res[mode] = (loss, grads, time.perf_counter() - t0, torch.cuda.max_memory_allocated())
        (l_r, g_r, s_r, m_r), (l_a, g_a, s_a, m_a) = res["replay"], res["autodiff"]
        gap = grads_gap(g_r, g_a)
        rel = abs(l_r.item() - l_a.item()) / abs(l_a.item())
        name, eps = "materials.reflectivity", 1e-3
        fd_l = []
        for sign in (1, -1):
            p = dict(params, **{name: params[name].clone()})
            p[name][0] += sign * eps
            with torch.no_grad():
                fd_l.append(diff.image_loss(p, basic, target, size, rng.make_key(1), **kw).item())
        fd = (fd_l[0] - fd_l[1]) / (2 * eps)
        an = g_r[name][0].item()
        grad_ok = abs(an - fd) <= max(2e-2 * abs(fd), 1e-4)
        out["loss_and_grad"] = {"shape": "basic 800x600 4spp d4", "replay_s": s_r,
                                "autodiff_s": s_a, "replay_peak_bytes": m_r,
                                "autodiff_peak_bytes": m_a, "loss": l_r.item(),
                                "loss_rel_gap": rel, "grads_gap": gap, "grad_an": an,
                                "grad_fd": fd, "grad_ok": grad_ok}
        log(f"[6] (d) loss_and_grad basic 800x600 4spp d4: replay {s_r:.2f} s (peak "
            f"{m_r / 2**30:.2f} GiB), autodiff {s_a:.2f} s (peak {m_a / 2**30:.2f} GiB); loss "
            f"rel gap {rel:.3g}, gradients at {gap:.3f} of the tolerance; reflectivity[0] "
            f"analytic {an:.6g}, central FD {fd:.6g}: grad_ok={grad_ok} | {card}")
        check(rel <= 1e-5 and gap <= 1.0, "replay and autodiff gradients disagree")
        check(grad_ok, "the jnp path's gradient disagrees with finite differences")

        # (e) fit: examples/inverse_rendering.py's set-up, then the README's shape
        inv = rt_tpu_torch.loads(INVERSE_TOML)
        true = {k: v.cuda() for k, v in diff.extract_params(inv).items()}
        fkw = dict(spp=4, max_bounces=4)
        with torch.no_grad():
            target_e = diff.render_for_loss(true, inv, (96, 64), rng.make_key(0), **fkw)
        albedo = true["materials.albedo"].clone()
        albedo[1] = torch.tensor([0.8, 0.8, 0.2, 1.0])
        start = diff.apply_params(inv, {"materials.albedo": albedo.cpu()})
        t0 = time.perf_counter()
        fitted, losses = train.fit(start, target_e, (96, 64), steps=30, learning_rate=3e-2,
                                   param_names=["materials.albedo"], verbose=False, **fkw)
        fit_s = time.perf_counter() - t0
        rec = fitted["materials.albedo"][1, :3].tolist()
        log(f"[6] (e) fit 96x64 4spp d4, 30 steps: loss {losses[0]:.5g} -> {losses[-1]:.5g}, "
            f"albedo[1] {[round(v, 4) for v in rec]} (true [0.2, 0.45, 0.85]); "
            f"{fit_s / 30 * 1e3:.1f} ms a step | {card}")
        check(losses[-1] < losses[0], "fit did not lower the loss")
        ckpt = dict(learning_rate=3e-2, param_names=["materials.albedo"], verbose=False,
                    checkpoint_every=2, **fkw)
        full, _ = train.fit(start, target_e, (96, 64), steps=4,
                            checkpoint_dir=str(Path(tmp) / "full"), **ckpt)
        train.fit(start, target_e, (96, 64), steps=2, checkpoint_dir=str(Path(tmp) / "cut"),
                  **ckpt)
        resumed, _ = train.fit(start, target_e, (96, 64), steps=4,
                               checkpoint_dir=str(Path(tmp) / "cut"), **ckpt)
        a, b = full["materials.albedo"], resumed["materials.albedo"]
        resume_gap = ((a - b).abs() / a.abs().clamp_min(1e-12)).max().item()
        log(f"[6] (e) 4 steps against 2 + resume from step 2: largest relative gap {resume_gap:.3g}")
        check(resume_gap <= 1e-6, "the resumed run differs from the uninterrupted one")
        with torch.no_grad():
            target_r = diff.render_for_loss(true, inv, (400, 300), rng.make_key(0), **fkw)
        p_r = {"materials.albedo": albedo.clone()}
        step = train.make_train_step(torch.optim.Adam(list(p_r.values()), lr=1e-2), start,
                                     target_r, (400, 300))
        key = rng.make_key(0)
        t_r = profiling.sustained(lambda i: step(p_r, rng.fold(key, i)), iters=1, windows=3)
        out["fit"] = {"steps": 30, "losses": losses, "albedo1": rec, "step_ms_96x64":
                      fit_s / 30 * 1e3, "resume_rel_gap": resume_gap,
                      "readme_step_ms_400x300": t_r["median"] * 1e3,
                      "readme_step_spread_ms": [t_r["min"] * 1e3, t_r["max"] * 1e3]}
        log(f"[6] (e) README fit step 400x300 4spp d4 (albedo, replay): {t_r['median'] * 1e3:.1f} "
            f"ms (spread {t_r['min'] * 1e3:.1f}-{t_r['max'] * 1e3:.1f}) | {card}")

    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches for fn in wrappers}
    log(f"[6] kernel launches on the jnp path: {launched}")
    check(not any(launched.values()), f"the jnp path launched kernels: {launched}")
    report["jnp_path"] = out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--box-rays", type=Path, metavar="NPZ",
                    help="write the rays that carry the largest shares of phase 4 (c)'s "
                         "box-centre gradient (records, draws, camera rays, loss weights) here")
    opts = ap.parse_args()

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
        "proc90": rt_tpu_torch.scene.make_procedural_scene(90),
        "proc500": rt_tpu_torch.scene.make_procedural_scene(500),
        "proc640": rt_tpu_torch.scene.make_procedural_scene(640),
        "proc1000": rt_tpu_torch.scene.make_procedural_scene(1000),
        "proc2000": rt_tpu_torch.scene.make_procedural_scene(2000),
        "proc5000": rt_tpu_torch.scene.make_procedural_scene(5000),
        "ties": rt_tpu_torch.loads(tie_scene_toml()),
        "grazing": rt_tpu_torch.loads(grazing_scene_toml()),
        "sky": rt_tpu_torch.loads(SKY_TOML),
        "proc2100": rt_tpu_torch.scene.make_procedural_scene(2100),
    }

    def tile_args(scene, personality, size, include_boxes=False, seed=11):
        seeds = torch.tensor([seed], dtype=torch.int32, device=dev)
        return (*card_tables(scene, personality, size, include_boxes), seeds)

    cases = [
        ("basic/mg", "basic", "mg", (800, 600), False),
        ("dielectric/sm", "dielectric", "sm", (800, 600), False),
        ("basic+box/mg --boxes", "basic+box", "mg", (800, 600), True),
        ("proc500/mg", "proc500", "mg", (320, 180), False),
        # the rejecting scan's edges: exact ties, grazing rays
        ("ties/mg --boxes", "ties", "mg", (320, 240), True),
        ("grazing/mg", "grazing", "mg", (320, 240), False),
        # one 4-spp launch of the config-4 frame (500 spheres, its width; half
        # its height, for the plain version's time)
        ("proc500/mg config-4 launch", "proc500", "mg", (1920, 540), False),
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
        log(f"[3] render_kernel {label} {size[0]}x{size[1]} 4spp d8: max|d| {row['max_abs']:.3g} "
            f"mean|d| {row['mean_abs']:.3g} px>1e-3 {row['share_gt_1e-3']:.5f} "
            f"exact {row['exact_share']:.5f}")
        check(torch.isfinite(got).all().item(), f"{label}: kernel output not finite")
        check(torch.equal(got, want), f"{label}: kernel differs from its plain version")
        max_err = max(max_err, row["max_abs"])
    scenes["cornell"] = rt_tpu_torch.load(str(ROOT / "scenes" / "cornell_spheres.toml"))
    grad_errs = grad_parity(scenes, report)
    bw_errs = blockwise_parity(scenes, report)
    wf_errs = wavefront_parity(scenes, report)
    wf_shape = wavefront_main_shape(scenes, report, wf_errs)
    scenes["bigbox"] = big_box_scene()
    scenes["box2100"] = rt_tpu_torch.loads(box_scene_toml(2100, 24))
    rec_errs = records_parity(scenes, report)

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
    wf_launches, step_wf, params_wf, target_wf = wavefront_main_paths(scenes, report)
    rec_launches, shape_a = records_main_paths(scenes, report, opts.box_rays)

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
    # row 1 at its main-path shape: one 4-spp launch of the config-4 frame
    # (500 spheres, 1920x1080; the frame's first chunk, sample 0 at the centre)
    m_size = (1920, 1080)
    m_args = tile_args(scenes["proc500"], "mg", m_size)
    m_kw = dict(size=m_size, spp=4, max_bounces=8, center_sample=True)
    m_s = profiling.sustained(lambda i: R.render_tile(*m_args, **m_kw), iters=4, windows=3)
    m_work = live_work(m_args[0], m_args[1], m_args[3], [11] * 4,
                       [s * (2 + 4 * 8) for s in range(4)], [True, False, False, False], m_size,
                       8, "reference")
    m_px = m_size[0] * m_size[1]
    m_bound = bound(4 * (10 * (m_args[0].shape[0] + m_args[1].shape[0]) + 16 + 1 + 3 * m_px),
                    forward_ops(m_work, m_args[0].shape[0], m_args[1].shape[0]))
    b.update(config4_launch_ms=m_s["median"] * 1e3,
             config4_launch_spread_ms=[m_s["min"] * 1e3, m_s["max"] * 1e3],
             config4_launch_bound_ms=m_bound[0], config4_launch_bound_by=m_bound[1],
             config4_launch_live_work=m_work)
    log(f"[5] render_kernel proc500 1920x1080 4spp d8 (one launch of the config-4 frame): "
        f"{b['config4_launch_ms']:.4f} ms, bound {m_bound[0]:.4f} ms ({m_bound[1]}); live "
        f"bounces {m_work['live']} of {m_work['rays'] * 8}, warp slots {m_work['warp_live']}, "
        f"sphere pairs with disc >= 0 {m_work['disc_pairs']} of "
        f"{m_work['live'] * m_args[0].shape[0]} (warp rows {m_work['disc_warp_rows']} of "
        f"{m_work['warp_live'] // 32 * m_args[0].shape[0]}) | {card}")
    g_rows = grad_timing(scenes, step_mse, step_c3, card, report)
    bw_rows = blockwise_timing(scenes, step_bw, params_bw, card, report)
    wf_rows = wavefront_timing(scenes, step_wf, params_wf, target_wf, wf_shape, card, report)
    rec_rows = records_timing(scenes, shape_a, card, report)

    # ---- 6. the jnp-style path ----
    t6 = time.perf_counter()
    jnp_parity(scenes, report)
    jnp_main_paths(scenes, card, report)
    report["jnp_phase_s"] = time.perf_counter() - t6
    log(f"[6] the jnp-style path's phase: {report['jnp_phase_s']:.1f} s")

    check("jax" not in sys.modules and "rt_tpu" not in sys.modules, "JAX was imported")
    log("[report] " + json.dumps(report))

    kernels = [{
        "name": "render_kernel",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/render_kernel.cu",
        "replaces": "rt_tpu/ops/pallas_render.py:171",
        "launches": launches + grad_launches["render_kernel"],
        "max_abs_err": max_err,
        "ms": b["config4_launch_ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["config4_launch_bound_ms"],
        "bound_by": b["config4_launch_bound_by"],
        "library_ms": None,
        "shape": "proc500 1920x1080 4spp d8 (one launch of the config-4 frame)",
        "plain_shape": "basic 800x600 4spp d8",
        "ms_basic": b["kernel_ms"], "bound_ms_basic": b["bound_ms"],
    }]
    for name, replaces in (("mse_step_kernel", "rt_tpu/ops/pallas_grad.py:1249"),
                           ("grad_kernel", "rt_tpu/ops/pallas_grad.py:207")):
        row = g_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "rt_tpu_torch/csrc/grad_kernel.cu",
            "replaces": replaces, "launches": grad_launches[name],
            "max_abs_err": grad_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "device_ms": row["device_ms"],
        })
    for name, replaces in (("blockwise_kernel", "rt_tpu/ops/pallas_blockwise.py:1073"),
                           ("bw_grad_kernel", "rt_tpu/ops/pallas_blockwise_grad.py:92")):
        row = bw_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"rt_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": bw_launches[name],
            "max_abs_err": bw_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "plain_shape": row["plain_shape"],
        })
    for name, source, replaces in (
            ("wf_bounce", "wavefront_kernel", "rt_tpu/ops/pallas_wavefront.py:219"),
            ("wf_rev", "wf_grad_kernel", "rt_tpu/ops/pallas_wavefront_grad.py:307")):
        row = wf_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"rt_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": wf_launches[name],
            "max_abs_err": wf_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            **{k: row[k] for k in ("bounce0_ms", "bounces_1_7_ms") if k in row},
        })
    for name, source, replaces in (
            ("render_record_kernel", "render_kernel", "rt_tpu/ops/pallas_render.py:686"),
            ("blockwise_record_kernel", "blockwise_kernel", "rt_tpu/ops/pallas_blockwise.py:1565"),
            ("fma_peak_kernel", "fma_peak_kernel", "tools/roofline.py:37")):
        row = rec_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"rt_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": rec_launches[name],
            "max_abs_err": rec_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
