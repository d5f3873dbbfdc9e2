"""The control of the check, and the faults it must catch, at a cell's own
size: the reference put in the program's place, judged by the same check.

* ``control``: computed in the nearest precision below the configuration's
  (bfloat16 for its float32);
* ``half_batch``: half of the samples left out, the mean taken over the
  rest;
* ``altered``: the answer altered where it is produced (a frame times
  1.01; the albedo gradient times 1.5);
* ``unchanged``: a unit that returns its state unchanged (every frame the
  first one; steps that never update the parameter);
* ``drop_rank`` (a cell of several ranks): the last rank's sums left out
  of the exchange, so that its pixels are missing from the gradient;
* ``no_exchange`` (a cell of several ranks): no exchange at all, each
  rank's replica stepping on its own pixels' gradient (the check reads
  rank 0's replica, and how far the others' parameters lie from it).

Their numbers set the upper reading of each limit.  The benchmark's runs
do not run this::

    python3 -m rtbench.control --workload <cell> --seeds 1,2,3 [--fault control]
                               [--plan per_sample]

prints one JSON line a seed: each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import core, inputs
from . import reference as R
from .drive import GENERATORS, shard_pixels

ROOT = core.ROOT


FAULTS = ("control", "half_batch", "altered", "unchanged", "drop_rank", "no_exchange")


def _frames_fault(gen, fault):
    """The kept frames of a window as the faulty stand-in renders them, at
    the pixels the check reads."""
    k = gen.traffic["check"]["frames"]
    tab = R.Tables(gen.arrays, gen.device, torch.bfloat16 if fault == "control" else
                   torch.float32)
    cam = gen.cam()
    n = gen.traffic["check"]["pixels"]
    spp = max(1, gen.spp // 2) if fault == "half_batch" else gen.spp
    gen.kept = []
    first = None
    for i in range(k):
        seed = gen.take_seed()
        first = seed if first is None else first
        pix = inputs.pixel_sample(gen.n_pix, n, gen.seed * 131 + i).to(gen.device)
        img = torch.zeros((gen.n_pix, 3), dtype=torch.float32, device=gen.device)
        img[pix] = R.frame_pixels(tab, cam, gen.size, spp, gen.depth,
                                  first if fault == "unchanged" else seed, pix).float()
        if fault == "altered":
            img *= 1.01
        gen.kept.append((i, seed, img))


def _steps_fault(gen, fault, plan):
    """The first steps of the job as the faulty stand-in takes them
    (float64 Adam on its gradients): the losses, the first gradient and the
    parameter after them; for ``no_exchange`` those of rank 0's replica,
    and the widest gap between a replica's parameter and rank 0's."""
    tr = gen.traffic
    ranks = tr.get("ranks", 1)
    if fault in ("drop_rank", "no_exchange") and ranks < 2:
        raise ValueError(f"{fault} needs a cell of several ranks")
    band = shard_pixels(gen.n_pix, ranks, 0)[1]
    m = gen.arrays["albedo"].shape[0]
    gen.target = inputs.target_image(gen.size, gen.seed, gen.device, tuple(tr["target_cells"]))
    gen.p0 = torch.full((m, 4), tr["init"], dtype=torch.float32)
    gen.check_seeds = [gen.take_seed() for _ in range(tr["check"]["steps"])]
    if fault == "drop_rank":
        pixels = [(0, (ranks - 1) * band)]
    elif fault == "no_exchange":   # each rank steps on its own band's sums
        pixels = [(r * band, band) for r in range(ranks)]
    else:
        pixels = [None]
    replicas = [_replica(gen, fault, plan, px) for px in pixels]
    gen.losses, gen.g1, gen.p_after = replicas[0]
    gen.replica_gap = max(float((p - gen.p_after).abs().max()) for _, _, p in replicas)


def _replica(gen, fault, plan, grad_pixels):
    """``(losses, first gradient, parameter after)`` of one replica of the
    stand-in, its gradient taken on ``grad_pixels`` (None: every pixel)."""
    dtype = torch.bfloat16 if fault == "control" else torch.float32
    spp = max(1, gen.spp // 2) if fault == "half_batch" else gen.spp
    p = gen.p0.double().to(gen.device)
    mo, vo = torch.zeros_like(p), torch.zeros_like(p)
    losses, g1 = [], None
    for k, seed in enumerate(gen.check_seeds):
        tab = R.Tables(gen.arrays, gen.device, dtype, albedo=p.float().cpu().numpy())
        loss, grad = R.loss_and_grad(tab, gen.cam(), gen.size, spp, gen.depth,
                                     R.STEP_PLANS[plan](seed, spp, gen.n_pix), gen.target,
                                     grad_pixels=grad_pixels)
        g = torch.zeros_like(p)
        g[:, :3] = grad * (1.5 if fault == "altered" else 1.0)
        if k == 0:
            g1 = (g * (fault != "unchanged")).float().cpu()
        losses.append(loss)
        if fault != "unchanged":
            R.adam_update(p, g, mo, vo, k + 1, gen.traffic["lr"])
    return losses, g1, p.float().cpu()


def control_checks(cell_name: str, seed: int, *, root: Path = ROOT, device="cuda",
                   fault: str = "control", plan: str = "per_sample") -> list:
    """``[(name, value, limit)]`` of the stand-in ``fault`` at ``seed``."""
    _, _, config, traffic = core.load_cell(root, cell_name)
    limits = core.load_limits(root, cell_name)
    gen = GENERATORS[traffic["kind"]](config, traffic, seed, torch.device(device))
    if traffic["kind"] == "frames":
        _frames_fault(gen, fault)
    else:
        _steps_fault(gen, fault, plan)
    return [(name, value, limits[name]) for name, value in gen.check()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--plan", default="per_sample", choices=sorted(R.STEP_PLANS),
                    help="the draws of the control's steps (a training cell's route)")
    ap.add_argument("--fault", default="control", choices=FAULTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control_checks(args.workload, seed, fault=args.fault, plan=args.plan)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "seconds": time.perf_counter() - t0,
                          "correct": all(v <= lim for _, v, lim in checks),
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
