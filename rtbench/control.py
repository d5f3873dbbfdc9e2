"""The control of the check, and the faults it must catch, at a cell's own
size: the reference put in the program's place, judged by the same check.

* ``control``: computed in the nearest precision below the configuration's
  (bfloat16 for its float32);
* ``half_batch``: half of the samples left out, the mean taken over the
  rest;
* ``altered``: the answer altered where it is produced (a frame times
  1.01; the albedo gradient times 1.5);
* ``unchanged``: a unit that returns its state unchanged (every frame the
  first one; steps that never update the parameter).

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
from .drive import GENERATORS

ROOT = core.ROOT


FAULTS = ("control", "half_batch", "altered", "unchanged")


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
    parameter after them."""
    dtype = torch.bfloat16 if fault == "control" else torch.float32
    spp = max(1, gen.spp // 2) if fault == "half_batch" else gen.spp
    tr = gen.traffic
    m = gen.arrays["albedo"].shape[0]
    gen.target = inputs.target_image(gen.size, gen.seed, gen.device, tuple(tr["target_cells"]))
    gen.p0 = torch.full((m, 4), tr["init"], dtype=torch.float32)
    p = gen.p0.double().to(gen.device)
    mo, vo = torch.zeros_like(p), torch.zeros_like(p)
    gen.check_seeds, gen.losses = [], []
    for k in range(tr["check"]["steps"]):
        seed = gen.take_seed()
        gen.check_seeds.append(seed)
        tab = R.Tables(gen.arrays, gen.device, dtype, albedo=p.float().cpu().numpy())
        loss, grad = R.loss_and_grad(tab, gen.cam(), gen.size, spp, gen.depth,
                                     R.STEP_PLANS[plan](seed, spp, gen.n_pix), gen.target)
        g = torch.zeros_like(p)
        g[:, :3] = grad * (1.5 if fault == "altered" else 1.0)
        if k == 0:
            gen.g1 = (g * (fault != "unchanged")).float().cpu()
        gen.losses.append(loss)
        if fault != "unchanged":
            R.adam_update(p, g, mo, vo, k + 1, tr["lr"])
    gen.p_after = p.float().cpu()


def control_checks(cell_name: str, seed: int, *, root: Path = ROOT, device="cuda",
                   fault: str = "control", plan: str = "per_sample") -> list:
    """``[(name, value, limit)]`` of the stand-in ``fault`` at ``seed``."""
    bench = core.load_benchmark(root)
    cell = core.find(bench["workloads"], cell_name, "workload")
    config = core.load_config(root, core.find(bench["configs"], cell["config"], "configuration"))
    traffic = core.load_traffic(root, cell["traffic"])
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
