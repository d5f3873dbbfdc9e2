"""Big-scene inverse rendering: optimize the albedos of a procedural
N-sphere scene with the fused forward+backward kernels (port of
``examples/big_scene_training.py``).

The blockwise pipeline rebuilds the primitive tables from the parameters
on the device every step, so a whole Adam loop runs at kernel speed.
:func:`rt_tpu_torch.train.make_kernel_train_step` builds the blockwise
step for every scene up to the kernels' 16384 primitives (the JAX package
takes its wavefront record/reverse step from 1024 padded sphere rows, which
an H100 runs slower).

Usage::

    python -m rt_tpu_torch.examples.big_scene_training --spheres 500
    python -m rt_tpu_torch.examples.big_scene_training --device cpu --spheres 24
"""

from __future__ import annotations

import argparse
import time

__all__ = ["main"]


def main(argv=None) -> dict:
    """Run the loop; returns ``{"losses": [...], "ms_per_step": ms,
    "mae": (held-out MAE at the start, after the loop)}``."""
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.examples.big_scene_training")
    ap.add_argument("--spheres", type=int, default=500)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--size", default=None, help="WxH (default 400x300; 96x64 on the CPU)")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions: "
                         "use a small --spheres)")
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    import rt_tpu_torch
    from rt_tpu_torch.ops.blockwise import render_forward_blockwise
    from rt_tpu_torch.ops.tables import _device
    from rt_tpu_torch.train import make_kernel_train_step

    dev = _device(args.device)
    if args.size:
        w, h = (int(x) for x in args.size.split("x"))
    else:
        w, h = (96, 64) if dev.type == "cpu" else (400, 300)

    scene = rt_tpu_torch.scene.make_procedural_scene(args.spheres)
    true_albedo = scene.materials.albedo

    def render_with(albedo, seed):
        # gamma=False: every gradient pipeline optimizes PRE-gamma radiance
        # (rt_tpu_torch.diff: sqrt gamma has an infinite derivative at 0),
        # so the target and the held-out frames are pre-gamma too
        sc = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                      albedo=albedo))
        return render_forward_blockwise(sc, (w, h), seed=seed, spp=args.spp, max_bounces=4,
                                        gamma=False, device=dev)

    # target = render with the true albedos; start from gray
    target = render_with(true_albedo, seed=0)
    params = {"materials.albedo": torch.full_like(true_albedo, 0.5).to(dev)}
    optimizer = torch.optim.Adam(list(params.values()), lr=5e-2)
    step = make_kernel_train_step(optimizer, scene, target, (w, h), spp=args.spp, max_bounces=4,
                                  device=dev)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = step(params, i)
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
    losses = [float(v) for v in losses]  # waits for the device
    dt = (time.perf_counter() - t0) / args.steps
    # the inverse problem is under-constrained at demo sizes (some of the
    # 12 materials barely appear in the image), so albedo recovery is not
    # the right success metric: image-space error against a held-out
    # render (a fresh seed) is what the loss optimizes
    holdout = render_with(true_albedo, seed=12345)
    e0 = float((render_with(torch.full_like(true_albedo, 0.5), seed=12345) - holdout).abs().mean())
    e1 = float((render_with(params["materials.albedo"].detach(), seed=12345)
                - holdout).abs().mean())
    print(f"{dt * 1e3:.1f} ms/step; held-out image MAE {e0:.4f} -> {e1:.4f}")
    return {"losses": losses, "ms_per_step": dt * 1e3, "mae": (e0, e1)}


if __name__ == "__main__":
    main()
