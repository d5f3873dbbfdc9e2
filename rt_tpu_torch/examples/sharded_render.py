"""Sharded rendering demo: path-trace one frame over a mesh of ranks (port
of ``examples/sharded_render.py``).

Shards the camera rays over the 'rays' axis of a
:mod:`rt_tpu_torch.dist` mesh (and, with ``--prims``, the sphere table over
'prims'); the reference's only parallelism is a thread pool over pixels
(mg_ray_tracer.cpp:203-204).  Each rank is a process of its own, started
here (``dist.run_local``); the gathered frame is the single-device one bit
for bit, because the draws are keyed by the global ray-chunk index.

Usage (from the repository root; the script also runs by its path)::

    python -m rt_tpu_torch.examples.sharded_render                # one rank per card
    python -m rt_tpu_torch.examples.sharded_render --virtual 4    # 4 ranks on the CPU

prints ``sharded == single-device: True`` and writes ``--out``.
"""

from __future__ import annotations

import argparse
import os
import sys

if not __package__:  # run as a script: the ranks import the package from the checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))))

__all__ = ["main"]

# bit-identity holds when both renders use the same ray_chunk (the draws
# are keyed by the global chunk index)
CHUNK = 1024


def _rank(scene_path: str, size, spp: int, n_prims: int, device: str):
    """One rank: the sharded frame and the single-device one, on the CPU."""
    import torch
    import torch.distributed as tdist

    import rt_tpu_torch as rt
    from rt_tpu_torch import dist

    scene = rt.load(scene_path)
    key = rt.rng.make_key(0)
    mesh = dist.make_mesh(tdist.get_world_size() // n_prims, n_prims)
    img = dist.render_image_sharded(scene, size, key, mesh, spp=spp, ray_chunk=CHUNK,
                                    device=device)
    single = rt.integrator.render_image(scene, size, key, spp=spp, ray_chunk=CHUNK,
                                        device=device)
    return img.cpu(), bool(torch.equal(img, single))


def main(argv=None) -> bool:
    """Run the demo; returns whether the sharded frame equals the
    single-device one."""
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.examples.sharded_render")
    ap.add_argument("--virtual", type=int, default=0,
                    help="N ranks on the CPU (Gloo) instead of one rank per card")
    ap.add_argument("--scene", default="scenes/basic.toml")
    ap.add_argument("--size", default="400x300")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--prims", type=int, default=1,
                    help="shard the sphere table this many ways ('prims' axis)")
    ap.add_argument("--out", default="sharded.png")
    args = ap.parse_args(argv)

    import torch

    import rt_tpu_torch as rt
    from rt_tpu_torch import dist

    device = "cpu" if args.virtual else "cuda"
    n = args.virtual or torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no card: pass --virtual N for N ranks on the CPU")
    print(f"mesh: {n} ranks as rays={n // args.prims} x prims={args.prims} on {device}")
    w, h = (int(v) for v in args.size.lower().split("x"))
    res = dist.run_local(_rank, n, args.scene, (w, h), args.spp, args.prims, device,
                         device=device, timeout=None, threads=1 if args.virtual else None)
    equal = all(ok for _, ok in res)
    print("sharded == single-device:", equal)
    rt.image.write_png(args.out, res[0][0])
    print("wrote", args.out)
    return equal


if __name__ == "__main__":
    main()
