"""Multi-process check of :mod:`rt_tpu_torch.dist` (port of
``tools/mp_check.py``).

Starts N ranks, each a process of its own that joins the world by TCP on a
free local port (:func:`rt_tpu_torch.dist.run_local`: Gloo on the CPU and
where the ranks share a card, NCCL where each has one), builds a
('rays',) mesh over them, and checks on every rank:

* its slice of the sharded frame (:func:`rt_tpu_torch.dist.render_image_sharded`)
  is bit for bit the single-process :func:`rt_tpu_torch.integrator.render_image`,
  and so is the whole gathered frame;
* the MSE loss and the parameter gradients through the sharded renderer
  (the gathered frame's backward and the world's sum of the parameters'
  gradients) match the single-process :func:`rt_tpu_torch.diff.loss_and_grad`:
  the loss to rtol 1e-6, the gradients to atol 1e-5 and rtol 1e-4 (the JAX
  tool's tolerances).

Usage::

    python -m rt_tpu_torch.mp_check [--procs 2] [--device cuda] [--scene scenes/basic.toml]

prints ``mp_check OK`` and exits 0, or exits 1 naming the rank that failed.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main", "worker"]


def worker(scene_path: str, device: str) -> str:
    """One rank's checks (the world is joined); raises on a mismatch."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    import rt_tpu_torch as rt
    from rt_tpu_torch import diff, dist

    rank, n = tdist.get_rank(), tdist.get_world_size()
    s = rt.load(scene_path)
    size = (64, 32)
    key = rt.rng.make_key(5)
    kw = dict(ray_chunk=256, device=device)

    # 1) the sharded frame against the single-process one, bit for bit
    ref = rt.integrator.render_image(s, size, key, spp=2, max_bounces=3, **kw)
    mesh = dist.make_mesh(n, 1)
    img = dist.render_image_sharded(s, size, key, mesh, spp=2, max_bounces=3, **kw)
    n_pix = size[0] * size[1]
    per_rank = -(-n_pix // (256 * n)) * 256  # the rank's pixels: whole chunks of 256
    own = slice(rank * per_rank, min((rank + 1) * per_rank, n_pix))
    if not (torch.equal(img.reshape(-1, 3)[own], ref.reshape(-1, 3)[own])
            and torch.equal(img, ref)):
        raise AssertionError(f"rank {rank}: the sharded frame differs from the single-process one")
    print(f"[rank {rank}] render parity ok (pixels {own.start}..{own.stop - 1})", flush=True)

    # 2) loss and gradients through the sharded renderer
    params = diff.extract_params(s)
    target = torch.zeros((size[1], size[0], 3))
    opts = dict(spp=1, max_bounces=2, **kw)
    l_ref, g_ref = diff.loss_and_grad(params, s, target, size, key, **opts)
    l_sh, g_sh = diff.loss_and_grad(
        params, s, target, size, key,
        render_fn=lambda sc, sz, k, **o: dist.render_image_sharded(sc, sz, k, mesh, **o), **opts)
    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-6)
    for k in g_ref:
        np.testing.assert_allclose(g_sh[k].cpu().numpy(), g_ref[k].cpu().numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    print(f"[rank {rank}] summed gradients ok", flush=True)
    return "ok"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.mp_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2, help="ranks (processes) to start")
    ap.add_argument("--device", default="cuda", help="the ranks' device (cpu: Gloo on the CPU)")
    ap.add_argument("--scene", default="scenes/basic.toml")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds for the whole launch")
    args = ap.parse_args(argv)

    from rt_tpu_torch import dist

    try:
        dist.run_local(worker, args.procs, args.scene, args.device, device=args.device,
                       timeout=args.timeout, threads=1 if args.device == "cpu" else None)
    except (RuntimeError, TimeoutError) as ex:
        print(f"mp_check FAILED: {ex}", file=sys.stderr, flush=True)
        return 1
    print(f"mp_check OK: {args.procs} processes on {args.device}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
