"""The port's headline on the card (port of ``bench.py``).

Run on a machine with a CUDA card, from the repository root::

    python -m rt_tpu_torch.bench            # basic.toml 800x600, 4 spp, depth 8
    python -m rt_tpu_torch.bench --quick    # 160x120, 2 spp, depth 4, one call a window
    python -m rt_tpu_torch.bench --scaling  # the mesh-size ladder, one row a size

It prints the card's name and power limit (as nvidia-smi gives them) on a
line of its own, then ``bench.py``'s JSON line, with its keys and
roundings: the forward+backward rate of the training step in Mrays/s
(W*H*spp camera rays a step), ``grad_ok`` in the metric's text,
``vs_baseline`` against the native CPU tracer on the card's host,
``spread`` over the timed windows, and, except under ``--quick``, the
same-shape forward's rate ``fwd_ref`` and ``ratio_step_over_fwd``.

* The step is :func:`rt_tpu_torch.ops.grad.make_mse_step` (the mono
  kernel, one launch a step) wherever ``grad_supported`` takes the scene,
  else the jnp autodiff step (:func:`rt_tpu_torch.diff.loss_and_grad`),
  as ``bench.py`` chooses; it is timed by
  :func:`rt_tpu_torch.profiling.sustained` (CUDA events, the median of 9
  windows of ``--iters`` calls).
* ``fwd_ref`` and the ratio come from one
  :func:`rt_tpu_torch.profiling.interleaved` call of the step and
  :func:`rt_tpu_torch.ops.render.make_render_step` (alternating windows).
* ``grad_ok``: every gradient finite and, except under ``--quick``, a
  central finite difference of the loss in ``materials.reflectivity[0]``
  at 200x150, 2 spp, depth 4, seed 17 within 2e-2 of the analytic one.
* The baseline is :func:`rt_tpu_torch._native.render_cpu` at the timed
  shape, cached per host CPU in ``rt_tpu_torch/_build/`` with the bench
  table's baselines; where it cannot be built the tool raises.

Unlike ``bench.py`` it falls back to nothing: a failure of the kernel step
or of the ``fwd_ref`` block raises, and no ``vs_baseline`` of 0.0 is
printed.  The scene is the repository's ``scenes/basic.toml``.  Without
CUDA the tool raises: it times nothing on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from . import diff, dist, profiling, rng
from .bench_table import NATIVE_CACHE, native_mrays
from .roofline import _card_line
from .scene import load

__all__ = ["grad_check", "native_baseline", "scaling", "main"]

SCENE = Path(__file__).resolve().parent.parent / "scenes" / "basic.toml"
# bench.py:151-158: (size, spp, depth) of the default and --quick runs
FULL = ((800, 600), 4, 8)
QUICK = ((160, 120), 2, 4)
WINDOWS = 9  # the timed step's windows (1 under --quick) and the fwd_ref round-robin's
# bench.py:265-294: the gradient check
FD_PARAM = "materials.reflectivity"
FD_EPS = 1e-3
FD_SIZE = (200, 150)
FD_SPP, FD_DEPTH, FD_SEED = 2, 4, 17
FD_RTOL, FD_ATOL = 2e-2, 1e-4
# bench.py:61-112: the --scaling ladder
SCALING_SIZE = (512, 384)
SCALING_DEPTH = 8
SCALING_CHUNK = 4096
SCALING_FRAMES = 4
SCALING_NOTE = "virtual mesh (shared cores) — path check only"


def _step(scene, params, target, size, spp, depth, device):
    """``(step(i) -> (loss, grads), fused)``: the mono kernel step where the
    fused step takes the scene, else the jnp autodiff step with the key
    folded by ``i`` (bench.py:167-200)."""
    from .ops.grad import grad_supported, make_mse_step

    if grad_supported(scene):
        return make_mse_step(params, scene, target, size, spp=spp, max_bounces=depth,
                             device=device), True
    key = rng.make_key(0)

    def step(i):
        return diff.loss_and_grad(params, scene, target, size, rng.fold(key, i), spp=spp,
                                  max_bounces=depth, grad_mode="autodiff", device=device)

    return step, False


def grad_check(scene, params, fused: bool, *, size=FD_SIZE, device="cuda"):
    """bench.py's finite-difference check (bench.py:270-294): ``(ok,
    analytic, fd)`` for ``materials.reflectivity[0]``, a central difference
    with step 1e-3 of the MSE against a black frame at ``size``, 2 spp,
    depth 4; through the fused step's own loss at seed 17 where ``fused``,
    else through the jnp integrator's at key 0.  ``ok``: the two agree
    within max(2e-2 |fd|, 1e-4)."""
    from .ops.grad import mse_loss_and_grad

    w, h = size
    target = torch.zeros((h, w, 3), device=device)
    shifted = []
    for sign in (1, -1):
        p = dict(params)
        p[FD_PARAM] = params[FD_PARAM].clone()
        p[FD_PARAM][0] += sign * FD_EPS
        shifted.append(p)
    kw = dict(spp=FD_SPP, max_bounces=FD_DEPTH, device=device)
    if fused:
        _, grads = mse_loss_and_grad(params, scene, target, size, seed=FD_SEED, **kw)
        hi, lo = (float(mse_loss_and_grad(p, scene, target, size, seed=FD_SEED, **kw)[0])
                  for p in shifted)
    else:
        key = rng.make_key(0)
        hi, lo = (float(diff.image_loss(p, scene, target, size, key, **kw)) for p in shifted)
        _, grads = diff.loss_and_grad(params, scene, target, size, key, **kw)
    fd = (hi - lo) / (2 * FD_EPS)
    an = float(grads[FD_PARAM][0])
    return abs(an - fd) <= max(FD_RTOL * abs(fd), FD_ATOL), an, fd


def native_baseline(scene, size, spp: int, max_bounces: int, cache: Path = NATIVE_CACHE) -> float:
    """The native CPU tracer's Mrays/s at the timed shape and depth
    (bench.py:33-58: a 1-spp warm-up, then one timed frame), cached under
    bench.py's key ``WxHxSPPxDEPTH`` beside the bench table's baselines;
    raises where the library cannot be built."""
    tag = f"{size[0]}x{size[1]}x{spp}x{max_bounces}"
    return native_mrays(tag, scene, size, spp, "mg", max_bounces=max_bounces, cache=cache)


def _measure(scene, size, spp: int, depth: int, iters: int, quick: bool, *, sustained,
             interleaved, native, device="cuda", fd_size=FD_SIZE) -> dict:
    """bench.py's JSON line (bench.py:161-313) measured with the given
    clocks: ``sustained(step, iters=, windows=)`` and ``interleaved(steps,
    iters=, windows=)`` as :mod:`rt_tpu_torch.profiling` gives them
    (seconds a call), ``native(scene, size, spp, max_bounces)`` in Mrays/s."""
    from .ops.render import make_render_step

    w, h = size
    params = diff.extract_params(scene)
    target = torch.zeros((h, w, 3), device=device)
    step, fused = _step(scene, params, target, size, spp, depth, device)
    _, grads = step(0)

    def rate(seconds):
        return w * h * spp / seconds / 1e6

    stats = sustained(step, iters=iters, windows=1 if quick else WINDOWS)
    mrays = rate(stats["median"])

    # the forward at the step's shape, in the step's windows: the ratio of
    # two medians of one round-robin compares one state of the card
    fwd_ref = ratio = None
    if fused and not quick:
        fwd = make_render_step(scene, size, spp=spp, max_bounces=depth, device=device)
        s_stats, f_stats = interleaved([step, fwd], iters=iters, windows=WINDOWS)
        fwd_ref = rate(f_stats["median"])
        ratio = s_stats["median"] / f_stats["median"]

    grad_ok = all(torch.isfinite(g).all().item() for g in grads.values())
    if grad_ok and not quick:
        grad_ok = grad_check(scene, params, fused, size=fd_size, device=device)[0]

    vs_baseline = mrays / native(scene, size, spp, depth)
    row = {
        "metric": "fwd+bwd Mrays/s/chip (basic.toml %dx%d @ %dspp, depth %d, grad_ok=%s)"
                  % (w, h, spp, depth, grad_ok),
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(vs_baseline, 3),
        "spread": [round(rate(stats["max"]), 1), round(rate(stats["min"]), 1)],
    }
    if fwd_ref is not None:
        row["fwd_ref"] = round(fwd_ref, 1)
        row["ratio_step_over_fwd"] = round(ratio, 3)
    return row


# ---- --scaling: the mesh-size ladder ----

def _scaling_rank(size, spp: int, max_bounces: int, ray_chunk: int, frames: int, device: str):
    """One rank of a mesh size (the world is joined): one warm-up frame,
    then ``frames`` frames ended by a synchronize, forward only (no
    autograd graph, as bench.py's frames).  Returns (seconds a frame, the
    last frame on the CPU)."""
    import torch.distributed as tdist

    scene = load(str(SCENE))
    key = rng.make_key(0)
    mesh = dist.make_mesh(tdist.get_world_size(), 1)
    cuda = torch.device(device).type == "cuda"

    @torch.no_grad()
    def render():
        return dist.render_image_sharded(scene, size, key, mesh, spp=spp,
                                         max_bounces=max_bounces, ray_chunk=ray_chunk,
                                         device=device)

    out = render()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        out = render()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / frames, out.cpu()


def scaling(top: int, *, spp: int = 4, device="cuda", size=SCALING_SIZE,
            max_bounces: int = SCALING_DEPTH, ray_chunk: int = SCALING_CHUNK,
            frames: int = SCALING_FRAMES) -> list:
    """bench.py's ladder (bench.py:61-112): for n = 1, 2, 4, ... up to
    ``top``, a world of n local ranks (:func:`rt_tpu_torch.dist.run_local`:
    NCCL where each rank has a card, Gloo on the CPU or where ranks share
    one) renders the sharded frame on a (n, 1) mesh.  Returns one
    ``(row, seconds, frames)`` a mesh size: bench.py's JSON row (the rate
    from the slowest rank's seconds a frame; ``vs_baseline`` the rate over
    n times the 1-rank rate; the note where the ranks are not one a card),
    each rank's seconds a frame and each rank's last frame."""
    cpu = torch.device(device).type != "cuda"
    out, base, n = [], None, 1
    while n <= top:
        res = dist.run_local(_scaling_rank, n, size, spp, max_bounces, ray_chunk, frames,
                             str(device), device=device, timeout=None,
                             threads=1 if cpu else None)
        rate = size[0] * size[1] * spp / max(s for s, _ in res) / 1e6
        base = rate if base is None else base
        row = {"metric": f"scaling rays/s ({n} devices)", "value": round(rate, 2),
               "unit": "Mrays/s", "vs_baseline": round(rate / (base * n), 3)}
        if cpu or n > torch.cuda.device_count():
            row["note"] = SCALING_NOTE
        out.append((row, [t for t, _ in res], [f for _, f in res]))
        n *= 2
    return out


def _shapes(args):
    """(size, spp, depth, iters) of a run (bench.py:151-158)."""
    size, spp, depth = QUICK if args.quick else FULL
    iters = 1 if args.quick else args.iters
    if args.size:
        w, h = args.size.split("x")
        size = (int(w), int(h))
    return size, args.spp or spp, depth, iters


def _parser() -> argparse.ArgumentParser:
    """bench.py's flags, with its defaults (bench.py:115-130)."""
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="tiny smoke run")
    ap.add_argument("--size", default=None, help="WxH override")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--scaling", action="store_true",
                    help="mesh scaling-efficiency ladder instead of the headline fwd+bwd "
                         "benchmark")
    ap.add_argument("--iters", type=int, default=32,
                    help="steps per timed window; the metric is the median over 9 windows "
                         "(CUDA events), via rt_tpu_torch.profiling.sustained")
    return ap


def main(argv=None):
    """Measure on the card and print the card line, then bench.py's JSON
    line (or one row a mesh size under ``--scaling``).  Returns the row
    (the rows)."""
    args = _parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench times the CUDA device; none is available")
    print(_card_line(), flush=True)
    if args.scaling:
        rows = [row for row, _, _ in scaling(torch.cuda.device_count(), spp=args.spp or 4)]
        for row in rows:
            print(json.dumps(row), flush=True)
        return rows
    size, spp, depth, iters = _shapes(args)
    row = _measure(load(str(SCENE)), size, spp, depth, iters, args.quick,
                   sustained=profiling.sustained, interleaved=profiling.interleaved,
                   native=native_baseline, device="cuda")
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
