"""BASELINE config 5's whole frame (port of ``tools/render_4k.py``):
3840x2160 at 256 spp, depth 8, over the 5000-sphere procedural scene,
through the route that ``mg_auto`` takes for it
(:func:`rt_tpu_torch.renderer.auto_route`: the blockwise kernel,
:func:`rt_tpu_torch.ops.blockwise.render_forward_blockwise`).  The JAX
tool renders through the wavefront route; at 3840x2160 both routes take 4
samples a chunk and draw the same frame, which the blockwise route renders
about 3 times faster on an H100 in a fifth of the device memory.

Usage::

    python -m rt_tpu_torch.render_4k [--spp 256] [--size 3840x2160]
        [--out PATH] [--device cuda]

It prints the route, the samples each chunk takes (4, the JAX entry
points' ``spp_unroll``, which fixes the chunks' seeds), the wall time with
Mrays/s, and on the card the peak device memory; then it writes the frame
at half resolution (``arr[::2, ::2]``) as a PNG to ``--out``, by default
``rt_tpu_torch_config5_4k.png`` in the temporary directory (``$TMPDIR``,
else ``/tmp``).  Before rendering on the card it refuses, with an error, a
frame whose sums would not fit in the card's free memory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

__all__ = ["main", "frame_bytes", "default_out"]

SPHERES = 5000
MAX_BOUNCES = 8


def default_out() -> str:
    """``--out``'s default: a file in the temporary directory, read when
    called, so each environment's ``$TMPDIR`` is honoured."""
    return os.path.join(tempfile.gettempdir(), "rt_tpu_torch_config5_4k.png")


def frame_bytes(n_pixels: int) -> int:
    """Device bytes the blockwise frame of ``n_pixels`` pixels needs at its
    peak, an estimate from ``render_forward_blockwise``'s float32 RGB
    tensors (12 B a pixel each): a chunk's sum, the running sum and their
    new sum, and the frame scaled and gamma-corrected (two more)."""
    return n_pixels * 12 * 5


def _check_fits(n_pixels: int, dev) -> None:
    import torch

    free, total = torch.cuda.mem_get_info(dev)
    need = frame_bytes(n_pixels)
    if need > free:
        raise MemoryError(f"a frame of {n_pixels} pixels needs about {need / 2**30:.2f} GiB of "
                          f"device memory; {free / 2**30:.2f} of {total / 2**30:.2f} GiB are "
                          "free")


def main(argv=None):
    """Render the frame, print its numbers, write the preview PNG.
    Returns the (H, W, 3) frame on the device."""
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.render_4k",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--size", default="3840x2160")
    ap.add_argument("--out", default=default_out())
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernel's plain version)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import rt_tpu_torch
    from rt_tpu_torch.ops.blockwise import _kernel
    from rt_tpu_torch.ops.render import _SPP_CHUNK
    from rt_tpu_torch.ops.tables import _device

    dev = _device(args.device)
    w, h = (int(v) for v in args.size.lower().split("x"))
    scene = rt_tpu_torch.scene.make_procedural_scene(SPHERES)
    route = rt_tpu_torch.renderer.auto_route(scene, dev.type)
    chunk = min(_SPP_CHUNK, args.spp)
    n_chunks = -(-args.spp // chunk)
    print(f"{w}x{h} @{args.spp}spp d{MAX_BOUNCES}, {SPHERES} spheres: the {route} route, "
          f"{chunk} samples a chunk, {n_chunks} chunks of up to {w * h * chunk} rays",
          flush=True)
    if dev.type == "cuda":
        _check_fits(w * h, dev)
        t0 = time.perf_counter()
        _kernel()  # the kernel's build (or its cached library), outside the timed frame
        print(f"{route} kernel ready in {time.perf_counter() - t0:.2f} s", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    img = rt_tpu_torch.renderer.create("mg_auto")(scene, (w, h), seed=0, spp=args.spp,
                                                  max_bounces=MAX_BOUNCES, device=dev)
    arr = img.cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    rays = w * h * args.spp
    peak = (f", peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
            if dev.type == "cuda" else "")
    print(f"{w}x{h} @{args.spp}spp d{MAX_BOUNCES}: {dt:.3f} s wall "
          f"({rays / dt / 1e6:.2f} Mrays/s){peak}",
          flush=True)
    rt_tpu_torch.image.write_png(args.out, np.ascontiguousarray(arr[::2, ::2]))
    print(f"wrote {args.out}", flush=True)
    return img


if __name__ == "__main__":
    main()
