"""BASELINE config 5's whole frame (port of ``tools/render_4k.py``):
3840x2160 at 256 spp, depth 8, over the 5000-sphere procedural scene,
through the wavefront route
(:func:`rt_tpu_torch.ops.wavefront.render_forward_wavefront`).

Usage::

    python -m rt_tpu_torch.render_4k [--spp 256] [--spp-chunk 8]
        [--size 3840x2160] [--out PATH] [--device cuda]

It prints the samples each chunk really takes (``--spp-chunk`` is capped
at 2^25 rays a chunk: 4 samples at 3840x2160, the JAX package's cap, which
fixes the chunks' seeds), the wall time with Mrays/s, and on the card the
peak device memory; then it writes the frame at half resolution
(``arr[::2, ::2]``) as a PNG to ``--out``, by default
``rt_tpu_torch_config5_4k.png`` in the temporary directory (``$TMPDIR``,
else ``/tmp``).  Before rendering on the card it
refuses, with an error, a chunk whose state would not fit in the card's
free memory; the chunk size itself never depends on the memory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

__all__ = ["main", "chunk_bytes", "default_out"]

SPHERES = 5000
MAX_BOUNCES = 8


def default_out() -> str:
    """``--out``'s default: a file in the temporary directory, read when
    called, so each environment's ``$TMPDIR`` is honoured."""
    return os.path.join(tempfile.gettempdir(), "rt_tpu_torch_config5_4k.png")


def chunk_bytes(n_rays: int) -> int:
    """Device bytes a wavefront chunk of ``n_rays`` rays needs at its peak,
    an estimate from ``render_forward_wavefront``'s tensors at a compaction
    sort: the (13, N) float32 state and int32 ids (56 B a ray) beside
    their sorted copies (56 B), the int32 key, its sorted copy and the
    int64 permutation (16 B), and the key's temporaries and the sort's
    scratch (32 B at most)."""
    return n_rays * (56 + 56 + 16 + 32)


def _check_fits(n_rays: int, dev) -> None:
    import torch

    free, total = torch.cuda.mem_get_info(dev)
    need = chunk_bytes(n_rays)
    if need > free:
        raise MemoryError(f"a wavefront chunk of {n_rays} rays needs about {need / 2**30:.2f} "
                          f"GiB of device memory; {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
                          "are free")


def main(argv=None):
    """Render the frame, print its numbers, write the preview PNG.
    Returns the (H, W, 3) frame on the device."""
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.render_4k",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--spp-chunk", type=int, default=8)
    ap.add_argument("--size", default="3840x2160")
    ap.add_argument("--out", default=default_out())
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernel's plain version)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import rt_tpu_torch
    from rt_tpu_torch.ops.render import _device
    from rt_tpu_torch.ops.wavefront import _library, _resolve_chunk, render_forward_wavefront

    dev = _device(args.device)
    w, h = (int(v) for v in args.size.lower().split("x"))
    scene = rt_tpu_torch.scene.make_procedural_scene(SPHERES)
    chunk = _resolve_chunk((w, h), args.spp, args.spp_chunk)
    n_chunks = -(-args.spp // chunk)
    print(f"{w}x{h} @{args.spp}spp d{MAX_BOUNCES}, {SPHERES} spheres: {chunk} samples a chunk "
          f"(--spp-chunk {args.spp_chunk}), {n_chunks} chunks of up to {w * h * chunk} rays",
          flush=True)
    if dev.type == "cuda":
        _check_fits(w * h * chunk, dev)
        t0 = time.perf_counter()
        _library()  # the kernel's build (or its cached library), outside the timed frame
        print(f"wavefront kernel ready in {time.perf_counter() - t0:.2f} s", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    img = render_forward_wavefront(scene, (w, h), seed=0, spp=args.spp, spp_chunk=args.spp_chunk,
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
