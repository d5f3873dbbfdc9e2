"""Kernels of the port and their plain PyTorch versions.

Only the forward megakernel (``render``) is ported so far; the other TPU
kernels of ``rt_tpu.ops`` are listed in ROADMAP.md, queue 2.
"""

from .render import MAX_UNROLL_PRIMS, make_render_step, render_forward, supported

__all__ = ["MAX_UNROLL_PRIMS", "make_render_step", "render_forward", "supported"]
