"""Kernels of the port and their plain PyTorch versions.

Ported so far: the forward megakernel (``render``) and the fused
forward+backward MSE step (``grad``, two kernels); the other TPU kernels of
``rt_tpu.ops`` are listed in ROADMAP.md, queue 2.
"""

from .grad import make_mse_step, mse_loss_and_grad
from .render import MAX_UNROLL_PRIMS, make_render_step, render_forward, supported

__all__ = ["MAX_UNROLL_PRIMS", "make_mse_step", "make_render_step", "mse_loss_and_grad",
           "render_forward", "supported"]
