"""Kernels of the port and their plain PyTorch versions.

Ported so far: the forward megakernel (``render``), the fused
forward+backward MSE step (``grad``, two kernels), and the blockwise route
for scenes of up to 16384 primitives (``blockwise``, the forward kernel
with runtime tables; ``blockwise_grad``, its fused fwd+bwd kernel and the
optimizer step); the other TPU kernels of ``rt_tpu.ops`` are listed in
ROADMAP.md, queue 2.
"""

from .blockwise import MAX_BLOCKWISE_PRIMS, blockwise_supported, render_forward_blockwise
from .blockwise_grad import (bw_grad_supported, bw_mse_loss_and_grad, make_bw_mse_step,
                             make_bw_train_step)
from .grad import make_mse_step, mse_loss_and_grad
from .render import MAX_UNROLL_PRIMS, make_render_step, render_forward, supported

__all__ = ["MAX_BLOCKWISE_PRIMS", "MAX_UNROLL_PRIMS", "blockwise_supported",
           "bw_grad_supported", "bw_mse_loss_and_grad", "make_bw_mse_step",
           "make_bw_train_step", "make_mse_step", "make_render_step", "mse_loss_and_grad",
           "render_forward", "render_forward_blockwise", "supported"]
