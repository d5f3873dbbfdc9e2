"""Kernels of the port and their plain PyTorch versions.

Every TPU kernel of ``rt_tpu.ops`` has its counterpart here: the forward
megakernel and its record form (``render``), the fused forward+backward
MSE step (``grad``, two kernels), the blockwise route for scenes of up to
16384 primitives (``blockwise``, the forward kernel with runtime tables and
its record form; ``blockwise_grad``, its fused fwd+bwd kernel and the
optimizer step), and the wavefront route for the same scenes
(``wavefront``, the bounce-major forward kernel; ``wavefront_grad``, its
scan-free reverse and the optimizer step).  ``intersect`` holds the ray
helpers the replay needs.  ROADMAP.md, queue 2, maps each kernel to its
TPU original.
"""

from .blockwise import (MAX_BLOCKWISE_PRIMS, blockwise_supported, render_forward_blockwise,
                        render_record_blockwise)
from .blockwise_grad import (bw_grad_supported, bw_mse_loss_and_grad, make_bw_mse_step,
                             make_bw_train_step)
from .grad import make_mse_step, mse_loss_and_grad
from .render import (MAX_UNROLL_PRIMS, make_render_step, records_to_flat, render_forward,
                     render_record, supported)
from .wavefront import render_forward_wavefront, wavefront_supported
from .wavefront_grad import (make_wf_mse_step, make_wf_train_step, wf_grad_supported,
                             wf_mse_loss_and_grad)

__all__ = ["MAX_BLOCKWISE_PRIMS", "MAX_UNROLL_PRIMS", "blockwise_supported",
           "bw_grad_supported", "bw_mse_loss_and_grad", "make_bw_mse_step",
           "make_bw_train_step", "make_mse_step", "make_render_step", "make_wf_mse_step",
           "make_wf_train_step", "mse_loss_and_grad", "records_to_flat", "render_forward",
           "render_forward_blockwise", "render_forward_wavefront", "render_record",
           "render_record_blockwise", "supported",
           "wavefront_supported", "wf_grad_supported", "wf_mse_loss_and_grad"]
