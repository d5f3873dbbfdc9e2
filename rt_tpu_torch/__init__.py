"""rt_tpu_torch — the PyTorch/CUDA port of rt_tpu.

The JAX package ``rt_tpu`` stays the reference; this package re-implements
it module by module for an NVIDIA H100, with every TPU kernel on a ported
path replaced by a hand-written CUDA kernel (built with nvcc at first use).
Module names follow ``rt_tpu`` so each counterpart is easy to find.

Ported so far (the forward render path, from TOML scene to PNG, the
fused training step, the blockwise and wavefront routes for scenes of up
to 16384 primitives, the records-and-replay gradient, and the jnp path:
the integrator, its gradients and the training loop):
  log, colour, camera, scene, materials (class table and scatter), image,
  rng (threefry keys and draws), ops.intersect (closest_hit),
  integrator (trace_batch, render_image, the rasterizer and null
  renderers), replay (trace_batch_recorded, replay_radiance,
  trace_batch_replay), diff (parameter plumbing, loss_and_grad and
  records_loss_and_grad), train (fit, make_train_step, checkpoints and
  make_kernel_train_step), ops.render (the forward megakernel and its
  record form), ops.grad (the fused fwd+bwd MSE step and its two kernels),
  ops.blockwise and ops.blockwise_grad (the blockwise forward and record
  kernels, the fused fwd+bwd kernel, and the optimizer step), ops.wavefront
  and ops.wavefront_grad (the bounce-major forward kernel, its scan-free
  reverse, and the optimizer step), roofline (the FMA peak probe; run as
  ``python -m rt_tpu_torch.roofline``, so not imported here), profiling,
  renderer, cli.

Importing this package needs neither CUDA nor JAX.
"""

from . import (camera, colour, diff, image, integrator, log, materials, ops, profiling, renderer,
               replay, rng, scene, train)
from .scene import Scene, from_jax_scene, load, load_first_available, loads

__version__ = "0.1.0"

__all__ = [
    "camera",
    "colour",
    "diff",
    "image",
    "integrator",
    "log",
    "materials",
    "ops",
    "profiling",
    "renderer",
    "replay",
    "rng",
    "scene",
    "train",
    "Scene",
    "from_jax_scene",
    "load",
    "load_first_available",
    "loads",
    "__version__",
]
