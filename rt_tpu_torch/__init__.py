"""rt_tpu_torch — the PyTorch/CUDA port of rt_tpu.

The JAX package ``rt_tpu`` stays the reference; this package re-implements
it module by module for an NVIDIA H100, with every TPU kernel on a ported
path replaced by a hand-written CUDA kernel (built with nvcc at first use).
Module names follow ``rt_tpu`` so each counterpart is easy to find.

Ported so far (the forward render path, from TOML scene to PNG, the
fused training step, and the blockwise and wavefront routes for scenes of
up to 16384 primitives):
  log, colour, camera, scene, materials (class table), image,
  ops.render (the forward megakernel), diff (parameter plumbing),
  ops.grad (the fused fwd+bwd MSE step and its two kernels),
  ops.blockwise and ops.blockwise_grad (the blockwise forward and fused
  fwd+bwd kernels, and the optimizer step), ops.wavefront and
  ops.wavefront_grad (the bounce-major forward kernel, its scan-free
  reverse, and the optimizer step), train (make_kernel_train_step),
  profiling, renderer, cli.

Importing this package needs neither CUDA nor JAX.
"""

from . import camera, colour, diff, image, log, materials, ops, profiling, renderer, scene, train
from .scene import Scene, from_jax_scene, load, load_first_available, loads

__version__ = "0.1.0"

__all__ = [
    "camera",
    "colour",
    "diff",
    "image",
    "log",
    "materials",
    "ops",
    "profiling",
    "renderer",
    "scene",
    "train",
    "Scene",
    "from_jax_scene",
    "load",
    "load_first_available",
    "loads",
    "__version__",
]
