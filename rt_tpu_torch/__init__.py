"""rt_tpu_torch — the PyTorch/CUDA port of rt_tpu.

The JAX package ``rt_tpu`` stays the reference; this package re-implements
it module by module for an NVIDIA H100, with every TPU kernel on a ported
path replaced by a hand-written CUDA kernel (built with nvcc at first use).
Module names follow ``rt_tpu`` so each counterpart is easy to find.

Ported so far (the forward render path, from TOML scene to PNG):
  log, colour, camera, scene, materials (class table), image,
  ops.render (the forward megakernel), profiling, renderer, cli.

Importing this package needs neither CUDA nor JAX.
"""

from . import camera, colour, image, log, materials, ops, profiling, renderer, scene
from .scene import Scene, from_jax_scene, load, load_first_available, loads

__version__ = "0.1.0"

__all__ = [
    "camera",
    "colour",
    "image",
    "log",
    "materials",
    "ops",
    "profiling",
    "renderer",
    "scene",
    "Scene",
    "from_jax_scene",
    "load",
    "load_first_available",
    "loads",
    "__version__",
]
