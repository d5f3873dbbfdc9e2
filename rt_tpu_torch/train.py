"""Optimizer steps for inverse rendering (port of ``rt_tpu.train``).

Ported: :func:`make_kernel_train_step`, the router to the fused-kernel
optimizer steps (blockwise and wavefront).  Still to port: ``fit``,
``make_train_step`` and the checkpoints, which need ``diff.image_loss``
and so the pure-torch integrator (ROADMAP.md, queue 1).

The JAX package takes an optax optimizer and threads its state through
``step(params, opt_state, seed)``; here the optimizer is a ``torch.optim``
optimizer built over the parameter tensors, which keeps its own state, and
a step is ``step(params, seed) -> loss``.
"""

from __future__ import annotations

import torch

__all__ = ["make_kernel_train_step"]

# the JAX router's train-step crossover to the wavefront pipeline, in padded
# sphere rows (rt_tpu/train.py:72-82)
_WAVEFRONT_MIN_BUCKET = 1024


def make_kernel_train_step(
    optimizer: torch.optim.Optimizer,
    scene,
    target,
    size: tuple[int, int],
    *,
    spp: int = 4,
    max_bounces=None,
    **opts,
):
    """The fused-kernel optimizer step for ``scene``: ``step(params, seed)
    -> loss`` (see :func:`rt_tpu_torch.ops.blockwise_grad.make_bw_train_step`).

    Routed as the JAX package routes it: scenes whose sphere table pads to
    1024 rows or more (and that the wavefront pipeline takes) go to the
    wavefront record/reverse step
    (:func:`rt_tpu_torch.ops.wavefront_grad.make_wf_train_step`), every
    other scene to the blockwise fused step.  ``opts`` (``personality``,
    ``rng_mode``, ``device``) go to the step."""
    from .ops.blockwise import _bucket
    from .ops.blockwise_grad import make_bw_train_step
    from .ops.wavefront_grad import make_wf_train_step, wf_grad_supported

    route = (make_wf_train_step if wf_grad_supported(scene)
             and _bucket(scene.spheres.count) >= _WAVEFRONT_MIN_BUCKET else make_bw_train_step)
    return route(optimizer, scene, target, size, spp=spp, max_bounces=max_bounces, **opts)
