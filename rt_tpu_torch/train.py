"""Inverse-rendering optimization with checkpoint and resume (port of
``rt_tpu.train``).

:func:`fit` optimizes scene parameters against a target image with Adam
(``torch.optim.Adam`` for ``optax.adam``), one :func:`make_train_step` step
per iteration through the jnp-style integrator, the key of step i being
``rng.fold(rng.make_key(seed), i)`` as in the JAX package.
:func:`make_kernel_train_step` routes to the fused-kernel optimizer steps
(blockwise and wavefront).

The JAX package takes an optax optimizer and threads its state through
``step(params, opt_state, key)``; here the optimizer is a ``torch.optim``
optimizer built over the parameter tensors, which keeps its own state and
updates them in place, and a step is ``step(params, key) -> loss``.  A
checkpoint is ``torch.save`` of the params, the optimizer's
``state_dict()`` (Adam's moments and step count) and the step, in
``step_{n}.pt``; a resume restores all three, so that a resumed run
continues the uninterrupted one.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

__all__ = ["TrainState", "make_train_step", "make_kernel_train_step", "fit", "save_checkpoint",
           "restore_checkpoint"]


class TrainState:
    """Minimal train state: params, the optimizer's state and the step."""

    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


def make_train_step(optimizer: torch.optim.Optimizer, scene, target, size: tuple[int, int], *,
                    render_fn=None, device="cuda", **render_opts) -> Callable:
    """One optimizer step per call: ``step(params, key) -> loss``.

    ``optimizer`` is built over the tensors of ``params`` (a dict keyed like
    :func:`rt_tpu_torch.diff.extract_params`, on ``device``).  Each call
    takes the loss and gradients of :func:`rt_tpu_torch.diff.loss_and_grad`
    at ``params`` and ``key``, sets ``.grad`` of every tensor of ``params``
    and calls ``optimizer.step()``, which updates them in place.  The loss
    is the one before the update.  ``target`` is pre-gamma radiance."""
    from .diff import _as_tensor, loss_and_grad
    from .integrator import _device

    device = _device(device)
    scene = scene.to(device)
    target = _as_tensor(target, device)

    def step(params, key):
        loss, grads = loss_and_grad(params, scene, target, size, key, render_fn=render_fn,
                                    device=device, **render_opts)
        for k, p in params.items():
            p.grad = grads[k]
        optimizer.step()
        return loss

    return step


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


def fit(scene, target, size: tuple[int, int], *, steps: int = 100, learning_rate: float = 1e-2,
        param_names=None, seed: int = 0, checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50, log_every: int = 10, verbose: bool = True, device="cuda",
        **render_opts):
    """Fit scene parameters to a pre-gamma target image: ``(params,
    losses)``, the params a dict of tensors on ``device`` and the losses
    the floats of the steps run here.

    ``param_names`` restricts the optimization to a subset of the params
    (for instance ``["materials.albedo"]``); geometry only receives interior
    (non-silhouette) gradients.  With ``checkpoint_dir`` the run saves every
    ``checkpoint_every`` steps and resumes from the latest checkpoint found
    there.  ``render_opts`` go to :func:`rt_tpu_torch.diff.render_for_loss`
    (``spp``, ``max_bounces``, ``personality``, ``grad_mode``, ...)."""
    from . import rng as _rng
    from .diff import extract_params
    from .integrator import _device

    device = _device(device)
    params = extract_params(scene)
    if param_names is not None:
        params = {k: params[k] for k in param_names}
    params = {k: v.detach().to(device).clone() for k, v in params.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)
    start = 0
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        restored = restore_checkpoint(checkpoint_dir, params)
        if restored is not None:
            saved, opt_state, start = restored
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])
            optimizer.load_state_dict(opt_state)

    step_fn = make_train_step(optimizer, scene, target, size, device=device, **render_opts)
    key = _rng.make_key(seed)
    losses = []
    for i in range(start, steps):
        loss = float(step_fn(params, _rng.fold(key, i)))
        losses.append(loss)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {loss:.6g}")
        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, params, optimizer.state_dict(), i + 1)
    return params, losses


def save_checkpoint(path: str, params, opt_state, step: int) -> None:
    """Write ``step_{step}.pt`` under ``path``: the params, the optimizer's
    ``state_dict()`` (``opt_state``) and the step."""
    os.makedirs(path, exist_ok=True)
    torch.save({"params": {k: v.detach() for k, v in params.items()}, "opt_state": opt_state,
                "step": int(step)}, os.path.join(path, f"step_{step}.pt"))


def restore_checkpoint(path: str, params_like, opt_state_like=None):
    """``(params, opt_state, step)`` of the latest checkpoint under
    ``path``, the params on the devices of ``params_like``'s tensors;
    ``None`` if there is none.  ``opt_state_like`` is unused (the JAX
    version needs it to rebuild optax's state): load the returned state
    into the optimizer with ``load_state_dict``."""
    del opt_state_like
    steps = {int(e[len("step_"):-len(".pt")]): e for e in os.listdir(path)
             if e.startswith("step_") and e.endswith(".pt")}
    if not steps:
        return None
    data = torch.load(os.path.join(path, steps[max(steps)]), map_location="cpu",
                      weights_only=True)
    params = {k: data["params"][k].to(v.device) for k, v in params_like.items()}
    return params, data["opt_state"], int(data["step"])
