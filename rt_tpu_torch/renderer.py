"""Renderer registry (port of ``rt_tpu.renderer``).

Mirrors the reference's plugin layer (renderer.hpp:9-41, renderer.cpp:11-69):
renderers register under a unique key, are listed by :func:`all_renderers`,
found by key or exact name, and the CLI resolves fuzzy prefixes
(main.cpp:67-81).

A renderer is a callable ``render(scene, size, key=None, *, seed=0,
device="cuda", **opts) -> (H, W, 3)`` float32 radiance tensor on
``device``.  The registry holds the JAX registry's names in its order:

* ``mg_ray_tracer`` / ``sm_ray_tracer`` — the jnp-style integrator
  (:func:`rt_tpu_torch.integrator.render_image`), keyed by ``key`` (an
  :mod:`rt_tpu_torch.rng` key; ``rng.make_key(seed)`` when none is given);
* ``rasterizer`` and ``null_renderer`` — the preview and the black frame;
* ``mg_pallas`` / ``sm_pallas`` — the forward megakernel
  (:func:`rt_tpu_torch.ops.render.render_forward`);
* ``mg_blockwise`` / ``sm_blockwise`` — the blockwise kernel, runtime
  tables of up to 16384 primitives
  (:func:`rt_tpu_torch.ops.blockwise.render_forward_blockwise`);
* ``mg_wavefront`` / ``sm_wavefront`` — the bounce-major wavefront kernel,
  the same tables (:func:`rt_tpu_torch.ops.wavefront.render_forward_wavefront`);
* ``mg_auto`` / ``sm_auto`` — :func:`auto_route` picks one of the three
  kernels, or the integrator past their limits.

The kernel renderers take ``seed`` and ignore ``key``.  The names keep
"pallas" although nothing here is Pallas: on CUDA they run the hand-written
CUDA kernels, and with ``device="cpu"`` their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .profiling import span

__all__ = [
    "Description",
    "install",
    "all_renderers",
    "find_by_key",
    "find_by_name",
    "find_by_name_fuzzy",
    "register_renderer",
    "create",
    "auto_route",
]


@dataclasses.dataclass(frozen=True)
class Description:
    key: str
    name: str
    create: Callable[[], Callable]


_REGISTRY: list[Description] = []


def install(desc: Description) -> None:
    """Idempotent by key (renderer.cpp:21-37)."""
    if find_by_key(desc.key) is None:
        _REGISTRY.append(desc)


def all_renderers() -> tuple[Description, ...]:
    return tuple(_REGISTRY)


def find_by_key(key: str) -> Optional[Description]:
    return next((d for d in _REGISTRY if d.key == key), None)


def find_by_name(name: str) -> Optional[Description]:
    return next((d for d in _REGISTRY if d.name == name), None)


def find_by_name_fuzzy(name: str) -> Optional[Description]:
    """Exact match first, else first registered whose name starts with the
    query (main.cpp:67-81)."""
    if not name:
        return None
    d = find_by_name(name)
    if d is not None:
        return d
    return next((d for d in _REGISTRY if d.name.startswith(name)), None)


def register_renderer(name: str, factory: Callable[[], Callable]) -> None:
    install(Description(key=f"{factory.__module__}:{name}", name=name, create=factory))


def create(name: str) -> Callable:
    """Create a renderer by (fuzzy) name; raises KeyError if unknown."""
    d = find_by_name_fuzzy(name)
    if d is None:
        raise KeyError(f"no known renderer with name '{name}'")
    return d.create()


# the JAX package's forward crossover to the wavefront route, in padded
# sphere rows (rt_tpu.renderer.auto_route)
_WAVEFRONT_MIN_BUCKET = 2048


def auto_route(scene, platform: str, include_boxes: bool = False) -> str:
    """The forward route for ``mg_auto``/``sm_auto`` on ``platform``
    ("cuda" or "cpu").

    Returns "pallas" (the megakernel), "blockwise", "wavefront" or "jnp"
    exactly where the JAX package does on an accelerator: the megakernel up
    to its 640 primitives, then up to 16384 the blockwise kernel while the
    sphere table pads to fewer than 2048 rows and the wavefront kernel from
    there, and past the kernels' limits the jnp-style integrator (much
    slower; ``mg_auto`` warns once, :func:`_jnp_warning`).  The route does
    not depend on ``platform``: on the CPU a kernel route runs its
    kernel's plain version, where the JAX package takes "jnp" for every
    scene.  Unlike the JAX version, which returns ``(route, warning)``,
    this returns the route alone.
    """
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r}")
    from .ops.blockwise import _bucket, blockwise_supported
    from .ops.render import supported

    if supported(scene, include_boxes):
        return "pallas"
    if blockwise_supported(scene, include_boxes):
        # wavefront_supported is blockwise_supported
        return "wavefront" if _bucket(scene.spheres.count) >= _WAVEFRONT_MIN_BUCKET else "blockwise"
    return "jnp"


def _jnp_warning(scene, include_boxes: bool) -> str:
    """The JAX package's warning for a scene past the kernels' limits."""
    from .ops.blockwise import MAX_BLOCKWISE_PRIMS

    n = scene.spheres.count + scene.planes.count
    why = (f"{n} primitives > {MAX_BLOCKWISE_PRIMS}" if n > MAX_BLOCKWISE_PRIMS else
           f"--boxes with {scene.boxes.count} box(es) beyond the unrolled kernel's cap")
    return ("auto renderer: scene unsupported by the CUDA kernels "
            f"({why}) — falling back to the jnp-style integrator "
            "(much slower than the kernels)")


def _install_builtins() -> None:
    from . import integrator

    def _tracer(personality):
        def factory():
            def render(scene, size, key=None, *, seed: int = 0, device="cuda", **opts):
                from . import rng

                opts.setdefault("personality", personality)
                return integrator.render_image(scene, size,
                                               rng.make_key(seed) if key is None else key,
                                               device=device, **opts)
            return render
        return factory

    def _pallas(personality):
        def factory():
            def render(scene, size, key=None, *, seed: int = 0, **opts):
                from .ops.render import render_forward

                with span("rt.frame", root=True):
                    return render_forward(scene, size, seed=seed, personality=personality,
                                          **opts)
            return render
        return factory

    def _blockwise(personality):
        def factory():
            def render(scene, size, key=None, *, seed: int = 0, **opts):
                from .ops.blockwise import render_forward_blockwise

                with span("rt.frame", root=True):
                    return render_forward_blockwise(scene, size, seed=seed,
                                                    personality=personality, **opts)
            return render
        return factory

    def _wavefront(personality):
        def factory():
            def render(scene, size, key=None, *, seed: int = 0, **opts):
                from .ops.wavefront import render_forward_wavefront

                with span("rt.frame", root=True):
                    return render_forward_wavefront(scene, size, seed=seed,
                                                    personality=personality, **opts)
            return render
        return factory

    def _auto(personality):
        def factory():
            def render(scene, size, key=None, *, seed: int = 0, device="cuda", **opts):
                import torch

                from .ops.blockwise import render_forward_blockwise
                from .ops.render import render_forward
                from .ops.wavefront import render_forward_wavefront

                include_boxes = opts.get("include_boxes", False)
                with span("rt.frame", root=True):
                    # the route names its span, so the choice (host arithmetic
                    # on the scene's counts) precedes it
                    route = auto_route(scene, torch.device(device).type, include_boxes)
                    with span("rt.route", route):
                        if route == "jnp":
                            from .log import warn_once

                            warning = _jnp_warning(scene, include_boxes)
                            warn_once(("auto", personality, warning), warning)
                            return _tracer(personality)()(scene, size, key, seed=seed,
                                                          device=device, **opts)
                        fwd = {"pallas": render_forward, "blockwise": render_forward_blockwise,
                               "wavefront": render_forward_wavefront}[route]
                        return fwd(scene, size, seed=seed, personality=personality,
                                   device=device, **opts)
            return render
        return factory

    # registration order follows the JAX registry's (main.cpp:181-191
    # cycles through renderers in registry order)
    register_renderer("mg_ray_tracer", _tracer("mg"))
    register_renderer("sm_ray_tracer", _tracer("sm"))
    register_renderer("rasterizer", lambda: integrator.render_rasterizer)
    register_renderer("null_renderer", lambda: integrator.render_null)
    register_renderer("mg_pallas", _pallas("mg"))
    register_renderer("sm_pallas", _pallas("sm"))
    register_renderer("mg_blockwise", _blockwise("mg"))
    register_renderer("sm_blockwise", _blockwise("sm"))
    register_renderer("mg_wavefront", _wavefront("mg"))
    register_renderer("sm_wavefront", _wavefront("sm"))
    register_renderer("mg_auto", _auto("mg"))
    register_renderer("sm_auto", _auto("sm"))


_install_builtins()
