"""Renderer registry (port of ``rt_tpu.renderer``).

Mirrors the reference's plugin layer (renderer.hpp:9-41, renderer.cpp:11-69):
renderers register under a unique key, are listed by :func:`all_renderers`,
found by key or exact name, and the CLI resolves fuzzy prefixes
(main.cpp:67-81).

A renderer is a callable ``render(scene, size, *, seed=0, device="cuda",
**opts) -> (H, W, 3)`` float32 radiance tensor on ``device``.

Only the renderers whose path is ported are registered, under the JAX
package's names so that each maps one to one onto its counterpart:

* ``mg_pallas`` / ``sm_pallas`` — the forward megakernel
  (:func:`rt_tpu_torch.ops.render.render_forward`);
* ``mg_blockwise`` / ``sm_blockwise`` — the blockwise kernel, runtime
  tables of up to 16384 primitives
  (:func:`rt_tpu_torch.ops.blockwise.render_forward_blockwise`);
* ``mg_auto`` / ``sm_auto`` — :func:`auto_route` picks one of the two.

The names keep "pallas" although nothing here is Pallas: on CUDA they run
the hand-written CUDA kernels, and with ``device="cpu"`` their plain
PyTorch versions.  The jnp integrator (``mg_ray_tracer``,
``sm_ray_tracer``), the rasterizer, the null renderer and the wavefront
route are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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

    Returns "pallas" (the megakernel) or "blockwise" exactly where the JAX
    package does on an accelerator: the megakernel up to its 640
    primitives, then the blockwise kernel up to 16384 while the sphere
    table pads to fewer than 2048 rows.  Any other scene would take a route
    that is not ported yet — wavefront or the jnp integrator — and raises
    ``NotImplementedError`` naming it; such a scene is never rendered
    another way instead.  The route does not depend on ``platform``: on
    the CPU the same route runs its kernel's plain version.  Unlike the JAX
    version, which returns ``(route, warning)``, this returns the route
    alone: no route here falls back with a warning.
    """
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r}")
    from .ops.blockwise import MAX_BLOCKWISE_PRIMS, _bucket, blockwise_supported
    from .ops.render import supported

    if supported(scene, include_boxes):
        return "pallas"
    n = scene.spheres.count + scene.planes.count + (scene.boxes.count if include_boxes else 0)
    bucket = _bucket(scene.spheres.count)
    if not blockwise_supported(scene, include_boxes):
        missing, why = "jnp integrator", f"> {MAX_BLOCKWISE_PRIMS} primitives"
    elif bucket >= _WAVEFRONT_MIN_BUCKET:
        # wavefront_supported is blockwise_supported
        missing, why = "wavefront", f"a sphere table of {bucket} rows"
    else:
        return "blockwise"
    raise NotImplementedError(
        f"auto renderer: a scene of {n} primitives ({why}) needs the {missing} route, "
        f"which is not ported to {platform} yet")


def _install_builtins() -> None:
    def _pallas(personality):
        def factory():
            def render(scene, size, *, seed: int = 0, **opts):
                from .ops.render import render_forward

                return render_forward(scene, size, seed=seed, personality=personality, **opts)
            return render
        return factory

    def _blockwise(personality):
        def factory():
            def render(scene, size, *, seed: int = 0, **opts):
                from .ops.blockwise import render_forward_blockwise

                return render_forward_blockwise(scene, size, seed=seed, personality=personality,
                                                **opts)
            return render
        return factory

    def _auto(personality):
        def factory():
            def render(scene, size, *, seed: int = 0, device="cuda", **opts):
                import torch

                from .ops.blockwise import render_forward_blockwise
                from .ops.render import render_forward

                route = auto_route(scene, torch.device(device).type,
                                   opts.get("include_boxes", False))
                fwd = render_forward if route == "pallas" else render_forward_blockwise
                return fwd(scene, size, seed=seed, personality=personality, device=device,
                           **opts)
            return render
        return factory

    # registration order follows the JAX registry's (main.cpp:181-191
    # cycles through renderers in registry order)
    register_renderer("mg_pallas", _pallas("mg"))
    register_renderer("sm_pallas", _pallas("sm"))
    register_renderer("mg_blockwise", _blockwise("mg"))
    register_renderer("sm_blockwise", _blockwise("sm"))
    register_renderer("mg_auto", _auto("mg"))
    register_renderer("sm_auto", _auto("sm"))


_install_builtins()
