"""Command-line interface (port of ``rt_tpu.cli``).

Same flags as ``python -m rt_tpu.cli`` plus ``--device`` (default
``cuda``; ``cpu`` renders with the kernels' plain PyTorch versions):

* ``--list`` prints the registered renderers and exits (main.cpp:355-360).
* ``--scene``: path, ``-`` for stdin, or empty → first *.toml under the
  search prefixes (scene.cpp:620-643).
* ``--renderer``: fuzzy prefix resolution, default ``mg`` →
  ``mg_ray_tracer`` (main.cpp:346-351), the jnp-style integrator.  As in
  the JAX CLI, every renderer is called as ``render(scene, (w, h), key)``
  with ``key = rng.make_key(--seed)``: the ray tracers draw from the key,
  and the kernel renderers, which take a seed and not a key, draw with
  their default seed 0 whatever ``--seed`` says.
* ``--watch`` re-renders when the scene file changes (mtime polled every
  0.5 s, main.cpp:235-249; a failed reload keeps the previous scene).
* ``--boxes`` traces boxes (the slab test) in ``mg_ray_tracer`` and
  ``sm_ray_tracer`` only, as in the JAX CLI; the other renderers keep the
  reference's box stub.
* ``--interactive`` runs the terminal viewer (:mod:`rt_tpu_torch.viewer`)
  on ``--device`` instead of writing an image; ``--preview`` prints an ANSI
  preview of the frame after writing it.

``--mesh R`` or ``--mesh RxP`` renders with the path tracers only
(``mg_ray_tracer``, ``sm_ray_tracer``; any other renderer is rc 2) over a
('rays', 'prims') mesh of R x P ranks (:mod:`rt_tpu_torch.dist`): the
unsharded frame bit for bit wherever the sharded render's ray chunk (JAX's
rule: at most a rank's share of the pixels, at least 1024) is the
unsharded one's, as at 800x600 on 2 ranks.  In a process that is not already a rank of
a world (no ``WORLD_SIZE``, as ``torchrun`` sets) the CLI starts the R x P
local ranks itself (``dist.run_local``: processes of their own, Gloo on
the CPU and where they share a card, NCCL where each has one); under
``torchrun --nproc-per-node N`` it renders in the world it is in.  Rank 0
logs and writes the image.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m rt_tpu_torch.cli",
        description="rt_tpu_torch — the PyTorch/CUDA port of the rt_tpu path tracer",
    )
    ap.add_argument("-l", "--list", action="store_true",
                    help="list available renderers and exit")
    ap.add_argument("-s", "--scene", default="",
                    help="scene TOML path ('-' = stdin; default: first .toml found)")
    ap.add_argument("-r", "--renderer", default="mg",
                    help="renderer name (fuzzy prefix; default mg_ray_tracer)")
    ap.add_argument("-o", "--out", default="out.png",
                    help="output image path (.png/.ppm/.npy)")
    ap.add_argument("--size", default="800x600", help="WxH (default 800x600)")
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per pixel (default: scene's)")
    ap.add_argument("--bounces", type=int, default=None,
                    help="max bounces (default: scene's)")
    ap.add_argument("--seed", type=int, default=0, help="RNG seed")
    ap.add_argument("--mesh", default="",
                    help="shard over ranks, e.g. '4' (rays) or '2x2' (rays x prims); starts "
                         "the local ranks unless run by torchrun")
    ap.add_argument("--procedural", type=int, default=0, metavar="N",
                    help="render the procedural N-sphere benchmark scene "
                         "(BASELINE configs 4/5) instead of a TOML file")
    ap.add_argument("--watch", action="store_true",
                    help="re-render whenever the scene file changes (0.5 s mtime poll)")
    ap.add_argument("-i", "--interactive", action="store_true",
                    help="ANSI terminal viewer with FPS controls (the "
                         "reference's SDL window, sans SDL)")
    ap.add_argument("--preview", action="store_true",
                    help="print an ANSI preview of the render to the terminal")
    ap.add_argument("--boxes", action="store_true",
                    help="enable real box intersection in the path tracers "
                         "(the reference's test_boxes is a stub that never "
                         "hits, mg_ray_tracer.cpp:89-93 — parity default)")
    ap.add_argument("--true-colours", action="store_true",
                    help="interpret named colours as /255 instead of the "
                         "reference's clamp binarization")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu runs "
                         "the plain PyTorch versions of the kernels)")
    return ap


def _parse_mesh(text: str) -> tuple[int, int]:
    """'R' or 'RxP' -> (R, P)."""
    parts = [int(v) for v in text.lower().split("x")]
    if not 1 <= len(parts) <= 2 or min(parts) < 1:
        raise ValueError(text)
    return parts[0], parts[1] if len(parts) > 1 else 1


def _meshed_renderer(args, name: str, argv):
    """``--mesh``: ``(render, quiet)`` for this rank of the world, or an rc
    (2 for a bad mesh or a renderer the mesh does not take; the rank 0 rc
    of the local ranks that this call started and ran)."""
    import torch.distributed as tdist

    from . import dist
    from .log import error

    try:
        n_rays, n_prims = _parse_mesh(args.mesh)
    except ValueError:
        error(f"bad --mesh '{args.mesh}' (expected R or RxP)")
        return 2
    personality = {"mg_ray_tracer": "mg", "sm_ray_tracer": "sm"}.get(name)
    if personality is None:
        error(f"--mesh is only supported for the path tracers, not {name}")
        return 2
    if not tdist.is_initialized() and "WORLD_SIZE" not in os.environ:
        # no world yet: start the R x P local ranks, each running this CLI
        # in the world it joins; a render's length is unknown, so the ranks'
        # launch has no deadline
        rcs = dist.run_local(main, n_rays * n_prims, sys.argv[1:] if argv is None
                             else list(argv), device=args.device, timeout=None,
                             collective_timeout=1800.0)
        return rcs[0]
    dist.initialize(device=args.device)
    mesh = dist.make_mesh(n_rays, n_prims)

    def render(scene, size, key, **o):
        return dist.render_image_sharded(scene, size, key, mesh, personality=personality, **o)

    return render, tdist.get_rank() != 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import rt_tpu_torch
    from rt_tpu_torch import renderer as registry
    from rt_tpu_torch.log import error, log

    if args.list:
        for d in registry.all_renderers():
            log(d.name)
        return 0

    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        error(f"bad --size '{args.size}' (expected WxH)")
        return 2

    if args.mesh and (args.watch or args.interactive):
        error("--mesh renders one frame: it takes neither --watch nor --interactive")
        return 2

    if args.interactive:
        from .viewer import interactive

        interactive(args.scene.strip(), args.renderer.strip(), size=(w, h), spp=args.spp,
                    seed=args.seed, device=args.device)
        return 0

    desc = registry.find_by_name_fuzzy(args.renderer.strip())
    if desc is None:
        error(f"no known renderer with name '{args.renderer}'")
        return 2
    render = desc.create()
    quiet = False  # a rank other than 0 of a --mesh world logs and writes nothing
    if args.mesh:
        meshed = _meshed_renderer(args, desc.name, argv)
        if isinstance(meshed, int):  # an error's rc, or the rc of the local ranks' run
            return meshed
        render, quiet = meshed
        if quiet:
            def log(*_args):
                pass
    log(f"created renderer: {desc.name}")

    def load_scene():
        if args.procedural:
            return rt_tpu_torch.scene.make_procedural_scene(args.procedural)
        if args.scene.strip():
            return rt_tpu_torch.load(args.scene.strip(), compat_colours=not args.true_colours)
        return rt_tpu_torch.load_first_available(compat_colours=not args.true_colours)

    try:
        scene = load_scene()
    except Exception as ex:  # loader errors are reported, as the reference does
        error(ex)
        return 1
    log(f"scene '{scene.path}' loaded." if scene.path else "scene loaded.")

    opts = {"device": args.device}
    if args.spp is not None:
        opts["spp"] = args.spp
    if args.bounces is not None:
        opts["max_bounces"] = args.bounces
    if args.boxes and desc.name in ("mg_ray_tracer", "sm_ray_tracer"):
        opts["include_boxes"] = True

    def do_render(scene):
        t0 = time.perf_counter()
        key = rt_tpu_torch.rng.make_key(args.seed)
        img = render(scene, (w, h), key, **opts).cpu()  # .cpu() waits for the device
        dt = time.perf_counter() - t0
        if not quiet:
            rt_tpu_torch.image.write_image(args.out, img)
        spp = opts.get("spp", scene.samples_per_pixel)
        log(f"rendered {w}x{h}@{spp}spp on {args.device} in {dt:.2f}s "
            f"({w * h * spp / dt / 1e6:.1f} Mrays/s, set-up included) -> {args.out}")
        if args.preview and not quiet:
            from .viewer import print_preview

            print_preview(img)

    do_render(scene)

    if args.watch and not args.procedural and os.path.exists(scene.path or ""):
        last = os.path.getmtime(scene.path)  # before the log line: an edit after it is seen
        log("watching for changes (ctrl-c to stop)...")
        try:
            while True:
                time.sleep(0.5)  # the reference polls every 0.5 s (main.cpp:235-249)
                try:
                    mtime = os.path.getmtime(scene.path)
                except OSError:
                    continue
                if mtime != last:
                    last = mtime
                    try:
                        scene = load_scene()
                        log(f"scene '{scene.path}' reloaded.")
                    except Exception as ex:  # keep the previous scene (main.cpp:127-132)
                        error(ex)
                        continue
                    do_render(scene)
        except KeyboardInterrupt:
            log("bye")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
