"""Command-line interface (port of ``rt_tpu.cli``).

Same flags as ``python -m rt_tpu.cli`` plus ``--device`` (default
``cuda``; ``cpu`` renders with the kernels' plain PyTorch versions):

* ``--list`` prints the registered renderers and exits (main.cpp:355-360).
* ``--scene``: path, ``-`` for stdin, or empty → first *.toml under the
  search prefixes (scene.cpp:620-643).
* ``--renderer``: fuzzy prefix resolution, default ``mg`` →
  ``mg_ray_tracer`` (main.cpp:346-351), the jnp-style integrator.  Every
  renderer gets ``rng.make_key(--seed)`` as its key and ``--seed`` as its
  seed: the ray tracers draw from the key, the kernel renderers from the
  seed.
* ``--watch`` re-renders when the scene file changes (mtime polled every
  0.5 s, main.cpp:235-249; a failed reload keeps the previous scene).
* ``--boxes`` traces boxes (the slab test) in the ray tracers and the
  kernel renderers.

``--mesh``, ``--interactive`` and ``--preview`` are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
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
                    help="shard over devices (not ported yet)")
    ap.add_argument("--procedural", type=int, default=0, metavar="N",
                    help="render the procedural N-sphere benchmark scene "
                         "(BASELINE configs 4/5) instead of a TOML file")
    ap.add_argument("--watch", action="store_true",
                    help="re-render whenever the scene file changes (0.5 s mtime poll)")
    ap.add_argument("-i", "--interactive", action="store_true",
                    help="ANSI terminal viewer (not ported yet)")
    ap.add_argument("--preview", action="store_true",
                    help="ANSI preview of the render (not ported yet)")
    ap.add_argument("--boxes", action="store_true",
                    help="enable real box intersection (the reference's "
                         "test_boxes is a stub that never hits, "
                         "mg_ray_tracer.cpp:89-93 — parity default)")
    ap.add_argument("--true-colours", action="store_true",
                    help="interpret named colours as /255 instead of the "
                         "reference's clamp binarization")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu runs "
                         "the plain PyTorch versions of the kernels)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import rt_tpu_torch
    from rt_tpu_torch import renderer as registry
    from rt_tpu_torch.log import error, log

    if args.list:
        for d in registry.all_renderers():
            log(d.name)
        return 0

    for flag, on in (("--mesh", args.mesh), ("--interactive", args.interactive),
                     ("--preview", args.preview)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet")

    try:
        w, h = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        error(f"bad --size '{args.size}' (expected WxH)")
        return 2

    desc = registry.find_by_name_fuzzy(args.renderer.strip())
    if desc is None:
        error(f"no known renderer with name '{args.renderer}'")
        return 2
    render = desc.create()
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
    if args.boxes:
        opts["include_boxes"] = True

    def do_render(scene):
        t0 = time.perf_counter()
        key = rt_tpu_torch.rng.make_key(args.seed)
        img = render(scene, (w, h), key, seed=args.seed, **opts).cpu()  # .cpu() waits for the device
        dt = time.perf_counter() - t0
        rt_tpu_torch.image.write_image(args.out, img)
        spp = opts.get("spp", scene.samples_per_pixel)
        log(f"rendered {w}x{h}@{spp}spp on {args.device} in {dt:.2f}s "
            f"({w * h * spp / dt / 1e6:.1f} Mrays/s, set-up included) -> {args.out}")

    do_render(scene)

    if args.watch and not args.procedural and os.path.exists(scene.path or ""):
        log("watching for changes (ctrl-c to stop)...")
        last = os.path.getmtime(scene.path)
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
