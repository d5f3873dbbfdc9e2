"""The bench table of the port on the card (port of ``tools/bench_table.py``).

Run on a machine with a CUDA card::

    python -m rt_tpu_torch.bench_table [--fast] [--out PATH]

It measures the JAX tool's 21 rows, in its order, on its scenes and shapes
(15 rows under ``--fast``, which also cuts the samples of four rows), with
its methodology and arithmetic (its times print with more decimals: the
card's would round to 0 at the JAX tool's):

* a sustained row is the median of 5 windows of back-to-back calls of a
  prebuilt step (:func:`rt_tpu_torch.profiling.sustained`, CUDA events);
* every ratio comes from one :func:`rt_tpu_torch.profiling.interleaved`
  call, whose round-robin windows sample one state of the card;
* an eager row is the fastest of a few calls, each ended by
  ``torch.cuda.synchronize()`` (:func:`timeit`);
* the native CPU baseline is :func:`rt_tpu_torch._native.render_cpu` on the
  card's host, cached per host CPU in ``rt_tpu_torch/_build/`` (never the
  JAX tool's ``.baseline_cpu.json``); where it cannot be built the tool
  raises, and prints no row.

Row 21, BASELINE config 5's 3840x2160 frame at 256 spp, is measured through
the wavefront route, as the JAX tool's ``render_4k`` renders it (8 spp
under ``--fast``).
The rows print, and the table is written to ``--out`` (by default
``BENCH_TABLE_torch.md`` at the repository root: ``BENCH_TABLE.md`` is the
JAX tool's), headed by the card's name and power limit as nvidia-smi gives
them.  Without CUDA the tool raises: it times nothing on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import torch

from . import _native, diff, profiling
from .roofline import _card_line
from .scene import load, make_procedural_scene

__all__ = ["Row", "rows", "sustained", "interleaved", "timeit", "native_mrays", "main"]

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "BENCH_TABLE_torch.md"
NATIVE_CACHE = _native.BUILD_DIR / "baseline_cpu.json"
BATCH_FRAMES = 16  # row 3's frames a launch
TRAIN_LR = 1e-2    # the JAX tool's optax.adam(1e-2)
# row 21's samples a chunk: the JAX render_4k's --spp-chunk, which the 2^25-ray cap
# of a chunk cuts to 4 at 3840x2160
E2E_SPP_CHUNK = 8
# what a label calls each route of ops.grad.route
ROUTE_TEXT = {"mono": "one-launch mono step", "multi": "per-sample route"}


@dataclasses.dataclass(frozen=True)
class Row:
    """One row of the table: what it times, and on what.

    ``title`` is the label with ``{size}``, ``{spp}``, ``{depth}`` and
    ``{route}`` left to fill from the fields.  ``scene``: "basic",
    "dielectric" (the files in ``scenes/``) or "procN"
    (``make_procedural_scene(N)``).  ``personality``: "mg", "sm", or "sm/mg"
    for the gap row, which times both.  ``route``: "unrolled"
    (``ops.render``), "mono" or "multi" (``ops.grad``, as ``ops.grad.route``
    sends the step), "blockwise" or "wavefront".  ``native``: the native
    baseline the row is held against, ``(cache tag, size, spp)``.
    """

    key: str
    title: str
    scene: str
    size: tuple[int, int]
    spp: int
    depth: int
    personality: str = "mg"
    route: str = "unrolled"
    native: Optional[tuple] = None

    def label(self) -> str:
        w, h = self.size
        return self.title.format(size=f"{w}x{h}", spp=self.spp, depth=self.depth,
                                 route=ROUTE_TEXT.get(self.route, self.route))


def _scene(name: str):
    if name.startswith("proc"):
        return make_procedural_scene(int(name[4:]))
    return load(str(REPO / "scenes" / f"{name}.toml"))


def _fused_route(scene: str, spp: int, depth: int, mode: str = "mono") -> str:
    from .ops.grad import route

    s = _scene(scene)
    return route(s.spheres.count + s.planes.count, spp, depth, mode)


def rows(fast: bool) -> list[Row]:
    """The rows of the table in the JAX tool's order (tools/bench_table.py
    :123-410): 21, or 15 with ``fast``."""
    spp2, spp3, spp4, spp_4k = (4, 8, 4, 8) if fast else (16, 64, 16, 256)
    hd, c5, small = (1920, 1080), (960, 540), (400, 300)
    nat3 = ("3-sm-dielectric", (400, 300), 16)
    nat4 = ("4-mg-500sph", (480, 270), 8)
    nat5 = ("5-mg-5000sph", (240, 135), 2)
    out = [
        Row("anchor", "ref: basic {size} @{spp}spp d{depth} fwd (session ratio anchor)",
            "basic", (800, 600), 4, 8),
        Row("c1", "1: basic {size} @{spp}spp d{depth} fwd", "basic", (200, 150), 1, 4),
        Row("c1_batched", "1: basic {size} @{spp}spp d{depth} fwd, %d-frame batched dispatch"
            % BATCH_FRAMES, "basic", (200, 150), 1, 4),
        Row("c2_fwd", "2: basic {size} @{spp}spp d{depth} fwd", "basic", (800, 600), spp2, 8),
        Row("c2_step", "2: basic {size} @{spp}spp d{depth} fwd+bwd "
            "(sphere/material/camera grads)", "basic", (800, 600), 4, 8,
            route=_fused_route("basic", 4, 8)),
    ]
    if not fast:
        out.append(Row("c2_step16", "2: basic {size} @{spp}spp d{depth} fwd+bwd (SPECIFIED spp; "
                       "{route})", "basic", (800, 600), 16, 8, route=_fused_route("basic", 16, 8)))
    out += [
        Row("c3_fwd", "3: dielectric {size} @{spp}spp d{depth} fwd (sm)", "dielectric",
            (800, 600), spp3, 8, "sm", native=nat3),
        Row("c3_step", "3: dielectric {size} @{spp}spp d{depth} fwd+bwd "
            "(IOR/Fresnel + camera-pose grads, sm)", "dielectric", (800, 600), 4, 8, "sm",
            route=_fused_route("dielectric", 4, 8), native=nat3),
    ]
    if not fast:
        out += [
            Row("c3_gap", "3: sm/mg fwd+bwd gap decomposition (@{spp}spp d{depth}, "
                "interleaved same-state windows)", "dielectric", (800, 600), 4, 8, "sm/mg",
                route=_fused_route("dielectric", 4, 8)),
            Row("c3_step64", "3: dielectric {size} @{spp}spp d{depth} fwd+bwd (SPECIFIED spp, "
                "sm; {route})", "dielectric", (800, 600), 64, 8, "sm",
                route=_fused_route("dielectric", 64, 8)),
        ]
    out += [
        Row("w_step", "window: 200-sphere {size} @{spp}spp d{depth} fwd+bwd (unrolled fused, "
            "{route})", "proc200", small, 2, 6, route=_fused_route("proc200", 2, 6, "multi")),
        Row("w_train", "window: 200-sphere {size} @{spp}spp d{depth} full train step "
            "(blockwise fwd+bwd, runtime tables)", "proc200", small, 4, 8, route="blockwise"),
        Row("c4_bw", "4: 500-sphere 1080p @{spp}spp d{depth} fwd (blockwise)", "proc500", hd,
            spp4, 8, route="blockwise", native=nat4),
        Row("c4_unrolled", "4: 500-sphere 1080p @{spp}spp d{depth} fwd (unrolled, early-out)",
            "proc500", hd, spp4, 8),
        Row("c4_train", "4: 500-sphere {size} @{spp}spp d{depth} full train step "
            "(blockwise fwd+bwd)", "proc500", small, 4, 8, route="blockwise"),
    ]
    if not fast:
        out.append(Row("c4_train_hd", "4: 500-sphere {size} @{spp}spp d{depth} full train step "
                       "(blockwise fwd+bwd, specified shape)", "proc500", hd, 4, 8,
                       route="blockwise"))
    out += [
        Row("c5_bw", "5: 5000-sphere fwd rate ({size} @{spp}spp d{depth} slice, blockwise)",
            "proc5000", c5, 2, 8, route="blockwise", native=nat5),
        Row("c5_wf", "5: 5000-sphere fwd rate (same slice, WAVEFRONT)", "proc5000", c5, 2, 8,
            route="wavefront", native=nat5),
    ]
    if not fast:
        out += [
            Row("c5_bw_train", "5: 5000-sphere {size} @{spp}spp d{depth} full train step "
                "(blockwise fwd+bwd)", "proc5000", c5, 2, 8, route="blockwise"),
            Row("c5_wf_train", "5: 5000-sphere {size} @{spp}spp d{depth} full train step "
                "(WAVEFRONT fwd+bwd)", "proc5000", c5, 2, 8, route="wavefront"),
        ]
    out.append(Row("e2e", "5: END-TO-END frame — {size} @{spp}spp d{depth}, 5000 spheres"
                   + (" (--fast: 8 of 256 spp)" if fast else ""), "proc5000", (3840, 2160),
                   spp_4k, 8, route="wavefront"))
    return out


# ---- the clocks (main passes these; a test passes stubs) ----

def sustained(step, iters: int = 32) -> float:
    """Seconds a call: the median of 5 windows of ``iters`` back-to-back
    calls (``profiling.sustained``, the one methodology of every number)."""
    return profiling.sustained(step, iters=iters, windows=5)["median"]


def interleaved(steps, windows: int = 9) -> list[float]:
    """Seconds a call of each step, from one round-robin of ``windows``
    windows (``profiling.interleaved``): every ratio in the table comes
    from one such call, because ratios of two sequential blocks carry the
    card's drift between them."""
    return [m["median"] for m in profiling.interleaved(steps, windows=windows)]


def timeit(fn, reps: int = 3):
    """``(seconds, result)``: the fastest of ``reps`` calls ``fn(1..reps)``
    after one call ``fn(0)``, each ended by ``torch.cuda.synchronize()``
    (the JAX tool blocks on its result)."""
    if not torch.cuda.is_available():
        raise RuntimeError("timeit() times the CUDA device; none is available")
    out = fn(0)
    torch.cuda.synchronize()
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        out = fn(i + 1)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def native_mrays(tag: str, scene, size, spp: int, personality: str, max_bounces: int = 8,
                 cache: Path = NATIVE_CACHE) -> float:
    """The native CPU tracer's Mrays/s on this host at ``size``, ``spp`` and
    ``max_bounces`` (after a 1-spp warm-up), cached under ``cfg:<tag>`` in
    ``cache`` with the host's CPU model: a file written on another host is
    not read.  Raises where the native library cannot be built."""
    host = _native._cpu_model()
    try:
        entries = json.loads(Path(cache).read_text())
    except FileNotFoundError:
        entries = {}
    if entries.get("host") != host:
        entries = {"host": host}
    key = f"cfg:{tag}"
    if key in entries:
        return entries[key]
    _native.render_cpu(scene, size, spp=1, max_bounces=max_bounces, personality=personality)
    _, secs = _native.render_cpu(scene, size, spp=spp, max_bounces=max_bounces,
                                 personality=personality)
    entries[key] = size[0] * size[1] * spp / secs / 1e6
    Path(cache).parent.mkdir(parents=True, exist_ok=True)
    Path(cache).write_text(json.dumps(entries))
    return entries[key]


def _vs_cpu(rate: float, cpu: float) -> str:
    return f"{rate / cpu:.1f}x the native CPU baseline ({cpu:.2f} Mrays/s)"


def _scanned_prims(scene) -> int:
    """Primitive tests a ray-bounce of the blockwise kernel: it scans the
    used rows of its tables (``counts``), not the padding of
    ``ops.tables._bucket`` (5120 rows for 5000 spheres), which the TPU
    kernel scans whole and the JAX tool counts."""
    return scene.spheres.count + scene.planes.count


def _measure(specs, *, sustained, interleaved, timeit, native, device="cuda"):
    """Time every row of ``specs`` (:func:`rows`' list, or rows of other
    shapes) with the given clocks, in the JAX tool's order and groupings.
    Returns ``([(label, result text), ...], grad_ok)``."""
    from .ops.blockwise import render_forward_blockwise
    from .ops.blockwise_grad import make_bw_train_step
    from .ops.grad import make_mse_step
    from .ops.render import make_render_step, render_forward
    from .ops.wavefront import _resolve_chunk, render_forward_wavefront
    from .ops.wavefront_grad import make_wf_train_step

    R = {r.key: r for r in specs}
    scenes = {}
    table = []

    def scene(row):
        if row.scene not in scenes:
            scenes[row.scene] = _scene(row.scene)
        return scenes[row.scene]

    def px(row):
        return row.size[0] * row.size[1]

    def zeros(row):
        return torch.zeros((row.size[1], row.size[0], 3), dtype=torch.float32)

    def add(row, text):
        table.append((row.label(), text))

    def render_step(row, **kw):
        return make_render_step(scene(row), row.size, spp=row.spp, max_bounces=row.depth,
                                personality=row.personality, device=device, **kw)

    def mse_step(row, params, personality=None):
        step = make_mse_step(params, scene(row), zeros(row), row.size, spp=row.spp,
                             max_bounces=row.depth, personality=personality or row.personality,
                             mode=row.route, device=device)
        if step.mode != row.route:
            raise RuntimeError(f"{row.key}: the step took the {step.mode} route, not {row.route}")
        return step

    def train_step(make, row):
        """A prebuilt optimizer step over a copy of the scene's params on
        the device (Adam, the JAX tool's learning rate): ``fn(i) -> loss``."""
        params = {k: v.detach().clone().to(device)
                  for k, v in diff.extract_params(scene(row)).items()}
        opt = torch.optim.Adam(list(params.values()), lr=TRAIN_LR)
        step = make(opt, scene(row), zeros(row), row.size, spp=row.spp, max_bounces=row.depth,
                    device=device)
        return lambda i: step(params, i)

    def native_rate(row):
        tag, size, spp = row.native
        return native(tag, scene(row), size, spp, row.personality)

    # --- session forward reference (ratio anchor) ---
    a = R["anchor"]
    ref_step = render_step(a)
    t_ref = sustained(ref_step, iters=16)
    add(a, f"{px(a) * a.spp / t_ref / 1e6:.0f} Mrays/s ({t_ref * 1e3:.3f} ms; absolute, "
           "session-dependent — each ratio row below re-measures this step in interleaved "
           "windows)")

    # --- config 1: basic 200x150 @ 1spp d4 ---
    c1, c1b = R["c1"], R["c1_batched"]
    t_cold, _ = timeit(lambda i: render_forward(scene(c1), c1.size, seed=i, spp=c1.spp,
                                                max_bounces=c1.depth, device=device))
    step1 = render_step(c1)
    step1b = render_step(c1b, frames=BATCH_FRAMES)
    t1, t1b, t_ref_i = interleaved([step1, (step1b, 4), (ref_step, 16)])
    tb = t1b / BATCH_FRAMES
    add(c1, f"{px(c1) * c1.spp / t1 / 1e6:.0f} Mrays/s sustained ({t1 * 1e3:.3f} ms/frame "
            f"prebuilt step = {t1 / t_ref_i:.2f}x the anchor frame time, interleaved; "
            f"{t_cold * 1e3:.3f} ms per synchronized eager call — host set-up and round trip, "
            "not compute)")
    add(c1b, f"{px(c1b) * c1b.spp / tb / 1e6:.0f} Mrays/s sustained ({tb * 1e3:.3f} ms/frame = "
             f"{tb / t_ref_i:.3f}x the anchor frame time, interleaved — {BATCH_FRAMES} seeds per "
             "launch amortize the fixed dispatch floor)")

    # --- config 2: basic 800x600 @ 16spp d8 fwd and fwd+bwd ---
    c2 = R["c2_fwd"]
    step2 = render_step(c2)
    t, t_ref_i = interleaved([(step2, 16), (ref_step, 16)])
    add(c2, f"{px(c2) * c2.spp / t / 1e6:.0f} Mrays/s sustained ({t * 1e3:.3f} ms/frame; "
            f"{t / t_ref_i / (c2.spp / a.spp):.2f}x the anchor per-spp, interleaved)")

    c2s = R["c2_step"]
    params = diff.extract_params(scene(c2s))
    step = mse_step(c2s, params)
    t, t_ref_i = interleaved([step, ref_step])
    add(c2s, f"{px(c2s) * c2s.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; step/fwd = "
             f"{t / t_ref_i:.2f}x the session anchor, interleaved windows)")

    if "c2_step16" in R:  # config 2 at its specified 16 spp
        r = R["c2_step16"]
        step16 = mse_step(r, params)
        t, t_ref_i = interleaved([(step16, 8), (ref_step, 16)])
        add(r, f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; step/fwd = "
               f"{t / t_ref_i / (r.spp / a.spp):.2f}x the {a.spp}spp anchor per-spp, "
               "interleaved)")

    # --- config 3: dielectric 800x600, sm ---
    c3, c3s = R["c3_fwd"], R["c3_step"]
    step3 = render_step(c3)
    cpu3 = native_rate(c3)
    dparams = diff.extract_params(scene(c3s))
    dstep = mse_step(c3s, dparams)
    _, dgrads = dstep(0)
    grad_ok = bool(all(torch.isfinite(g).all().item() for g in dgrads.values())
                   and dgrads["camera.position"].abs().max().item() > 0
                   and dgrads["materials.reflectivity"].abs().max().item() > 0)
    # one interleaved group: the sm forward and step share the windows
    t3, t = interleaved([(step3, 8), dstep])
    sm_fwd_rate = px(c3) * c3.spp / t3 / 1e6
    add(c3, f"{sm_fwd_rate:.0f} Mrays/s sustained ({t3 * 1e3:.3f} ms/frame; "
            f"{_vs_cpu(sm_fwd_rate, cpu3)})")
    sm_step_rate = px(c3s) * c3s.spp / t / 1e6
    add(c3s, f"{sm_step_rate:.0f} Mrays/s ({t * 1e3:.3f} ms/step, grad_ok={grad_ok}; step/fwd = "
             f"{t / (t3 / (c3.spp // c3s.spp)):.2f}x the session sm fwd per-spp, interleaved; "
             f"{_vs_cpu(sm_step_rate, cpu3)})")

    if "c3_gap" in R:  # scene tax and dielectric tax of the sm/mg gap, one round-robin
        r = R["c3_gap"]
        mgd_step = mse_step(r, dparams, "mg")
        mg_t, mgd_t, smd_t = interleaved([step, mgd_step, dstep])
        add(r, f"BASELINE-row ratio {mg_t / smd_t:.2f} = 1 / (scene tax {mgd_t / mg_t:.2f}x "
               f"[{scene(r).spheres.count} vs {scene(c2s).spheres.count} spheres, mg on both] "
               f"x dielectric tax {smd_t / mgd_t:.2f}x); matched-scene sm/mg = "
               f"{mgd_t / smd_t:.2f}")

    if "c3_step64" in R:  # config 3 at its specified 64 spp
        r = R["c3_step64"]
        dstep64 = mse_step(r, dparams)
        t, t3_i = interleaved([(dstep64, 2), (step3, 8)])
        add(r, f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; step/fwd = "
               f"{t / t3_i:.2f}x the session sm @{c3.spp}spp fwd frame, interleaved)")

    # --- the 96-640-primitive window: fused gradients two ways ---
    w = R["w_step"]
    fstep = mse_step(w, diff.extract_params(scene(w)))
    t = sustained(fstep, iters=16)
    add(w, f"{px(w) * w.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; absolute, "
           "session-dependent)")
    wt = R["w_train"]
    t = sustained(train_step(make_bw_train_step, wt), iters=8)
    add(wt, f"{px(wt) * wt.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; absolute, "
            "session-dependent)")

    # --- config 4: 500 spheres at 1080p ---
    c4 = R["c4_bw"]

    def bw500_fwd(i):
        return render_forward_blockwise(scene(c4), c4.size, seed=i, spp=c4.spp,
                                        max_bounces=c4.depth, device=device)

    t, _ = timeit(bw500_fwd, reps=2)
    rb = px(c4) * c4.spp * c4.depth
    cpu4 = native_rate(c4)
    add(c4, f"{rb / t / 1e9:.2f} Gray-bounces/s ({t:.4f} s/frame; 128 spp ≈ "
            f"{t * 128 / c4.spp:.3f} s; {_vs_cpu(px(c4) * c4.spp / t / 1e6, cpu4)}; absolute, "
            "session-dependent)")
    # the static-scene alternative: the unrolled megakernel, same frame
    c4u = R["c4_unrolled"]
    t, t_bw4 = interleaved([(render_step(c4u), 4), (bw500_fwd, 2)], windows=5)
    add(c4u, f"{px(c4u) * c4u.spp * c4u.depth / t / 1e9:.2f} Gray-bounces/s ({t:.4f} s/frame = "
             f"{t_bw4 / t:.2f}x the blockwise frame, interleaved)")

    r = R["c4_train"]
    t = sustained(train_step(make_bw_train_step, r), iters=8)
    add(r, f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; absolute, "
           "session-dependent)")

    if "c4_train_hd" in R:  # the full train step at the specified 1080p shape
        r = R["c4_train_hd"]
        t = sustained(train_step(make_bw_train_step, r), iters=2)
        add(r, f"{px(r) * r.spp / t / 1e6:.1f} Mrays/s ({t * 1e3:.3f} ms/step; 128 spp ≈ "
               f"{t * 128 / r.spp:.3f} s/step; absolute, session-dependent)")

    # --- config 5: 5000 spheres on a slice of the 4K frame ---
    c5b, c5w = R["c5_bw"], R["c5_wf"]
    rb = px(c5b) * c5b.spp * c5b.depth
    cpu5 = native_rate(c5b)

    def bw5(i):
        return render_forward_blockwise(scene(c5b), c5b.size, seed=i, spp=c5b.spp,
                                        max_bounces=c5b.depth, device=device)

    def wf5(i):
        return render_forward_wavefront(scene(c5w), c5w.size, seed=i, spp=c5w.spp,
                                        max_bounces=c5w.depth, device=device)

    # one interleaved group, so the wavefront/blockwise ratio is same-state
    t_bw5, t_wf5 = interleaved([(bw5, 2), (wf5, 4)], windows=5)
    n_prims = _scanned_prims(scene(c5b))
    add(c5b, f"{rb / t_bw5 / 1e9:.2f} Gray-bounces/s ({rb * n_prims / t_bw5 / 1e12:.2f} T "
             f"prim-tests/s at {n_prims} primitives a ray-bounce; "
             f"{_vs_cpu(px(c5b) * c5b.spp / t_bw5 / 1e6, cpu5)})")
    add(c5w, f"{rb / t_wf5 / 1e9:.2f} Gray-bounces/s ({t_wf5 * 1e3:.3f} ms; "
             f"{t_bw5 / t_wf5:.2f}x the pixel-major blockwise kernel, interleaved windows; "
             f"{_vs_cpu(px(c5w) * c5w.spp / t_wf5 / 1e6, cpu5)})")

    if "c5_bw_train" in R:  # the two train steps and the wavefront frame, one group
        rb_, rw_ = R["c5_bw_train"], R["c5_wf_train"]
        one5k = train_step(make_bw_train_step, rb_)
        one5w = train_step(make_wf_train_step, rw_)
        t_wfg, t, t_wf5_i = interleaved([(one5w, 2), (one5k, 2), (wf5, 4)], windows=5)
        add(rb_, f"{px(rb_) * rb_.spp / t / 1e6:.1f} Mrays/s ({t * 1e3:.3f} ms/step = "
                 f"{t / t_wf5_i:.2f}x the wavefront forward frame, interleaved)")
        add(rw_, f"{px(rw_) * rw_.spp / t_wfg / 1e6:.1f} Mrays/s ({t_wfg * 1e3:.3f} ms/step = "
                 f"{t / t_wfg:.2f}x the blockwise step, step/fwd = {t_wfg / t_wf5_i:.2f}x the "
                 "wavefront forward — all interleaved windows)")

    # --- config 5 end to end: the whole frame through the wavefront route ---
    e = R["e2e"]
    chunk = _resolve_chunk(e.size, e.spp, E2E_SPP_CHUNK)
    t, img = timeit(lambda i: render_forward_wavefront(scene(e), e.size, seed=i, spp=e.spp,
                                                       spp_chunk=E2E_SPP_CHUNK,
                                                       max_bounces=e.depth, device=device),
                    reps=1)
    if not torch.isfinite(img).all().item():
        raise RuntimeError("the end-to-end frame is not finite")
    add(e, f"{t:.3f} s wall via the wavefront route ({px(e) * e.spp / t / 1e6:.2f} Mrays/s; "
           f"{-(-e.spp // chunk)} chunks of {chunk} samples = {px(e) * chunk} rays; one frame "
           "after a warm-up frame)")
    return table, grad_ok


NOTES = [
    "- Every RATIO in this table is measured from INTERLEAVED round-robin",
    "  windows (rt_tpu_torch.profiling.interleaved, CUDA events): the card's",
    "  rate drifts within one session, enough to bias a ratio of two",
    "  sequential measurement blocks.  Rows without a ratio are tagged",
    "  'absolute, session-dependent'.",
    "- Sustained rows run prebuilt steps (make_render_step / make_mse_step /",
    "  make_bw_train_step / make_wf_train_step), 2-32 back-to-back calls a",
    "  window, the median of the windows: the steady serving and training",
    "  shape, the host enqueuing while the card works.  Eager rows (config 1's",
    "  cold call, config 4's blockwise frame, the end-to-end frame) end each",
    "  call with torch.cuda.synchronize() and pay the host's per-call set-up.",
    "- fwd+bwd rows use the fused CUDA kernels (the mono step or the",
    "  per-sample route, as ops.grad.route sends a step, up to 640",
    "  primitives; the blockwise and wavefront kernels beyond); the gradient",
    "  convention is detached sampling, checked against finite differences",
    "  by chip_smoke.py and held against the JAX package by the tests.",
    "- Config 4/5 rows count potential ray-bounces (W*H*spp*depth); the",
    "  reference's linear-scan semantics make work proportional to",
    "  ray-bounces x primitives.",
    "- The native CPU baseline is native/rt_native.cpp built with",
    "  native/Makefile's flags and run on the card's host.",
    "- Roofline: python -m rt_tpu_torch.roofline measures the card's FP32",
    "  peak and the config-5 scan rates; PERF.md's kernel table gives each",
    "  kernel's time beside its bound.",
]


def _markdown(table, card: str, how: str) -> str:
    md = [f"# BENCH_TABLE — measured on {card}", "", how, "", "| Config | Result |", "|---|---|"]
    md += [f"| {k} | {v} |" for k, v in table]
    md += ["", "Notes:", *NOTES]
    return "\n".join(md) + "\n"


def main(argv=None) -> dict:
    """Measure the table on the card, print its rows and write it to
    ``--out``.  Returns ``{"rows", "grad_ok", "card", "out", "seconds"}``."""
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.bench_table",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="shrink spp for a quick pass")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where the markdown table goes (default: BENCH_TABLE_torch.md at the "
                         "repository root)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_table times the CUDA device; none is available")
    card = _card_line()
    t0 = time.perf_counter()
    table, grad_ok = _measure(rows(args.fast), sustained=sustained, interleaved=interleaved,
                              timeit=timeit, native=native_mrays, device="cuda")
    seconds = time.perf_counter() - t0
    for k, v in table:
        print(f"{k}: {v}", flush=True)
    how = (f"`python -m rt_tpu_torch.bench_table{' --fast' if args.fast else ''}`: torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}; {len(table)} rows in "
           f"{seconds:.0f} s of wall time.")
    Path(args.out).write_text(_markdown(table, card, how))
    print(f"wrote {args.out} ({seconds:.1f} s)", flush=True)
    return {"rows": table, "grad_ok": grad_ok, "card": card, "out": args.out,
            "seconds": seconds}


if __name__ == "__main__":
    main()
