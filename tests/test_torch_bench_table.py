"""``rt_tpu_torch.bench_table`` on the CPU: its rows against the JAX tool's
(read from ``tools/bench_table.py`` with ``ast``: labels, shapes, the
``--fast`` branches and the order of every ``sustained``, ``interleaved``
and ``timeit`` call), its scenes against the JAX package's, its arithmetic
at tiny shapes through the kernels' plain versions with a stub clock, the
file it writes, and its native baseline.  No JAX render runs here."""

import ast
import contextlib
import dataclasses
import io
import json
import re
import types

import pytest

import rt_tpu
from rt_tpu_torch import _native, bench_table
from rt_tpu_torch.ops import grad as G
from test_torch_common import SCENES
from test_torch_host import assert_scenes_equal

REPO = SCENES.parent
JAX_TOOL = REPO / "tools" / "bench_table.py"
CARD = "Stub Card 80GB, 123.00 W"
# the native baselines the stub returns, by the JAX tool's cache tags
NATIVE = {"3-sm-dielectric": 61.25, "4-mg-500sph": 7.5, "5-mg-5000sph": 0.875}
# the tiny shapes of the arithmetic check: every row at 16x12, a quarter of
# its samples (at least 1, so that the per-spp ratios still divide unequal
# sample counts), depth at most 2, and the procedural scenes cut to a few
# spheres (the routes stay as the rows name them)
TINY_SIZE = (16, 12)
TINY_SCENES = {"proc200": "proc24", "proc500": "proc32", "proc5000": "proc48"}


# ---- the JAX tool, read with ast ----

def _jax_main():
    tree = ast.parse(JAX_TOOL.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _statements(body, full_only=False):
    """main's statements in source order with whether they run only
    without --fast (the tool's ``if not args.fast:`` blocks); its helper
    functions are skipped."""
    for st in body:
        if isinstance(st, ast.FunctionDef):
            continue
        if isinstance(st, ast.If):
            assert ast.unparse(st.test) == "not args.fast" and not st.orelse
            yield from _statements(st.body, True)
        else:
            yield st, full_only


def _jax_env(fast):
    """The values of main's ``name = a if args.fast else b`` assignments."""
    env = {"args": types.SimpleNamespace(fast=fast)}
    for st, _ in _statements(_jax_main().body):
        if (isinstance(st, ast.Assign) and isinstance(st.value, ast.IfExp)
                and "args.fast" in ast.unparse(st.value.test)):
            env[st.targets[0].id] = eval(compile(ast.Expression(st.value), "", "eval"), env)
    return env


def _timing_call(node):
    """(kind, iters or [iters per step], windows or reps) of a call of the
    tool's sustained / interleaved / timeit, else None."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("sustained", "timeit", "interleaved")):
        return None
    kw = {k.arg: k.value.value for k in node.keywords}
    if node.func.id == "sustained":
        return ("sustained", kw.get("iters", 32))
    if node.func.id == "timeit":
        return ("timeit", kw.get("reps", 3))
    iters = [e.elts[1].value if isinstance(e, ast.Tuple) else 32 for e in node.args[0].elts]
    return ("interleaved", iters, kw.get("windows", 9))


def jax_tool(fast):
    """The JAX tool's rows as (label, the literal text of its result) and
    its timing calls, in order, for one mode."""
    env = _jax_env(fast)
    rows, calls = [], []
    for st, full_only in _statements(_jax_main().body):
        if full_only and fast:
            continue
        for node in ast.walk(st):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and ast.unparse(node.func) == "rows.append"):
                label, value = node.args[0].elts
                text = eval(compile(ast.Expression(label), "", "eval"), env)
                lit = " ".join(c.value for c in ast.walk(value)
                               if isinstance(c, ast.Constant) and isinstance(c.value, str))
                rows.append((text, lit))
            elif _timing_call(node):
                calls.append(_timing_call(node))
    return rows, calls


def facts(label, result_text="", before=None):
    """What a label says it times: scene, size, spp, depth, personality and
    route; a label that leaves out its scene, size, samples or depth
    ("same slice", the gap row) takes them from the row ``before``."""
    f = dict(before or {})
    m = re.search(r"(\d+)x(\d+)", label)
    if m:
        f["size"] = (int(m.group(1)), int(m.group(2)))
    elif "1080p" in label:
        f["size"] = (1920, 1080)
    for key, pat in (("spp", r"@(\d+)spp"), ("depth", r"\bd(\d+)\b")):
        m = re.search(pat, label)
        if m:
            f[key] = int(m.group(1))
    m = re.search(r"(\d+)[- ]spheres?", label)
    if m:
        f["scene"] = f"proc{m.group(1)}"
    for name in ("basic", "dielectric"):
        if name in label:
            f["scene"] = name
    f["personality"] = ("sm/mg" if "sm/mg" in label
                        else "sm" if re.search(r"[(, ]sm[);]", label) else "mg")
    low = label.lower()
    if "wavefront" in low or ("END-TO-END" in label and "wavefront" in result_text):
        f["route"] = "wavefront"
    elif "blockwise" in low:
        f["route"] = "blockwise"
    elif "fwd+bwd" in label:
        f["route"] = "fused"
    else:
        f["route"] = "unrolled"
    return f


def row_facts(row):
    return {"scene": row.scene, "size": row.size, "spp": row.spp, "depth": row.depth,
            "personality": row.personality,
            "route": "fused" if row.route in ("mono", "multi") else row.route}


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_rows_are_the_jax_tools(fast):
    jrows, _ = jax_tool(fast)
    ours = bench_table.rows(fast)
    assert len(jrows) == len(ours) == (15 if fast else 21)
    before = None
    for (jlabel, jtext), row in zip(jrows, ours):
        want = facts(jlabel, jtext, before)
        before = want
        if row.key == "e2e" and fast:
            # the JAX row is static text at 256 spp; the port measures it, at 8 spp under --fast
            assert want["spp"] == 256 and row.spp == 8
            assert "(--fast: 8 of 256 spp)" in row.label()
            want = {**want, "spp": 8}
        assert row_facts(row) == want, (jlabel, row.label())
        # the port's label says what its row times, too
        assert {k: v for k, v in facts(row.label(), "", want).items() if k != "route"} == \
            {k: v for k, v in want.items() if k != "route"}, row.label()
        assert "TPU" not in row.label() and "tunnel" not in row.label().lower()
    for row in ours:  # a fused row names the route ops.grad.route takes
        if row.route in ("mono", "multi"):
            s = bench_table._scene(row.scene)
            mode = "multi" if row.key == "w_step" else "mono"  # the JAX tool's mode="multi"
            assert row.route == G.route(s.spheres.count + s.planes.count, row.spp, row.depth,
                                        mode)
    assert [r.route for r in ours if r.key in ("c2_step16", "c3_step64")] == (
        [] if fast else ["mono", "multi"])


@pytest.mark.parametrize("name", ["basic", "dielectric", "proc200", "proc500", "proc5000"])
def test_scenes_are_the_jax_packages(name):
    want = (rt_tpu.scene.make_procedural_scene(int(name[4:])) if name.startswith("proc")
            else rt_tpu.load(str(SCENES / f"{name}.toml")))
    assert_scenes_equal(bench_table._scene(name), want)


# ---- the tool at tiny shapes through the plain versions, with a stub clock ----

class StubClock:
    """The three clocks of ``bench_table._measure``: each calls its steps
    once (so every path runs) and returns fixed seconds, (k + 2) us for the
    k-th timed step; the two steps that a "128 spp ≈" figure reads (the
    only ``timeit(reps=2)`` and ``sustained(iters=2)``) and the end-to-end
    frame get (k + 2) ms, so that those figures are not all zeros."""

    def __init__(self):
        self.calls = []
        self.k = 0

    def _seconds(self, slow):
        self.k += 1
        return (self.k + 1) * (1e-3 if slow else 1e-6)

    def sustained(self, step, iters=32):
        step(0)
        t = self._seconds(iters == 2)
        self.calls.append(("sustained", iters, [t]))
        return t

    def interleaved(self, steps, windows=9):
        for s in steps:
            (s if callable(s) else s[0])(0)
        ts = [self._seconds(False) for _ in steps]
        self.calls.append(("interleaved", [32 if callable(s) else s[1] for s in steps], windows,
                           ts))
        return ts

    def timeit(self, fn, reps=3):
        out = fn(0)
        t = self._seconds(reps in (1, 2))
        self.calls.append(("timeit", reps, [t]))
        return t, out

    def native(self, tag, scene, size, spp, personality):
        self.calls.append(("native", tag, size, spp, personality))
        return NATIVE[tag]


def tiny(row):
    return dataclasses.replace(row, size=TINY_SIZE, spp=max(1, row.spp // 4),
                               depth=min(row.depth, 2),
                               scene=TINY_SCENES.get(row.scene, row.scene))


def _bytes(path):
    return path.read_bytes() if path.exists() else None


@pytest.fixture(scope="module", params=[True, False], ids=["fast", "full"])
def run(request, tmp_path_factory):
    """``bench_table.main`` on the CPU: CUDA reported present, the card line
    stubbed, and ``_measure`` given the tiny rows, the stub clock and the
    CPU (``main`` passes it the real clocks and the card)."""
    fast = request.param
    clock = StubClock()
    seen = {}
    real_measure = bench_table._measure

    def measure(specs, *, sustained, interleaved, timeit, native, device):
        assert (sustained, interleaved, timeit, native, device) == (
            bench_table.sustained, bench_table.interleaved, bench_table.timeit,
            bench_table.native_mrays, "cuda")
        seen["rows"] = [tiny(r) for r in specs]
        return real_measure(seen["rows"], sustained=clock.sustained,
                            interleaved=clock.interleaved, timeit=clock.timeit,
                            native=clock.native, device="cpu")

    frozen = [REPO / "BENCH_TABLE.md", REPO / ".baseline_cpu.json"]
    before = [_bytes(p) for p in frozen]
    out = tmp_path_factory.mktemp("table") / "table.md"
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
        mp.setattr(bench_table.torch.cuda, "is_available", lambda: True)
        mp.setattr(bench_table, "_card_line", lambda: CARD)
        mp.setattr(bench_table, "_measure", measure)
        result = bench_table.main(["--out", str(out)] + (["--fast"] if fast else []))
    return types.SimpleNamespace(fast=fast, result=result, calls=clock.calls, rows=seen["rows"],
                                 out=out, printed=printed.getvalue(), frozen=frozen,
                                 before=before)


def test_timing_calls_are_the_jax_tools(run):
    _, want = jax_tool(run.fast)
    got = [c[:-1] for c in run.calls if c[0] != "native"]
    # the JAX tool quotes its end-to-end row; the port times one frame after a warm-up
    assert got == want + [("timeit", 1)]
    natives = [c[1:] for c in run.calls if c[0] == "native"]
    assert natives == [("3-sm-dielectric", (400, 300), 16, "sm"),
                       ("4-mg-500sph", (480, 270), 8, "mg"),
                       ("5-mg-5000sph", (240, 135), 2, "mg")]


def expected(rows, calls, fast):
    """Each row's figures by the JAX tool's formulas (tools/bench_table.py,
    lines cited) at the stub's seconds and the rows' shapes; times print
    with more decimals than the JAX tool's (3 for ms, 4 for a frame's s)."""
    R = {r.key: r for r in rows}
    ts = iter(t for c in calls if c[0] != "native" for t in c[-1])

    def px(r):
        return r.size[0] * r.size[1]

    def vs_cpu(rate, tag):
        return f"{rate / NATIVE[tag]:.1f}x the native CPU baseline ({NATIVE[tag]:.2f} Mrays/s)"

    E = {}
    a = R["anchor"]
    t_ref = next(ts)  # :120-126
    E["anchor"] = [f"{px(a) * a.spp / t_ref / 1e6:.0f} Mrays/s ({t_ref * 1e3:.3f} ms;"]
    c1 = R["c1"]  # :129-147
    t_cold, t1, t1b, t_ref_i = (next(ts) for _ in range(4))
    tb = t1b / 16
    E["c1"] = [f"{px(c1) / t1 / 1e6:.0f} Mrays/s sustained ({t1 * 1e3:.3f} ms/frame",
               f"= {t1 / t_ref_i:.2f}x the anchor frame time", f"{t_cold * 1e3:.3f} ms per"]
    E["c1_batched"] = [f"{px(c1) / tb / 1e6:.0f} Mrays/s sustained ({tb * 1e3:.3f} ms/frame",
                       f"= {tb / t_ref_i:.3f}x the anchor frame time"]
    r = R["c2_fwd"]  # :150-156
    t, t_ref_i = next(ts), next(ts)
    E["c2_fwd"] = [f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s sustained ({t * 1e3:.3f} ms/frame;",
                   f"{t / t_ref_i / (r.spp / a.spp):.2f}x the anchor per-spp"]
    r = R["c2_step"]  # :158-165
    t, t_ref_i = next(ts), next(ts)
    E["c2_step"] = [f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step;",
                    f"step/fwd = {t / t_ref_i:.2f}x the session anchor"]
    if not fast:  # :170-180
        r = R["c2_step16"]
        t, t_ref_i = next(ts), next(ts)
        E["c2_step16"] = [f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step;",
                          f"step/fwd = {t / t_ref_i / (r.spp / a.spp):.2f}x the "
                          f"{a.spp}spp anchor per-spp"]
    c3, c3s = R["c3_fwd"], R["c3_step"]  # :183-211
    t3, t = next(ts), next(ts)
    sm_fwd = px(c3) * c3.spp / t3 / 1e6
    sm_step = px(c3s) * c3s.spp / t / 1e6
    E["c3_fwd"] = [f"{sm_fwd:.0f} Mrays/s sustained ({t3 * 1e3:.3f} ms/frame; "
                   f"{vs_cpu(sm_fwd, '3-sm-dielectric')})"]
    E["c3_step"] = [f"{sm_step:.0f} Mrays/s ({t * 1e3:.3f} ms/step, grad_ok=True; step/fwd = "
                    f"{t / (t3 / (c3.spp // c3s.spp)):.2f}x the session sm fwd per-spp",
                    vs_cpu(sm_step, "3-sm-dielectric")]
    if not fast:
        mg_t, mgd_t, smd_t = next(ts), next(ts), next(ts)  # :218-231
        E["c3_gap"] = [f"BASELINE-row ratio {mg_t / smd_t:.2f} = 1 / (scene tax "
                       f"{mgd_t / mg_t:.2f}x [7 vs 3 spheres, mg on both] x dielectric tax "
                       f"{smd_t / mgd_t:.2f}x); matched-scene sm/mg = {mgd_t / smd_t:.2f}"]
        r = R["c3_step64"]  # :234-243
        t, t3_i = next(ts), next(ts)
        E["c3_step64"] = [f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step;",
                          f"step/fwd = {t / t3_i:.2f}x the session sm @{c3.spp}spp fwd frame"]
    for key in ("w_step", "w_train"):  # :258-276
        r, t = R[key], next(ts)
        E[key] = [f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; absolute"]
    c4 = R["c4_bw"]  # :280-289
    t = next(ts)
    rb = px(c4) * c4.spp * c4.depth
    E["c4_bw"] = [f"{rb / t / 1e9:.2f} Gray-bounces/s ({t:.4f} s/frame; 128 spp ≈ "
                  f"{t * 128 / c4.spp:.3f} s; {vs_cpu(px(c4) * c4.spp / t / 1e6, '4-mg-500sph')}"]
    t, t_bw4 = next(ts), next(ts)  # :294-301
    E["c4_unrolled"] = [f"{rb / t / 1e9:.2f} Gray-bounces/s ({t:.4f} s/frame = "
                        f"{t_bw4 / t:.2f}x the blockwise frame"]
    r, t = R["c4_train"], next(ts)  # :304-316
    E["c4_train"] = [f"{px(r) * r.spp / t / 1e6:.0f} Mrays/s ({t * 1e3:.3f} ms/step; absolute"]
    if not fast:  # :319-334
        r, t = R["c4_train_hd"], next(ts)
        E["c4_train_hd"] = [f"{px(r) * r.spp / t / 1e6:.1f} Mrays/s ({t * 1e3:.3f} ms/step; "
                            f"128 spp ≈ {t * 128 / r.spp:.3f} s/step"]
    c5 = R["c5_bw"]  # :339-361
    t_bw5, t_wf5 = next(ts), next(ts)
    rb = px(c5) * c5.spp * c5.depth
    n_prims = int(c5.scene[4:])  # the spheres the kernel scans (no planes here)
    E["c5_bw"] = [f"{rb / t_bw5 / 1e9:.2f} Gray-bounces/s ({rb * n_prims / t_bw5 / 1e12:.2f} T "
                  f"prim-tests/s at {n_prims} primitives a ray-bounce; "
                  f"{vs_cpu(px(c5) * c5.spp / t_bw5 / 1e6, '5-mg-5000sph')}"]
    E["c5_wf"] = [f"{rb / t_wf5 / 1e9:.2f} Gray-bounces/s ({t_wf5 * 1e3:.3f} ms; "
                  f"{t_bw5 / t_wf5:.2f}x the pixel-major blockwise kernel",
                  vs_cpu(px(c5) * c5.spp / t_wf5 / 1e6, "5-mg-5000sph")]
    if not fast:  # :364-399
        t_wfg, t, t_wf5_i = next(ts), next(ts), next(ts)
        r = R["c5_bw_train"]
        E["c5_bw_train"] = [f"{px(r) * r.spp / t / 1e6:.1f} Mrays/s ({t * 1e3:.3f} ms/step = "
                            f"{t / t_wf5_i:.2f}x the wavefront forward frame"]
        E["c5_wf_train"] = [f"{px(r) * r.spp / t_wfg / 1e6:.1f} Mrays/s ({t_wfg * 1e3:.3f} "
                            f"ms/step = {t / t_wfg:.2f}x the blockwise step, step/fwd = "
                            f"{t_wfg / t_wf5_i:.2f}x the wavefront forward"]
    e, t = R["e2e"], next(ts)  # measured here; the JAX row (:400-410) is static text
    chunk = min(8, e.spp)  # the JAX render_4k's --spp-chunk 8 (the 2^25-ray cap binds only at 4K)
    E["e2e"] = [f"{t:.3f} s wall via the wavefront route ({px(e) * e.spp / t / 1e6:.2f} "
                f"Mrays/s; {-(-e.spp // chunk)} chunks of {chunk} samples = {px(e) * chunk} rays"]
    assert next(ts, None) is None
    return E


def test_figures_are_the_jax_formulas(run):
    E = expected(run.rows, run.calls, run.fast)
    table = run.result["rows"]
    assert run.result["grad_ok"] is True
    assert [label for label, _ in table] == [r.label() for r in run.rows]
    assert list(E) == [r.key for r in run.rows]
    for (label, text), row in zip(table, run.rows):
        for want in E[row.key]:
            assert want in text, (row.key, want, text)
        assert "TPU" not in text and "tunnel" not in text.lower()


def test_the_table_file(run):
    text = run.out.read_text()
    lines = text.splitlines()
    assert lines[0] == f"# BENCH_TABLE — measured on {CARD}"
    body = [ln for ln in lines if ln.startswith("| ") and ln != "| Config | Result |"]
    assert body == [f"| {k} | {v} |" for k, v in run.result["rows"]]
    assert len(body) == (15 if run.fast else 21)
    assert "TPU" not in text and "tunnel" not in text.lower()
    assert run.result["out"] == str(run.out) and run.result["card"] == CARD
    printed = [ln for ln in run.printed.splitlines() if ": " in ln and not ln.startswith("wrote")]
    assert printed == [f"{k}: {v}" for k, v in run.result["rows"]]
    # the JAX tool's files are left as they were
    assert [_bytes(p) for p in run.frozen] == run.before
    assert bench_table.DEFAULT_OUT == REPO / "BENCH_TABLE_torch.md"


def test_needs_cuda(tmp_path):
    out = tmp_path / "t.md"
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_table.main(["--fast", "--out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_table.timeit(lambda i: None)


def test_native_baseline_that_cannot_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_TRIED", True)  # no library loaded...
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")  # ...none built...
    monkeypatch.setenv("CXX", "no-such-c++-compiler")  # ...and none can be
    cache = tmp_path / "cache.json"
    scene = bench_table._scene("basic")
    with pytest.raises(RuntimeError, match="compiler"):
        bench_table.native_mrays("3-sm-dielectric", scene, (8, 6), 1, "sm", cache=cache)
    assert not cache.exists()


def test_native_baseline_cache_is_the_ports(monkeypatch, tmp_path):
    calls = []

    def render_cpu(scene, size, *, spp, max_bounces, personality):
        calls.append((size, spp, max_bounces, personality))
        return None, 0.25

    monkeypatch.setattr(_native, "render_cpu", render_cpu)
    cache = tmp_path / "cache.json"
    scene = bench_table._scene("proc500")
    got = bench_table.native_mrays("4-mg-500sph", scene, (48, 27), 8, "mg", cache=cache)
    assert got == 48 * 27 * 8 / 0.25 / 1e6
    assert calls == [((48, 27), 1, 8, "mg"), ((48, 27), 8, 8, "mg")]  # a warm-up, then timed
    assert json.loads(cache.read_text()) == {"host": _native._cpu_model(),
                                             "cfg:4-mg-500sph": got}
    assert bench_table.native_mrays("4-mg-500sph", scene, (48, 27), 8, "mg", cache=cache) == got
    assert len(calls) == 2  # read from the cache
    # a file written on another host is not read
    cache.write_text(json.dumps({"host": "another CPU", "cfg:4-mg-500sph": 1.0}))
    assert bench_table.native_mrays("4-mg-500sph", scene, (48, 27), 8, "mg", cache=cache) == got
    assert len(calls) == 4
    # the default cache is the port's own, under its build directory (gitignored)
    assert bench_table.NATIVE_CACHE.parent == _native.BUILD_DIR
    assert bench_table.NATIVE_CACHE != REPO / ".baseline_cpu.json"
    assert "rt_tpu_torch/_build/" in (REPO / ".gitignore").read_text().splitlines()
