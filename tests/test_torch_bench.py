"""``rt_tpu_torch.bench`` on the CPU: its flags, shapes, gradient check,
ladder and JSON line against ``bench.py`` (read with ``ast``: it loads a
scene this repository lacks), the whole line at tiny shapes through the
kernels' plain versions with stub clocks, the gradient check, the
``--scaling`` ladder in Gloo worlds, and what raises.  No JAX render runs
here."""

import ast
import contextlib
import io
import json

import pytest
import torch

import rt_tpu_torch
from rt_tpu_torch import _native, bench, bench_table, integrator, profiling, rng
from test_torch_common import SCENES

REPO = SCENES.parent
CARD = "Stub Card 80GB, 123.00 W"
NATIVE = 61.25  # the stub's native baseline, Mrays/s
KEYS = ["metric", "value", "unit", "vs_baseline", "spread", "fwd_ref", "ratio_step_over_fwd"]


# ---- bench.py and the port, read with ast ----

def _functions(path):
    tree = ast.parse(path.read_text())
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}


JAX = _functions(REPO / "bench.py")
PORT = _functions(REPO / "rt_tpu_torch" / "bench.py")


def _calls(fn, name):
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and ast.unparse(n.func).split(".")[-1] == name]


def _kw(call):
    return {k.arg: k.value for k in call.keywords}


def _assigned(fn, name):
    """The value nodes assigned to ``name`` in ``fn``."""
    return [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == name for t in n.targets)]


def _row(fn):
    """A row's keys in order, each with the ndigits of its ``round`` (a list
    for a list of rounds, the text of anything else): the ``row = {...}``
    display and the ``row[key] = ...`` assignments after it."""
    def spec(v):
        if isinstance(v, ast.Call) and ast.unparse(v.func) == "round":
            return v.args[1].value
        if isinstance(v, ast.List):
            return [spec(e) for e in v.elts]
        return "text"

    (display,) = [v for v in _assigned(fn, "row") if isinstance(v, ast.Dict)]
    out = {k.value: spec(v) for k, v in zip(display.keys, display.values)}
    for n in ast.walk(fn):
        if (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
                and ast.unparse(n.targets[0].value) == "row"):
            out[n.targets[0].slice.value] = spec(n.value)
    return out


def test_flags_are_bench_pys():
    jax_flags = {}
    for call in _calls(JAX["main"], "add_argument"):
        kw = _kw(call)
        jax_flags[call.args[0].value] = (
            ast.literal_eval(kw["default"]) if "default" in kw else None,
            ast.unparse(kw["type"]) if "type" in kw else None,
            kw["action"].value if "action" in kw else None)
    ours = {}
    for a in bench._parser()._actions:
        if a.option_strings[0] != "-h":
            ours[a.option_strings[0]] = (
                None if a.const is True else a.default,
                a.type.__name__ if a.type else None,
                "store_true" if a.const is True else None)
    assert ours == jax_flags
    assert list(ours) == ["--quick", "--size", "--spp", "--scaling", "--iters"]


def test_shapes_are_bench_pys():
    (branch,) = [n for n in ast.walk(JAX["main"])
                 if isinstance(n, ast.If) and ast.unparse(n.test) == "args.quick"
                 and isinstance(n.body[0], ast.Assign)
                 and ast.unparse(n.body[0].targets[0]) == "(size, spp, max_bounces, iters)"]

    def shape(st):
        *vals, iters = st.value.elts
        return tuple(ast.literal_eval(v) for v in vals), ast.unparse(iters)

    assert shape(branch.body[0]) == (bench.QUICK, "1")
    assert shape(branch.orelse[0]) == (bench.FULL, "args.iters")
    args = bench._parser().parse_args
    assert bench._shapes(args([])) == (*bench.FULL, 32)
    assert bench._shapes(args(["--quick"])) == (*bench.QUICK, 1)
    assert bench._shapes(args(["--size", "64x48", "--spp", "3", "--iters", "5"])) == (
        (64, 48), 3, 8, 5)
    assert bench._shapes(args(["--quick", "--size", "64x48", "--iters", "5"])) == (
        (64, 48), 2, 4, 1)
    # the scene: basic.toml, the repository's copy
    (load,) = [c for c in _calls(JAX["main"], "load")]
    assert load.args[0].value.endswith("/scenes/basic.toml")
    assert bench.SCENE == SCENES / "basic.toml"


def test_gradient_check_is_bench_pys():
    main = JAX["main"]
    assert [ast.literal_eval(v) for v in _assigned(main, "eps")] == [bench.FD_EPS]
    assert [ast.literal_eval(v) for v in _assigned(main, "name")] == [bench.FD_PARAM]
    assert [ast.literal_eval(v) for v in _assigned(main, "small")] == [bench.FD_SIZE]
    (base,) = _assigned(main, "base_args")
    assert {k: v.value for k, v in _kw(base).items()} == {"spp": bench.FD_SPP,
                                                          "max_bounces": bench.FD_DEPTH}
    (kw,) = _assigned(main, "kw")
    assert _kw(kw)["seed"].value == bench.FD_SEED
    (test,) = [v for v in _assigned(main, "grad_ok") if isinstance(v, ast.Compare)]
    assert ast.unparse(test) == "abs(an - fd) <= max(2e-2 * abs(fd), 1e-4)".replace(
        "2e-2", "0.02").replace("1e-4", "0.0001")
    assert (bench.FD_RTOL, bench.FD_ATOL) == (2e-2, 1e-4)


def test_windows_and_scaling_shapes_are_bench_pys():
    (sus,) = _calls(JAX["main"], "sustained")
    assert ast.unparse(_kw(sus)["windows"]) == "1 if args.quick else 9"
    # the fwd_ref round-robin: the one loop over a constant count of windows
    (loop,) = [n for n in ast.walk(JAX["main"]) if isinstance(n, ast.For)
               and isinstance(n.iter, ast.Call) and ast.unparse(n.iter.func) == "range"
               and isinstance(n.iter.args[0], ast.Constant)]
    assert loop.iter.args[0].value == bench.WINDOWS
    assert [ast.unparse(c) for c in _calls(loop, "append")] == [
        "s_ws.append(_window(lambda i: fwd_bwd(params, i)[1]))", "f_ws.append(_window(_fwd))"]
    sc = JAX["scaling"]
    assert [ast.literal_eval(v) for v in _assigned(sc, "size")] == [bench.SCALING_SIZE]
    assert [ast.literal_eval(v) for v in _assigned(sc, "iters")] == [bench.SCALING_FRAMES]
    assert [ast.unparse(v) for v in _assigned(sc, "spp")] == ["args.spp or 4"]
    (render,) = _calls(sc, "render_image_sharded")
    assert {k: v.value for k, v in _kw(render).items() if k != "spp"} == {
        "max_bounces": bench.SCALING_DEPTH, "ray_chunk": bench.SCALING_CHUNK}
    (note,) = [n.value.value for n in ast.walk(sc) if isinstance(n, ast.Assign)
               and ast.unparse(n.targets[0]) == "row['note']"]
    assert note == bench.SCALING_NOTE


def test_rows_are_bench_pys():
    assert _row(JAX["main"]) == _row(PORT["_measure"]) == {
        "metric": "text", "value": 3, "unit": "text", "vs_baseline": 3, "spread": [1, 1],
        "fwd_ref": 1, "ratio_step_over_fwd": 3}
    assert _row(JAX["scaling"]) == _row(PORT["scaling"]) == {
        "metric": "text", "value": 2, "unit": "text", "vs_baseline": 3, "note": "text"}
    metric = [d.values[0] for d in (_assigned(JAX["main"], "row")[0],
                                    _assigned(PORT["_measure"], "row")[0])]
    assert metric[0].left.value == metric[1].left.value
    metric = [d.values[0] for d in (_assigned(JAX["scaling"], "row")[0],
                                    _assigned(PORT["scaling"], "row")[0])]
    assert ast.unparse(metric[0]) == ast.unparse(metric[1]) == "f'scaling rays/s ({n} devices)'"


# ---- the line at tiny shapes, with stub clocks ----

class Clock:
    """``_measure``'s clocks: each runs its steps once (so every path
    runs) and returns fixed seconds a call."""

    STEP, FWD = 2e-6, 0.5e-6

    def __init__(self):
        self.calls = []

    def sustained(self, step, iters=32, windows=5):
        step(0)
        self.calls.append(("sustained", step, iters, windows))
        return {"median": self.STEP, "min": 0.75 * self.STEP, "max": 1.5 * self.STEP}

    def interleaved(self, steps, iters=32, windows=9):
        outs = [s(0) for s in steps]
        self.calls.append(("interleaved", steps, iters, windows, outs))
        return [{"median": 1.25 * self.STEP}, {"median": self.FWD}]

    def native(self, scene, size, spp, max_bounces):
        self.calls.append(("native", size, spp, max_bounces))
        return NATIVE


TINY = (16, 12)
FD_TINY = (48, 36)  # test_torch_grad_host.py::test_fd_through_the_ports_loss's size


@pytest.mark.parametrize("argv", [[], ["--quick"], ["--size", "64x48", "--spp", "3",
                                                    "--iters", "5"]],
                         ids=["default", "quick", "size-spp-iters"])
def test_the_line(argv, monkeypatch):
    """``bench.main`` with CUDA reported present and the card line stubbed;
    ``_measure`` gets the run's shapes and clocks from main, and measures
    at 16x12, depth 2 (the FD at 48x36) on the CPU with the stub clocks."""
    clock, seen = Clock(), {}
    real = bench._measure

    def measure(scene, size, spp, depth, iters, quick, *, sustained, interleaved, native,
                device):
        assert (sustained, interleaved, native, device) == (
            profiling.sustained, profiling.interleaved, bench.native_baseline, "cuda")
        seen.update(size=size, spp=spp, depth=depth, iters=iters, quick=quick)
        assert scene.spheres.count == 3  # basic.toml
        return real(scene, TINY, spp, 2, iters, quick, sustained=clock.sustained,
                    interleaved=clock.interleaved, native=clock.native, device="cpu",
                    fd_size=FD_TINY)

    printed = io.StringIO()
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "_card_line", lambda: CARD)
    monkeypatch.setattr(bench, "_measure", measure)
    with contextlib.redirect_stdout(printed):
        row = bench.main(argv)
    quick = "--quick" in argv
    want = bench._shapes(bench._parser().parse_args(argv))
    assert (seen["size"], seen["spp"], seen["depth"], seen["iters"], seen["quick"]) == (
        *want, quick)
    spp = seen["spp"]

    # the card line, then the JSON line, last
    lines = printed.getvalue().splitlines()
    assert lines == [CARD, json.dumps(row)]
    assert list(json.loads(lines[-1])) == (KEYS[:5] if quick else KEYS)

    # the rates follow from the stub's seconds, with bench.py's roundings
    def rate(s):
        return TINY[0] * TINY[1] * spp / s / 1e6

    assert row["metric"] == (f"fwd+bwd Mrays/s/chip (basic.toml {TINY[0]}x{TINY[1]} @ "
                             f"{spp}spp, depth 2, grad_ok=True)")
    assert row["value"] == round(rate(Clock.STEP), 3) and row["unit"] == "Mrays/s"
    assert row["vs_baseline"] == round(rate(Clock.STEP) / NATIVE, 3)
    assert row["spread"] == [round(rate(1.5 * Clock.STEP), 1), round(rate(0.75 * Clock.STEP), 1)]
    if not quick:
        assert row["fwd_ref"] == round(rate(Clock.FWD), 1)
        assert row["ratio_step_over_fwd"] == round(1.25 * Clock.STEP / Clock.FWD, 3)

    # what each clock was given: the mono step; the render step beside it
    sus, *rest = clock.calls
    assert sus[0] == "sustained" and sus[1].mode == "mono"
    assert sus[2:] == ((want[3], 1) if quick else (want[3], 9))
    if not quick:
        inter = rest.pop(0)
        assert inter[0] == "interleaved" and inter[1][0] is sus[1] and inter[2:4] == (want[3], 9)
        assert inter[4][1].shape == (TINY[1], TINY[0], 3)  # the forward's frame
    assert rest == [("native", TINY, spp, 2)]


def test_the_jnp_route_line():
    """Past the fused step's 640 primitives the step is the jnp autodiff
    step, with no fwd_ref; the line keeps bench.py's other keys."""
    clock = Clock()
    scene = rt_tpu_torch.scene.make_procedural_scene(700)
    row = bench._measure(scene, (8, 6), 1, 1, 4, False, sustained=clock.sustained,
                         interleaved=clock.interleaved, native=clock.native, device="cpu",
                         fd_size=(8, 6))
    assert list(row) == KEYS[:5] and "grad_ok=True" in row["metric"]
    assert [c[0] for c in clock.calls] == ["sustained", "native"]
    assert not hasattr(clock.calls[0][1], "mode")  # not a kernel step
    loss, grads = clock.calls[0][1](3)
    assert set(grads) == set(bench.diff.extract_params(scene)) and torch.isfinite(loss)


@pytest.mark.parametrize("fused", [True, False], ids=["kernel-route", "jnp-route"])
def test_gradient_check(fused):
    """bench.py's gradient check at 48x36 through the fused step's loss (as
    test_torch_grad_host.py::test_fd_through_the_ports_loss), and at 16x12
    through the jnp integrator's."""
    scene = rt_tpu_torch.load(str(bench.SCENE))
    size = FD_TINY if fused else TINY
    ok, an, fd = bench.grad_check(scene, bench.diff.extract_params(scene), fused, size=size,
                                  device="cpu")
    assert ok is True and abs(an - fd) <= max(2e-2 * abs(fd), 1e-4)
    assert abs(an) > 1e-3


# ---- --scaling in Gloo worlds ----

def test_scaling_ladder():
    """The ladder up to 2 ranks at 32x16, 1 spp, depth 2 (chunks of 128
    rays): one Gloo world a mesh size; each rank's frame is the unsharded
    frame bit for bit, and the rows carry the note and the efficiency."""
    size, chunk = (32, 16), 128
    out = bench.scaling(2, spp=1, device="cpu", size=size, max_bounces=2, ray_chunk=chunk,
                        frames=1)
    want = integrator.render_image(rt_tpu_torch.load(str(bench.SCENE)), size, rng.make_key(0),
                                   spp=1, max_bounces=2, ray_chunk=chunk, device="cpu")
    assert [len(frames) for _, _, frames in out] == [1, 2]
    rates = []
    for n, (row, seconds, frames) in enumerate(out, start=1):
        for f in frames:
            assert torch.equal(f, want)
        rate = size[0] * size[1] / max(seconds) / 1e6
        rates.append(rate)
        assert row == {"metric": f"scaling rays/s ({n} devices)", "value": round(rate, 2),
                       "unit": "Mrays/s", "vs_baseline": round(rate / (rates[0] * n), 3),
                       "note": bench.SCALING_NOTE}
    assert out[0][0]["vs_baseline"] == 1.0


# ---- what raises ----

def test_needs_cuda(capsys):
    for argv in ([], ["--quick"], ["--scaling"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(argv)
    assert capsys.readouterr().out == ""  # no line at all


def test_native_baseline_that_cannot_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_TRIED", True)  # no library loaded...
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")  # ...none built...
    monkeypatch.setenv("CXX", "no-such-c++-compiler")  # ...and none can be
    cache = tmp_path / "cache.json"
    scene = rt_tpu_torch.load(str(bench.SCENE))
    with pytest.raises(RuntimeError, match="compiler"):
        bench.native_baseline(scene, (8, 6), 1, 2, cache=cache)
    assert not cache.exists()


def test_native_baseline_is_bench_pys(monkeypatch, tmp_path):
    """A warm-up at 1 spp, then the timed frame at the run's depth, cached
    under bench.py's WxHxSPPxDEPTH key in the bench table's file."""
    calls = []

    def render_cpu(scene, size, *, spp, max_bounces, personality):
        calls.append((size, spp, max_bounces, personality))
        return None, 0.5

    monkeypatch.setattr(_native, "render_cpu", render_cpu)
    cache = tmp_path / "cache.json"
    scene = rt_tpu_torch.load(str(bench.SCENE))
    got = bench.native_baseline(scene, (80, 60), 4, 8, cache=cache)
    assert got == 80 * 60 * 4 / 0.5 / 1e6
    assert calls == [((80, 60), 1, 8, "mg"), ((80, 60), 4, 8, "mg")]
    assert json.loads(cache.read_text()) == {"host": _native._cpu_model(),
                                             "cfg:80x60x4x8": got}
    assert bench.native_baseline(scene, (80, 60), 4, 8, cache=cache) == got and len(calls) == 2
    assert bench.native_baseline.__defaults__ == (bench_table.NATIVE_CACHE,)
