"""The harness on the CPU: discovery by name, the statistics, and whole
runs of every cell at a tiny size (the program's plain versions)."""

import contextlib
import io
import json

import pytest

from rtbench import core
from rtbench.tests.tiny import ROOT, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        cfg = core.load_config(ROOT, c)
        assert cfg["name"] == c["name"] and cfg["personality"] == "mg"
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert cfg[key] != cfg["source_values"][key]
    for w in BENCH["workloads"]:
        assert core.load_traffic(ROOT, w["traffic"])["kind"] in ("frames", "steps",
                                                                  "sharded_steps")
        assert core.load_limits(ROOT, w["name"])
    for m in BENCH["per_layer"]:
        assert callable(core.load_reader(ROOT, m["name"]))


def test_cell_metrics():
    for cell in CELLS:
        e2e = {m["name"] for m in core.cell_metrics(BENCH, cell, "end_to_end")}
        layer = core.cell_metrics(BENCH, cell, "per_layer")
        kind = cell.rsplit(".", 1)[1].split("-")[0]   # train-x4: a training cell
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["name"].endswith("." + kind) for m in layer)
        assert all(m["moves"] in e2e for m in layer)


def test_rate_is_all_work_over_the_whole_window():
    # 10 units of 1000 rays in a 2 s window: 5000 rays/s, whatever their spacing
    assert core.rate_mrays(10, 1000, 2.0) == pytest.approx(5000 / 1e6)


def test_p95_is_over_all_values():
    values = list(range(1, 101))
    assert core.p95(values) == 95
    assert core.p95([3.0] * 19 + [100.0]) == 3.0
    assert core.p95([3.0] * 18 + [100.0] * 2) == 100.0
    assert core.p95([7.0]) == 7.0


def test_idle_share():
    assert core.idle_share(19.0, 20.0) == pytest.approx(5.0)
    assert core.idle_share(20.0, 20.0) == 0.0


def test_devtrace_union_and_names():
    from rtbench import devtrace

    ev = [{"cat": "kernel", "name": "void wf_bounce_kernel(Args)", "ts": 0, "dur": 10},
          {"cat": "kernel", "name": "render_kernel(Args, int)", "ts": 5, "dur": 10},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 20, "dur": 2},
          {"cat": "cpu_op", "name": "aten::sort", "ts": 14, "dur": 5}]
    assert devtrace.union_us(devtrace.device_events(ev)) == 17
    assert devtrace.busy_gaps(devtrace.device_events(ev)) == [(15, 20)]
    assert devtrace.kernel_base("void blockwise_record_kernel<1>(Args)") == \
        "blockwise_record_kernel"
    assert devtrace.kernel_base("void (anonymous namespace)::blockwise_kernel<true, 1>(float "
                                "const*, int)") == "blockwise_kernel"
    assert devtrace.kernel_base("(anonymous namespace)::wf_gen_kernel((anonymous namespace)"
                                "::Args)") == "wf_gen_kernel"
    assert devtrace.kernel_base("void at::native::vectorized_elementwise_kernel<4, at::native::"
                                "CUDAFunctor_add<float> >(int)") == "vectorized_elementwise_kernel"
    assert devtrace.kernel_base("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    names = devtrace.csrc_kernels()
    assert {"render_kernel", "blockwise_kernel", "wf_bounce_kernel", "bw_grad_kernel",
            "wf_rev_kernel", "blockwise_record_kernel"} <= names
    b = devtrace.breakdown(ev)
    assert b["device_ops"][0][0] == "void wf_bounce_kernel(Args)"
    assert b["idle_gaps"] == [["aten::sort", pytest.approx(5e-6)]]


def test_readers_on_a_made_up_trace():
    import types

    ctx = types.SimpleNamespace(
        kind="frames", records=[(0.0, 0.001, 0.010), (0.010, 0.012, 0.020)], window_s=0.020,
        events=[{"cat": "kernel", "name": "render_kernel(Args)", "ts": 0, "dur": 8000},
                {"cat": "kernel", "name": "elementwise_kernel", "ts": 8000, "dur": 1000}],
        profiled=1, csrc=frozenset({"render_kernel"}), work=[(0, 33.5e12 * 4e-3)])
    get = {m: core.load_reader(ROOT, m)(ctx) for m in
           ("enqueue_ms.serve", "glue_device_ms.serve", "kernel_roofline.serve",
            "device_idle.serve", "enqueue_ms.train")}
    assert get["enqueue_ms.serve"] == pytest.approx(1.5)
    assert get["glue_device_ms.serve"] == pytest.approx(1.0)
    assert get["kernel_roofline.serve"] == pytest.approx(50.0)
    assert get["device_idle.serve"] == pytest.approx(10.0)
    assert get["enqueue_ms.train"] is None


def run_cell(root, cell, seed, trace=0, seconds=0.5):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = core.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], 0.0, root=root, device="cpu",
                      chips_check=False)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_prints_the_result_last(tmp_path, cell, trace):
    root = tiny_root(tmp_path)
    rc, out, err = run_cell(root, cell, 2**31 + 5, trace)
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in core.cell_metrics(BENCH, cell,
                                                 "per_layer" if trace else "end_to_end")}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in last] == list(res["checks"])


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = core.run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], 0.0,
                      root=tiny_root(tmp_path))
    assert rc != 0 and out.getvalue() == ""


def test_same_seed_same_work():
    from rtbench import inputs

    def first(seed, n):
        stream = inputs.SeedStream(seed)
        return [next(stream) for _ in range(n)]

    assert first(2**31 + 9, 50) == first(2**31 + 9, 50)
    assert first(1, 50) != first(2, 50)
    got = first(3, 10_000)
    assert len(set(got)) == 10_000 and all(0 <= s < 2**31 for s in got)


def test_jax_loaded_after_the_window_means_no_result(tmp_path, monkeypatch):
    import types as _types

    monkeypatch.setitem(__import__("sys").modules, "jax", _types.ModuleType("jax"))
    rc, out, err = run_cell(tiny_root(tmp_path), CELLS[2], 3)
    assert rc != 0 and out == "" and "jax" in err


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil
    import subprocess
    import sys

    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; from pathlib import Path; sys.path.insert(0, '.'); "
            "from rtbench import core; sys.exit(core.run(['--workload', 'cfg4-proc500.serve', "
            "'--seed', '1', '--seconds', '1'], 0.0, root=Path('.'), device='cpu', "
            "chips_check=False))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "rt_tpu_torch" in proc.stderr


def test_a_gap_that_is_not_a_number_fails():
    from rtbench.drive import _worst

    assert _worst([1e-7, float("nan"), 2e-7]) == float("inf")
    assert _worst([]) == float("inf")
    assert _worst([1e-7, 3e-7]) == 3e-7
