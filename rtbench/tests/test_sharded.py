"""A cell of several ranks on the CPU: two Gloo ranks through the harness
(rank 0 in this process, rank 1 started by it), the same tiny cell run as
one rank, a rank that fails, the faults such a cell can have, and the
readers of several ranks' traces."""

import contextlib
import functools
import io
import json
import subprocess
import sys
import time
import types

import pytest
import torch

from rtbench import core, ranks
from rtbench.drive import ShardedSteps, Steps
from rtbench.tests.test_control import TRAIN_FAULTS
from rtbench.tests.tiny import ROOT, tiny_root

CELL = "cfg4-proc500.train-x4"
SEED = 2**31 + 77


def two_ranks(tmp_path):
    """The tiny benchmark with the sharded cell cut to two ranks."""
    root = tiny_root(tmp_path)
    path = root / "rtbench" / "traffic" / "train-x4.json"
    traffic = json.loads(path.read_text())
    traffic.update(ranks=2, mesh=[2, 1])
    path.write_text(json.dumps(traffic))
    return root


def run_two(root, seed=SEED, trace=0, entry=None):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = core.run(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], 0.0, root=root, device="cpu", chips_check=False,
                      rank_entry=entry)
    return rc, out.getvalue(), err.getvalue()


def rank_lines(err):
    """``{rank: (units, first losses)}`` from rank 0's log."""
    got = {}
    for line in err.splitlines():
        if line.startswith("rtbench: rank ") and "first losses" in line:
            head, rest = line[len("rtbench: rank "):].split(": ", 1)
            units = int(rest.split()[0])
            losses = json.loads(rest.split("first losses ", 1)[1].split("]", 1)[0] + "]")
            got[int(head)] = (units, losses)
    return got


@pytest.mark.parametrize("trace", [0, 1])
def test_two_ranks_through_the_harness(tmp_path, trace):
    root = two_ranks(tmp_path)
    rc, out, err = run_two(root, trace=trace)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["replica_gap"]["value"] == 0.0
    assert set(res["metrics"]) <= {m["name"] for m in core.cell_metrics(
        core.load_benchmark(root), CELL, "per_layer" if trace else "end_to_end")}
    per_rank = rank_lines(err)
    assert sorted(per_rank) == [0, 1]
    assert per_rank[0][0] == per_rank[1][0] == res["attempted"] > 0
    assert per_rank[0][1] == per_rank[1][1]
    # the one-rank job of the same tiny cell, from the same seed
    bench = core.load_benchmark(root)
    config = core.load_config(root, core.find(bench["configs"], "cfg4-proc500", "configuration"))
    one = Steps(config, core.load_traffic(root, "train"), SEED, torch.device("cpu"))
    one.setup()
    assert per_rank[0][1][0] == one.losses[0]   # the frame is gathered whole: bit for bit
    assert per_rank[0][1] == pytest.approx(one.losses, rel=1e-6, abs=0)


def test_the_window_is_counted_out_in_set_up(tmp_path):
    """Every rank takes the count rank 0 broadcast; the window's steps are
    that count."""
    root = two_ranks(tmp_path)
    rc, _, err = run_two(root, seed=SEED + 1)
    assert rc == 0
    counted = [ln for ln in err.splitlines() if ln.startswith("rtbench: set-up s:")]
    n = int(counted[0].split(" steps timed, ")[1].split(" to the window")[0])
    assert {u for u, _ in rank_lines(err).values()} == {n}


def _failing_rank(how, *args):
    """Rank 1 of a run whose window fails on this rank: it raises, or the
    process dies."""
    def window(self, seconds):
        if how == "raises":
            raise RuntimeError("a fault planted in rank 1")
        import os
        os._exit(9)
    ShardedSteps.window = window
    ranks.rank_main(*args)


@pytest.mark.parametrize("how", ["raises", "dies"])
def test_a_rank_that_fails_ends_the_run(tmp_path, how):
    root = two_ranks(tmp_path)
    code = (f"import sys, functools; sys.path.insert(0, {str(ROOT)!r}); "
            "from pathlib import Path; from rtbench import core; "
            "from rtbench.tests.test_sharded import _failing_rank; "
            f"sys.exit(core.run(['--workload', {CELL!r}, '--seed', '5', '--seconds', '30', "
            f"'--trace', '0'], 0.0, root=Path({str(root)!r}), device='cpu', "
            f"chips_check=False, rank_entry=functools.partial(_failing_rank, {how!r})))")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240)
    took = time.monotonic() - t0
    # rank 0 ends at once: its watch of the ranks, or its collective that
    # lost a peer, ends it well before the program's 60 s timeout
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert took < 90.0
    if how == "raises":
        assert "a fault planted in rank 1" in proc.stderr


def _left_out(mp):
    """The last rank's gradient sums left out of the exchange."""
    import rt_tpu_torch.ops.blockwise_grad as bg

    orig = bg._sum_over

    def fn(axis, acc, _o=orig):
        if axis is not None and axis.rank == axis.size - 1:
            acc = tuple(torch.zeros_like(a) for a in acc)
        return _o(axis, acc)
    mp.setattr(bg, "_sum_over", fn)


def _no_exchange(mp):
    """Each rank steps on its own gradient sums."""
    import rt_tpu_torch.ops.blockwise_grad as bg

    mp.setattr(bg, "_sum_over", lambda axis, acc: acc)


FAULTS = dict(TRAIN_FAULTS, rank_left_out=_left_out, exchange_left_out=_no_exchange)


def _faulty_rank(fault, *args):
    FAULTS[fault](pytest.MonkeyPatch())
    ranks.rank_main(*args)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_sharded_steps_are_not_correct(tmp_path, monkeypatch, fault):
    """The timed path broken underneath, on every rank."""
    FAULTS[fault](monkeypatch)
    rc, out, err = run_two(two_ranks(tmp_path), seed=7,
                           entry=functools.partial(_faulty_rank, fault))
    assert rc == 0, err[-3000:]
    res = json.loads(out.splitlines()[-1])
    assert res["correct"] is False
    if fault == "exchange_left_out":
        assert res["checks"]["replica_gap"]["value"] > 0.0


@pytest.mark.parametrize("fault", ["drop_rank", "no_exchange"])
def test_stand_ins_of_a_lost_exchange_are_not_correct(tmp_path, fault):
    """The reference in the program's place with the last rank's pixels
    missing from the gradient, or with every rank stepping on its own
    pixels' gradient (``python3 -m rtbench.control --fault ...`` at the
    cell's size; here two ranks, as four would leave the last only padding
    at this size)."""
    from rtbench.control import control_checks

    root = two_ranks(tmp_path)
    for seed in (1, 2, 3):
        got = dict((n, (v, lim)) for n, v, lim in control_checks(CELL, seed, root=root,
                                                                 device="cpu", fault=fault))
        assert not all(v <= lim for v, lim in got.values()), got
        assert (got["replica_gap"][0] > 0.0) == (fault == "no_exchange")


def _ev(name, dur, ts=0):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 9}


def _two_rank_ctx():
    """Two ranks over two profiled steps: rank 0 spends 6000 us in the
    program's kernels and 1000 in NCCL's, rank 1 10000 and 3000."""
    r0 = [_ev("void (anonymous namespace)::blockwise_kernel<true, 1>(Args)", 5000),
          _ev("(anonymous namespace)::bw_grad_kernel(Args)", 1000, 5000),
          _ev("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 600, 6000),
          _ev("ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 400,
              6600),
          _ev("void at::native::vectorized_elementwise_kernel<4>(int)", 300, 7000)]
    r1 = [_ev("void (anonymous namespace)::blockwise_kernel<true, 1>(Args)", 9000),
          _ev("(anonymous namespace)::bw_grad_kernel(Args)", 1000, 9000),
          _ev("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 3000, 10000)]
    work = [(0, 33.5e12 * 1e-3)]   # 1 ms of least time a step on each rank
    return types.SimpleNamespace(
        kind="steps", records=[(0.0, 0.001, None), (0.010, 0.012, None)], window_s=0.020,
        events=r0, rank_events=[r0, r1], profiled=2,
        csrc=frozenset({"blockwise_kernel", "bw_grad_kernel"}),
        work=work * 2, rank_work=[work * 2, work * 2])


@pytest.mark.parametrize("metric,want", [
    ("comm_device_ms.train", (1000 + 3000) / 2 / 2 / 1e3),
    ("rank_skew.train", 100.0 * (10000 / 8000 - 1.0)),
    ("kernel_roofline.train", 100.0 * 4.0 / 16.0),   # 4 ms least over 16 ms of own kernels
    ("device_idle.train", 100.0 * (1.0 - 6.3 / 2 / 10.0)),   # rank 0's, NCCL's left out
    ("enqueue_ms.train", 1.5),
])
def test_readers_of_several_ranks(metric, want):
    assert core.load_reader(ROOT, metric)(_two_rank_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["comm_device_ms.train", "rank_skew.train"])
def test_readers_of_several_ranks_find_nothing_in_one(metric):
    ctx = _two_rank_ctx()
    ctx.rank_events = ctx.rank_events[:1]
    assert core.load_reader(ROOT, metric)(ctx) is None
    del ctx.rank_events
    assert core.load_reader(ROOT, metric)(ctx) is None
