"""The check fails what it must: the control (the reference in bfloat16 in
the program's place) and runs whose timed path is broken underneath, on
the CPU at a tiny size.  The control's readings at the cells' own sizes
come from ``python3 -m rtbench.control`` on the card."""

import json

import pytest
import torch

from rtbench.control import control_checks
from rtbench.tests.test_harness import CELLS, run_cell
from rtbench.tests.tiny import tiny_root

WAVEFRONT = {"cfg5-proc5000": 1600}   # past both routers' thresholds


@pytest.mark.parametrize("fault", ["control", "half_batch", "altered", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_stand_ins_are_not_correct(tmp_path, cell, fault):
    """The control and the planted faults, in the program's place."""
    root = tiny_root(tmp_path, WAVEFRONT)
    plan = "chunked" if cell == "cfg5-proc5000.train" else "per_sample"
    for seed in (1, 2, 3):
        got = control_checks(cell, seed, root=root, device="cpu", fault=fault, plan=plan)
        assert not all(v <= lim for _, v, lim in got), got


def _stale(orig):
    first = {}

    def fn(*a, **k):
        out = orig(*a, **k)
        return first.setdefault("frame", out)
    return fn


def _half_samples(orig):
    def fn(launch, cam, seed, spp, *a, **k):
        return orig(launch, cam, seed, max(1, spp // 2), *a, **k)
    return fn


def _altered(orig):
    def fn(*a, **k):
        return orig(*a, **k) * 1.01
    return fn


SERVE_FAULTS = {"state_unchanged": _stale, "half_the_batch": _half_samples,
                "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".serve")])
def test_broken_frames_are_not_correct(tmp_path, monkeypatch, cell, fault):
    import rt_tpu_torch.ops.render as render
    import rt_tpu_torch.ops.wavefront as wavefront

    for mod in (render, wavefront):
        if hasattr(mod, "_chunked_frame"):
            monkeypatch.setattr(mod, "_chunked_frame", SERVE_FAULTS[fault](mod._chunked_frame))
    rc, out, _ = run_cell(tiny_root(tmp_path, WAVEFRONT), cell, 7)
    assert rc == 0 and json.loads(out.splitlines()[-1])["correct"] is False


def _no_update(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    import rt_tpu_torch.ops.blockwise_grad as bg
    import rt_tpu_torch.ops.wavefront_grad as wg

    for mod, name in ((bg, "_bw_pipeline"), (wg, "_wf_pipeline")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, spp, **k: _o(*a, spp=max(1, spp // 2),
                                                                          **k))


def _gradient_altered(monkeypatch):
    import rt_tpu_torch.ops.blockwise_grad as bg
    import rt_tpu_torch.ops.wavefront_grad as wg

    for mod in (bg, wg):
        orig = mod._assemble_grads

        def fn(*a, _o=orig, **k):
            g = _o(*a, **k)
            g["materials.albedo"] = g["materials.albedo"] * 1.5
            return g
        monkeypatch.setattr(mod, "_assemble_grads", fn)


TRAIN_FAULTS = {"state_unchanged": _no_update, "half_the_batch": _half_batch,
                "answer_altered": _gradient_altered}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".train")])
def test_broken_steps_are_not_correct(tmp_path, monkeypatch, cell, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    rc, out, _ = run_cell(tiny_root(tmp_path, WAVEFRONT), cell, 7)
    assert rc == 0 and json.loads(out.splitlines()[-1])["correct"] is False
