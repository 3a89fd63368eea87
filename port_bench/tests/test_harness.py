"""The harness on the CPU at tiny sizes: it runs every cell's driver, its
comparison passes the port and fails the port broken underneath, nothing it
loads is JAX, and without a card it prints no result."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_pruner_torch.policy as tp
from port_bench import run
from port_bench.cell import load_bench
from tpu_pruner_torch import analyze

ROOT = Path(__file__).resolve().parents[2]
TINY = {"chips": 1024, "slices": 64, "window_samples": 8, "window_chunks": 12,
        "chunk_samples": 6, "cycle_s": 180, "lookback_s": 2100, "hbm_threshold": 0.05}
CELLS = [w["name"] for w in load_bench(ROOT)["workloads"]]


def tiny(workload, scale=1):
    cfg = dict(TINY, chips=TINY["chips"] * scale, slices=TINY["slices"] * scale)
    if workload.startswith("eval"):
        cfg["window_samples"] = 40
    return cfg


def run_tiny(workload, seed=2**31 + 11, seconds=0.3, trace=False):
    return run.run(workload, seed, seconds, trace, device="cpu", config=tiny(workload))[0]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu(workload):
    result = run_tiny(workload)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "compared"}
    assert list(result)[-1] == "compared"
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_on_the_cpu_reports_only_what_it_read(workload):
    result = run_tiny(workload, trace=True)
    assert result["correct"]
    bench = load_bench(ROOT)
    per_layer = {m["name"] for m in bench["per_layer"]}
    assert set(result["metrics"]) <= per_layer  # no device metric without a card
    for name, metric in result["metrics"].items():
        assert metric["value"] > 0, name


def _half_out_stream(orig):
    def fault(state, age, bounds, params_q):
        _, candidate = orig(state, age, bounds, params_q)
        candidate = candidate.clone()
        candidate[candidate.shape[0] // 2:] = False
        return tp.slice_verdicts_contiguous(candidate, bounds), candidate
    return fault


def _altered(orig):
    def fault(*args, **kwargs):
        verdicts, candidate = orig(*args, **kwargs)
        verdicts = verdicts.clone()
        verdicts[0] = ~verdicts[0]
        return verdicts, candidate
    return fault


def _half_out_eval(orig):
    def fault(tc_q, hbm_q, age, bounds, params_q):
        _, candidate = orig(tc_q, hbm_q, age, bounds, params_q)
        candidate = candidate.clone()
        candidate[candidate.shape[0] // 2:] = False
        return tp.slice_verdicts_contiguous(candidate, bounds), candidate
    return fault


def _half_out_audit(orig):
    def fault(fleet, num_slices, params, **kwargs):
        tc, hbm, valid, age, slice_id = fleet
        valid = valid.copy()
        valid[len(slice_id) // 2:] = False
        return orig((tc, hbm, valid, age, slice_id), num_slices, params, **kwargs)
    return fault


def _altered_audit(orig):
    def fault(*args, **kwargs):
        verdicts, candidates = orig(*args, **kwargs)
        verdicts = verdicts.copy()
        verdicts[0] = ~verdicts[0]
        return verdicts, candidates
    return fault


# (cell prefix, module, attribute, fault); one chip, so no exchange to leave out
FAULTS = [
    ("stream", tp, "update_window_", lambda orig: lambda state, a, b: state),
    ("stream", tp, "evaluate_window_qc", _half_out_stream),
    ("stream", tp, "evaluate_window_qc", _altered),
    ("eval", tp, "evaluate_fleet_qc", _half_out_eval),
    ("eval", tp, "evaluate_fleet_qc", _altered),
    ("audit", analyze, "evaluate_loaded", _half_out_audit),
    ("audit", analyze, "evaluate_loaded", _altered_audit),
]


@pytest.mark.parametrize("workload, module, attr, fault", [
    (w, m, a, f) for w in CELLS for p, m, a, f in FAULTS if w.startswith(p)],
    ids=lambda x: getattr(x, "__name__", str(x)))
def test_broken_program_is_not_correct(monkeypatch, workload, module, attr, fault):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    result = run_tiny(workload)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["compared"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    from port_bench.control import readings
    r = readings(workload, 5, 0.2, True, device="cpu", config=tiny(workload, scale=8))
    assert not any(r["program"].values())
    assert any(r["control"].values())


def test_no_harness_module_loads_jax():
    modules = ["port_bench.run", "port_bench.control", "port_bench.cell", "port_bench.gen",
               "port_bench.work", "port_bench.trace", "port_bench.check",
               "port_bench.dumpfile", "port_bench.reference.fleet"]
    code = ("import sys, importlib; from pathlib import Path\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "from port_bench.cell import load_module\n"
            "for p in sorted(Path('port_bench').glob('*/*.py')):\n"
            "    if p.parent.name in ('drivers', 'metrics'): load_module(p, 'm_' + p.stem)\n"
            "from port_bench.run import forbidden_modules\n"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_pruner_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert run.forbidden_modules() == ["jaxlib"]


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card_at_a_tiny_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = run.run(workload, 3, 0.3, False, device="cuda", config=tiny(workload))[0]
    assert result["correct"], json.dumps(result["compared"])
    traced = run.run(workload, 4, 0.3, True, device="cuda", config=tiny(workload))[0]
    assert traced["correct"] and traced["device"]["busy_s"] > 0
    assert np.isfinite([m["value"] for m in traced["metrics"].values()]).all()
