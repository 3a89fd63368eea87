"""tpu_pruner_torch.obs: the port's spans and counters, and the readers of
``port_bench/metrics`` that read them.

On the CPU but the tests marked ``gpu``, which skip without a CUDA device.
This file imports no JAX, so it also runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_obs.py
"""

import contextlib
import io
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.cell import load_module
from port_bench.run import Run
from tpu_pruner_torch import analyze, obs
from tpu_pruner_torch import policy as tp

ROOT = Path(__file__).resolve().parents[1]
MAIN_CHILDREN = ("analyze.parse", "analyze.load_fleet", "analyze.release", "analyze.evaluate",
                 "analyze.report")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def off():
    """One span with no profiler running, which ends any session."""
    with obs.span("off"):
        pass


@contextlib.contextmanager
def profiled(cuda=False):
    off()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof


def write_dump(path, chips=64, samples=8, seed=0):
    rng = np.random.default_rng(seed)
    doc = {"lookback_s": 2100, "hbm_threshold": 0.05, "chips": [
        {"slice": f"ns/s{i // 4:05d}", "id": f"ns/p{i}/0", "pod_age_s": 7200.0,
         "tc": ([0.0] * samples if (i // 4) % 2 else rng.uniform(0, 1, samples).tolist()),
         "hbm": [0.0] * samples} for i in range(chips)]}
    path.write_text(json.dumps(doc))
    return path


def audit(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert analyze.main(argv) == 0
    return out.getvalue(), err.getvalue()


def test_off_span_is_the_shared_noop_and_records_nothing():
    off()
    before = obs.summary()
    span = obs.span("engine.upload")
    assert span is obs._NOOP and obs.span("x") is span
    with span:
        pass
    tp.slice_bounds(np.array([0, 0, 1], dtype=np.int32), 2, device="cpu")
    assert obs.summary() == before


def test_profiled_audit_nests_its_spans_under_main_on_the_profilers_clock(tmp_path):
    dump = str(write_dump(tmp_path / "d.json", chips=512))
    audit([dump, "--device", "cpu"])  # imports the engine outside the profile
    with profiled() as prof:
        audit([dump, "--device", "cpu"])
    events = [e for e in prof.events() if e.name.startswith("tp.analyze.")]
    assert {e.name for e in events} == {"tp.analyze.main"} | {"tp." + n for n in MAIN_CHILDREN}
    assert not any(e.is_user_annotation for e in events)
    for e in events:
        if e.name != "tp.analyze.main":
            assert e.cpu_parent is not None and e.cpu_parent.name == "tp.analyze.main", e.name

    recs = obs.records()
    main = [i for i, r in enumerate(recs) if r[0] == "analyze.main"]
    assert len(main) == 1 and recs[main[0]][3] == -1
    for name in MAIN_CHILDREN:
        assert [r[3] for r in recs if r[0] == name] == main, name
    assert {r[0] for r in recs if r[3] != -1 and recs[r[3]][0] == "analyze.evaluate"} == {
        "engine.upload", "engine.bounds", "engine.evaluate"}

    spans = obs.summary()["spans"]
    for e in events:
        name = e.name[len(obs.PREFIX):]
        want_ms = e.time_range.elapsed_us() / 1e3
        got_ms = spans[name]["total_ms"]
        assert abs(got_ms - want_ms) <= max(0.1 * want_ms, 0.05), (name, got_ms, want_ms)
    main_ms = spans["analyze.main"]
    assert main_ms["self_ms"] == pytest.approx(
        main_ms["total_ms"] - sum(spans[n]["total_ms"] for n in MAIN_CHILDREN))


def test_a_new_profiler_session_clears_the_last_sessions_records():
    with profiled():
        with obs.span("first"):
            pass
    assert [r[0] for r in obs.records()] == ["first"]
    with profiled():
        with obs.span("second"):
            with obs.span("third"):
                pass
    assert [r[:1] + r[3:] for r in obs.records()] == [("second", -1), ("third", 0)]
    assert set(obs.summary()["spans"]) == {"second", "third"}


def test_records_stop_at_the_cap_and_the_totals_go_on():
    extra = 7
    with profiled():
        for _ in range(obs.CAP + extra):
            with obs.span("many"):
                pass
    summ = obs.summary()
    assert summ["records"] == len(obs.records()) == obs.CAP
    assert summ["dropped"] == extra
    assert summ["spans"]["many"]["count"] == obs.CAP + extra


def test_a_span_never_opens_inside_a_span_of_its_own_name():
    C, K = 64, 4
    ring = tp.init_window(C, K, device="cpu")
    age = torch.full((C,), 7200.0)
    bounds = tp.slice_bounds(np.repeat(np.arange(16, dtype=np.int32), 4), 16, device="cpu")
    params_q = torch.tensor([2100.0, 5.0])
    with profiled() as prof:
        with obs.span("outer"):
            assert obs.span("outer") is obs._NOOP
        tp.evaluate_window_qc(ring, age, bounds, params_q)  # calls evaluate_fleet_qc
    assert obs.summary()["spans"]["engine.evaluate"]["count"] == 1
    assert obs.summary()["spans"]["outer"]["count"] == 1
    assert sum(e.name == "tp.engine.evaluate" for e in prof.events()) == 1


def cycle_inputs(C=131072, T=6, S=8192, seed=1):
    rng = np.random.default_rng(seed)
    tc = rng.uniform(0, 1, (C, T)).astype(np.float32)
    hbm = rng.uniform(0, 1, (C, T)).astype(np.float32)
    valid = rng.uniform(0, 1, (C, T)) > 0.1
    age = rng.uniform(0, 9000, C).astype(np.float32)
    slice_id = np.repeat(np.arange(S, dtype=np.int32), C // S)
    parr = np.array([2100.0, 0.05], dtype=np.float32)
    return tc, hbm, valid, age, slice_id, parr


def test_counters_add_each_copys_bytes_with_meta_standing_in_for_the_card():
    inputs = cycle_inputs()  # the stream cell's shapes: 131,072 chips, 6 samples
    before = dict(obs.counts)
    tensors = tp.fleet_from_numpy(inputs, device="meta")
    assert all(t.device.type == "meta" for t in tensors)
    assert obs.counts["h2d_bytes"] - before["h2d_bytes"] == 8_126_472
    tp.slice_bounds(inputs[4], 8192, device="meta")
    assert obs.counts["h2d_bytes"] - before["h2d_bytes"] == 8_159_244  # h2d_mb.cycle
    assert obs.counts["d2h_bytes"] == before["d2h_bytes"]
    assert obs.counts["host_syncs"] == before["host_syncs"]

    at = dict(obs.counts)
    tp.fleet_from_numpy(inputs, device="cpu")  # stays on the host: nothing counts
    state = tp.window_from_numpy((np.zeros((16, 3), np.int8), np.zeros((16, 3), np.int8), 1),
                                 device="cpu")
    tp.update_window_(state, torch.zeros((16, 2), dtype=torch.int8),
                      torch.zeros((16, 2), dtype=torch.int8))
    obs.to_host(torch.zeros(5))
    assert obs.counts == at

    tp.window_from_numpy((np.zeros((16, 3), np.int8), np.zeros((16, 3), np.int8), 1),
                         device="meta")
    assert obs.counts["h2d_bytes"] - at["h2d_bytes"] == 2 * 48 + 4


class _OnTheCard:
    """A device tensor as ``to_host`` sees it, without a card."""

    is_cpu = False
    nbytes = 131072

    def cpu(self):
        return "copied"


def test_to_host_counts_a_device_tensors_bytes_and_one_sync():
    before = dict(obs.counts)
    assert obs.to_host(_OnTheCard()) == "copied"
    assert obs.counts["d2h_bytes"] - before["d2h_bytes"] == 131072
    assert obs.counts["host_syncs"] - before["host_syncs"] == 1
    assert obs.counts["h2d_bytes"] == before["h2d_bytes"]


def test_summary_reports_counter_growth_and_the_kernels_launches():
    from tpu_pruner_torch.policy import kernels

    try:
        with profiled():
            with obs.span("x"):
                tp.fleet_from_numpy(cycle_inputs(C=1024, S=64), device="meta")
                kernels.LAUNCHES["slice_gate"] += 2
        off()  # ends the session: its counters stop there
        obs.count("h2d_bytes", 10)
    finally:
        kernels.LAUNCHES["slice_gate"] -= 2
    counters = obs.summary()["counters"]
    assert counters["h2d_bytes"] == 1024 * 6 * 9 + 1024 * 8 + 8
    assert counters["launches.slice_gate"] == 2
    assert counters["d2h_bytes"] == counters["host_syncs"] == 0
    assert {"launches.chip_pass", "launches.slice_scatter", "design_launches.rows",
            "f32_design_launches.long"} <= set(counters)


def test_profile_option_writes_the_trace_and_the_summary(tmp_path):
    dump = str(write_dump(tmp_path / "d.json"))
    plain_out, _ = audit([dump, "--device", "cpu"])
    trace = tmp_path / "trace.json"
    out, err = audit([dump, "--device", "cpu", "--profile", str(trace)])
    assert out == plain_out
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"tp.analyze.main", "tp.analyze.parse", "tp.engine.evaluate"} <= names
    summary = err[err.index("span "):].splitlines()
    rows = {line.split()[0]: line.split()[1:] for line in summary[1:]
            if not line.startswith("counters")}
    assert set(MAIN_CHILDREN) | {"analyze.main"} <= set(rows)
    assert rows["analyze.main"][0] == "1"
    assert float(rows["analyze.main"][1]) >= float(rows["analyze.parse"][1])
    assert any(line.startswith("counters: h2d_bytes 0") for line in summary)
    assert "device idle" not in err  # on the card only


def test_idle_by_span_gives_each_part_of_a_gap_to_the_innermost_span():
    spans = [("main", 0.0, 10.0), ("parse", 1.0, 4.0), ("evaluate", 5.0, 8.0),
             ("upload", 5.0, 6.0), ("after", 11.0, 12.0)]
    # names out of time order, and an operation inside another
    device = [("kernel", 5.5, 6.5), ("copy", 7.0, 7.5), ("before", -1.0, 0.5),
              ("inner", 7.1, 7.2), ("another", 1.5, 1.75)]
    window, idle = obs.idle_by_span(spans, device)
    assert window == 12.0
    assert idle == pytest.approx({"main": 0.5 + 1.0 + 2.0, "parse": 2.75, "upload": 0.5,
                                  "evaluate": 0.5 + 0.5, obs.OUTSIDE: 1.0, "after": 1.0})
    assert obs.idle_by_span([], device) == (0.0, {})


def read(metric, run):
    path = ROOT / "port_bench" / "metrics" / f"{metric}.py"
    return load_module(path, f"obs_test_{metric}").read(run)


def test_the_benchmarks_readers_read_the_session(tmp_path, monkeypatch):
    dump = str(write_dump(tmp_path / "d.json"))
    with profiled():
        for _ in range(2):
            audit([dump, "--device", "cpu"])
        tp.fleet_from_numpy(cycle_inputs(C=1024, S=64), device="meta")
    spans = obs.summary()["spans"]
    run = Run("x", object(), 4, {}, {})
    assert read("parse_ms.audit", run) == pytest.approx(spans["analyze.parse"]["total_ms"] / 2)
    assert read("report_ms.audit", run) == pytest.approx(spans["analyze.report"]["total_ms"] / 2)
    assert read("bounds_ms.cycle", run) == pytest.approx(spans["engine.bounds"]["total_ms"] / 4)
    assert read("evaluate_host_ms.eval", run) == pytest.approx(
        spans["engine.evaluate"]["total_ms"] / 4)
    assert read("h2d_mb.cycle", run) == pytest.approx((1024 * 6 * 9 + 1024 * 8 + 8) / 4 / 1e6)
    for metric in ("parse_ms.audit", "report_ms.audit", "h2d_mb.cycle", "bounds_ms.cycle",
                   "evaluate_host_ms.eval"):
        assert read(metric, Run("x", None, 0, {}, {})) is None
        with monkeypatch.context() as m:  # a program without obs, as the parent's
            m.setitem(sys.modules, "tpu_pruner_torch.obs", None)
            assert read(metric, run) is None


# --- on the card --------------------------------------------------------------


def stream_cycle(inputs, ring, dev):
    tc, hbm, valid, age, slice_id, parr = inputs
    tc_t, hbm_t, valid_t, age_t, _, parr_t = tp.fleet_from_numpy(inputs, dev)
    ring = tp.update_window_(ring, tp.quantize_samples_device(tc_t, valid_t),
                             tp.quantize_samples_device(hbm_t, valid_t))
    parr_q = torch.from_numpy(tp.quantize_params(parr_t)).to(dev)
    bounds = tp.slice_bounds(slice_id, 8192, device=dev)
    verdicts, candidates = tp.evaluate_window_qc(ring, age_t, bounds, parr_q)
    verdicts.cpu(), candidates.cpu()
    return ring


@pytest.mark.gpu
def test_spans_put_no_operation_on_the_card(cuda, monkeypatch):
    from port_bench.trace import trace_window

    inputs = cycle_inputs()
    ring = tp.init_window(131072, 12, device=cuda)
    for _ in range(3):
        ring = stream_cycle(inputs, ring, cuda)

    def ops():
        off()
        trace = trace_window(lambda: stream_cycle(inputs, ring, cuda), cuda)
        return Counter(name for name, _, _ in trace.device)

    recording = ops()
    assert obs.summary()["spans"]["engine.upload"]["count"] == 1
    assert not any(name.startswith(obs.PREFIX) for name in recording)
    with monkeypatch.context() as m:
        m.setattr(obs, "span", lambda name: obs._NOOP)
        stubbed = ops()
    assert recording == stubbed and sum(recording.values()) > 20


@pytest.mark.gpu
def test_leaf_spans_of_main_hold_the_idle_time_of_a_profiled_audit(cuda, tmp_path):
    dump = str(write_dump(tmp_path / "d.json", chips=32768))
    audit([dump])
    with profiled(cuda=True) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        audit([dump])
        torch.cuda.synchronize()
    window, idle = obs.idle_by_span(*obs.profiler_spans(prof.events()))
    recs = obs.records()
    parents = {recs[r[3]][0] for r in recs if r[3] >= 0}
    leaves = {r[0] for r in recs} - parents
    assert {"analyze.parse", "analyze.load_fleet", "analyze.release", "analyze.report"} <= leaves
    total = sum(idle.values())
    assert 0 < total <= window
    assert sum(idle.get(n, 0.0) for n in leaves) >= 0.95 * total, idle
