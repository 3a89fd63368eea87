"""The trace's arithmetic on a hand-built window, and the metric readers."""

from pathlib import Path

import pytest

from port_bench import work
from port_bench.cell import load_module
from port_bench.run import Run
from port_bench.trace import Trace, breakdown, busy_s, device_seconds, idle_gaps

METRICS = Path(__file__).resolve().parents[1] / "metrics"

# a window of 10 s: two cycles; spans main > load (nested) and upload
TRACE = Trace(
    window=(0.0, 10.0),
    device=[("Memcpy HtoD (Pageable -> Device)", 1.0, 2.0), ("kernel_a", 1.5, 3.0),
            ("kernel_b", 6.0, 6.5), ("Memset (Device)", 6.5, 7.0)],
    spans=[("main", 0.0, 5.0), ("load", 3.0, 4.0), ("upload", 5.0, 8.0)])


def test_busy_and_gaps():
    assert busy_s(TRACE) == pytest.approx(3.0)
    assert idle_gaps(TRACE) == [(0.0, 1.0), (3.0, 6.0), (7.0, 10.0)]


def test_device_seconds_by_kind():
    assert device_seconds(TRACE, "kernels") == pytest.approx(2.0)
    assert device_seconds(TRACE, "h2d") == pytest.approx(1.0)
    assert device_seconds(TRACE, "all") == pytest.approx(3.5)


def test_breakdown_gives_each_part_of_a_gap_to_the_innermost_span():
    out = breakdown(TRACE)
    gaps = dict((k, pytest.approx(v)) for k, v in out["idle_gaps"])
    assert gaps == {"main": 2.0, "load": 1.0, "upload": 2.0, "harness": 2.0}
    assert out["device_ops"][0] == ["kernel_a", pytest.approx(1.5)]


def read(metric, view):
    return load_module(METRICS / f"{metric}.py", f"m_{metric}").read(view)


def test_readers_on_the_hand_built_trace():
    shape = {"chips": 1000, "new_samples": 6, "chunks": 12, "slices": 10, "samples": 360}
    view = Run("x", TRACE, 2, {"load_fleet": [0.5, 1.5]}, shape)
    assert read("h2d_ms.cycle", view) == pytest.approx(500.0)
    assert read("device_ops.cycle", view) == pytest.approx(2.0)
    assert read("idle_pct.cycle", view) == pytest.approx(70.0)
    assert read("ingest_ms.audit", view) == pytest.approx(1000.0)
    assert read("evaluate_ms.audit", view) is None
    assert read("cycle_roofline", view) == pytest.approx(
        work.cycle_bytes(1000, 6, 12, 10) / work.HBM_BYTES_PER_S / 1.0 * 100)
    assert read("eval_roofline", view) == pytest.approx(
        work.eval_qc_bytes(1000, 360, 10) / work.HBM_BYTES_PER_S / 1.0 * 100)


def test_readers_find_nothing_without_a_trace():
    view = Run("x", None, 0, {}, {})
    for path in sorted(METRICS.glob("*.py")):
        assert read(path.stem, view) is None, path.stem


def test_logical_bytes_of_the_main_shapes():
    assert work.cycle_bytes(131072, 6, 12, 8192) == 11_182_092
    assert work.eval_qc_bytes(1048576, 360, 65536) == 760_545_292
