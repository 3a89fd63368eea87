"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell's parts by name alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench import run
from port_bench.cell import load_bench, load_cell

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_.\-/]+$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def bench():
    return load_bench(ROOT)


def line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text \
        and "\t" not in text


def test_top_level_and_entry_keys(bench):
    assert set(bench) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for kind, entries in (("config", bench["configs"]), ("workload", bench["workloads"]),
                          ("end_to_end", bench["end_to_end"]),
                          ("per_layer", bench["per_layer"])):
        for entry in entries:
            assert set(entry) <= KEYS[kind], entry
            assert set(entry) >= KEYS[kind] - {"workloads"}, entry


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert len(path) <= 200 and FILE.match(path) and ".." not in path.split("/")
        assert not path.startswith("/") and (ROOT / path).is_dir()
        assert not path.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    for path in bench["paths"]:
        for f in (ROOT / path).rglob("*"):
            if "__pycache__" not in f.parts:
                assert FILE.match(str(f.relative_to(ROOT))), f


def test_names_units_and_choices(bench):
    every = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["per_layer"]:
        assert line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_end_to_end_bounds(bench):
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in bench["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_configs_and_cells(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    assert 1 <= len(cells) <= 24 and 1 <= len(bench["configs"]) <= 24
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for config in bench["configs"]:
        assert line(config["source"]) and line(config["why"])
        assert any(config["file"].startswith(p + "/") for p in bench["paths"])
        assert (ROOT / config["file"]).is_file()
        assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
        assert any(w["config"] == config["name"] for w in cells.values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in cells.values())
    assert four <= max(1, len(cells) // 4)
    for w in cells.values():
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in {c["name"] for c in bench["configs"]}


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for name in cells:
        cell = load_cell(ROOT, name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, name
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in reported, (name, m["name"])
            assert cell.reader_path(m["name"]).is_file()
        assert cell.driver_path.is_file()
        assert reported - {"setup_s"} <= set(cell.mix["end_to_end"])


def test_run_seconds_fits_a_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_new_config_mix_and_metric_are_found_as_new_files(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with their entries, in a copy: the harness runs the new cell and reads
    the new metric, and no file that was there changed."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}

    base = tmp_path / "port_bench"
    (base / "configs" / "fleet-tiny.json").write_text(json.dumps({
        "chips": 2048, "slices": 64, "window_samples": 8, "window_chunks": 6,
        "chunk_samples": 4, "cycle_s": 120, "lookback_s": 1800, "hbm_threshold": 0.1,
        "reduced": [], "assumed": {}}))
    mix = json.loads((base / "traffic" / "stream-k12.json").read_text())
    mix.update(flip_share=0.1, pool_chunks=8, warmup_ops=4)
    (base / "traffic" / "stream-churn.json").write_text(json.dumps(mix))
    (base / "metrics" / "traced_ops.cycle.py").write_text(
        "def read(run):\n    return run.ops or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fleet-tiny", "source": "https://example.org/tiny",
                             "file": "port_bench/configs/fleet-tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "stream-tiny-churn", "config": "fleet-tiny",
                               "traffic": "stream-churn", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("cycle"):
            m["workloads"].append("stream-tiny-churn")
    bench["per_layer"].append({"name": "traced_ops.cycle", "unit": "ops", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "cycle_ms", "workloads": ["stream-tiny-churn"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result, _ = run.run("stream-tiny-churn", 99, 0.2, False, device="cpu", root=tmp_path)
    assert result["correct"] and {"setup_s", "cycle_ms", "cycle_p95_ms"} == set(result["metrics"])
    traced, _ = run.run("stream-tiny-churn", 98, 0.2, True, device="cpu", root=tmp_path)
    assert traced["correct"] and traced["metrics"]["traced_ops.cycle"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
