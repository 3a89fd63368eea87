"""Finding a cell's parts by name: BENCHMARK.json, then its files.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file, and a traffic mix, ``<paths[0]>/traffic/<traffic>.json``,
which names its driver, ``<paths[0]>/drivers/<driver>.py``. A per-layer metric
is read by ``<paths[0]>/metrics/<name>.py``. Nothing here lists a cell, a
mix or a metric: adding one is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

from port_bench.trace import Spans


@dataclass
class Ctx:
    """What a driver is built from."""

    workload: str
    config: dict
    mix: dict
    seed: int
    device: torch.device
    workdir: Path  # a fixed directory inside the checkout for the run's files
    spans: Spans = field(default_factory=Spans)


@dataclass
class Cell:
    base: Path  # the benchmark's directory: <root>/<paths[0]>
    entry: dict
    config: dict
    mix: dict
    driver_path: Path
    end_to_end: list  # the BENCHMARK.json entries of the cell's metrics
    per_layer: list

    def reader_path(self, metric: str) -> Path:
        return self.base / "metrics" / f"{metric}.py"

    def driver(self, ctx: Ctx):
        """The cell's driver, built (its inputs made) from ``ctx``."""
        return load_module(self.driver_path, f"port_bench_driver_{self.mix['driver']}").Driver(ctx)


def load_bench(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether a metric is reported in a cell: listed there, or, without a
    list, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(root: Path, workload: str) -> Cell:
    bench = load_bench(root)
    entry = _named(bench["workloads"], workload, "workload")
    config_entry = _named(bench["configs"], entry["config"], "configuration")
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    base = root / bench["paths"][0]
    with open(base / "traffic" / f"{entry['traffic']}.json") as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, workload, names)]
    return Cell(base, entry, config, mix, base / "drivers" / f"{mix['driver']}.py",
                e2e, per_layer)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
