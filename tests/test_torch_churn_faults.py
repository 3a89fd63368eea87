"""The cell ``stream-260k-churn-k12`` with the program broken underneath its
keyed window: each fault turns the run's ``correct`` false.

- a carry that forgets the rows of absent chips, so that a chip back from a
  missed scrape is judged on its new chunks alone;
- a carry that fills a new chip's row with 0 (idle, with data) in place of
  INVALID_Q (no data);
- a join shifted by one row, so that each carried chip takes its
  neighbour's history.

At a small size on the CPU: the cell's driver over 80 cycles, every answer
compared as a run compares its sample, with the cell's traffic in a copy of
the benchmark whose rates of dropouts (long ones among them) are raised so
that a few hundred chips show them. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_churn_faults.py
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import run
from port_bench.cell import Ctx, load_cell
from port_bench.trace import Spans
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import engine

ROOT = Path(__file__).resolve().parents[1]
CELL = "stream-260k-churn-k12"
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "gke-65k-jobset-churn.json").read_text())
TABLE = [[1, 64], [1, 32], [2, 16], [8, 8], [40, 4]]
SMALL = dict(CONFIG, groups=TABLE, chips=sum(n * c for n, c in TABLE),
             slices=sum(n for n, _ in TABLE))
RAISED = {"dropout_share": 0.03, "long_dropout_share": 0.5}
SEED = 2**31 + 41


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A copy of the benchmark with the cell's dropouts raised."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "port_bench" / "traffic" / "stream-churn-k12.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **RAISED)))
    return root


def run_small(tree, cycles=80):
    """The cell's driver for ``cycles`` cycles after its warm-up, every
    answer compared, as a run compares its sample: the numbers compared."""
    cell = load_cell(tree, CELL)
    driver = cell.driver(Ctx(CELL, SMALL, cell.mix, SEED, torch.device("cpu"), tree, Spans()))
    warm = cell.mix["warmup_ops"]
    for i in range(warm):
        driver.step(i)
    answers = [(i, driver.step(i)) for i in range(warm, warm + cycles)]
    driver.release()
    return {c.name: c.value for c in driver.compare(answers)}


def forget_absent_rows(orig):
    def fault(state, rows, keys, cycle):
        present = len(rows.keys)
        return orig((state[0][:present], state[1][:present], state[2]),
                    tp.WindowRows.of(rows.keys, rows.cycle), keys, cycle)
    return fault


def zero_for_new_rows(orig):
    def fault(tc_ring, hbm_ring, runs, rows):
        out = orig(tc_ring, hbm_ring, runs, rows)
        lengths = torch.diff(runs[0].long(), append=runs.new_tensor([rows]).long())
        new = runs[1].repeat_interleave(lengths) < 0
        for ring in out:
            ring[new] = 0
        return out
    return fault


def shifted_by_one_row(orig):
    def fault(tc_ring, hbm_ring, runs, rows):
        src = runs[1]  # each run from the row before its own (stays in range)
        shifted = torch.where(src >= 1, src - 1, src)
        return orig(tc_ring, hbm_ring, torch.stack([runs[0], shifted]), rows)
    return fault


def test_the_small_run_is_correct_unbroken(tree):
    assert run_small(tree) == {"slices_wrong": 0, "chips_wrong": 0, "answers_missing": 0}
    result = run.run(CELL, SEED, 0.2, False, device="cpu", root=tree, config=SMALL)[0]
    assert result["correct"] and result["attempted"] > 0


@pytest.mark.parametrize("module, attr, fault", [
    (tp, "rekey_window", forget_absent_rows), (engine, "window_gather_plain", zero_for_new_rows),
    (engine, "window_gather_plain", shifted_by_one_row)],
    ids=["forgets-absent-rows", "fills-new-rows-with-0", "join-shifted-by-one"])
def test_a_broken_carry_is_not_correct(tree, monkeypatch, module, attr, fault):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    compared = run_small(tree)
    assert compared["chips_wrong"] > 0 and compared["answers_missing"] == 0
