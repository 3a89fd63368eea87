"""The streaming window on a fleet that changes between cycles: ``rekey_window``.

The entry against the plain reference ``port_bench/reference/churn.py`` on
every cycle of a small cluster drawn by ``port_bench/churn.py`` (JobSets
replaced and restarted, hosts missing scrapes for fewer and more than K
cycles, the largest group's burst), its native join against its plain
version, the edge cases one by one, ``analyze --stream --follow-fleet``
against the reference, and the cell ``stream-260k-churn-k12`` at a tiny
size with its readers.

On the CPU. This file imports no JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_churn.py
"""

import contextlib
import io
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import churn, run, work, work_churn
from port_bench.cell import load_module
from port_bench.reference import churn as ref
from port_bench.trace import Trace
from torch_kernel_cases import join_cases
from tpu_pruner_torch import analyze, hostlib, obs
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import engine, kernels

ROOT = Path(__file__).resolve().parents[1]
JOIN_CASES = join_cases()
CELL = "stream-260k-churn-k12"
MIX = json.loads((ROOT / "port_bench" / "traffic" / "stream-churn-k12.json").read_text())
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "gke-65k-jobset-churn.json").read_text())
K = 4
# about 300 chips in about 40 groups, 4-chip hosts; the churn rates raised
# so that 40 cycles hold every kind of change
SMALL_TABLE = [[1, 64], [2, 32], [3, 16], [8, 8], [24, 4]]
SMALL_MIX = dict(MIX, pool_cycles=40, burst_every=20, restart_share=0.01, dropout_share=0.03,
                 long_dropout_share=0.3, replace_share={"4": 0.05, "8": 0.04, "16": 0.03,
                                                        "32": 0.03})
LOOKBACK, THRESHOLD = 2100.0, 0.05


def config(table, window_chunks=K, **extra):
    return dict(CONFIG, groups=table, chips=sum(n * c for n, c in table),
                slices=sum(n for n, _ in table), window_chunks=window_chunks, **extra)


def cycles(cfg, mix, seed, n=None):
    pool = churn.Churn(cfg, mix, seed, "cpu")
    return [pool.cycle(t, mix) for t in range(n or pool.N)], pool


def params_q():
    parr = np.array([LOOKBACK, THRESHOLD], dtype=np.float32)
    return torch.from_numpy(tp.quantize_params(parr))


class Window:
    """The program's daemon cycle on the CPU, as the cell's driver runs it."""

    def __init__(self, num_chunks=K):
        self.state = tp.init_window(0, num_chunks, device="cpu")
        self.rows = tp.WindowRows.of(np.zeros(0, dtype=np.int64), 0)
        self.pq = params_q()

    def cycle(self, i, keys, tc, hbm, valid, age, slice_id, num_slices):
        r = tp.rekey_window(self.state, self.rows, keys, i)
        self.rows = r.rows
        self.state = tp.update_window_(
            r.state, tp.quantize_samples_device(torch.from_numpy(tc), torch.from_numpy(valid)),
            tp.quantize_samples_device(torch.from_numpy(hbm), torch.from_numpy(valid)))
        bounds = tp.slice_bounds(slice_id, num_slices, device="cpu")
        v, c = tp.evaluate_window_qc(self.state, torch.from_numpy(age), bounds, self.pq)
        return v.numpy(), c.numpy(), r


def reference(cycle_list, i, num_chunks=K, precision="int8"):
    window = [(c.keys, *ref.chunk_peaks(c.tc, c.hbm, c.valid, precision))
              for c in cycle_list[max(0, i - num_chunks + 1):i + 1]]
    c = cycle_list[i]
    return ref.verdicts(window, c.keys, c.age, c.slice_id, c.slices, LOOKBACK, THRESHOLD,
                        precision)


@pytest.fixture(scope="module")
def small():
    cfg = config(SMALL_TABLE)
    assert 250 <= cfg["chips"] <= 350 and 35 <= cfg["slices"] <= 45
    return cycles(cfg, SMALL_MIX, 2**31 + 23)


# --- the entry against the reference, every cycle ---------------------------------


def test_rekey_matches_the_reference_every_cycle(small):
    """40 cycles, the pool twice (its wrap included): every cycle's verdicts
    and candidates equal the reference's exactly, and the native join gives
    the plain version's gather, kept rows and counts bit for bit."""
    pool, gen_ = small
    seq = pool + pool
    window = Window()
    seen = set()
    joins = ("rekey_card", "rekey_native", "rekey_plain")
    for i, c in enumerate(seq):
        native = engine._rekey_native(window.rows, c.keys, i, K)
        plain = engine.rekey_plain(window.rows, c.keys, i, K)
        for a, b in zip(native[:3], plain[:3]):
            np.testing.assert_array_equal(a, b, err_msg=f"cycle {i}")
        assert native[3] == plain[3], i
        counts = dict(zip(("new", "retained", "dropped", "moved"), native[3]))
        before = [obs.counts[k] for k in joins]
        v, cand, r = window.cycle(i, c.keys, c.tc, c.hbm, c.valid, c.age, c.slice_id, c.slices)
        # CPU rings: the native join answers every call, the card's none
        assert [obs.counts[k] - n for k, n in zip(joins, before)] == [0, 1, 0], i
        want_v, want_c = reference(seq, i)
        np.testing.assert_array_equal(v, want_v, err_msg=f"cycle {i}")
        np.testing.assert_array_equal(cand, want_c, err_msg=f"cycle {i}")
        assert r.present == len(c.keys) and np.array_equal(r.rows.keys, c.keys)
        assert len(r.rows.kept_keys) == counts["retained"]
        assert not np.isin(r.rows.kept_keys, c.keys).any()
        assert (i - r.rows.kept_seen < K).all() and (r.rows.kept_seen < i).all()
        seen.update(k for k, n in counts.items() if n)
    assert seen == {"new", "retained", "dropped", "moved"}
    # every kind of change happened: replacements, restarts, both dropouts, the burst
    ev = gen_.events
    assert (ev == churn.REPLACE).any() and (ev == churn.RESTART).any()
    big = int(np.argmax(gen_.size))
    assert list(np.flatnonzero(ev[big])) == [0, 20]
    spans = gen_.absent.sum(axis=1)
    assert spans.max() >= K and ((spans > 0) & (spans < K)).any()


def test_the_pool_wraps_without_a_jump(small):
    """The chips new at the wrap are no more than at the pool's other cycles."""
    pool, _ = small
    new = [len(np.setdiff1d(b.keys, a.keys)) for a, b in zip(pool, pool[1:] + pool[:1])]
    assert new[-1] <= max(new[:-1])
    assert sum(new) > 0


def test_unchanged_keys_give_the_same_rings_with_no_operation():
    """An unchanged fleet: the same state object back, no operation under
    the profiler, no copy, and all four counters unchanged."""
    state = tp.init_window(6, K, device="cpu")
    keys = np.array([11, 3, 7, 5, 2, 9])
    rows = tp.WindowRows.of(keys, 4)
    before = dict(obs.counts)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r = tp.rekey_window(state, rows, keys.copy(), 5)
    assert r.state is state and r.present == 6
    assert not [e.name for e in prof.events() if e.name.startswith("aten::")]
    joined = "rekey_native" if hostlib.load() is not None else "rekey_plain"
    assert {k: obs.counts[k] - before[k] for k in before} == {**dict.fromkeys(before, 0),
                                                              joined: 1}
    assert r.rows.cycle == 5 and np.array_equal(r.rows.keys, keys)
    # kept rows still within the window stay in place too
    state = tp.init_window(8, K, device="cpu")
    rows = tp.WindowRows(keys, 4, np.array([40, 41]), np.array([3, 2]))
    r = tp.rekey_window(state, rows, keys, 5)
    assert r.state is state and list(r.rows.kept_keys) == [40, 41]


def one_chip_cycles(absent_at, busy_at, num_cycles, age=86400.0):
    """Chips 1 and 2 (group 0, name a) and 3 (group 1, name b); chip 1 is
    absent at ``absent_at`` and busy at ``busy_at`` (one sample of 0.5), the
    rest idle with valid samples: (keys, tc, hbm, valid, age, slice_id, S)
    of each cycle."""
    out = []
    for t in range(num_cycles):
        keys = np.array([k for k in (1, 2, 3) if not (k == 1 and t in absent_at)])
        tc = np.zeros((len(keys), 3), np.float32)
        if t in busy_at and 1 in keys:
            tc[0, 1] = 0.5
        slice_id = (keys == 3).astype(np.int32)
        out.append(churn.Cycle(keys, slice_id, 2, np.array([0, 1]), np.full(len(keys), age,
                                                                           np.float32), tc,
                               np.zeros_like(tc), np.ones(tc.shape, bool)))
    return out


def test_a_chip_busy_before_a_missed_scrape_is_not_judged_idle():
    """Busy two cycles before a one-cycle dropout, back with its old age:
    its kept row holds the busy chunk, so it is no candidate and its group
    is no reclaimable; a window of present chips only would call it idle."""
    seq = one_chip_cycles(absent_at={2}, busy_at={0}, num_cycles=4)
    window = Window()
    for i, c in enumerate(seq):
        v, cand, r = window.cycle(i, c.keys, c.tc, c.hbm, c.valid, c.age, c.slice_id, c.slices)
        want_v, want_c = reference(seq, i)
        np.testing.assert_array_equal(v, want_v)
        np.testing.assert_array_equal(cand, want_c)
        if i == 2:
            assert list(r.rows.kept_keys) == [1] and r.state[0].shape[0] == 3
    assert cand.tolist() == [False, True, True] and v.tolist() == [False, True]
    # the false idle: the same cycle judged on a fresh window
    fresh = Window()
    c = seq[3]
    v, cand, _ = fresh.cycle(3, c.keys, c.tc, c.hbm, c.valid, c.age, c.slice_id, c.slices)
    assert cand.tolist() == [True, True, True] and v.tolist() == [True, True]


def test_a_row_absent_k_cycles_is_dropped():
    seq = one_chip_cycles(absent_at=set(range(1, 1 + K + 1)), busy_at=set(), num_cycles=K + 3)
    window = Window()
    kept, dropped = [], []
    for i, c in enumerate(seq):
        before = obs.counts["window_rows_dropped"]
        _, _, r = window.cycle(i, c.keys, c.tc, c.hbm, c.valid, c.age, c.slice_id, c.slices)
        kept.append(list(r.rows.kept_keys))
        dropped.append(obs.counts["window_rows_dropped"] - before)
        assert r.state[0].shape[0] == r.present + len(r.rows.kept_keys)
    # absent in cycles 1..K+1: kept while it may hold data (cycles 1..K-1)
    assert kept[1:K] == [[1]] * (K - 1) and kept[K] == [] and dropped[K] == 1
    assert sum(dropped) == 1
    # back at K + 2 as a new row: one chunk, so a candidate at once (old age)
    v, cand = reference(seq, K + 2)
    assert cand[0]


@pytest.mark.parametrize("case", [name for name, (rows, keys, cycle, k) in JOIN_CASES.items()
                                  if not name.startswith("repeated")])
def test_rekey_on_cpu_rings_matches_plain_at_the_joins_edges(case):
    """The join's edge cases (tests/torch_kernel_cases.py, which the card's
    join runs too) through rekey_window on CPU rings: the native join (or
    the plain version without the library) answers, the card's never, and
    the rings, kept rows and counts are rekey_plain's."""
    rows, keys, cycle, k = JOIN_CASES[case]
    total = len(rows.keys) + len(rows.kept_keys)
    g = torch.Generator().manual_seed(total)
    state = (*(torch.randint(-1, 100, (total, k), generator=g, dtype=torch.int8)
               for _ in range(2)), torch.zeros((), dtype=torch.int32))
    runs, kept_keys, kept_seen, counts = engine.rekey_plain(rows, keys, cycle, k)
    before = dict(obs.counts)
    r = tp.rekey_window(state, rows, keys, cycle)
    grew = {name: obs.counts[name] - before[name] for name in before}
    joined = "rekey_native" if hostlib.load() is not None else "rekey_plain"
    assert grew["rekey_card"] == 0 and grew[joined] == 1
    assert tuple(grew[f"window_rows_{n}"] for n in ("new", "retained", "dropped",
                                                     "moved")) == counts
    assert np.array_equal(r.rows.kept_keys, kept_keys)
    assert np.array_equal(r.rows.kept_seen, kept_seen) and r.rows.on_card is None
    want = kernels.window_gather_plain(*state[:2], torch.from_numpy(runs),
                                       len(keys) + len(kept_keys))
    assert all(torch.equal(a, b) for a, b in zip(r.state[:2], want))


def test_join_constants_agree_with_the_kernel():
    """kernels.JOIN_COUNTS is chip_pass.cu's kJoinCounts, the host words
    before the kept rows, of which the join's last tile writes the five
    that engine._rekey_card reads."""
    src = (Path(kernels.__file__).parent / "csrc" / "chip_pass.cu").read_text()
    found = re.search(r"constexpr int64_t kJoinCounts = (\d+);", src)
    assert int(found.group(1)) == kernels.JOIN_COUNTS
    written = [f"out.host[{i}] =" in src for i in range(kernels.JOIN_COUNTS)]
    assert written == [True] * 5 + [False] * 3


def test_join_and_gather_wrappers_check_their_inputs():
    """window_join takes the rows' int64 keys on the card (no plain version
    on the CPU: the engine joins there on the host) and 1-D keys;
    window_gather a 1-D int32 index."""
    k = torch.arange(6, dtype=torch.int64)
    keys = np.arange(3)
    with pytest.raises(ValueError, match="runs on the card"):
        kernels.window_join(kernels.CardRows(k, 2, 2, 4), keys, 0, 1, 4)
    with pytest.raises(TypeError, match="int64"):
        kernels.window_join(kernels.CardRows(k.int(), 2, 2, 4), keys, 0, 1, 4)
    with pytest.raises(TypeError, match="1-D"):
        kernels.window_join(kernels.CardRows(k.view(2, 3), 2, 2, 4), keys, 0, 1, 4)
    rings = torch.zeros((4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="1-D"):
        kernels.window_gather(rings, rings, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        kernels.window_gather(rings, rings, torch.zeros(2, dtype=torch.int64))


def test_rekey_checks_its_inputs_and_refuses_repeated_keys():
    state = tp.init_window(3, K, device="cpu")
    rows = tp.WindowRows.of(np.array([1, 2, 3]), 0)
    before = obs.counts["rekey_card"]
    with pytest.raises(ValueError, match="repeat"):
        tp.rekey_window(state, rows, np.array([4, 4, 5]), 1)
    assert obs.counts["rekey_card"] == before
    with pytest.raises(ValueError, match="rings"):
        tp.rekey_window(tp.init_window(2, K, device="cpu"), rows, np.array([1]), 1)
    with pytest.raises(ValueError, match="repeat"):
        engine.rekey_plain(tp.WindowRows.of(np.array([1, 1]), 0), np.array([1]), 1, K)


def test_update_fills_the_kept_rows_column_and_evaluation_reads_the_present():
    state = tp.init_window(4, 3, device="cpu")
    state[0][3] = 5  # a kept row with data
    new = torch.zeros((2, 2), dtype=torch.int8)
    state = tp.update_window_(state, new, new)
    assert state[0][:2, 0].tolist() == [0, 0] and state[0][2:, 0].tolist() == [-1, -1]
    assert state[0][3].tolist() == [-1, 5, 5] and int(state[2]) == 1
    age = torch.full((2,), 86400.0)
    v, c = tp.evaluate_window_qc(state, age, torch.tensor([0, 2], dtype=torch.int32),
                                 torch.tensor([2100.0, 5.0]))
    assert c.tolist() == [True, True] and v.tolist() == [True]
    with pytest.raises(ValueError, match="rows of new samples"):
        tp.update_window_(state, torch.zeros((5, 2), dtype=torch.int8),
                          torch.zeros((5, 2), dtype=torch.int8))


@pytest.mark.parametrize("gather", [[], [-1, -1], [3, -1, 0, 0], [1, 2, 3, -1, -1, 0, 2]],
                         ids=["empty", "all-new", "short", "runs"])
def test_window_gather_plain_takes_the_runs_of_a_gather(gather):
    from tpu_pruner_torch.policy import kernels

    tc = torch.arange(12, dtype=torch.int8).view(4, 3)
    hbm = -tc
    runs = engine.gather_runs(gather)
    assert runs.shape[1] == {0: 0, 2: 1, 4: 4, 7: 4}[len(gather)]
    out_tc, out_hbm = kernels.window_gather_plain(tc, hbm, torch.from_numpy(runs), len(gather))
    assert out_tc.shape == out_hbm.shape == (len(gather), 3)
    assert out_tc.tolist() == [tc[s].tolist() if s >= 0 else [-1] * 3 for s in gather]
    assert out_hbm.tolist() == [hbm[s].tolist() if s >= 0 else [-1] * 3 for s in gather]
    # the card's wrapper takes the row index itself; on the CPU, its runs
    index = torch.tensor(gather, dtype=torch.int32)
    assert all(torch.equal(a, b) for a, b in zip(kernels.window_gather(tc, hbm, index),
                                                 (out_tc, out_hbm)))


# --- the CLI: analyze --stream --follow-fleet ----------------------------------------


def dump(c, names, ids=True):
    """Cycle ``c`` as an analyze dump: a chip's valid samples only (the
    chunk's peak is theirs), its group's name, its id zero-padded so that
    load_fleet orders chips as the cycle does."""
    chips = []
    for k, s, a, tc, hbm, valid in zip(c.keys, c.slice_id, c.age, c.tc, c.hbm, c.valid):
        chip = {"slice": names[s], "pod_age_s": float(a), "tc": tc[valid].tolist(),
                "hbm": hbm[valid].tolist()}
        if ids:
            chip["id"] = f"chip-{k:09d}"
        chips.append(chip)
    return {"chips": chips, "timestamp": 1000.0, "lookback_s": LOOKBACK,
            "hbm_threshold": THRESHOLD}


def cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = analyze.main(argv)
        except SystemExit as exc:
            rc = exc.code if isinstance(exc.code, int) else 1
            print(exc.code, file=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()


def test_follow_fleet_prints_what_the_reference_gives(tmp_path, small):
    """Cycle by cycle over a churned dump sequence, the JSON line's
    reclaimable slices and idle chips are the reference's, its deltas go by
    slice name, and the state file keeps the rows' ids."""
    pool, _ = small
    seq = pool[:16]
    state = tmp_path / "state.npz"
    prev = set()
    for i, c in enumerate(seq):
        names = [f"ml/g{n:07d}" for n in c.names]  # padded: sorted as the ranks
        path = tmp_path / "dump.json"
        path.write_text(json.dumps(dump(c, names)))
        rc, line, err = cli([str(path), "--stream", str(state), "--window-chunks", str(K),
                             "--follow-fleet", "--device", "cpu"])
        assert rc == 0, err
        want_v, want_c = reference(seq, i)
        want = [names[s] for s in np.flatnonzero(want_v)]
        assert line["reclaimable_slices"] == want, i
        assert line["idle_chips"] == int(want_c.sum()) and line["num_chips"] == len(c.keys)
        assert line["newly_reclaimable"] == sorted(set(want) - prev), i
        assert line["no_longer_reclaimable"] == sorted(prev & set(names) - set(want)), i
        prev = set(want)
        with np.load(state, allow_pickle=False) as saved:
            assert int(saved["cycle"]) == i
            assert len(saved["row_ids"]) == saved["tc_ring"].shape[0] == len(saved["row_seen"])
            assert list(saved["row_ids"][:len(c.keys)]) == [f"chip-{k:09d}" for k in c.keys]


def test_follow_fleet_refuses_a_dump_without_ids(tmp_path, small):
    pool, _ = small
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump(pool[0], [f"ml/g{n}" for n in range(pool[0].slices)],
                                    ids=False)))
    rc, line, err = cli([str(path), "--stream", str(tmp_path / "s.npz"), "--follow-fleet",
                         "--device", "cpu"])
    assert rc == 1 and line is None and "'id'" in err
    assert not (tmp_path / "s.npz").exists()
    rc, _, err = cli([str(path), "--follow-fleet", "--device", "cpu"])
    assert rc == 2 and "only applies with --stream" in err


def test_follow_fleet_on_an_unchanged_fleet_prints_what_plain_stream_prints(tmp_path, small):
    pool, _ = small
    c = pool[0]
    names = [f"ml/g{n}" for n in range(c.slices)]
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump(c, names)))
    for _ in range(3):
        got = cli([str(path), "--stream", str(tmp_path / "a.npz"), "--follow-fleet",
                   "--window-chunks", str(K), "--device", "cpu"])
        want = cli([str(path), "--stream", str(tmp_path / "b.npz"), "--window-chunks", str(K),
                    "--device", "cpu"])
        assert got[:2] == want[:2]
    # a file written under the flag is refused without it once rows are kept
    rows = dump(c, names)
    rows["chips"] = rows["chips"][4:]
    path.write_text(json.dumps(rows))
    assert cli([str(path), "--stream", str(tmp_path / "a.npz"), "--follow-fleet",
                "--window-chunks", str(K), "--device", "cpu"])[0] == 0
    rc, _, err = cli([str(path), "--stream", str(tmp_path / "a.npz"), "--window-chunks",
                      str(K), "--device", "cpu"])
    assert rc == 1 and "--reset" in err


# --- the cell, through the harness ----------------------------------------------------

TINY = config([[1, 64], [1, 32], [2, 16], [4, 8], [8, 4]], window_chunks=12)
SEED = 2**31 + 5


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark, so that a run writes inside it alone."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def run_tiny(tree, trace=False, seed=SEED, cfg=TINY):
    return run.run(CELL, seed, 0.3, trace, device="cpu", root=tree, config=cfg)[0]


def test_the_cell_runs_correct_on_the_cpu(tree):
    result = run_tiny(tree)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "cycle_ms", "cycle_p95_ms"}
    assert set(result["compared"]) == {"slices_wrong", "chips_wrong", "answers_missing",
                                       "failed"}
    traced = run_tiny(tree, trace=True)
    assert traced["correct"]
    # no device metric on the CPU
    assert set(traced["metrics"]) == {"rekey_ms.churn", "rows_rekeyed.churn"}
    assert all(m["value"] > 0 for m in traced["metrics"].values())


def test_the_int4_control_is_not_correct():
    from port_bench import control

    r = control.readings(CELL, 7, 0.3, True, device="cpu",
                         config=config(SMALL_TABLE, window_chunks=12))
    assert not any(r["program"].values())
    assert r["control"]["slices_wrong"] > 0 and r["control"]["chips_wrong"] > 0


def test_the_parent_program_fails_at_once(tree, monkeypatch):
    """A program without the keyed window fails before it draws a cycle."""
    monkeypatch.delattr(tp, "rekey_window")
    with pytest.raises(SystemExit, match="rekey_window"):
        run_tiny(tree)


def read(metric, run_):
    path = ROOT / "port_bench" / "metrics" / f"{metric}.py"
    return load_module(path, f"churn_test_{metric}").read(run_)


def test_the_cells_bytes_and_readers():
    # one cycle at the cell's size: 260,000 chips, 3,000 kept rows, 3,100 new,
    # 4,000 runs
    rows, chips = 263_000, 260_000
    b = work_churn.cycle_bytes(chips, rows, rows - 3_100, 32_000, 3, 12, 23_149)
    assert b == (work.cycle_bytes(chips, 3, 12, 23_149) + 2 * 3_000
                 + 32_000 + 24 * (rows - 3_100) + 24 * rows)
    assert work_churn.cycle_bytes(chips, chips, chips, 0, 3, 12, 9) == work.cycle_bytes(
        chips, 3, 12, 9)
    bound_s = b / work.HBM_BYTES_PER_S
    shape = {"new_samples": 3, "chunks": 12, "cycles": 2, "bytes": 2 * b}
    trace = Trace((0.0, 1e-2), device=[
        ("window_gather_kernel", 0.0, 2 * bound_s), ("Memcpy HtoD", 1e-3, 2e-3),
        ("chip_pass_q_rows", 3e-3, 3e-3 + 2 * bound_s)])
    traced = run.Run(CELL, trace, 2, {}, shape)
    assert read("churn_roofline", traced) == pytest.approx(50.0)
    assert read("device_ops.churn", traced) == 1.5
    busy = 4 * bound_s + 1e-3
    assert read("idle_pct.churn", traced) == pytest.approx(100 * (1 - busy / 1e-2))
    for metric in ("churn_roofline", "device_ops.churn", "idle_pct.churn", "rekey_ms.churn",
                   "rows_rekeyed.churn"):
        assert read(metric, run.Run(CELL, None, 0, {}, shape)) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state = tp.init_window(3, K, device="cpu")
        tp.rekey_window(state, tp.WindowRows.of(np.array([1, 2, 3]), 0), np.array([2, 5]), 1)
    summary = obs.summary()
    assert read("rekey_ms.churn", run.Run(CELL, object(), 1, {}, shape)) == pytest.approx(
        summary["spans"]["engine.rekey"]["total_ms"])
    # 3 moved (key 2 to row 0, the kept keys 1 and 3 behind it), 1 new, none dropped
    assert read("rows_rekeyed.churn", run.Run(CELL, object(), 1, {}, shape)) == 4
