"""``evaluate_fleet_sweep``: a grid of up to 64 policies in one pass.

The port against ``port_bench/reference/sweep.py`` on fleets drawn by
``port_bench/sweep.py`` (the ``gke-65k-policy-sweep`` deployment's group
sizes, counts cut, a 96-sample window) under grids of 1, 16 and 64
policies, and on hand-made edge cases; each policy's bit against
``evaluate_fleet`` on its window; numpy replays of the CUDA kernels' walk
and reduction against their plain versions; the ``sweep-260k-t1440-d8h8``
cell at a small size, whole and with the program broken underneath; the
``engine.sweep`` span, the counters and the cell's readers.

On the CPU. This file imports no JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sweep.py
"""

import contextlib
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import gen, run, sweep, work_sweep
from port_bench.cell import load_module
from port_bench.drivers.sweep import bits_differing
from port_bench.reference import sweep as ref
from port_bench.trace import Trace
from torch_kernel_cases import sweep_pass_cases, sweep_scatter_cases
from tpu_pruner_torch import obs
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import engine, kernels

ROOT = Path(__file__).resolve().parents[1]
CELL = "sweep-260k-t1440-d8h8"
MIX = json.loads((ROOT / "port_bench" / "traffic" / "sweep-d8h8.json").read_text())
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "gke-65k-policy-sweep.json").read_text())
# the deployment's group sizes, counts and sizes cut to about 4,096 chips
TABLE = [[1, 1024], [1, 512], [2, 256], [8, 64], [64, 16], [128, 4]]
T = 96
DURATIONS_MIN = [1, 2, 5, 15, 30, 60, 90, 96]
GRIDS = {  # name -> (durations in minutes, thresholds)
    "P=1": ([96], [0.05]),
    "P=16": ([2, 15, 60, 96], [0, 0.01, 0.03, 0.05]),
    "P=64": (DURATIONS_MIN, CONFIG["hbm_thresholds"]),
}


def config(table=TABLE, window=T, durations=DURATIONS_MIN):
    return dict(CONFIG, groups=table, chips=sum(n * c for n, c in table),
                slices=sum(n for n, _ in table), window_samples=window,
                durations_min=durations)


def draw(cfg, seed):
    """The cluster and its samples, as the cell's driver draws them, on the CPU."""
    fleet = sweep.make_fleet(cfg, MIX, seed, "cpu")
    g = gen.generator(seed, "cpu", 2)
    tc, hbm, valid = sweep.samples(fleet, MIX, g, cfg["window_samples"], 0, cfg["chips"])
    return fleet, tc, hbm, valid


def grid(name, grace=300, window=T):
    minutes, thresholds = GRIDS[name]
    return tp.sweep_grid([60.0 * m for m in minutes], thresholds, grace, 60, window)


def want(tc, hbm, valid, age, slice_id, num_slices, g, block=1000):
    """The reference, over blocks of ``block`` rows."""
    arrays = [np.asarray(x) for x in (tc, hbm, valid)]
    blocks = [tuple(x[r0:r0 + block] for x in arrays) for r0 in range(0, len(age), block)]
    return ref.sweep(blocks, np.asarray(age), np.asarray(slice_id), num_slices, g.durations_s,
                     g.hbm_thresholds, g.grace_s, g.step_s)


def assert_equal(got, expected):
    for x, y, what in zip(got, expected, ("slices", "chips", "counts"), strict=True):
        assert torch.equal(x, y), what


@pytest.fixture(scope="module")
def fleet():
    return draw(config(), 2**31 + 125)


# --- the generator --------------------------------------------------------------


def test_the_cluster_lies_around_the_grids_edges(fleet):
    f, tc, hbm, valid = fleet
    kinds = f.base.kinds.long()
    idle = kinds == gen.IDLE
    edges = {60 * m // 60 for m in DURATIONS_MIN}
    since = f.idle_since[idle].tolist()
    assert any(s in edges for s in since) and any(s >= T for s in since)
    assert any(s + 1 in edges or s - 1 in edges for s in since)
    assert (f.idle_since[kinds == gen.BUSY] == 0).all()
    assert (f.idle_since[kinds == gen.VETO] == T).all()
    gates = {60 * m + g for m in DURATIONS_MIN for g in (300, 600)}
    ages = f.age.numpy().reshape(-1, 4)
    assert (ages == ages[:, :1]).all()  # a host's pods share an age
    near = [min(abs(float(a) - gate) for gate in gates) for a in ages[:, 0]]
    assert sum(d <= 60 and d == int(d) for d in near) > len(near) * 0.05  # whole seconds
    assert (f.stale > 0).sum() >= 1 and (~valid[:, -30:]).all(dim=1).any()
    big = int(torch.argmax(f.base.size))
    assert f.base.size[big] == 1024 and kinds[big] == gen.VETO


@pytest.mark.parametrize("window", [15, T], ids=["short", "long"])
def test_hbm_peaks_lie_around_every_threshold(fleet, window):
    """Some chip's HBM peak over the newest ``window`` samples lies within two
    bfloat16 steps of each enabled threshold."""
    f, tc, hbm, valid = fleet
    peak = torch.where(valid[:, -window:], hbm[:, -window:], -1.0).amax(dim=1).double()
    for t in CONFIG["hbm_thresholds"]:
        if t > 0:
            assert ((peak - np.float32(t)).abs() <= 2 * sweep.bf16_step(t)).any(), t


# --- the port against the reference -------------------------------------------


@pytest.mark.parametrize("grace", [300, 600])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_port_matches_the_reference(fleet, name, grace):
    f, tc, hbm, valid = fleet
    S = f.base.slices
    g = grid(name, grace)
    got = tp.evaluate_fleet_sweep(tc, hbm, valid, f.age, f.slice_id, g, S)
    assert_equal(got, want(tc, hbm, valid, f.age, f.slice_id, S, g))
    slices = got[2][:, 0]
    assert slices.sum() > 0 and (slices < S).all()
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int64
    assert got[2].shape == (g.num_policies, 2)
    if name == "P=64":
        assert (got[0] < 0).any() and (got[0] >= 0).any()  # bit 63 set and clear
        assert len(set(slices.tolist())) > 8  # the policies disagree


def test_each_bit_is_evaluate_fleet_on_its_window(fleet):
    f, tc, hbm, valid = fleet
    S = f.base.slices
    g = grid("P=16", grace=600)
    slices, chips, counts = tp.evaluate_fleet_sweep(tc, hbm, valid, f.age, f.slice_id, g, S)
    for p in range(g.num_policies):
        duration, threshold = g.policy(p)
        n = round(duration / 60)
        params = tp.params_array(tp.PolicyParams(lookback_s=duration + 600,
                                                 hbm_threshold=threshold), device="cpu")
        verdicts, candidates = tp.evaluate_fleet(tc[:, -n:], hbm[:, -n:], valid[:, -n:], f.age,
                                                 f.slice_id, params, num_slices=S)
        assert torch.equal((slices >> p) & 1 == 1, verdicts), p
        assert torch.equal((chips >> p) & 1 == 1, candidates), p
        assert counts[p, 0] == verdicts.sum()
        sizes = torch.bincount(f.slice_id.long(), minlength=S)
        assert counts[p, 1] == sizes[verdicts].sum()
    assert ((chips >> 16) == 0).all() and ((slices >> 16) == 0).all()  # bits from P on


# --- edge cases -------------------------------------------------------------------


def idle_fleet(sizes, window=8, cph=4, seed=0):
    """Chips of groups ``sizes`` (table order) in shuffled host order, every
    sample idle and valid, HBM 0.01, pods a day old: (tc, hbm, valid, age,
    group of each chip)."""
    rng = np.random.default_rng(seed)
    host_group = np.repeat(np.arange(len(sizes)), np.asarray(sizes) // cph)
    group = np.repeat(host_group[rng.permutation(len(host_group))], cph)
    C = len(group)
    return (np.zeros((C, window), np.float32), np.full((C, window), 0.01, np.float32),
            np.ones((C, window), bool), np.full(C, 86400.0, np.float32), group)


def run_edge(tc, hbm, valid, age, group, durations_steps, thresholds, grace=300):
    """The sweep of an edge case on the port and the reference, which must
    agree; returns the port's (slice masks, chip masks, counts) as numpy."""
    g = tp.sweep_grid([60.0 * n for n in durations_steps], thresholds, grace, 60,
                      tc.shape[1])
    S = int(group.max()) + 1
    tensors = [torch.from_numpy(x) for x in (tc, hbm, valid, age)]
    sid = torch.from_numpy(group.astype(np.int32))
    got = tp.evaluate_fleet_sweep(*tensors, sid, g, S)
    assert_equal(got, want(tc, hbm, valid, age, group, S, g, block=7))
    return tuple(x.numpy() for x in got)


def bit(masks, p):
    return ((masks >> p) & 1).astype(bool)


def test_a_window_of_the_whole_row_and_of_one_step():
    tc, hbm, valid, age, group = idle_fleet([8, 4, 4])
    tc[group == 0, 0] = 0.5   # busy at the oldest sample: only the whole row sees it
    tc[group == 1, -1] = 0.5  # busy at the newest: every window sees it
    slices, _, _ = run_edge(tc, hbm, valid, age, group, [1, 8], [0])
    assert bit(slices, 0).tolist() == [True, False, True]
    assert bit(slices, 1).tolist() == [False, False, True]


def test_threshold_zero_is_disabled_beside_a_cutoff_of_0_01():
    tc, hbm, valid, age, group = idle_fleet([4, 4, 4])
    hbm[group == 0] = 0.0
    hbm[group == 1] = 0.5
    slices, _, counts = run_edge(tc, hbm, valid, age, group, [8], [0, 0.01])
    assert bit(slices, 0).tolist() == [True, True, True]   # disabled: HBM rescues nothing
    assert bit(slices, 1).tolist() == [True, False, False]  # 0.01 is not under 0.01
    assert counts.tolist() == [[3, 12], [1, 4]]


def test_a_chip_with_data_only_outside_the_shortest_window():
    tc, hbm, valid, age, group = idle_fleet([4, 4])
    stale = np.flatnonzero(group == 0)[2]
    valid[stale, -3:] = False  # no data in the newest three samples
    slices, chips, _ = run_edge(tc, hbm, valid, age, group, [3, 4], [0])
    assert bit(chips, 0)[stale] == 0 and bit(chips, 1)[stale] == 1
    assert bit(slices, 0).tolist() == [False, True] and bit(slices, 1).all()


def test_busy_samples_on_and_inside_a_windows_edge():
    tc, hbm, valid, age, group = idle_fleet([4, 4, 4], window=40)
    tc[np.flatnonzero(group == 0)[1], -33] = 0.3  # distance 32: just outside 32 steps
    tc[np.flatnonzero(group == 1)[3], -32] = 0.3  # distance 31: the oldest inside
    tc[np.flatnonzero(group == 2)[0], -34] = 0.3  # inside 33 and 40 steps only
    slices, _, _ = run_edge(tc, hbm, valid, age, group, [32, 33, 40], [0.05])
    assert bit(slices, 0).tolist() == [True, False, True]
    assert bit(slices, 1).tolist() == [False, False, True]
    assert bit(slices, 2).tolist() == [False, False, False]


def test_an_age_exactly_at_duration_plus_grace():
    tc, hbm, valid, age, group = idle_fleet([4, 4, 4])
    age[group == 0] = 8 * 60 + 300        # exactly the gate of 8 steps: old enough
    age[group == 1] = np.nextafter(np.float32(780), np.float32(0))  # just under it
    slices, _, _ = run_edge(tc, hbm, valid, age, group, [8, 4], [0])
    assert bit(slices, 0).tolist() == [True, False, True]
    assert bit(slices, 1).all()


def test_groups_of_one_host_and_of_50944_chips():
    tc, hbm, valid, age, group = idle_fleet([50944, 4, 4, 16], window=4)
    last = np.flatnonzero(group == 0)[-1]
    tc[last, 1] = 0.2  # the big group's last chip, busy but in the newest two samples
    hbm[group == 1, -1] = 0.04
    slices, _, counts = run_edge(tc, hbm, valid, age, group, [2, 4], [0, 0.03])
    assert bit(slices, 0).tolist() == [True, True, True, True]
    assert bit(slices, 1).tolist() == [True, False, True, True]
    assert bit(slices, 2).tolist() == [False, True, True, True]
    assert counts[0].tolist() == [4, 50968] and counts[2].tolist() == [3, 24]


def test_bit_63_set_and_clear():
    tc, hbm, valid, age, group = idle_fleet([4, 4, 8])
    hbm[group == 1, 0] = 0.99  # rescued by the largest window under every cutoff but 0
    steps = [1, 2, 3, 4, 5, 6, 7, 8]
    thresholds = [0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.95]
    slices, chips, counts = run_edge(tc, hbm, valid, age, group, steps, thresholds)
    assert bit(slices, 63).tolist() == [True, False, True]
    assert slices[0] < 0 and slices[1] >= 0  # the sign bit
    assert bit(chips, 63).sum() == 12 and counts[63].tolist() == [2, 12]


def test_bad_grids_are_refused():
    with pytest.raises(ValueError, match="1 to 64 policies"):
        tp.sweep_grid([60.0 * n for n in range(1, 14)], [0, 0.01, 0.02, 0.03, 0.05], 300, 60, 96)
    with pytest.raises(ValueError, match="1 to 64 policies"):
        tp.sweep_grid([], [0.05], 300, 60, 96)
    with pytest.raises(ValueError, match="whole number"):
        tp.sweep_grid([90.0], [0.05], 300, 60, 96)
    with pytest.raises(ValueError, match="window holds"):
        tp.sweep_grid([60.0 * 97], [0.05], 300, 60, 96)
    with pytest.raises(ValueError, match="window holds"):
        tp.sweep_grid([0.0], [0.05], 300, 60, 96)
    g = tp.sweep_grid([60.0 * n for n in range(1, 9)], CONFIG["hbm_thresholds"], 300, 60, 96)
    assert g.num_policies == 64 and g.policy(63) == (480.0, 0.2)
    assert g.cutoffs[0] == np.inf and g.lookback_s.tolist() == [60 * n + 300 for n in range(1, 9)]
    tc, hbm, valid, age, group = idle_fleet([4, 4])
    with pytest.raises(ValueError, match="windows of 96 samples"):
        tp.evaluate_fleet_sweep(*(torch.from_numpy(x) for x in (tc, hbm, valid, age, group)),
                                g, 2)
    with pytest.raises(ValueError, match="1 to 64 policies"):
        kernels.sweep_pass(*(torch.from_numpy(x) for x in (tc, hbm, valid, age)),
                           np.ones(65, np.int32), np.zeros(65, np.float32), [np.inf])
    with pytest.raises(TypeError, match="int32 or int64"):
        kernels.sweep_scatter(torch.zeros(8, dtype=torch.int64), torch.zeros(8), 2, 8)
    with pytest.raises(ValueError, match="1 to 64 policies"):
        kernels.sweep_scatter(torch.zeros(8, dtype=torch.int64),
                              torch.zeros(8, dtype=torch.int32), 2, 65)


def test_inputs_of_other_dtypes_are_taken_as_evaluate_fleet_takes_them(fleet):
    f, tc, hbm, valid = fleet
    g = grid("P=16")
    S = f.base.slices
    expected = tp.evaluate_fleet_sweep(tc, hbm, valid, f.age, f.slice_id, g, S)
    got = tp.evaluate_fleet_sweep(tc.double(), hbm.to(torch.float64), valid.to(torch.uint8),
                                  f.age.double(), f.slice_id.to(torch.int16), g, S)
    assert_equal(got, expected)


# --- the CUDA kernels, replayed in numpy --------------------------------------

FLT_MIN = np.float32(1.1754944e-38)
CU = (ROOT / "tpu_pruner_torch" / "policy" / "csrc" / "chip_pass.cu").read_text()


def test_sweep_constants_agree_with_the_kernels():
    assert re.search(r"constexpr int kSweepK = (\d+);", CU).group(1) == str(kernels._SWEEP_K)
    assert re.search(r"constexpr int kSweepMaxPolicies = (\d+);", CU).group(1) == str(
        kernels.SWEEP_MAX_POLICIES)


def emulate_sweep_pass(tc, hbm, valid, age, samples, lookbacks, cutoffs, K=kernels._SWEEP_K):
    """sweep_pass_kernel's walk, every row at once: 32 lanes a row, the
    lanes' running peaks from the newest sample back, a chunk of K steps of
    32 samples at a time, each window recorded as the warp's reduction of
    the lanes' peaks plus their sample of its last step where it lies
    inside; then each policy's bit."""
    C, T = tc.shape
    flush = lambda x: np.where(np.abs(x) < FLT_MIN, np.float32(0), x)  # noqa: E731
    order = np.argsort(samples, kind="stable")  # the insertion sort of the window ends
    bounds, D, H = np.asarray(samples)[order], len(samples), len(cutoffs)
    n_max = int(bounds.max())
    run_max = {k: np.full((C, 32), -np.inf, np.float32) for k in ("tc", "hbm")}
    run_nan = {k: np.zeros((C, 32), bool) for k in ("tc", "hbm")}
    run_has = np.zeros((C, 32), bool)
    slots = {}

    def add(state, x_tc, x_hbm, x_v, lanes):
        maxes, nans, has = state
        has = has | (x_v & lanes)
        for key, x in (("tc", x_tc), ("hbm", x_hbm)):
            x = np.where(x_v, flush(x), np.float32(-1))
            nan = np.isnan(x) & lanes
            nans = {**nans, key: nans[key] | nan}
            maxes = {**maxes, key: np.where(lanes & ~nan & (x > maxes[key]), x, maxes[key])}
        return maxes, nans, has

    def record(state, d):
        maxes, nans, has = state
        slots[d] = tuple(np.where(nans[k].any(axis=1), np.float32(np.nan), maxes[k].max(axis=1))
                         for k in ("tc", "hbm")) + (has.any(axis=1),)

    state, nxt = (run_max, run_nan, run_has), 0
    at = bounds[0] >> 5
    lane = np.arange(32)
    for k0 in range(0, n_max, 32 * K):
        chunk = []
        for j in range(K):
            k = k0 + 32 * j + lane
            inside = k < n_max
            col = np.where(inside, T - 1 - k, 0)
            chunk.append((np.where(inside, tc[:, col], 0), np.where(inside, hbm[:, col], 0),
                          valid[:, col] & inside))
        for j in range(K):
            step = (k0 >> 5) + j
            while step == at:
                lanes = np.broadcast_to(lane < (bounds[nxt] & 31), (C, 32))
                record(add(state, *chunk[j], lanes), order[nxt])
                nxt += 1
                at = bounds[nxt] >> 5 if nxt < D else 1 << 31
            state = add(state, *chunk[j], np.ones((C, 32), bool))
    for i in range(nxt, D):
        record(state, order[i])
    out = np.zeros(C, np.int64)
    for p in range(D * H):
        d, h = divmod(p, H)
        peak_tc, peak_hbm, has = slots[d]
        cut = flush(np.float32(cutoffs[h]))
        b = (peak_tc <= 0) & has & ~(peak_hbm >= cut) & (flush(age) >= flush(np.float32(
            lookbacks[d])))
        out |= b.astype(np.int64) << p
    return out


@pytest.mark.parametrize("case", sorted(sweep_pass_cases(91)))
def test_the_pass_kernels_walk_matches_the_plain_version(case):
    tc, hbm, valid, age, samples, lookbacks, cutoffs = sweep_pass_cases(91)[case]
    plain = kernels.sweep_pass_plain(*(torch.from_numpy(x) for x in (tc, hbm, valid, age)),
                                     samples, lookbacks, cutoffs)
    assert np.array_equal(emulate_sweep_pass(tc, hbm, valid, age, samples, lookbacks, cutoffs),
                          plain.numpy())
    # and each bit is the chip pass on its window
    for p in range(len(samples) * len(cutoffs)):
        d, h = divmod(p, len(cutoffs))
        n = int(samples[d])
        params = torch.tensor([lookbacks[d], cutoffs[h]], dtype=torch.float32)
        one = kernels.chip_pass_plain(*(torch.from_numpy(np.ascontiguousarray(x[:, -n:]))
                                        for x in (tc, hbm, valid)), torch.from_numpy(age),
                                      params)
        assert torch.equal((plain >> p) & 1 == 1, one), (case, p)


def emulate_sweep_scatter(masks, ids, S, P):
    """tp_sweep_scatter's three kernels in numpy: each warp of 32 chips ANDs
    the masks of its lanes of one slice by five shuffles down, a run's first
    lane ORs what its run lacks into the slice's word; then each slice's
    mask and the counts."""
    C = len(ids)
    bits = np.uint64(2**64 - 1) if P == 64 else np.uint64((1 << P) - 1)
    pad = -C % 32
    s = np.where((ids >= 0) & (ids < S), ids, -1).astype(np.int64)
    acc = np.where(s >= 0, masks.view(np.uint64), np.uint64(2**64 - 1))
    s = np.concatenate([s, np.full(pad, -1)]).reshape(-1, 32)
    acc = np.concatenate([acc, np.full(pad, 2**64 - 1, np.uint64)]).reshape(-1, 32)
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        other = np.roll(acc, -off, axis=1)
        same = (lane + off < 32) & (np.roll(s, -off, axis=1) == s)
        acc = np.where(same, acc & other, acc)
    start = (s >= 0) & ((lane == 0) | (np.roll(s, 1, axis=1) != s))
    lacking = np.zeros(S, np.uint64)
    has = np.zeros(S, bool)
    has[s[start]] = True
    np.bitwise_or.at(lacking, s[start], ~acc[start] & bits)
    slice_masks = np.where(has, ~lacking & bits, np.uint64(0)).view(np.int64)
    counts = np.zeros((P, 2), np.int64)
    inside = (ids >= 0) & (ids < S)
    chip_masks = slice_masks[np.where(inside, ids, 0)] * inside if S else np.zeros(C, np.int64)
    for p in range(P):
        counts[p] = [((slice_masks >> p) & 1).sum(), ((chip_masks >> p) & 1).sum()]
    return slice_masks, counts


@pytest.mark.parametrize("case", sorted(sweep_scatter_cases(92)))
def test_the_scatter_kernels_replay_matches_the_plain_version(case):
    masks, ids, S, P = sweep_scatter_cases(92)[case]
    slice_masks, counts = kernels.sweep_scatter_plain(torch.from_numpy(masks),
                                                      torch.from_numpy(ids), S, P)
    replay = emulate_sweep_scatter(masks, ids.astype(np.int64), S, P)
    assert np.array_equal(replay[0], slice_masks.numpy())
    assert np.array_equal(replay[1], counts.numpy())


# --- the cell, through the harness -----------------------------------------------

TINY = config()
SEED = 2**31 + 25


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark, so that a run writes inside it alone."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def run_tiny(tree, trace=False, seed=SEED):
    return run.run(CELL, seed, 0.3, trace, device="cpu", root=tree, config=TINY)[0]


def test_the_cell_runs_correct_on_the_cpu(tree):
    result = run_tiny(tree)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "eval_ms"}
    assert set(result["compared"]) == {"slices_wrong", "chips_wrong", "counts_wrong",
                                       "answers_missing", "failed"}
    traced = run_tiny(tree, trace=True)
    assert traced["correct"]
    # no device metric on the CPU
    assert set(traced["metrics"]) == {"sweep_host_ms.sweep", "window_passes.sweep"}
    assert traced["metrics"]["window_passes.sweep"]["value"] == 1
    assert traced["metrics"]["sweep_host_ms.sweep"]["value"] > 0


def one_short(orig):
    def fault(tc, hbm, valid, age, samples, lookbacks, cutoffs):
        return orig(tc, hbm, valid, age, np.maximum(np.asarray(samples) - 1, 1), lookbacks,
                    cutoffs)
    return fault


def at_most_the_cutoff(orig):
    def fault(tc, hbm, valid, age, samples, lookbacks, cutoffs):
        cut = np.nextafter(np.asarray(cutoffs, np.float32), np.float32(np.inf))
        return orig(tc, hbm, valid, age, samples, lookbacks, cut)
    return fault


def drop_bit_63(orig):
    def fault(*args, **kwargs):
        slices, chips, counts = orig(*args, **kwargs)
        keep = torch.iinfo(torch.int64).max
        counts = counts.clone()
        counts[-1] = 0
        return slices & keep, chips & keep, counts
    return fault


def flip_one_slice(orig):
    def fault(*args, **kwargs):
        slices, chips, counts = orig(*args, **kwargs)
        slices = slices.clone()
        slices[0] = ~slices[0]
        return slices, chips, counts
    return fault


@pytest.mark.parametrize("module, attr, fault, shows", [
    (engine, "sweep_pass", one_short, "chips_wrong"),
    (engine, "sweep_pass", at_most_the_cutoff, "chips_wrong"),
    (tp, "evaluate_fleet_sweep", drop_bit_63, "slices_wrong"),
    (tp, "evaluate_fleet_sweep", flip_one_slice, "slices_wrong")],
    ids=["a-window-one-sample-short", "at-most-the-cutoff", "bit-63-dropped",
         "one-slice-flipped"])
def test_broken_program_is_not_correct(tree, monkeypatch, module, attr, fault, shows):
    assert run_tiny(tree)["correct"]
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    result = run_tiny(tree)
    assert not result["correct"]
    assert result["compared"][shows]["value"] > 0


def test_the_bf16_control_is_not_correct():
    from port_bench import control

    r = control.readings(CELL, 7, 0.2, True, device="cpu", config=TINY)
    assert not any(r["program"].values())
    assert r["control"]["slices_wrong"] > 0 and r["control"]["chips_wrong"] > 0


def test_bits_differing_counts_bits_of_the_policies_only():
    a = np.array([0, -1, 5], np.int64)
    b = np.array([1, 0, 5], np.int64)
    assert bits_differing(a, b, 64) == 65 and bits_differing(a, b, 1) == 2
    assert bits_differing(None, b, 16) == 48 and bits_differing(a[:2], b, 4) == 12


# --- the engine.sweep span and the counters ------------------------------------


def off():
    with obs.span("off"):
        pass


@contextlib.contextmanager
def profiled():
    off()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof


def test_the_span_and_counters(fleet):
    f, tc, hbm, valid = fleet
    g = grid("P=64")
    args = (tc, hbm, valid, f.age, f.slice_id, g, f.base.slices)
    off()
    before = obs.summary()
    tp.evaluate_fleet_sweep(*args)
    assert obs.summary() == before  # off: no session, no record
    with profiled() as prof:
        tp.evaluate_fleet_sweep(*args)
        tp.evaluate_fleet_sweep(*args[:5], grid("P=16"), f.base.slices)
    summ = obs.summary()
    assert [r[0] for r in obs.records()] == ["engine.sweep", "engine.sweep"]
    assert summ["spans"]["engine.sweep"]["count"] == 2
    assert summ["counters"]["sweep_policies"] == 80
    assert summ["counters"]["sweep_window_passes"] == 2
    assert sum(e.name == "tp.engine.sweep" for e in prof.events()) == 2


# --- the cell's readers and bytes ------------------------------------------------


def read(metric, run_):
    path = ROOT / "port_bench" / "metrics" / f"{metric}.py"
    return load_module(path, f"sweep_test_{metric}").read(run_)


def test_the_cells_bytes_and_readers(fleet, monkeypatch):
    nbytes = work_sweep.sweep_bytes(260000, 1440, 23149, 64)
    assert nbytes == 260000 * 1440 * 9 + 260000 * 8 + 64 * 12 + 260000 * 8 + 23149 * 8 + 64 * 16
    assert round(nbytes / 1e6) == 3374
    bound_s = nbytes / work_sweep.HBM_BYTES_PER_S
    assert bound_s * 1e3 == pytest.approx(1.007, abs=1e-3)
    shape = {"chips": 260000, "samples": 1440, "slices": 23149, "policies": 64}
    # two calls: each the pass at 1.25 times its bound, a memset, a copy, idle between
    trace = Trace((0.0, 4e-3), device=[
        ("sweep_pass_kernel", 0.0, 1.25 * bound_s), ("Memset (Device)", 1.3e-3, 1.31e-3),
        ("sweep_pass_kernel", 2e-3, 2e-3 + 1.25 * bound_s),
        ("Memcpy DtoH (Device -> Pageable)", 3.5e-3, 3.6e-3)])
    traced = run.Run(CELL, trace, 2, {}, shape)
    assert read("sweep_roofline", traced) == pytest.approx(80.0)
    assert read("device_ops.sweep", traced) == 2
    busy = 2.5 * bound_s + 0.11e-3
    assert read("idle_pct.sweep", traced) == pytest.approx(100 * (1 - busy / 4e-3))

    f, tc, hbm, valid = fleet
    with profiled():
        for _ in range(3):
            tp.evaluate_fleet_sweep(tc, hbm, valid, f.age, f.slice_id, grid("P=1"),
                                    f.base.slices)
    span = obs.summary()["spans"]["engine.sweep"]
    later = run.Run(CELL, object(), 3, {}, shape)
    assert read("sweep_host_ms.sweep", later) == pytest.approx(span["total_ms"] / 3)
    assert read("window_passes.sweep", later) == 1
    for metric in ("sweep_roofline", "device_ops.sweep", "idle_pct.sweep",
                   "sweep_host_ms.sweep", "window_passes.sweep"):
        assert read(metric, run.Run(CELL, None, 0, {}, shape)) is None
    with monkeypatch.context() as m:  # a program without obs
        m.setitem(sys.modules, "tpu_pruner_torch.obs", None)
        assert read("sweep_host_ms.sweep", later) is None
        assert read("window_passes.sweep", later) is None
    with profiled():  # a program without the span and the counter, as the parent's
        with obs.span("engine.evaluate"):
            pass
    assert read("sweep_host_ms.sweep", later) is None
    assert read("window_passes.sweep", later) is None
