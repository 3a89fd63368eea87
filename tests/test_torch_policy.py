"""tpu_pruner_torch.policy against the JAX reference, on the CPU.

The same seeded numpy inputs go through the JAX engine (XLA, and the
Pallas chip-pass kernels in interpret mode) and through the port, whose
chip pass runs its plain PyTorch version on CPU tensors. Every output is a
boolean mask or int8 bytes, so the tolerance is exact equality.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pruner.policy import engine as jeng
from tpu_pruner.policy import pallas_engine as jpal
from torch_kernel_cases import F32_PARAMS, GATE_OFFSETS, f32_edge_fleet, gate_cases, scatter_cases
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import kernels

CPU = "cpu"


def to_torch(*arrays):
    """numpy -> CPU tensors, float64 narrowed to float32 as jnp.asarray does."""
    return [torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.float32 if a.dtype == np.float64 else a.dtype)) for a in arrays]


def np_params(lookback_s, hbm_threshold):
    p = tp.PolicyParams(lookback_s=lookback_s, hbm_threshold=hbm_threshold)
    return np.array([p.lookback_s, p.hbm_cutoff()], dtype=np.float32)


def jax_fleet(tc, hbm, valid, age, slice_id, parr, S):
    """Reference (verdicts, candidates) from the XLA engine and the Pallas
    kernel; the two must agree before the port is compared with them."""
    args = tuple(jnp.asarray(x) for x in (tc, hbm, valid, age, slice_id, parr))
    xla_v, xla_c = jeng.evaluate_fleet(*args, num_slices=S)
    pal_v, pal_c = jpal.evaluate_fleet_pallas(*args, num_slices=S)
    np.testing.assert_array_equal(np.asarray(pal_c), np.asarray(xla_c))
    np.testing.assert_array_equal(np.asarray(pal_v), np.asarray(xla_v))
    return np.asarray(xla_v), np.asarray(xla_c)


def torch_fleet(tc, hbm, valid, age, slice_id, parr, S):
    inputs = tp.fleet_from_numpy((tc, hbm, valid, age, slice_id, parr), CPU)
    v, c = tp.evaluate_fleet(*inputs, num_slices=S)
    return v.numpy(), c.numpy()


def jax_fleet_q(tc, hbm, valid, age, slice_id, parr, S):
    """Reference int8 path: device quantizer, then XLA and Pallas passes."""
    q = jeng.quantize_fleet_inputs(tuple(
        jnp.asarray(x) for x in (tc, hbm, valid, age, slice_id, parr)))
    xla_v, xla_c = jeng.evaluate_fleet_q(*q, num_slices=S)
    pal_v, pal_c = jpal.evaluate_fleet_pallas_q(*q, num_slices=S)
    np.testing.assert_array_equal(np.asarray(pal_c), np.asarray(xla_c))
    np.testing.assert_array_equal(np.asarray(pal_v), np.asarray(xla_v))
    return np.asarray(xla_v), np.asarray(xla_c), np.asarray(q[0]), np.asarray(q[1])


def torch_fleet_q(tc, hbm, valid, age, slice_id, parr, S):
    q = tp.quantize_fleet_inputs(
        tp.fleet_from_numpy((tc, hbm, valid, age, slice_id, parr), CPU))
    v, c = tp.evaluate_fleet_q(*q, num_slices=S)
    return v.numpy(), c.numpy(), q[0].numpy(), q[1].numpy()


def assert_same(ref, got):
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(g, r)


def oracle_fleet(seed):
    """tests/test_policy.py's numpy-oracle fleet (C=96, T=12, S=7)."""
    rng = np.random.default_rng(seed)
    C, T, S = 96, 12, 7
    tc = (rng.uniform(size=(C, T)) < 0.5).astype(np.float32) * rng.uniform(size=(C, T))
    hbm = rng.uniform(0, 0.2, size=(C, T)).astype(np.float32)
    valid = rng.uniform(size=(C, T)) < 0.9
    age = rng.uniform(0, 4000, size=C).astype(np.float32)
    slice_id = rng.integers(0, S, size=C).astype(np.int32)
    return tc, hbm, valid, age, slice_id, S


def random_fleet(seed, C=200, T=24, S=9):
    """tests/test_policy.py's random fleet: scrape gaps, absent series,
    unaligned floats; C=200 is not a multiple of any block size."""
    rng = np.random.default_rng(seed)
    tc = (rng.uniform(size=(C, T)) < 0.5).astype(np.float32) * rng.uniform(size=(C, T))
    hbm = rng.uniform(0, 0.2, size=(C, T)).astype(np.float32)
    valid = rng.uniform(size=(C, T)) < 0.9
    valid[:5] = False
    age = rng.uniform(0, 4000, size=C).astype(np.float32)
    slice_id = rng.integers(0, S, size=C).astype(np.int32)
    return tc, hbm, valid, age, slice_id, S


# ── fleets and parameters ─────────────────────────────────────────────────


@pytest.mark.parametrize("shape", [(256, 16, 16, 0.5, 0), (64, 8, 8, 0.25, 3),
                                   (100, 7, 10, 0.3, 11)])
def test_make_example_fleet_bit_identical(shape):
    C, T, S, idle, seed = shape
    j_inputs, j_expected = jeng.make_example_fleet(C, T, S, idle, seed)
    t_inputs, t_expected = tp.make_example_fleet(C, T, S, idle, seed, device=CPU)
    for j, t in zip(j_inputs, t_inputs):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        assert t.numpy().tobytes() == j.tobytes()
    np.testing.assert_array_equal(t_expected, j_expected)


@pytest.mark.parametrize("threshold", [0.0, 0.05, -1.0])
def test_params_array_matches(threshold):
    params = tp.PolicyParams(lookback_s=2100, hbm_threshold=threshold)
    ref = np.asarray(jeng.params_array(
        jeng.PolicyParams(lookback_s=2100, hbm_threshold=threshold)))
    np.testing.assert_array_equal(tp.params_array(params, device=CPU).numpy(), ref)
    np.testing.assert_array_equal(tp.quantize_params(ref), jeng.quantize_params(ref))


def test_example_fleet_verdicts_match():
    j_inputs, expected = jeng.make_example_fleet(64, num_slices=8, idle_fraction=0.25)
    t_inputs, _ = tp.make_example_fleet(64, num_slices=8, idle_fraction=0.25, device=CPU)
    v, c = tp.evaluate_fleet(*t_inputs, num_slices=8)
    ref = jax_fleet(*(np.asarray(x) for x in j_inputs), 8)
    assert_same(ref, (v.numpy(), c.numpy()))
    np.testing.assert_array_equal(v.numpy(), expected)


# ── f32 path: evaluate_fleet ≡ the reference ──────────────────────────────


@pytest.mark.parametrize("threshold", [0.05, 0.0, 0.0437])
@pytest.mark.parametrize("make, seed", [(oracle_fleet, 42), (random_fleet, 11),
                                        (random_fleet, 17)],
                         ids=["oracle42", "random11", "random17"])
def test_evaluate_fleet_matches_reference(make, seed, threshold):
    tc, hbm, valid, age, slice_id, S = make(seed)
    parr = np_params(2100, threshold)
    assert_same(jax_fleet(tc, hbm, valid, age, slice_id, parr, S),
                torch_fleet(tc, hbm, valid, age, slice_id, parr, S))


def test_evaluate_chips_scalar_params_match():
    tc, hbm, valid, age, _, _ = random_fleet(5)
    ref = jeng.evaluate_chips(jnp.asarray(tc), jnp.asarray(hbm), jnp.asarray(valid),
                              jnp.asarray(age), 2100.0, 0.05)
    t = to_torch(tc, hbm, valid, age)
    got = tp.evaluate_chips(*t, 2100.0, 0.05)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got_t = tp.evaluate_chips(*t, torch.tensor(2100.0), torch.tensor(0.05))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["busy_chip_vetoes", "hbm_rescue", "young_pod",
                                  "no_data_chip", "empty_slice_ids"])
def test_gate_cases_match_reference(case):
    j_inputs, _ = jeng.make_example_fleet(32, num_slices=4, idle_fraction=1.0)
    tc, hbm, valid, age, slice_id, parr = (np.array(x) for x in j_inputs)
    S = 4
    if case == "busy_chip_vetoes":
        tc[5, 3] = 0.7
    elif case == "hbm_rescue":
        hbm[0:8, :] = 0.3
        parr = np_params(2100, 0.05)
    elif case == "young_pod":
        age[0] = 60.0
    elif case == "no_data_chip":
        valid[3, :] = False
    elif case == "empty_slice_ids":
        S = 7  # ids 4..6 are declared but hold no chips: never idle
    ref = jax_fleet(tc, hbm, valid, age, slice_id, parr, S)
    assert_same(ref, torch_fleet(tc, hbm, valid, age, slice_id, parr, S))
    if case == "empty_slice_ids":
        assert not ref[0][4:].any() and ref[0][:4].all()


# ── numeric rules the port reproduces (subnormal, NaN, inf) ───────────────

EDGE_CASES = {
    # name: (tc row, hbm row, valid row, age, [lookback, cutoff])
    "subnormal_tc_is_idle": ([0.0, 1e-40], [0.0, 0.0], [1, 1], 7200, [2100, np.inf]),
    "negative_subnormal_tc": ([-1e-40, 0.0], [0.0, 0.0], [1, 1], 7200, [2100, np.inf]),
    "nan_tc_is_busy": ([0.0, np.nan], [0.0, 0.0], [1, 1], 7200, [2100, np.inf]),
    "invalid_nan_tc_ignored": ([0.0, np.nan], [0.0, 0.0], [1, 0], 7200, [2100, np.inf]),
    "nan_hbm_never_rescues": ([0.0, 0.0], [0.0, np.nan], [1, 1], 7200, [2100, 0.05]),
    "inf_hbm_rescues_disabled": ([0.0, 0.0], [0.0, np.inf], [1, 1], 7200, [2100, np.inf]),
    "inf_tc_is_busy": ([np.inf, 0.0], [0.0, 0.0], [1, 1], 7200, [2100, np.inf]),
    "neg_inf_tc_is_idle": ([-np.inf, -np.inf], [0.0, 0.0], [1, 1], 7200, [2100, np.inf]),
    "negative_zero_tc": ([-0.0, -0.5], [0.0, 0.0], [1, 1], 7200, [2100, np.inf]),
    "subnormal_cutoff_reads_zero": ([0.0, 0.0], [-1e-3, 0.0], [1, 1], 7200, [2100, 1e-40]),
    "subnormal_cutoff_negative_hbm": ([0.0, 0.0], [-1e-3, -1e-3], [1, 1], 7200, [2100, 1e-40]),
    "subnormal_age_and_lookback": ([0.0, 0.0], [0.0, 0.0], [1, 1], 1e-40, [2e-40, np.inf]),
    "all_invalid_row": ([0.0, 0.0], [0.0, 0.0], [0, 0], 7200, [2100, np.inf]),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_numeric_rules_match_reference(case):
    tc, hbm, valid, age, parr = EDGE_CASES[case]
    args = (np.array([tc], np.float32), np.array([hbm], np.float32),
            np.array([valid], bool), np.array([age], np.float32),
            np.zeros(1, np.int32), np.array(parr, np.float32), 1)
    ref = jax_fleet(*args)
    assert_same(ref, torch_fleet(*args))
    if case in ("subnormal_tc_is_idle", "inf_hbm_rescues_disabled", "nan_tc_is_busy",
                "nan_hbm_never_rescues"):
        # the behaviours a naive port gets wrong: pin which way they go
        expected = {"subnormal_tc_is_idle": True, "inf_hbm_rescues_disabled": False,
                    "nan_tc_is_busy": False, "nan_hbm_never_rescues": True}[case]
        assert bool(ref[1][0]) is expected


def test_numeric_rules_int8_match_reference():
    """All edge rows at once through the int8 path: quantized bytes and
    masks equal the reference's (NaN lands in bucket 0 on both)."""
    rows = [EDGE_CASES[k] for k in sorted(EDGE_CASES)]
    tc = np.array([r[0] for r in rows], np.float32)
    hbm = np.array([r[1] for r in rows], np.float32)
    valid = np.array([r[2] for r in rows], bool)
    age = np.array([r[3] for r in rows], np.float32)
    sid = np.arange(len(rows), dtype=np.int32)
    for parr in (np_params(2100, 0.05), np_params(2100, 0.0)):
        ref = jax_fleet_q(tc, hbm, valid, age, sid, parr, len(rows))
        assert_same(ref, torch_fleet_q(tc, hbm, valid, age, sid, parr, len(rows)))


# ── int8 storage ──────────────────────────────────────────────────────────


def test_quantize_samples_match_reference():
    rng = np.random.default_rng(23)
    util = rng.uniform(0, 1, size=(64, 48)).astype(np.float32)
    util[0, :12] = [0.0, 0.01, 0.05, 1e-38, 1e-40, -1e-40, -0.0, -0.5,
                    np.inf, -np.inf, 1.5, 0.999999]
    util[1, :4] = np.nan
    valid = rng.uniform(size=(64, 48)) < 0.9
    valid[1, :2] = True
    with np.errstate(invalid="ignore"):
        ref = jeng.quantize_samples(util, valid)
    ref_dev = np.asarray(jeng.quantize_samples_device(jnp.asarray(util), jnp.asarray(valid)))
    np.testing.assert_array_equal(ref_dev, ref)
    got_np = tp.quantize_samples(util, valid)
    got_dev = tp.quantize_samples_device(*to_torch(util, valid))
    assert got_np.dtype == np.int8 and got_dev.dtype == torch.int8
    np.testing.assert_array_equal(got_np, ref)
    np.testing.assert_array_equal(got_dev.numpy(), ref)
    assert ref[1, 0] == 0 and ref[0, 8] == 127 and ref[0, 9] == 0


@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.0437])
@pytest.mark.parametrize("seed", [11, 17, 101])
def test_quantized_fleet_matches_reference(seed, threshold):
    tc, hbm, valid, age, slice_id, S = random_fleet(seed)
    parr = np_params(2100, threshold)
    assert_same(jax_fleet_q(tc, hbm, valid, age, slice_id, parr, S),
                torch_fleet_q(tc, hbm, valid, age, slice_id, parr, S))


def test_quantized_exact_on_aligned_threshold():
    """1%-aligned samples and cutoff: int8 ≡ f32 in the port, as in the
    reference (tests/test_policy.py:378-396)."""
    rng = np.random.default_rng(13)
    C, T, S = 96, 12, 7
    tc = rng.integers(0, 3, size=(C, T)).astype(np.float32) / 100
    hbm = rng.integers(0, 20, size=(C, T)).astype(np.float32) / 100
    valid = rng.uniform(size=(C, T)) < 0.9
    age = rng.uniform(0, 4000, size=C).astype(np.float32)
    slice_id = rng.integers(0, S, size=C).astype(np.int32)
    parr = np_params(2100, 0.05)
    f32 = torch_fleet(tc, hbm, valid, age, slice_id, parr, S)
    q = torch_fleet_q(tc, hbm, valid, age, slice_id, parr, S)
    assert_same(f32, q[:2])
    assert_same(jax_fleet_q(tc, hbm, valid, age, slice_id, parr, S), q)


@pytest.mark.parametrize("seed", range(100, 105))
def test_quantized_only_errs_toward_rescue(seed):
    """Unaligned threshold: q_candidates ⊆ f32_candidates in the port
    (tests/test_policy.py:399-414), and equal to the reference's."""
    tc, hbm, valid, age, slice_id, S = random_fleet(seed)
    parr = np_params(2100, 0.0437)
    _, f32_c = torch_fleet(tc, hbm, valid, age, slice_id, parr, S)
    _, q_c, _, _ = torch_fleet_q(tc, hbm, valid, age, slice_id, parr, S)
    assert not np.any(q_c & ~f32_c)
    _, ref_q_c, _, _ = jax_fleet_q(tc, hbm, valid, age, slice_id, parr, S)
    np.testing.assert_array_equal(q_c, ref_q_c)


# ── contiguous (cumsum) reductions ────────────────────────────────────────


def contiguous_fleet():
    """Sorted slice ids, uneven sizes, empty slices 3 and 9
    (tests/test_policy.py:417-450)."""
    rng = np.random.default_rng(29)
    C, T, S = 192, 16, 12
    sizes = rng.multinomial(C, np.array([1 if s not in (3, 9) else 0
                                         for s in range(S)]) / (S - 2))
    slice_id = np.repeat(np.arange(S, dtype=np.int32), sizes)
    tc = (rng.uniform(size=(C, T)) < 0.5).astype(np.float32) * rng.uniform(size=(C, T))
    hbm = rng.uniform(0, 0.2, size=(C, T)).astype(np.float32)
    valid = rng.uniform(size=(C, T)) < 0.9
    age = rng.uniform(0, 4000, size=C).astype(np.float32)
    return tc, hbm, valid, age, slice_id, S


def test_contiguous_matches_reference():
    tc, hbm, valid, age, slice_id, S = contiguous_fleet()
    parr = np_params(2100, 0.05)
    j_bounds = jeng.slice_bounds(slice_id, S)
    t_bounds = tp.slice_bounds(slice_id, S, device=CPU)
    np.testing.assert_array_equal(t_bounds.numpy(), np.asarray(j_bounds))

    jargs = tuple(jnp.asarray(x) for x in (tc, hbm, valid, age))
    ref_v, ref_c = jeng.evaluate_fleet_c(*jargs, j_bounds, jnp.asarray(parr))
    inputs = tp.fleet_from_numpy((tc, hbm, valid, age, slice_id, parr), CPU)
    v, c = tp.evaluate_fleet_c(*inputs[:4], t_bounds, inputs[5])
    assert_same((np.asarray(ref_v), np.asarray(ref_c)), (v.numpy(), c.numpy()))
    assert not v.numpy()[[3, 9]].any()

    jq = jeng.quantize_fleet_inputs(
        tuple(jnp.asarray(x) for x in (tc, hbm, valid, age, slice_id, parr)))
    ref_qv, ref_qc = jpal.evaluate_fleet_pallas_qc(jq[0], jq[1], jq[2], j_bounds, jq[4])
    tq = tp.quantize_fleet_inputs(inputs)
    qv, qc = tp.evaluate_fleet_qc(tq[0], tq[1], tq[2], t_bounds, tq[4])
    assert_same((np.asarray(ref_qv), np.asarray(ref_qc)), (qv.numpy(), qc.numpy()))
    # the contiguous reduction agrees with the scatter one
    sv, _ = tp.evaluate_fleet_q(*tq, num_slices=S)
    np.testing.assert_array_equal(sv.numpy(), qv.numpy())


def test_slice_bounds_rejects_unsorted():
    with pytest.raises(ValueError, match="sorted"):
        jeng.slice_bounds(np.array([0, 2, 1], dtype=np.int32), 3)
    with pytest.raises(ValueError, match="sorted"):
        tp.slice_bounds(np.array([0, 2, 1], dtype=np.int32), 3, device=CPU)


# ── kernel wrappers on the CPU ────────────────────────────────────────────


def test_chip_pass_wrappers_validate_inputs():
    tc, hbm, valid, age, _, _ = random_fleet(3, C=16, T=4)
    t_tc, t_hbm, t_valid, t_age = to_torch(tc, hbm, valid, age)
    params = torch.tensor([2100.0, 0.05])
    with pytest.raises(TypeError, match="valid"):
        tp.chip_pass(t_tc, t_hbm, t_valid.to(torch.uint8), t_age, params)
    with pytest.raises(ValueError, match="shape"):
        tp.chip_pass(t_tc, t_hbm[:8], t_valid, t_age, params)
    with pytest.raises(ValueError, match="contiguous"):
        tp.chip_pass(t_tc.t().contiguous().t(), t_hbm, t_valid, t_age, params)
    with pytest.raises(ValueError, match="2-D"):
        tp.chip_pass_q(torch.zeros(4, dtype=torch.int8), torch.zeros(4, dtype=torch.int8),
                       t_age[:4], params)
    tp.reset_launches()
    got = tp.chip_pass(t_tc, t_hbm, t_valid, t_age, params)
    np.testing.assert_array_equal(
        got.numpy(), tp.chip_pass_plain(t_tc, t_hbm, t_valid, t_age, params).numpy())
    assert tp.LAUNCHES == {"chip_pass": 0, "chip_pass_q": 0, "slice_gate": 0,  # no kernel
                           "slice_scatter": 0, "window_gather": 0, "window_join": 0,
                           "sweep_pass": 0, "sweep_scatter": 0}  # on the CPU


def test_cuda_entry_points_refuse_cpu_tensors():
    inputs, _ = tp.make_example_fleet(16, 4, 2, device=CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.evaluate_fleet_cuda(*inputs, num_slices=2)
    q = tp.quantize_fleet_inputs(inputs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.evaluate_fleet_cuda_q(*q, num_slices=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.evaluate_fleet_cuda_qc(q[0], q[1], q[2],
                                  tp.slice_bounds(inputs[4], 2, device=CPU), q[4])


# ── launch plan of the int8 kernel (pure Python, so checked here) ─────────


@pytest.mark.parametrize("num_chips", [1, 17, 1003, 131072])
@pytest.mark.parametrize("sm_count", [1, 78, 132])
def test_plan_q_invariants(sm_count, num_chips):
    """For every series length up to a week of minutes: tiles start 16-byte
    aligned, parts are whole 16-byte units that cover the tile, the shared
    memory fits without opting in, and every chip lands in a block."""
    for T in range(1, 10081):
        p = kernels._plan_q(num_chips, T, sm_count)
        assert p.rows_per_tile % 16 == 0 and p.rows_per_tile * T < 2**31
        assert p.part_bytes % 16 == 0 and 0 < p.part_bytes <= kernels._Q_PART_BYTES
        assert (p.parts - 1) * p.part_bytes < p.rows_per_tile * T <= p.parts * p.part_bytes
        assert p.parts == 1 or (p.rows_per_tile == kernels._Q_CARRY_ROWS and p.stages == 2)
        assert p.stages in (1, 2)
        assert p.lanes_per_row in (1, 2, 4, 8, 16, 32)
        assert p.smem_bytes == kernels._q_smem(p.rows_per_tile, p.part_bytes, p.stages)
        assert p.smem_bytes <= kernels._Q_SMEM_MAX <= 232_448  # 227 KB, Hopper's most
        assert p.grid >= 1
        assert (p.grid - 1) * p.rows_per_tile < num_chips <= p.grid * p.rows_per_tile


@pytest.mark.parametrize("num_chips, T", [(1, 1), (17, 12), (203, 31), (40, 360),
                                          (33, 361), (17, 385), (5, 10080)])
def test_plan_q_parts_cover_each_row_once(num_chips, T):
    """The kernel's walk over tiles and parts, replayed in Python: every byte
    of every row is in exactly one part, and a row cut by parts stays within
    the rows a block can carry."""
    p = kernels._plan_q(num_chips, T, 132)
    seen = np.zeros((num_chips, T), np.int64)
    for tile in range(p.grid):
        row0 = tile * p.rows_per_tile
        tile_len = min(p.rows_per_tile, num_chips - row0) * T
        for part in range(p.parts):
            start = part * p.part_bytes
            length = max(0, min(tile_len - start, p.part_bytes))
            if length == 0:
                continue
            for r in range(start // T, (start + length - 1) // T + 1):
                beg, end = max(r * T - start, 0), min(r * T + T - start, length)
                assert beg < end
                seen[row0 + r, start + beg - r * T:start + end - r * T] += 1
                if p.parts > 1 and not (r * T >= start and r * T + T <= start + length):
                    assert r < kernels._Q_CARRY_ROWS
    np.testing.assert_array_equal(seen, 1)


def test_plan_q_empty_fleet_has_no_blocks():
    assert kernels._plan_q(0, 360, 132).grid == 0


# ── the int8 kernel's row design for short rows (plan and arithmetic) ─────

def test_rows_design_constants_agree_with_the_kernels():
    """_Q_ROWS_T is the list of row lengths chip_pass.cu instantiates
    (RowsT): T up to 64 whose group is at most 5 vectors of each array,
    but not 5; _Q_ROWS_THREADS is its block size (kRowsThreads)."""
    src = (Path(kernels.__file__).parent / "csrc" / "chip_pass.cu").read_text()
    listed = re.search(r"using RowsT = std::integer_sequence<int, ([\d, ]+)>;", src).group(1)
    assert sorted(kernels._Q_ROWS_T) == [int(t) for t in listed.split(",")]
    assert kernels._Q_ROWS_T == {T for T in range(1, 65) if T // math.gcd(T, 16) <= 5} - {5}
    threads = re.search(r"constexpr int kRowsThreads = (\d+);", src).group(1)
    assert kernels._Q_ROWS_THREADS == int(threads)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("num_chips", [1, 5, 32768, 131072, 262144, 262145, 1048576])
def test_choose_plan_q_takes_row_design_where_intended(num_chips, aligned):
    """The row design exactly for the row lengths of _Q_ROWS_T, up to
    _Q_ROWS_MAX_BYTES an array, on 16-byte aligned inputs; the tile design
    for every other launch."""
    for T in range(1, 400):
        plan = kernels._choose_plan_q(num_chips, T, 132, aligned)
        if aligned and T in kernels._Q_ROWS_T and num_chips * T <= 16 * 2**20:
            assert plan == kernels._plan_q_rows(num_chips, T)
        else:
            assert plan == kernels._plan_q(num_chips, T, 132)
    window = kernels._choose_plan_q(num_chips, 12, 132, aligned)  # the daemon's default
    assert isinstance(window, kernels.PlanRows) == (aligned and num_chips <= 1398101)


@pytest.mark.parametrize("num_chips", [0, 1, 3, 4, 5, 131, 4097, 32768, 131072, 1048576])
def test_plan_q_rows_invariants(num_chips):
    """Each thread owns the fewest rows whose bytes are whole 16-byte
    vectors, and the grid has a block for every group of rows and no block
    without one (what rows_plan_ok checks in C)."""
    for T in sorted(kernels._Q_ROWS_T):
        p = kernels._plan_q_rows(num_chips, T)
        g = p.rows_per_thread
        assert g * T % 16 == 0 and all(k * T % 16 for k in range(1, g))
        assert g in (1, 2, 4, 8, 16) and g * T // 16 <= 5
        per_block = kernels._Q_ROWS_THREADS * g
        if num_chips:
            assert (p.grid - 1) * per_block < num_chips <= p.grid * per_block
        else:
            assert p.grid == 0


def rows_design_map(C: int, T: int, plan) -> tuple:
    """The row design's walk, replayed from the kernel's arithmetic: for each
    thread with rows, its first row, whether its group is whole, and per
    whole group the (row, byte) that each byte of its vectors folds into."""
    g = plan.rows_per_thread
    group = np.arange(plan.grid * kernels._Q_ROWS_THREADS, dtype=np.int64)
    row0 = group * g
    row0 = row0[row0 < C]
    whole = row0 + g <= C
    # chip_pass.cu row_peak: row R folds words R*T/4 .. (R*T+T-1)/4, of each
    # word the bytes [max(R*T - 4k, 0), min(R*T + T - 4k, 4))
    folds = []
    for R in range(g):
        for k in range(R * T // 4, (R * T + T - 1) // 4 + 1):
            lo, hi = max(R * T - 4 * k, 0), min(R * T + T - 4 * k, 4)
            folds += [(R, 4 * k + b) for b in range(lo, hi)]
    return row0, whole, folds


@pytest.mark.parametrize("T", sorted(kernels._Q_ROWS_T))
def test_rows_design_covers_each_row_once(T):
    """For every (C, T) of the card's sweep (SWEEP_C): each byte of a whole group's
    vectors folds into exactly the row it belongs to, the groups and the
    ragged last one cover every row once, loads stay inside the tensors, and
    the vector, age and verdict accesses are aligned."""
    for C in (1, 3, 4, 5, 131, 4097, 32768, 131072):
        plan = kernels._plan_q_rows(C, T)
        g = plan.rows_per_thread
        row0, whole, folds = rows_design_map(C, T, plan)
        assert sorted(b for _, b in folds) == list(range(g * T))
        assert all(R == b // T for R, b in folds)
        rows = np.zeros(C, np.int64)
        for r0, w in zip(row0, whole):
            rows[r0:r0 + g if w else C] += 1
        np.testing.assert_array_equal(rows, 1)
        assert whole.sum() == C // g and len(row0) == -(-C // g)
        last = row0[whole][-1] if whole.any() else None
        if last is not None:
            assert (last + g) * T <= C * T  # the last vector read ends inside
        assert np.all(row0 * T % 16 == 0) and np.all(row0 * 4 % min(16, 4 * g) == 0)
        assert np.all(row0 % g == 0)  # the verdict store of g bytes is g-aligned


def emulate_rows_design(tc_q, hbm_q, age, params_q, plan) -> np.ndarray:
    """chip_pass.cu's row design on numpy: the whole groups' words folded
    with max.s16x2 and the edge masks of row_peak, the ragged group bytewise,
    and verdict_q; one uint8 verdict per chip."""
    C, T = tc_q.shape
    g = plan.rows_per_thread
    lookback, cutoff = (float(x) if abs(x) >= 1.1754944e-38 else 0.0
                        for x in params_q.astype(np.float32))
    ages = np.where(np.abs(age) < 1.1754944e-38, 0, age).astype(np.float32)

    def max_s16x2(a, b):
        lo = np.maximum(a.astype(np.uint16).view(np.int16), b.astype(np.uint16).view(np.int16))
        hi = np.maximum((a >> 16).astype(np.uint16).view(np.int16),
                        (b >> 16).astype(np.uint16).view(np.int16))
        return lo.view(np.uint16).astype(np.uint32) | hi.view(np.uint16).astype(np.uint32) << 16

    def fold(acc, w, lo, hi):
        keep = np.uint32((0xFFFFFFFF << (8 * lo)) & (0xFFFFFFFF >> (8 * (4 - hi))))
        w = (w & keep) | (np.uint32(0x80808080) & ~keep)
        acc = max_s16x2(acc, w & np.uint32(0xFF00FF00))
        return max_s16x2(acc, (w << np.uint32(8)) & np.uint32(0xFF00FF00))

    def peaks(x, n_whole):
        words = np.ascontiguousarray(x[:n_whole * g]).reshape(-1).view(np.uint32)
        words = words.reshape(n_whole, g * T // 4)
        out = np.empty((n_whole, g), np.int64)
        for R in range(g):
            acc = np.full(n_whole, 0x80008000, np.uint32)
            for k in range(R * T // 4, (R * T + T - 1) // 4 + 1):
                acc = fold(acc, words[:, k], max(R * T - 4 * k, 0), min(R * T + T - 4 * k, 4))
            out[:, R] = np.maximum(acc.astype(np.uint16).view(np.int16),
                                   (acc >> 16).astype(np.uint16).view(np.int16)) >> 8
        return out.reshape(-1)

    n_whole = C // g
    peak_tc = np.concatenate([peaks(tc_q, n_whole), tc_q[n_whole * g:].max(axis=1)])
    peak_hbm = np.concatenate([peaks(hbm_q, n_whole), hbm_q[n_whole * g:].max(axis=1)])
    idle = peak_tc == 0
    hbm_active = peak_hbm.astype(np.float32) >= np.float32(cutoff)
    return (idle & ~hbm_active & (ages >= np.float32(lookback))).astype(np.uint8)


@pytest.mark.parametrize("T", sorted(kernels._Q_ROWS_T))
def test_rows_design_arithmetic_matches_plain(T):
    """The row design's bit arithmetic, emulated, equals chip_pass_q_plain on
    rows salted with -128, -1, 0 and 127 and on ragged chip counts."""
    rng = np.random.default_rng(T)
    for C in (1, 5, 131, 1003):
        tc = np.where(rng.uniform(size=(C, T)) < 0.3, -1, 0).astype(np.int8)
        busy = rng.uniform(size=C) < 0.4
        tc[busy] = rng.integers(-1, 128, size=(int(busy.sum()), T))
        hbm = rng.integers(-1, 8, size=(C, T)).astype(np.int8)
        for x in (tc, hbm):
            x[rng.uniform(size=C) < 0.05] = -128
            x[rng.uniform(size=C) < 0.05] = 127
            salt = rng.uniform(size=(C, T)) < 0.02
            x[salt] = rng.choice(np.array([-128, 127, -1, 0], np.int8), size=int(salt.sum()))
        age = rng.uniform(0, 4000, size=C).astype(np.float32)
        for params in ((2100.0, 0.05), (2100.0, np.inf), (0.0, 1e-40), (2e-40, 0.5)):
            params_q = tp.quantize_params(np.array(params, np.float32))
            got = emulate_rows_design(tc, hbm, age, params_q, kernels._plan_q_rows(C, T))
            want = tp.chip_pass_q_plain(*to_torch(tc, hbm, age, params_q))
            np.testing.assert_array_equal(got, want.numpy().astype(np.uint8), err_msg=str(params))


@pytest.mark.parametrize("offset", range(16))
def test_misaligned_base_takes_tile_design(offset):
    """A view whose data pointer is off a 16-byte boundary, in any of the
    three inputs, makes chip_pass_q launch the tile design; aligned inputs
    of short rows the row design."""
    C, T = 1003, 12
    flat = torch.zeros(C * T + 32, dtype=torch.int8)
    base = (-flat.data_ptr()) % 16  # flat[base:] starts on a 16-byte boundary
    tc = flat[base + offset:base + offset + C * T].view(C, T)
    hbm = torch.zeros(C, T, dtype=torch.int8)
    age_flat = torch.zeros(C + 8)
    age = age_flat[(-age_flat.data_ptr()) % 16 // 4:][:C]
    age_off = age_flat[(-age_flat.data_ptr()) % 16 // 4 + 1:][:C]
    assert hbm.data_ptr() % 16 == 0 and age.data_ptr() % 16 == 0
    rows = kernels._plan_q_rows(C, T)
    tiles = kernels._plan_q(C, T, 132)
    assert kernels._plan_for(tc, hbm, age, 132) == (rows if offset == 0 else tiles)
    assert kernels._plan_for(hbm, tc, age, 132) == (rows if offset == 0 else tiles)
    assert kernels._plan_for(hbm, hbm, age_off, 132) == tiles


def test_chip_pass_q_empty_fleet_launches_nothing():
    tp.reset_launches()
    empty = torch.empty((0, 12), dtype=torch.int8)
    out = tp.chip_pass_q(empty, empty, torch.empty(0), torch.tensor([2100.0, 1.0]))
    assert out.shape == (0,) and out.dtype == torch.bool
    assert tp.LAUNCHES == {"chip_pass": 0, "chip_pass_q": 0, "slice_gate": 0,
                           "slice_scatter": 0, "window_gather": 0, "window_join": 0,
                           "sweep_pass": 0, "sweep_scatter": 0}
    assert kernels.DESIGN_LAUNCHES == {"rows": 0, "tiles": 0}


# ── the f32 kernel's group design for short rows (plan and arithmetic) ───

_F32_MIN = np.float32(1.1754944e-38)


def test_f32_design_constants_agree_with_the_kernels():
    """_F32_GROUPS_K, _F32_LONG_K and _F32_WARPS_PER_BLOCK are what
    chip_pass.cu instantiates and launches (GroupsK, LongK,
    kWarpsPerBlock); every plan up to the threshold uses an instantiated K
    of the group design, every plan above it one of the long-row design;
    the threshold is the one PERF.md states."""
    src = (Path(kernels.__file__).parent / "csrc" / "chip_pass.cu").read_text()
    for name, ks in (("GroupsK", kernels._F32_GROUPS_K), ("LongK", kernels._F32_LONG_K)):
        listed = re.search(rf"using {name} = std::integer_sequence<int, ([\d, ]+)>;", src)
        assert ks == {int(k) for k in listed.group(1).split(",")}
    assert {kernels._plan_long(1, T).samples_per_lane
            for T in range(kernels._F32_GROUPS_MAX_T + 1, 3000)} == kernels._F32_LONG_K
    assert kernels._F32_WARPS_PER_BLOCK == int(
        re.search(r"constexpr int kWarpsPerBlock = (\d+);", src).group(1))
    perf = (Path(kernels.__file__).parents[2] / "PERF.md").read_text()
    assert f"`_F32_GROUPS_MAX_T = {kernels._F32_GROUPS_MAX_T}`" in perf
    assert {kernels._plan_groups(1, T).samples_per_lane
            for T in range(1, kernels._F32_GROUPS_MAX_T + 1)} == kernels._F32_GROUPS_K
    assert kernels._plan_groups(1, kernels._F32_GROUPS_MAX_T).lanes_per_row == 32


@pytest.mark.parametrize("num_chips", [1, 3, 31, 1003, 131072])
def test_choose_plan_f32_takes_each_design_where_intended(num_chips):
    """The group design for every T up to the threshold, the long-row
    design above it (16 samples a lane where that is one chunk and 12 are
    not, else 12; T = 360 one chunk of 12); among the forced plans the
    plan's, and the long-row design beside the group design's."""
    grid = -(-num_chips // 8)
    for T in range(1, 3000):
        plan = kernels._choose_plan_f32(num_chips, T)
        if T <= kernels._F32_GROUPS_MAX_T:
            assert plan == kernels._plan_groups(num_chips, T)
        else:
            assert plan == kernels.PlanLong(16 if 384 < T <= 512 else 12, grid)
        design = kernels.F32_DESIGNS[type(plan)]
        assert kernels._f32_plans(num_chips, T) == {design: plan,
                                                    "long": kernels._plan_long(num_chips, T)}
        assert set(kernels._f32_plans(num_chips, T)) == (
            {"groups", "long"} if T <= kernels._F32_GROUPS_MAX_T else {"long"})
    assert kernels._choose_plan_f32(num_chips, 360) == kernels.PlanLong(12, grid)
    assert kernels._choose_plan_f32(num_chips, 8) == kernels.PlanGroups(
        2, 4, -(-num_chips // 128))


def groups_design_map(C: int, T: int, plan):
    """The group design's walk, replayed from the kernel's index arithmetic
    over every thread of the grid, as [warps, 32] arrays of each lane's
    row, lane in its row and live flag, for the warps that stay (whose
    first row exists)."""
    L, _, grid = plan
    log2 = L.bit_length() - 1
    assert 1 << log2 == L
    thread = np.arange(grid * kernels._F32_WARPS_PER_BLOCK * 32, dtype=np.int64)
    lane = thread & 31
    warp_row0 = (thread >> 5) << (5 - log2)  # blockIdx * 8 + warp, then rows a warp
    lane_in_row = lane & (L - 1)
    row = warp_row0 + (lane >> log2)
    stays = (warp_row0 < C).reshape(-1, 32)[:, 0]
    return (row.reshape(-1, 32)[stays], lane_in_row.reshape(-1, 32)[stays],
            (row < C).reshape(-1, 32)[stays])


def long_design_map(C: int, T: int, plan):
    """The long-row design's walk, replayed from the kernel's index
    arithmetic over every thread of the grid: each lane's row as a
    [warps, 32] array for the warps that stay (whose row exists), and the
    sample t0 + lane + 32 j that a lane loads for each chunk start t0 < T
    (0, 32 K, ...) and each j < K, as a [chunks, K, 32] array (a sample at
    or past T is not loaded)."""
    K, grid = plan
    thread = np.arange(grid * kernels._F32_WARPS_PER_BLOCK * 32, dtype=np.int64)
    row = (thread >> 5).reshape(-1, 32)  # blockIdx * 8 + warp
    t = (np.arange(0, T, 32 * K)[:, None, None] + 32 * np.arange(K)[None, :, None]
         + np.arange(32)[None, None, :])
    return row[row[:, 0] < C], t


# rows longer than the group design's: each limit of the long-row design's
# chunks (384 and 512 samples), and rows of several chunks
LONG_T = (257, 300, 360, 383, 384, 385, 512, 513, 720, 769, 1000, 1024, 2880)


@pytest.mark.parametrize("num_chips", [1, 3, 31, 1003, 131072])
def test_f32_plans_cover_each_row_once(num_chips):
    """For every T up to 64, the threshold's two sides and the long rows of
    LONG_T (at 131,072 chips up to 360): every sample of every row is
    loaded by exactly one lane, every verdict written by one lane, and the
    grid has no block without a row (what groups_plan_ok and long_plan_ok
    check in C)."""
    C = num_chips
    limit = kernels._F32_GROUPS_MAX_T
    long_t = [T for T in LONG_T if C * T <= 131072 * 360]
    for T in sorted(set(range(1, 65)) | {limit, limit + 1} | set(long_t)):
        plan = kernels._choose_plan_f32(C, T)
        if isinstance(plan, kernels.PlanLong):
            assert T > limit
            K, grid = plan
            per_block = kernels._F32_WARPS_PER_BLOCK
            assert (grid - 1) * per_block < C <= grid * per_block
            assert 32 * K * (-(-T // (32 * K)) - 1) < T  # no chunk without a sample
            row, t = long_design_map(C, T, plan)
            np.testing.assert_array_equal(np.sort(row[:, 0]), np.arange(C))
            assert (row == row[:, :1]).all()  # a warp a row
            seen = (row[:, None, None, :] * T + t[None])[np.broadcast_to(t < T, (len(row),)
                                                                        + t.shape)]
            np.testing.assert_array_equal(np.bincount(seen, minlength=C * T), 1)
            continue
        L, K, grid = plan
        assert L * K >= T and (L == 32 or L * K < 2 * T or T <= K)
        per_block = kernels._F32_WARPS_PER_BLOCK * (32 // L)
        assert (grid - 1) * per_block < C <= grid * per_block
        row, lane_in_row, live = groups_design_map(C, T, plan)
        loads = [row * T + lane_in_row + j * L for j in range(K)]
        seen = np.concatenate([x[live & (lane_in_row + j * L < T)]
                               for j, x in enumerate(loads)])
        np.testing.assert_array_equal(np.bincount(seen, minlength=C * T), 1)
        np.testing.assert_array_equal(np.sort(row[live & (lane_in_row == 0)]), np.arange(C))


def _flush(x):
    return np.where(np.abs(x) < _F32_MIN, np.float32(0), x).astype(np.float32)


class _Peaks:
    """RowPeaks of chip_pass.cu over numpy arrays of lanes."""

    def __init__(self, n):
        self.max = {k: np.full(n, -np.inf, np.float32) for k in ("tc", "hbm")}
        self.nan = {k: np.zeros(n, bool) for k in ("tc", "hbm")}
        self.has = np.zeros(n, bool)

    def add(self, x_tc, x_hbm, v, active):
        """RowPeaks::add where ``active``: an invalid sample reads as -1."""
        self.has |= active & v
        for k, x in (("tc", x_tc), ("hbm", x_hbm)):
            x = np.where(v, _flush(x), np.float32(-1))
            self.nan[k] |= active & np.isnan(x)
            up = active & ~np.isnan(x) & (x > self.max[k])
            self.max[k] = np.where(up, x, self.max[k])

    def verdict(self, age, lookback, cutoff):
        """verdict_f32."""
        value = {k: np.where(self.nan[k], np.float32(np.nan), self.max[k]) for k in self.max}
        with np.errstate(invalid="ignore"):
            idle = (value["tc"] <= 0) & self.has
            hbm_active = value["hbm"] >= cutoff
        return (idle & ~hbm_active & (_flush(age) >= lookback)).astype(np.uint8)


def emulate_groups_design(tc, hbm, valid, age, params, plan) -> np.ndarray:
    """chip_pass.cu's group design on numpy: each lane's strided loads,
    the xor-shuffle tree over the group's lanes, the ballots masked to the
    group, and verdict_f32 on each group's first lane."""
    C, T = tc.shape
    L, K, _ = plan
    row, lane_in_row, live = groups_design_map(C, T, plan)
    shape = row.shape
    row, lane_in_row, live = row.ravel(), lane_in_row.ravel(), live.ravel()
    p = _Peaks(row.size)
    for j in range(K):
        t = lane_in_row + j * L
        active = live & (t < T)
        r, tt = np.where(active, row, 0), np.where(active, t, 0)
        p.add(tc[r, tt], hbm[r, tt], valid[r, tt], active)
    return _lane_group_verdicts(p, shape, L, row, lane_in_row, live, age, params, C)


def emulate_long_design(tc, hbm, valid, age, params, plan) -> np.ndarray:
    """chip_pass.cu's long-row design on numpy: each lane's chunks of K
    samples 32 apart, folded chunk by chunk in the kernel's order, then
    the xor-shuffle tree over the warp, the warp votes of the flags and
    verdict_f32 on lane 0, as in the group design with 32 lanes a row."""
    C, T = tc.shape
    row, t = long_design_map(C, T, plan)
    shape = row.shape
    row = row.ravel()
    p = _Peaks(row.size)
    for chunk in t:
        for t_j in chunk:  # LaneSamples<K>::fold
            tt = np.tile(t_j, shape[0])
            active = tt < T
            tt = np.where(active, tt, 0)
            p.add(tc[row, tt], hbm[row, tt], valid[row, tt], active)
    lane_in_row = np.tile(np.arange(32), shape[0])
    return _lane_group_verdicts(p, shape, 32, row, lane_in_row, np.ones(row.size, bool), age,
                                params, C)


def _lane_group_verdicts(p, shape, L, row, lane_in_row, live, age, params, C) -> np.ndarray:
    """The end both designs share, over lanes laid out as [warps, 32]: the
    xor shuffles of the two maxima inside each group of L lanes, the flags'
    ballots masked to the group, and verdict_f32 on each group's first
    lane; out[row] for every row, 255 where no lane wrote one."""
    lookback, cutoff = _flush(params.astype(np.float32))
    lane = np.arange(32)
    for k in p.max:  # other = __shfl_xor_sync(max, off); max = other > max ? other : max
        m = p.max[k].reshape(shape)
        off = L >> 1
        while off:
            other = m[:, lane ^ off]
            m = np.where(other > m, other, m)
            off >>= 1
        p.max[k] = m.ravel()
    group = np.uint64((1 << L) - 1 if L < 32 else 0xFFFFFFFF) << \
        (np.tile(lane, shape[0]) - lane_in_row).astype(np.uint64)
    weights = np.uint64(1) << lane.astype(np.uint64)
    for flags in (p.nan["tc"], p.nan["hbm"], p.has):
        ballot = (flags.reshape(shape).astype(np.uint64) * weights).sum(axis=1)
        flags[:] = (np.repeat(ballot, 32) & group) != 0
    leader = live & (lane_in_row == 0)
    out = np.full(C, 255, np.uint8)
    out[row[leader]] = p.verdict(age[np.where(live, row, 0)], lookback, cutoff)[leader]
    return out


_jax_chips = None


def jax_evaluate_chips(tc, hbm, valid, age, params):
    global _jax_chips
    if _jax_chips is None:
        import jax
        _jax_chips = jax.jit(jeng.evaluate_chips)
    return np.asarray(_jax_chips(*(jnp.asarray(x) for x in (tc, hbm, valid, age)),
                                 jnp.float32(params[0]), jnp.float32(params[1])))


@pytest.mark.parametrize("T", range(1, 34))
def test_f32_group_design_matches_plain_and_reference(T):
    """The group design's arithmetic, emulated in the plan's lanes and
    samples, equals chip_pass_plain and the JAX evaluate_chips on
    adversarial fleets of ragged chip counts, with rows right-aligned
    behind invalid padding as a dump's shorter series load."""
    rng = np.random.default_rng(1000 + T)
    for C in (1, 5, 131, 1003):
        tc, hbm, valid, age = f32_edge_fleet(rng, C, T)
        plan = kernels._choose_plan_f32(C, T)
        assert isinstance(plan, kernels.PlanGroups)
        for params in F32_PARAMS:
            parr = np.array(params, np.float32)
            want = tp.chip_pass_plain(*to_torch(tc, hbm, valid, age, parr)).numpy()
            np.testing.assert_array_equal(jax_evaluate_chips(tc, hbm, valid, age, parr), want)
            got = emulate_groups_design(tc, hbm, valid, age, parr, plan)
            np.testing.assert_array_equal(got, want.astype(np.uint8),
                                          err_msg=f"C={C}, {plan}, {params}")


@pytest.mark.parametrize("T", [257, 360, 513, 1000])
def test_f32_long_design_matches_plain_and_reference(T):
    """The long-row design's arithmetic, emulated in the plan's chunks,
    equals chip_pass_plain and the JAX evaluate_chips on adversarial fleets
    of ragged chip counts, with rows behind invalid padding and special
    values (busy, NaN, +-inf, -0.0, subnormal, negative) in a row's last
    sample, the last chunk's."""
    rng = np.random.default_rng(2000 + T)
    candidates = 0
    for C in (1, 5, 131, 1003):
        tc, hbm, valid, age = f32_edge_fleet(rng, C, T)
        plan = kernels._choose_plan_f32(C, T)
        assert isinstance(plan, kernels.PlanLong)
        for params in F32_PARAMS:
            parr = np.array(params, np.float32)
            want = tp.chip_pass_plain(*to_torch(tc, hbm, valid, age, parr)).numpy()
            np.testing.assert_array_equal(jax_evaluate_chips(tc, hbm, valid, age, parr), want)
            got = emulate_long_design(tc, hbm, valid, age, parr, plan)
            np.testing.assert_array_equal(got, want.astype(np.uint8),
                                          err_msg=f"C={C}, {plan}, {params}")
            candidates += int(want.sum())
    assert candidates > 0


def test_chip_pass_empty_fleet_launches_nothing():
    tp.reset_launches()
    empty = torch.empty((0, 8))
    out = tp.chip_pass(empty, empty, empty.bool(), torch.empty(0), torch.tensor([2100.0, 1.0]))
    assert out.shape == (0,) and out.dtype == torch.bool
    assert tp.LAUNCHES == {"chip_pass": 0, "chip_pass_q": 0, "slice_gate": 0,
                           "slice_scatter": 0, "window_gather": 0, "window_join": 0,
                           "sweep_pass": 0, "sweep_scatter": 0}
    assert kernels.F32_DESIGN_LAUNCHES == {"groups": 0, "long": 0}
    long_empty = torch.empty((0, 360))
    out = tp.chip_pass(long_empty, long_empty, long_empty.bool(), torch.empty(0),
                       torch.tensor([2100.0, 1.0]))
    assert out.shape == (0,) and kernels.F32_DESIGN_LAUNCHES == {"groups": 0, "long": 0}


def dump_at_width(rng, C: int, T: int, S: int) -> dict:
    """A dump document in the dump format with T samples a full series:
    about half the slices idle, a share of chips with 1 to T - 1 samples
    (so load_fleet right-aligns them behind invalid padding), some HBM
    series of another length, a few young pods and NaN samples."""
    chips = []
    for i in range(C):
        s = i % S
        n = T if rng.uniform() < 0.7 else int(rng.integers(1, T))
        busy = s % 2 == 1 or rng.uniform() < 0.01
        tc = [float(x) for x in (rng.uniform(0.2, 1.0, n) if busy else np.zeros(n))]
        if rng.uniform() < 0.01:
            tc[int(rng.integers(0, n))] = float("nan")
        chip = {"slice": f"ns/slice-{s:03d}", "id": f"ns/pod-{i}/tpu",
                "tc": tc, "pod_age_s": 60.0 if rng.uniform() < 0.01 else 7200.0}
        if rng.uniform() < 0.8:
            m = n if rng.uniform() < 0.8 else int(rng.integers(1, T + 1))
            hbm = rng.uniform(0.0, 0.04, m)
            if rng.uniform() < 0.01:
                hbm[-1] = 0.06  # an HBM-active chip
            chip["hbm"] = [float(x) for x in hbm]
        chips.append(chip)
    return {"timestamp": 1000.0, "hbm_threshold": 0.05, "chips": chips}


def test_evaluate_loaded_at_dump_width_matches_reference(tmp_path):
    """analyze.evaluate_loaded on a dump of 8-sample series (the dump's
    default window and step), right-aligned and padded, gives the JAX
    analyze's verdicts and idle chips; the port's CLI its JSON line."""
    import contextlib
    import io
    import json

    from tpu_pruner import analyze as jax_analyze
    from tpu_pruner_torch import analyze as torch_analyze

    doc = dump_at_width(np.random.default_rng(8), 1003, 8, 101)
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(doc))

    def run(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            assert main(argv) == 0
        return json.loads(out.getvalue().strip().splitlines()[-1])

    ref = run(jax_analyze.main, [str(path)])
    fleet, names, _, _ = torch_analyze.load_fleet(json.loads(path.read_text()))
    assert fleet[0].shape == (1003, 8) and not fleet[2].all()
    params = tp.PolicyParams(lookback_s=30 * 60 + 300, hbm_threshold=0.05)
    verdicts, candidates = torch_analyze.evaluate_loaded(fleet, len(names), params,
                                                         device=CPU)
    assert [names[i] for i in np.flatnonzero(verdicts)] == ref["reclaimable_slices"]
    assert int(candidates.sum()) == ref["idle_chips"]
    assert 0 < len(ref["reclaimable_slices"]) < len(names)
    assert run(torch_analyze.main, [str(path), "--device", "cpu"]) == ref


# ── the contiguous slice gate (work split) ────────────────────────────────

GATE_CASES = gate_cases(2023)
# the width and signedness of the bounds' difference, as the wrapper passes them
GATE_WRAP = {np.dtype(np.int32): (32, True), np.dtype(np.int64): (32, True),
             np.dtype(np.int8): (8, True), np.dtype(np.int16): (16, True),
             np.dtype(np.uint8): (8, False)}


def _gate_index(b: int, C: int) -> int:
    """clamp(b, -(C+1), C), a negative bound from the end (gate_index)."""
    n = C + 1
    b = min(max(b, -n), C)
    return b + n if b < 0 else b


def _gate_open(b0: int, b1: int, bits: int, signed: bool) -> bool:
    """int32 of b1 - b0 taken in `bits` bits, signed or not, is > 0."""
    d = (b1 - b0) % 2**bits
    if signed and d >= 2**(bits - 1):
        d -= 2**bits
    return d > 0


def gate_grid(C: int, S: int) -> tuple:
    """(slices a block, blocks) of tp_slice_gate's grid (gate_grid): a
    thread a slice in blocks of _GATE_THREADS, or the slices spread over
    C / _GATE_CHIPS_PER_BLOCK blocks where that is more, at most one a
    slice."""
    blocks = -(-S // kernels._GATE_THREADS)
    spread = -(-C // kernels._GATE_CHIPS_PER_BLOCK)
    if spread > blocks:
        blocks = min(spread, S)
    per = -(-S // blocks)
    return per, -(-S // per)


def gate_walk(total: int) -> np.ndarray:
    """The run's granule indices in the order the block's threads load them
    (tp_slice_gate's walk): thread r, in warp r // 32 at lane r % 32, reads
    granule (r // 32) 32 W + r % 32 + 32 u of each round of
    _GATE_THREADS x W granules, for u < W = _GATE_WALK_GRANULES; indices
    past the run load nothing."""
    W = kernels._GATE_WALK_GRANULES
    threads = kernels._GATE_THREADS
    r = np.arange(threads)
    first = (r >> 5) * 32 * W + (r & 31)
    rounds = np.arange(-(-total // (threads * W)))
    j = (rounds[:, None, None] * threads * W + first[None, :, None]
         + 32 * np.arange(W)[None, None, :])
    return j[j < total]


def emulate_slice_gate(cand, bounds, base: int):
    """numpy replay of tp_slice_gate's work split, the candidate starting
    `base` bytes past a 16-byte boundary: per slice, its granules (the
    aligned 16 bytes that hold its chips, the bytes outside its range
    masked); a slice of up to _GATE_LANE_GRANULES granules read by its
    thread alone; a longer one's first and last granule by its thread,
    then, if neither is busy, its interior granules in its block's lists
    (in thread order; a block owns gate_grid's `per` slices), and each
    block's lists walked as one run (gate_walk). Returns (verdicts uint8[S], the chips each slice tested,
    the first chip of each granule it loaded, each slice's [lo, hi), and
    whether its block walked it)."""
    C, S = cand.size, bounds.size - 1
    bits, signed = GATE_WRAP[bounds.dtype]
    per, _ = gate_grid(C, S)
    verdicts = np.zeros(S, np.uint8)
    tested = [[np.zeros(0, np.int64)] for _ in range(S)]
    loaded = [[np.zeros(0, np.int64)] for _ in range(S)]
    spans, walked = [(0, 0)] * S, np.zeros(S, bool)
    lists = {}  # block -> [(slice, first interior chip, interior granules)]

    def read(s, chips0, lo, hi) -> bool:  # granules starting at chips0: any busy chip in range
        chips = chips0[:, None] + np.arange(16)[None, :]
        loaded[s].append(chips0)
        t = chips[(chips >= lo) & (chips < hi)]
        tested[s].append(t)
        return bool((~cand[t]).any())

    for s in range(S):
        b0, b1 = int(bounds[s]), int(bounds[s + 1])
        if not _gate_open(b0, b1, bits, signed):
            continue
        lo, hi = sorted((_gate_index(b0, C), _gate_index(b1, C)))
        spans[s] = (lo, hi)
        a = (base + lo) // 16 * 16 - base  # the first granule's first chip
        n = 0 if lo == hi else (-(-(base + hi) // 16) * 16 - base - a) // 16
        if n <= kernels._GATE_LANE_GRANULES:
            verdicts[s] = not read(s, a + 16 * np.arange(n), lo, hi)
        elif not read(s, np.array([a, a + 16 * (n - 1)]), lo, hi):
            lists.setdefault(s // per, []).append((s, a + 16, n - 2))
    for run in lists.values():
        start = np.concatenate([[0], np.cumsum([n for _, _, n in run])])
        j = gate_walk(int(start[-1]))
        e = np.searchsorted(start, j, side="right") - 1
        first = np.array([f for _, f, _ in run])
        for k, (s, _, _) in enumerate(run):
            walked[s] = True
            mine = j[e == k] - start[k]
            verdicts[s] = not read(s, first[k] + 16 * mine, *spans[s])
    return (verdicts, [np.concatenate(t) for t in tested], [np.concatenate(x) for x in loaded],
            spans, walked)


def test_gate_constants_agree_with_the_kernels():
    """_GATE_THREADS, _GATE_LANE_GRANULES, _GATE_WALK_GRANULES and
    _GATE_CHIPS_PER_BLOCK are chip_pass.cu's kGateThreads,
    kGateLaneGranules, kGateWalkGranules and kGateChipsPerBlock, and the
    kernel's walk reads granules as gate_walk replays it."""
    src = (Path(kernels.__file__).parent / "csrc" / "chip_pass.cu").read_text()
    for name, value in (("kGateThreads", kernels._GATE_THREADS),
                        ("kGateLaneGranules", kernels._GATE_LANE_GRANULES),
                        ("kGateWalkGranules", kernels._GATE_WALK_GRANULES),
                        ("kGateChipsPerBlock", kernels._GATE_CHIPS_PER_BLOCK)):
        assert int(re.search(rf"constexpr int(?:64_t)? {name} = (\d+);", src).group(1)) == value, \
            name
    for line in ("int64_t at = int64_t(warp) * 32 * kGateWalkGranules + lane;",
                 "const int64_t j = at + int64_t(u) * 32;",
                 "int64_t(kGateThreads) * kGateWalkGranules"):
        assert line in src, line


@pytest.mark.parametrize(("C", "S"), [(0, 1), (16, 1), (131072, 8192), (131072, 3283),
                                    (1048576, 1), (1048576, 16), (1048576, 128), (1048576, 1024),
                                    (1048576, 65536), (1048576, 1048576), (10**9, 3)])
def test_gate_grid_owns_each_slice_once(C, S):
    """gate_grid gives every slice one owner thread: blocks of `per` <=
    _GATE_THREADS slices, no block empty; the main path's fleets keep
    _GATE_THREADS slices a block, fleets of few slices spread them over up
    to C / _GATE_CHIPS_PER_BLOCK blocks."""
    per, blocks = gate_grid(C, S)
    assert 1 <= per <= kernels._GATE_THREADS
    assert (blocks - 1) * per < S <= blocks * per
    least, spread = -(-S // kernels._GATE_THREADS), -(-C // kernels._GATE_CHIPS_PER_BLOCK)
    if least >= spread:
        assert (per, blocks) == (min(S, kernels._GATE_THREADS), least)
    else:
        assert per == -(-S // min(spread, S))
    assert gate_grid(131072, 8192) == (512, 16) and gate_grid(1048576, 128) == (2, 64)


@pytest.mark.parametrize("total", [1, 31, 255, 256, 16383, 16384, 16385, 65534])
def test_gate_walk_loads_each_granule_once(total):
    """The block's walk loads every granule of a run of `total` exactly
    once (65,534: the interior of one slice of 1,048,576 chips), and a
    warp's load u reads 32 consecutive granules."""
    j = gate_walk(total)
    np.testing.assert_array_equal(np.sort(j), np.arange(total))
    W, threads = kernels._GATE_WALK_GRANULES, kernels._GATE_THREADS
    r = np.arange(threads)
    first = (r >> 5) * 32 * W + (r & 31)
    assert (np.diff(first.reshape(-1, 32), axis=1) == 1).all()


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_slice_gate_replay_matches_plain_and_reference(case):
    """The replay of the gate's work split, with the candidate at each of
    GATE_OFFSETS past a 16-byte boundary: no
    chip tested outside a slice's range, no granule loaded that holds none
    of its chips, and the verdicts of slice_gate_plain and of the JAX
    slice_verdicts_contiguous. The JAX engine (x64 off) narrows int64
    bounds to int32 before it reads them, so the int64 case whose bounds
    pass 2^31 is held to the plain version alone: the port reads int64
    bounds whole, as its plain version does."""
    cand, bounds = GATE_CASES[case]
    S = bounds.size - 1
    want = tp.slice_verdicts_contiguous(torch.from_numpy(cand), torch.from_numpy(bounds))
    assert want.shape == (max(S, 0),)
    if np.iinfo(bounds.dtype).bits <= 32 or np.abs(bounds).max(initial=0) < 2**31:
        ref = jeng.slice_verdicts_contiguous(jnp.asarray(cand), jnp.asarray(bounds))
        np.testing.assert_array_equal(want.numpy(), np.asarray(ref))
    if S <= 0:
        return
    for k in GATE_OFFSETS:
        got, tested, loaded, spans, _ = emulate_slice_gate(cand, bounds, 4096 + k)
        for t, x, (lo, hi) in zip(tested, loaded, spans):
            assert ((t >= lo) & (t < hi)).all(), k
            assert ((x + 16 > lo) & (x < hi)).all(), k
        np.testing.assert_array_equal(got, want.numpy().astype(np.uint8), err_msg=f"offset {k}")


@pytest.mark.parametrize("offset", GATE_OFFSETS)
def test_slice_gate_replay_reads_each_chip_once(offset):
    """On all-idle candidates, where no slice is settled by its first or
    last granule, the replay tests each chip of each open slice's range
    exactly once, through its thread or its block's walk, and no chip of
    an empty or inverted slice; both ways are taken."""
    ways = set()
    for case, (cand, bounds) in GATE_CASES.items():
        if bounds.size <= 1:
            continue
        idle = np.ones_like(cand)
        got, tested, _, spans, walked = emulate_slice_gate(idle, bounds, 4096 + offset)
        for s, (t, (lo, hi)) in enumerate(zip(tested, spans)):
            np.testing.assert_array_equal(np.sort(t), np.arange(lo, hi),
                                          err_msg=f"{case}, slice {s}")
        want = kernels.slice_gate_plain(torch.from_numpy(idle), torch.from_numpy(bounds))
        np.testing.assert_array_equal(got, want.numpy().astype(np.uint8), err_msg=case)
        ways |= set(walked.tolist())
    assert ways == {False, True}


@pytest.mark.parametrize("where", ["first", "second granule", "middle", "last granule",
                                   "last"])
def test_slice_gate_replay_sees_each_busy_chip(where):
    """The replay is not vacuous: on the mixed fleet (16-chip slices and
    long ones), all idle but for one busy chip a slice at its first chip,
    16 chips in, its middle, 16 chips from its end or its last chip, every
    slice is busy, at every offset; a busy chip in a long slice's first or
    last granule settles it in its thread, one in its interior is found by
    its block's walk."""
    cand, bounds = GATE_CASES["mixed: 16-chip slices, one of 4,096, 8,960 and 65,536 chips"]
    lo, hi = bounds[:-1].astype(np.int64), bounds[1:].astype(np.int64)
    at = {"first": lo, "second granule": np.minimum(lo + 16, hi - 1), "middle": (lo + hi) // 2,
          "last granule": np.maximum(hi - 17, lo), "last": hi - 1}[where]
    busy = np.ones_like(cand)
    busy[at] = False
    for k in GATE_OFFSETS:
        got, _, _, _, walked = emulate_slice_gate(busy, bounds, 4096 + k)
        assert not got.any(), k
        assert walked.sum() == (0 if where in ("first", "last") else 3), k


def test_slice_gate_wrapper_validates_inputs():
    """slice_gate takes bool candidates and int32, int64, int8, int16 or
    uint8 bounds, 1-D, contiguous and on one device; on the CPU it is its
    plain version and counts no launch."""
    cand = torch.tensor([True, False, True, True])
    bounds = torch.tensor([0, 1, 3, 4], dtype=torch.int32)
    for dtype in (torch.bool, torch.float32, torch.float64, torch.uint16, torch.uint32):
        with pytest.raises(TypeError, match="bounds"):
            kernels.slice_gate(cand, bounds.to(dtype))
    with pytest.raises(TypeError, match="candidate"):
        kernels.slice_gate(cand.to(torch.uint8), bounds)
    with pytest.raises(ValueError, match="1-D"):
        kernels.slice_gate(cand.view(2, 2), bounds)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.slice_gate(cand, torch.arange(8, dtype=torch.int32)[::2])
    tp.reset_launches()
    for dtype in (torch.int32, torch.int64, torch.int8, torch.int16, torch.uint8):
        got = kernels.slice_gate(cand, bounds.to(dtype))
        assert torch.equal(got, kernels.slice_gate_plain(cand, bounds.to(dtype)))
        assert got.tolist() == [True, False, True]
    assert kernels.slice_gate(cand, bounds[:1]).shape == (0,)  # S = 0
    assert tp.LAUNCHES == {"chip_pass": 0, "chip_pass_q": 0, "slice_gate": 0,
                           "slice_scatter": 0, "window_gather": 0, "window_join": 0,
                           "sweep_pass": 0, "sweep_scatter": 0}


# --- the scatter slice reduction (tp_slice_scatter) ---------------------------

SCATTER_CASES = scatter_cases(2024)


def emulate_slice_scatter(cand, ids, num_slices: int):
    """numpy replay of tp_slice_scatter: the marks kernel warp by warp (a
    chip's mark is 2 s for a candidate, 2 s + 1 for a busy chip, none for an
    id outside [0, S), compared in int64; a lane stores its mark unless the
    lane before holds the same one), then the verdict kernel's
    little-endian read of each slice's two marks as one 16-bit word.
    Returns (verdicts, the stores the marks kernel makes)."""
    ids = ids.astype(np.int64)
    keep = (ids >= 0) & (ids < num_slices)
    m = np.full(ids.size, -1, np.int64)
    m[keep] = 2 * ids[keep] + (~cand[keep]).astype(np.int64)
    lanes = np.concatenate([m, np.full(-m.size % 32, -1)]).reshape(-1, 32)
    before = np.concatenate([np.full((lanes.shape[0], 1), -1), lanes[:, :-1]], axis=1)
    store = (lanes >= 0) & ((np.arange(32) == 0) | (before != lanes))
    marks = np.zeros(2 * num_slices, np.uint8)
    marks[lanes[store]] = 1
    return marks.view("<u2") == 1, int(store.sum())


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_slice_scatter_replay_matches_plain_and_reference(case):
    """The kernel's marks and verdict rule, replayed, give the plain
    version's verdicts (the index_add_ counts of slice_counts), and where the
    ids are int32 the JAX reference's slice_verdicts."""
    cand, ids, S = SCATTER_CASES[case]
    got, _ = emulate_slice_scatter(cand, ids, S)
    want = kernels.slice_scatter(torch.from_numpy(cand), torch.from_numpy(ids), S)
    np.testing.assert_array_equal(got, want.numpy())
    assert torch.equal(want, kernels.slice_scatter_plain(torch.from_numpy(cand),
                                                         torch.from_numpy(ids), S))
    if ids.dtype == np.int32 and S:
        ref = jeng.slice_verdicts(jnp.asarray(cand), jnp.asarray(ids), S)
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("C", [1, 31, 32, 33, 70001])
def test_slice_scatter_replay_stores_once_a_warp_on_one_slice(C):
    """All chips in one slice, every one a candidate: the marks kernel
    stores once a warp, never once a chip (the skew that index_add_ paid
    for with an atomic a chip)."""
    got, stores = emulate_slice_scatter(np.ones(C, bool), np.zeros(C, np.int32), 1)
    assert got.tolist() == [True] and stores == -(-C // 32)


def test_slice_scatter_replay_stores_once_a_host_in_host_order():
    """In the cut gke-65k layout a host's four chips share a mark unless one
    is busy, so the kernel stores at most once a host plus once for each
    busy chip and each warp edge."""
    cand, ids, S = SCATTER_CASES["cut gke-65k layout in host order"]
    _, stores = emulate_slice_scatter(cand, ids, S)
    assert stores <= ids.size // 4 + 2 * int((~cand).sum())


def test_slice_scatter_wrapper_validates_inputs():
    """slice_scatter takes bool candidates and int32 or int64 ids, 1-D,
    contiguous, of one length and on one device, and S >= 0; it refuses the
    rest before any launch. On the CPU it is its plain version and counts
    no launch."""
    cand = torch.tensor([True, False, True, True])
    ids = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    for dtype in (torch.bool, torch.float32, torch.float64, torch.int16, torch.uint8):
        with pytest.raises(TypeError, match="slice ids"):
            kernels.slice_scatter(cand, ids.to(dtype), 3)
    with pytest.raises(TypeError, match="candidate"):
        kernels.slice_scatter(cand.to(torch.uint8), ids, 3)
    with pytest.raises(ValueError, match="1-D"):
        kernels.slice_scatter(cand.view(2, 2), ids.view(2, 2), 3)
    with pytest.raises(ValueError, match="shape"):
        kernels.slice_scatter(cand, ids[:3], 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.slice_scatter(cand, torch.arange(8, dtype=torch.int32)[::2], 3)
    with pytest.raises(ValueError, match="is on meta"):
        kernels.slice_scatter(cand, ids.to("meta"), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.slice_scatter(cand.to("meta"), ids.to("meta"), 3)
    with pytest.raises(ValueError, match="num_slices"):
        kernels.slice_scatter(cand, ids, -1)
    tp.reset_launches()
    for dtype in (torch.int32, torch.int64):
        got = kernels.slice_scatter(cand, ids.to(dtype), 4)
        assert torch.equal(got, kernels.slice_scatter_plain(cand, ids.to(dtype), 4))
        assert got.tolist() == [True, False, True, False]  # slice 3 holds no chip
    assert kernels.slice_scatter(cand, ids, 0).shape == (0,)  # S = 0
    assert kernels.slice_scatter(cand[:0], ids[:0], 2).tolist() == [False, False]  # C = 0
    assert tp.LAUNCHES == {"chip_pass": 0, "chip_pass_q": 0, "slice_gate": 0,
                           "slice_scatter": 0, "window_gather": 0, "window_join": 0,
                           "sweep_pass": 0, "sweep_scatter": 0}


def test_slice_verdicts_go_through_the_scatter_wrapper():
    """engine.slice_verdicts widens narrow ids, makes its inputs contiguous
    and hands them to kernels.slice_scatter, whose plain version is the
    index_add_ counts of slice_counts, which the sharded paths keep."""
    cand = torch.tensor([True, False, True, True, True, True])
    ids = torch.tensor([0, 9, 1, 1, 1, 2, 2, 2, 2, -1, 3, 4], dtype=torch.int8)[::2]
    got = tp.slice_verdicts(cand, ids, 4)
    busy, chips = tp.engine.slice_counts(cand, ids, 4)
    assert got.tolist() == ((busy == 0) & (chips > 0)).tolist() == [True, False, True, True]
    assert tp.engine.slice_counts is kernels.slice_counts
    assert tp.engine.normalize_slice_ids is kernels.normalize_slice_ids
    from tpu_pruner_torch.policy import sharded
    assert sharded.slice_counts is kernels.slice_counts

