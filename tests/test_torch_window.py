"""The port's uniform path and streaming window against the JAX reference.

The same seeded numpy inputs go through tpu_pruner.policy and
tpu_pruner_torch.policy (CPU tensors, so the plain versions of the
kernels). Outputs are booleans and int8 bytes: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pruner.policy import engine as jeng
from tpu_pruner_torch import policy as tp

CPU = "cpu"


def params_q(lookback_s=2100, hbm_threshold=0.05):
    p = tp.PolicyParams(lookback_s=lookback_s, hbm_threshold=hbm_threshold)
    return tp.quantize_params(np.array([p.lookback_s, p.hbm_cutoff()], np.float32))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same(ref, got):
    """JAX outputs against the port's, dtype and bytes."""
    for r, g in zip(ref, got):
        r = np.asarray(r)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert r.dtype == g.dtype and r.shape == g.shape
        np.testing.assert_array_equal(g, r)


def chunk(rng, C, T, busy=0.6, hbm_max=0.1):
    tc = (rng.uniform(size=(C, T)) < busy).astype(np.float32) * rng.uniform(size=(C, T))
    hbm = rng.uniform(0, hbm_max, size=(C, T)).astype(np.float32)
    valid = rng.uniform(size=(C, T)) < 0.9
    return tp.quantize_samples(tc, valid), tp.quantize_samples(hbm, valid)


# -- uniform path (tests/test_policy.py:495-536) ------------------------------


@pytest.mark.parametrize("seed", [47, 48, 49])
def test_uniform_path_matches_reference(seed):
    """evaluate_fleet_qu equals the JAX evaluate_fleet_qu and the port's own
    evaluate_fleet_qc: partly busy slices, HBM rescues, young pods, no-data
    chips."""
    rng = np.random.default_rng(seed)
    C, S, T = 128, 16, 12
    tc = (rng.uniform(size=(C, T)) < 0.5).astype(np.float32) * rng.uniform(size=(C, T))
    hbm = rng.uniform(0, 0.2, size=(C, T)).astype(np.float32)
    valid = rng.uniform(size=(C, T)) < 0.9
    valid[:3] = False
    age = rng.uniform(0, 4000, size=C).astype(np.float32)
    slice_id = np.repeat(np.arange(S, dtype=np.int32), C // S)
    quiet = slice_id < 8  # idle slices, some rescued by HBM or held by young pods
    tc[quiet] = 0.0
    hbm[quiet] = np.where(rng.uniform(size=(int(quiet.sum()), 1)) < 0.1, 0.2, 0.0)
    age[quiet] = np.where(rng.uniform(size=int(quiet.sum())) < 0.05, 60.0, 7200.0)
    tc_q, hbm_q = tp.quantize_samples(tc, valid), tp.quantize_samples(hbm, valid)
    pq = params_q()

    ref = jeng.evaluate_fleet_qu(jnp.asarray(tc_q), jnp.asarray(hbm_q), jnp.asarray(age),
                                 jnp.asarray(pq), chips_per_slice=C // S)
    got = tp.evaluate_fleet_qu(t(tc_q), t(hbm_q), t(age), t(pq), C // S)
    assert_same(ref, got)
    qc = tp.evaluate_fleet_qc(t(tc_q), t(hbm_q), t(age),
                              tp.slice_bounds(slice_id, S, device=CPU), t(pq))
    assert_same([x.numpy() for x in qc], got)
    assert 0 < int(got[0].sum()) < S  # neither all idle nor all busy


UNIFORM_CASES = {
    "ok": (np.repeat(np.arange(4, dtype=np.int32), 8), 8),
    "ragged_total": (np.repeat(np.arange(4, dtype=np.int32), 8)[:30], 8),
    "heterogeneous": (np.concatenate([np.zeros(8, np.int32), np.ones(24, np.int32)]), 16),
    "descending": (np.repeat(np.arange(4, dtype=np.int32), 8)[::-1].copy(), 8),
}


@pytest.mark.parametrize("case", sorted(UNIFORM_CASES))
def test_assert_uniform_slices_matches_reference(case):
    """Same return value, or the same ValueError text, as the reference."""
    sid, cps = UNIFORM_CASES[case]
    try:
        want = jeng.assert_uniform_slices(sid, cps)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tp.assert_uniform_slices(sid, cps)
        assert str(got.value) == str(exc)
        assert ("do not divide" in str(exc)) == (case == "ragged_total")
        assert ("not uniform-contiguous" in str(exc)) == (case != "ragged_total")
    else:
        assert case == "ok"
        assert tp.assert_uniform_slices(sid, cps) == want == 4
        assert tp.assert_uniform_slices(t(sid), cps) == 4


# -- streaming window (tests/test_policy.py:190-262, 539-567) ----------------


def test_window_matches_reference_and_full_reeval():
    """Chunks through update_window + evaluate_window_qc equal the JAX window
    and a full re-evaluation over the concatenated chunks at every prefix,
    up to and past a full ring."""
    rng = np.random.default_rng(41)
    C, S, K, T_new = 96, 8, 6, 4
    slice_id = np.sort(rng.integers(0, S, size=C)).astype(np.int32)
    bounds_j = jeng.slice_bounds(slice_id, S)
    bounds_t = tp.slice_bounds(slice_id, S, device=CPU)
    age = np.full(C, 7200, np.float32)
    pq = params_q()

    ref_state = jeng.init_window(C, K)
    state = tp.init_window(C, K, device=CPU)
    assert state[0].dtype == torch.int8 and state[2].dtype == torch.int32
    assert state[2].dim() == 0 and state[0].is_contiguous()
    assert_same(ref_state, state)
    chunks = []
    for step in range(K + 3):
        tc_q, hbm_q = chunk(rng, C, T_new)
        chunks.append((tc_q, hbm_q))
        ref_state = jeng.update_window(ref_state, jnp.asarray(tc_q), jnp.asarray(hbm_q))
        state = tp.update_window(state, t(tc_q), t(hbm_q))
        assert_same(ref_state, state)

        ref = jeng.evaluate_window_qc(ref_state, jnp.asarray(age), bounds_j, jnp.asarray(pq))
        got = tp.evaluate_window_qc(state, t(age), bounds_t, t(pq))
        assert_same(ref, got)
        window = chunks[-K:]
        full = tp.evaluate_fleet_qc(t(np.concatenate([c[0] for c in window], axis=1)),
                                    t(np.concatenate([c[1] for c in window], axis=1)),
                                    t(age), bounds_t, t(pq))
        assert_same([x.numpy() for x in full], got)


def test_window_evicts_old_activity():
    """A busy chunk leaves the window exactly when the ring overwrites it."""
    C, S, K = 4, 2, 3
    bounds = tp.slice_bounds(np.array([0, 0, 1, 1], np.int32), S, device=CPU)
    age = t(np.full(C, 7200, np.float32))
    pq = t(params_q(hbm_threshold=0.0))
    valid = np.ones((C, 2), bool)
    busy = t(tp.quantize_samples(np.array([[0.9, 0.9]] + [[0.0, 0.0]] * 3, np.float32),
                                 valid))
    idle = t(tp.quantize_samples(np.zeros((C, 2), np.float32), valid))

    state = tp.update_window(tp.init_window(C, K, device=CPU), busy, idle)
    v, _ = tp.evaluate_window_qc(state, age, bounds, pq)
    assert v.tolist() == [False, True]
    for _ in range(K - 1):  # the busy chunk is still inside the window
        state = tp.update_window(state, idle, idle)
        assert tp.evaluate_window_qc(state, age, bounds, pq)[0].tolist() == [False, True]
    state = tp.update_window(state, idle, idle)  # overwrites the busy chunk
    assert tp.evaluate_window_qc(state, age, bounds, pq)[0].tolist() == [True, True]


def test_window_updates_rings_in_place():
    """update_window_ reuses the rings' storage: no ring is allocated per
    cycle, and it writes what update_window writes."""
    C, K = 8, 3
    rng = np.random.default_rng(8)
    state = tp.init_window(C, K, device=CPU)
    fresh = tp.init_window(C, K, device=CPU)
    ptrs = (state[0].data_ptr(), state[1].data_ptr())
    for cycle in range(K + 1):
        tc_q, hbm_q = (t(x) for x in chunk(rng, C, 2))
        state = tp.update_window_(state, tc_q, hbm_q)
        fresh = tp.update_window(fresh, tc_q, hbm_q)
        assert (state[0].data_ptr(), state[1].data_ptr()) == ptrs
        assert int(state[2]) == (cycle + 1) % K
        assert all(torch.equal(a, b) for a, b in zip(state, fresh))


def test_update_window_leaves_its_input_untouched():
    """update_window returns fresh rings: the state it was given keeps its
    bytes and its cursor, so it can be branched from again."""
    C, K = 8, 3
    rng = np.random.default_rng(9)
    state = tp.init_window(C, K, device=CPU)
    for _ in range(2):
        state = tp.update_window(state, *(t(x) for x in chunk(rng, C, 2)))
    before = tuple(x.clone() for x in state)
    after = tp.update_window(state, *(t(x) for x in chunk(rng, C, 2)))
    assert all(torch.equal(a, b) for a, b in zip(state, before))
    assert after[0].data_ptr() != state[0].data_ptr()
    assert after[1].data_ptr() != state[1].data_ptr()
    assert int(after[2]) == (int(state[2]) + 1) % K
    assert not torch.equal(after[0], state[0])


def test_window_uniform_matches_reference():
    """evaluate_window_qu equals the JAX window_qu and the port's window_qc
    on a uniform fleet, with the ring wrapped."""
    rng = np.random.default_rng(53)
    C, S, K = 64, 8, 4
    cps = C // S
    bounds = tp.slice_bounds(np.repeat(np.arange(S, dtype=np.int32), cps), S, device=CPU)
    age = np.full(C, 7200, np.float32)
    pq = params_q()
    ref_state, state = jeng.init_window(C, K), tp.init_window(C, K, device=CPU)
    for _ in range(K + 2):
        tc_q, hbm_q = chunk(rng, C, 3)
        ref_state = jeng.update_window(ref_state, jnp.asarray(tc_q), jnp.asarray(hbm_q))
        state = tp.update_window(state, t(tc_q), t(hbm_q))
        ref = jeng.evaluate_window_qu(ref_state, jnp.asarray(age), jnp.asarray(pq),
                                      chips_per_slice=cps)
        got = tp.evaluate_window_qu(state, t(age), t(pq), cps)
        assert_same(ref, got)
        qc = tp.evaluate_window_qc(state, t(age), bounds, t(pq))
        assert torch.equal(qc[0], got[0]) and torch.equal(qc[1], got[1])


def test_window_from_numpy_continues_reference_window():
    """A JAX window carried across with window_from_numpy continues in the
    port exactly as it would have in the reference."""
    rng = np.random.default_rng(5)
    C, K = 32, 4
    ref_state = jeng.init_window(C, K)
    for _ in range(K + 1):
        tc_q, hbm_q = chunk(rng, C, 2)
        ref_state = jeng.update_window(ref_state, jnp.asarray(tc_q), jnp.asarray(hbm_q))
    state = tp.window_from_numpy(tuple(np.asarray(x) for x in ref_state), CPU)
    assert_same(ref_state, state)
    for _ in range(2):
        tc_q, hbm_q = chunk(rng, C, 2)
        ref_state = jeng.update_window(ref_state, jnp.asarray(tc_q), jnp.asarray(hbm_q))
        state = tp.update_window(state, t(tc_q), t(hbm_q))
        assert_same(ref_state, state)
