"""The plain reference on hand-built cases."""

import numpy as np
import pytest

from port_bench.reference import fleet as ref

F32 = np.float32
SUB = np.array([0x00000001, 0x007FFFFF], dtype=np.uint32).view(F32)  # subnormals


def f32_case(tc, hbm=None, valid=None, age=7200.0, lookback=2100.0, threshold=0.05):
    tc = np.array([tc], dtype=F32)
    hbm = np.zeros_like(tc) if hbm is None else np.array([hbm], dtype=F32)
    valid = np.ones(tc.shape, bool) if valid is None else np.array([valid], bool)
    return ref.candidates_f32(tc, hbm, valid, np.array([age], F32), lookback, threshold)[0]


def test_idle_chip_is_a_candidate():
    assert f32_case([0, 0, 0, 0])


def test_any_busy_sample_vetoes_the_chip():
    assert not f32_case([0, 0, 1e-6, 0])


def test_subnormal_tc_reads_as_idle_in_every_precision():
    assert f32_case([SUB[0], SUB[1], 0, 0])
    q = ref.quantize(np.array([SUB], F32), np.ones((1, 2), bool))
    assert (q == 0).all()
    assert (ref.quantize(np.array([SUB], F32), np.ones((1, 2), bool), "int4") == 0).all()


def test_scrape_gaps_hide_samples_and_no_data_is_never_idle():
    assert f32_case([0.9, 0, 0], valid=[False, True, True])
    assert not f32_case([0, 0, 0], valid=[False, False, False])
    q = ref.quantize(np.array([[0.9, 0.0]], F32), np.array([[False, True]]))
    assert q.tolist() == [[-1, 0]]
    assert ref.peaks_q(np.array([[-1, -1]], np.int8)).tolist() == [-1]
    assert not ref.candidates_q(np.array([-1]), np.array([-1]), np.array([7200.0], F32),
                                2100, ref.cutoff_q(0.05))[0]


def test_age_gate_at_the_lookback():
    assert f32_case([0], age=2100.0)
    assert not f32_case([0], age=np.nextafter(F32(2100), F32(0)))


@pytest.mark.parametrize("hbm, rescued", [
    (np.nextafter(F32(0.05), F32(0)), False),
    (F32(0.05), True),
    (np.nextafter(F32(0.05), F32(1)), True),
])
def test_hbm_on_each_side_of_the_cutoff_f32(hbm, rescued):
    assert f32_case([0, 0], hbm=[0.0, hbm]) is np.bool_(not rescued)


def test_disabled_threshold_rescues_nothing_finite():
    assert f32_case([0], hbm=[0.99], threshold=0.0)


def test_int8_buckets_err_toward_rescue():
    cut = ref.cutoff_q(0.05)
    assert cut == 5
    for u, rescued in ((0.04, False), (0.0400001, True), (0.05, True)):
        q = ref.quantize(np.array([[u]], F32), np.ones((1, 1), bool))
        cand = ref.candidates_q(np.zeros(1, np.int8), q.max(axis=1), np.array([7200.0], F32),
                                2100, cut)
        assert cand[0] is np.bool_(not rescued), u


def test_bf16_control_moves_samples_near_the_cutoff():
    below = F32(0.04995)
    assert f32_case([0], hbm=[below])
    tc, hbm = np.zeros((1, 1), F32), np.array([[below]], F32)
    assert not ref.candidates_f32(tc, hbm, np.ones((1, 1), bool), np.array([7200.0], F32),
                                  2100, 0.05, "bf16")[0]


def test_int4_control_rescues_low_hbm():
    q8 = np.array([[0, 3]], np.int8)
    cand8 = ref.candidates_q(np.zeros(1, np.int8), ref.peaks_q(q8), np.array([7200.0], F32),
                             2100, ref.cutoff_q(0.05))
    cand4 = ref.candidates_q(np.zeros(1, np.int8), ref.peaks_q(ref.requantize(q8, "int4")),
                             np.array([7200.0], F32), 2100, ref.cutoff_q(0.05, "int4"))
    assert cand8[0] and not cand4[0]


def test_window_evicts_after_k_chunks():
    K = 12
    busy = np.array([5], np.int8)
    idle = np.array([0], np.int8)
    chunks = [busy] + [idle] * 20
    for i in range(len(chunks)):
        window = chunks[max(0, i - K + 1): i + 1]
        peak = ref.window_peaks(window)
        assert (peak[0] == 0) == (i >= K), i


def test_slices_empty_one_chip_and_vetoed():
    cand = np.array([True, True, False, True])
    slice_index = np.array([0, 0, 1, 3])  # slice 2 has no chip, 3 has one
    assert ref.slice_verdicts(cand, slice_index, 4).tolist() == [True, False, False, True]
    chips, idle = ref.slice_counts(cand, slice_index, 4)
    assert chips.tolist() == [2, 1, 0, 1] and idle.tolist() == [2, 0, 0, 1]


def test_to_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, np.inf], F32)
    assert ref.to_bf16(x).tolist() == [1.0, 1.0, 1.0 + 2**-6, np.inf]
