"""tpu_pruner_torch on the card: each CUDA kernel against its plain version,
and every path of the engine at the main path's full width.

Tests marked ``gpu`` skip without a CUDA device. This file imports no JAX,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import dumpfile
from torch_kernel_cases import (
    BYTES_EDGE, CHIPS, CHUNK_SAMPLES, CPS, DRYRUN_RANKS, DUMP_SAMPLES, F32_ADVERSARIAL_T,
    F32_LAYOUTS, F32_PARAMS, F32_SWEEP_T, GATE_OFFSETS, INT8_LAYOUTS, INT8_PARAMS, SAMPLES,
    SLICES, STREAM_CYCLES, SWEEP_C, SWEEP_T, WINDOW_CHUNKS, XL_CHIPS, XL_SLICES, adversarial_fleet,
    bounds_input_check, engine_input_check, f32_design_cases, f32_edge_fleet, f32_expected_design,
    gate_cases, gate_on, input_cases, int8_design_cases, int8_edge_fleet, int8_on, join_cases,
    launch_counts, q_input_cases, q_input_check, rows_taken, scatter_cases, scatter_fleets,
    seeded_fleet, stream_chunks, sweep_pass_cases, sweep_scatter_cases)
from tpu_pruner_torch import analyze, entry, obs
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.analyze import evaluate_loaded
from tpu_pruner_torch.policy import engine, kernels
from tpu_pruner_torch.policy.engine import normalize_inputs, normalize_inputs_q

INPUT_CASES = input_cases(5)
Q_INPUT_CASES = q_input_cases(98)
GATE_CASES = gate_cases(77, large=True)
SCATTER_CASES = scatter_cases(78)
JOIN_CASES = join_cases()
SWEEP_PASS_CASES = sweep_pass_cases(91)
SWEEP_SCATTER_CASES = sweep_scatter_cases(92)
# (chips, samples, slices) of the engine's paths: a small fleet, and the main
# path's full width
FLEETS = [pytest.param((4096, 64, 256), id="4096x64"),
          pytest.param((CHIPS, SAMPLES, SLICES), id=f"{CHIPS}x{SAMPLES}")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def adversarial_on(device, T, seed=7, C=1003):
    tc, hbm, valid, age = adversarial_fleet(np.random.default_rng(seed), C, T)
    return [torch.from_numpy(x).to(device) for x in (tc, hbm, valid, age)]


def q_design(C: int, T: int) -> str:
    """The int8 pass's design for fresh, aligned [C, T] tensors."""
    return "rows" if rows_taken(C, T) else "tiles"


@pytest.mark.gpu
@pytest.mark.parametrize("params", INT8_PARAMS)
@pytest.mark.parametrize("T", [1, 12, 31, 360, 361])
def test_chip_pass_matches_plain(cuda, T, params):
    tc, hbm, valid, age = adversarial_on(cuda, T)
    parr = torch.tensor(params, dtype=torch.float32, device=cuda)
    before = tp.LAUNCHES["chip_pass"]
    got = tp.chip_pass(tc, hbm, valid, age, parr)
    torch.cuda.synchronize()
    assert tp.LAUNCHES["chip_pass"] == before + 1
    assert torch.equal(got, tp.chip_pass_plain(tc, hbm, valid, age, parr))
    # and the card's plain version equals the CPU's
    assert torch.equal(got.cpu(), tp.chip_pass_plain(
        *(x.cpu() for x in (tc, hbm, valid, age, parr))))
    if params == INT8_PARAMS[0] and T <= 31:  # long rows of this fleet hold no idle chip
        assert 0 < int(got.sum()) < got.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("params", INT8_PARAMS)
@pytest.mark.parametrize("T", [1, 12, 31, 360, 361, 10080])
def test_chip_pass_q_matches_plain(cuda, T, params):
    tc, hbm, valid, age = adversarial_on(cuda, T)
    tc_q = tp.quantize_samples_device(tc, valid)
    hbm_q = tp.quantize_samples_device(hbm, valid)
    for x, x_q in ((tc, tc_q), (hbm, hbm_q)):
        np.testing.assert_array_equal(x_q.cpu().numpy(),
                                      tp.quantize_samples(x.cpu().numpy(), valid.cpu().numpy()))
    parr_q = torch.from_numpy(tp.quantize_params(np.array(params, np.float32))).to(cuda)
    before = tp.LAUNCHES["chip_pass_q"]
    got = tp.chip_pass_q(tc_q, hbm_q, age, parr_q)
    torch.cuda.synchronize()
    assert tp.LAUNCHES["chip_pass_q"] == before + 1
    assert torch.equal(got, tp.chip_pass_q_plain(tc_q, hbm_q, age, parr_q))


def assert_q_matches_plain(device, tc_q, hbm_q, age):
    for params in INT8_PARAMS:
        parr_q = torch.from_numpy(tp.quantize_params(np.array(params, np.float32))).to(device)
        before = tp.LAUNCHES["chip_pass_q"]
        got = tp.chip_pass_q(tc_q, hbm_q, age, parr_q)
        torch.cuda.synchronize()
        assert tp.LAUNCHES["chip_pass_q"] == before + 1
        assert torch.equal(got, tp.chip_pass_q_plain(tc_q, hbm_q, age, parr_q)), params


@pytest.mark.gpu
@pytest.mark.parametrize("layout", INT8_LAYOUTS)
@pytest.mark.parametrize("C", [1, 17, 1003])
@pytest.mark.parametrize("T", [1, 12, 31, 360, 361, 10080])
def test_chip_pass_q_edges(cuda, T, C, layout):
    """Every series length, ragged chip counts, data pointers off a 16-byte
    boundary (each array its own), rows of all -1, -128 and 127."""
    tc, hbm, age = int8_edge_fleet(np.random.default_rng(T * 7919 + C), C, T)
    assert_q_matches_plain(cuda, int8_on(cuda, tc, layout, 1), int8_on(cuda, hbm, layout, 2),
                           torch.from_numpy(age).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "row_offset"])
def test_chip_pass_q_full_width(cuda, layout):
    tc, hbm, age = int8_edge_fleet(np.random.default_rng(3), CHIPS, SAMPLES)
    assert_q_matches_plain(cuda, int8_on(cuda, tc, layout, 1), int8_on(cuda, hbm, layout, 2),
                           torch.from_numpy(age).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("T, chips", [pytest.param(T, SWEEP_C, id=str(T)) for T in SWEEP_T]
                         + [pytest.param(T, (C,), id=f"{T}-{C}") for C, T in BYTES_EDGE])
def test_chip_pass_q_design_sweep(cuda, T, chips):
    """The int8 pass's sweep at one T: every C of the sweep (or one side of
    the row design's 16 MiB limit), bases at every offset (0 and 1 above
    4,097 chips), bit-equal to the plain version in the design the plan
    promises; rows the row design has a kernel for take both designs."""
    took = {"rows": 0, "tiles": 0}
    for C in chips:
        for design, n in int8_design_cases(cuda, T, C, np.random.default_rng(T * 31 + C)).items():
            took[design] += n
    torch.cuda.synchronize()
    assert took["tiles"] > 0 and (took["rows"] > 0) == any(rows_taken(C, T) for C in chips)


@pytest.mark.gpu
@pytest.mark.parametrize("T", F32_ADVERSARIAL_T)
def test_chip_pass_designs_match_plain(cuda, T):
    """Each design of the f32 pass that takes T-sample rows, forced (the
    long-row design at every T, the group design up to its threshold),
    equals the plain version on adversarial rows with invalid padding;
    chip_pass launches the design its plan promises, on contiguous tensors
    and on views off a 16-byte boundary, and equals the plain version there."""
    C = 1003
    args = [torch.from_numpy(x).to(cuda) for x in f32_edge_fleet(np.random.default_rng(T), C, T)]
    for params in F32_PARAMS:
        parr = torch.tensor(params, device=cuda)
        want = tp.chip_pass_plain(*args, parr)
        for design, plan in kernels._f32_plans(C, T).items():
            before = dict(kernels.F32_DESIGN_LAUNCHES)
            got = kernels._launch_f32(*args, parr, plan).view(torch.bool)
            torch.cuda.synchronize()
            assert kernels.F32_DESIGN_LAUNCHES[design] == before[design] + 1
            assert torch.equal(got, want), (design, params)
        for offsets in F32_LAYOUTS:
            views = []
            for x, k in zip(args, offsets):
                flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=cuda)
                views.append(flat[k:k + x.numel()].view(x.shape))
                views[-1].copy_(x)
            before = dict(kernels.F32_DESIGN_LAUNCHES)
            got = tp.chip_pass(*views, parr)
            torch.cuda.synchronize()
            design = f32_expected_design(C, T)
            assert kernels.F32_DESIGN_LAUNCHES[design] == before[design] + 1, offsets
            assert torch.equal(got, want), (offsets, params)


@pytest.mark.gpu
@pytest.mark.parametrize("T", F32_SWEEP_T)
def test_chip_pass_design_sweep(cuda, T):
    """The f32 pass's sweep through its plan at one T: every C of the sweep,
    bases at each offset, bit-equal to the plain version in the design the
    plan promises."""
    took = {}
    for C in SWEEP_C:
        for design, n in f32_design_cases(cuda, T, C, np.random.default_rng(T * 37 + C)).items():
            took[design] = took.get(design, 0) + n
    torch.cuda.synchronize()
    assert took[f32_expected_design(1, T)] == len(SWEEP_C) * len(F32_LAYOUTS)


@pytest.mark.gpu
def test_fleet_on_card_matches_cpu(cuda):
    gpu_inputs, expected = tp.make_example_fleet(4096, 64, 256, idle_fraction=0.5,
                                                 device=cuda)
    cpu_inputs, _ = tp.make_example_fleet(4096, 64, 256, idle_fraction=0.5,
                                          device="cpu")
    v, c = tp.evaluate_fleet_cuda(*gpu_inputs, num_slices=256)
    v_cpu, c_cpu = tp.evaluate_fleet(*cpu_inputs, num_slices=256)
    np.testing.assert_array_equal(v.cpu().numpy(), expected)
    assert torch.equal(c.cpu(), c_cpu) and torch.equal(v.cpu(), v_cpu)

    bounds = tp.slice_bounds(gpu_inputs[4], 256, device=cuda)
    q = tp.quantize_fleet_inputs(gpu_inputs)
    qv, qc = tp.evaluate_fleet_cuda_qc(q[0], q[1], q[2], bounds, q[4])
    np.testing.assert_array_equal(qv.cpu().numpy(), expected)
    sv, _ = tp.evaluate_fleet_cuda_q(*q, num_slices=256)
    assert torch.equal(sv, qv)

    fleet_np = tuple(x.numpy() for x in cpu_inputs[:5])
    for quantize in (False, True):
        av, _ = evaluate_loaded(fleet_np, 256, tp.PolicyParams(), quantize, cuda)
        np.testing.assert_array_equal(av, expected)


@pytest.mark.gpu
def test_xl_fleet_on_card(cuda):
    """bench.py's XL point, 1,048,576 chips x 360 samples in 65,536 slices
    built on the card: evaluate_fleet_c, _qc and _qu give the expected
    verdicts, and each kernel equals its plain version."""
    inputs, expected = seeded_fleet(cuda, XL_CHIPS, SAMPLES, XL_SLICES)
    tc, hbm, valid, age, slice_id, parr = inputs
    q = tp.quantize_fleet_inputs(inputs)
    assert tp.assert_uniform_slices(slice_id, XL_CHIPS // XL_SLICES) == XL_SLICES
    bounds = tp.slice_bounds(slice_id, XL_SLICES, device=cuda)
    verdicts = {
        "evaluate_fleet_c": tp.evaluate_fleet_c(tc, hbm, valid, age, bounds, parr)[0],
        "evaluate_fleet_qc": tp.evaluate_fleet_qc(q[0], q[1], q[2], bounds, q[4])[0],
        "evaluate_fleet_qu": tp.evaluate_fleet_qu(q[0], q[1], q[2], q[4],
                                                  XL_CHIPS // XL_SLICES)[0],
    }
    for path, v in verdicts.items():
        np.testing.assert_array_equal(v.cpu().numpy(), expected, err_msg=path)
    candidate = tp.chip_pass_q(q[0], q[1], q[2], q[4])
    assert torch.equal(candidate, tp.chip_pass_q_plain(q[0], q[1], q[2], q[4]))
    assert torch.equal(tp.chip_pass(tc, hbm, valid, age, parr),
                       tp.chip_pass_plain(tc, hbm, valid, age, parr))
    assert torch.equal(kernels.slice_gate(candidate, bounds),
                       kernels.slice_gate_plain(candidate, bounds))


@pytest.mark.gpu
def test_wrappers_skip_launch_on_empty_fleet(cuda):
    before = dict(tp.LAUNCHES)
    empty = torch.empty((0, 4), dtype=torch.float32, device=cuda)
    out = tp.chip_pass(empty, empty, empty.bool(), torch.empty(0, device=cuda),
                       torch.tensor([1.0, 2.0], device=cuda))
    assert out.shape == (0,) and tp.LAUNCHES == before
    empty_q = torch.empty((0, 12), dtype=torch.int8, device=cuda)
    out = tp.chip_pass_q(empty_q, empty_q, torch.empty(0, device=cuda),
                         torch.tensor([1.0, 2.0], device=cuda))
    assert out.shape == (0,) and out.dtype == torch.bool and tp.LAUNCHES == before


def test_creating_tensors_without_a_card_raises():
    """Without a card, entry points that create tensors refuse the default
    device instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_example_fleet(16, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.params_array(tp.PolicyParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.slice_bounds(np.zeros(4, np.int32), 1)
    inputs, _ = tp.make_example_fleet(16, 4, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.fleet_from_numpy(tuple(x.numpy() for x in inputs))


@pytest.mark.gpu
def test_uniform_and_window_on_card_match_cpu(cuda):
    """evaluate_fleet_qu and the streaming window on the card equal the CPU,
    each evaluation one launch of the int8 kernel."""
    rng = np.random.default_rng(11)
    C, S, K = 4096, 256, 12
    gpu_inputs, expected = tp.make_example_fleet(C, 64, S, idle_fraction=0.5, device=cuda)
    cpu_inputs, _ = tp.make_example_fleet(C, 64, S, idle_fraction=0.5, device="cpu")
    assert tp.assert_uniform_slices(gpu_inputs[4], C // S) == S
    gq, cq = tp.quantize_fleet_inputs(gpu_inputs), tp.quantize_fleet_inputs(cpu_inputs)
    before = tp.LAUNCHES["chip_pass_q"]
    v, c = tp.evaluate_fleet_qu(gq[0], gq[1], gq[2], gq[4], C // S)
    assert tp.LAUNCHES["chip_pass_q"] == before + 1
    np.testing.assert_array_equal(v.cpu().numpy(), expected)
    v_cpu, c_cpu = tp.evaluate_fleet_qu(cq[0], cq[1], cq[2], cq[4], C // S)
    assert torch.equal(v.cpu(), v_cpu) and torch.equal(c.cpu(), c_cpu)

    bounds = tp.slice_bounds(gpu_inputs[4], S, device=cuda)
    bounds_cpu = tp.slice_bounds(cpu_inputs[4], S, device="cpu")
    state, state_cpu = tp.init_window(C, K, device=cuda), tp.init_window(C, K, device="cpu")
    for _ in range(K + 2):
        tc_new = torch.from_numpy(rng.integers(-1, 3, size=(C, 6), dtype=np.int8))
        hbm_new = torch.from_numpy(rng.integers(-1, 2, size=(C, 6), dtype=np.int8))
        state = tp.update_window(state, tc_new.to(cuda), hbm_new.to(cuda))
        state_cpu = tp.update_window(state_cpu, tc_new, hbm_new)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(state, state_cpu))
        before = tp.LAUNCHES["chip_pass_q"]
        got = tp.evaluate_window_qc(state, gq[2], bounds, gq[4])
        got_u = tp.evaluate_window_qu(state, gq[2], gq[4], C // S)
        assert tp.LAUNCHES["chip_pass_q"] == before + 2
        want = tp.evaluate_window_qc(state_cpu, cq[2], bounds_cpu, cq[4])
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got_u[0], got[0]) and torch.equal(got_u[1], got[1])


@pytest.mark.gpu
def test_streaming_window_full_width(cuda):
    """The daemon's window at full width, K = 12 chunks of 6 new samples a
    cycle over 14 cycles (the ring wraps): each cycle's evaluate_window_qc
    and _qu equal evaluate_fleet_qc over the last <= 12 chunks and the
    verdicts the chunks were built for, with slices that turn idle exactly
    when their busy chunk is evicted; update_window_ (as analyze --stream
    runs it) and update_window give the same rings, the functional form
    fresh ones; each window evaluation launches the int8 kernel once, in the
    row design, and the qc evaluation the slice gate once."""
    chunks, expected = stream_chunks(cuda)
    assert not np.array_equal(expected[11], expected[12])
    assert not np.array_equal(expected[12], expected[13])
    assert not np.array_equal(expected[0], expected[1])
    age = torch.full((CHIPS,), 7200.0, device=cuda)
    params = tp.PolicyParams(hbm_threshold=0.5)  # the hbm samples (<= 39%) rescue no chip
    pq = torch.from_numpy(tp.quantize_params(
        np.array([params.lookback_s, params.hbm_cutoff()], np.float32))).to(cuda)
    bounds = tp.slice_bounds(np.repeat(np.arange(SLICES, dtype=np.int32), CPS), SLICES,
                             device=cuda)
    state = tp.init_window(CHIPS, WINDOW_CHUNKS, device=cuda)
    fresh = tp.init_window(CHIPS, WINDOW_CHUNKS, device=cuda)
    for cycle, (tc_new, hbm_new) in enumerate(chunks):
        tp.reset_launches()
        state = tp.update_window_(state, tc_new, hbm_new)
        v, c = tp.evaluate_window_qc(state, age, bounds, pq)
        torch.cuda.synchronize()
        assert tp.LAUNCHES == {**dict.fromkeys(tp.LAUNCHES, 0), "chip_pass_q": 1,
                               "slice_gate": 1}, cycle
        assert kernels.DESIGN_LAUNCHES == {"rows": 1, "tiles": 0}, cycle
        prev, fresh = fresh, tp.update_window(fresh, tc_new, hbm_new)
        assert fresh[0].data_ptr() != prev[0].data_ptr(), cycle
        assert all(torch.equal(a, b) for a, b in zip(fresh, state)), cycle
        tp.reset_launches()
        vu, cu = tp.evaluate_window_qu(state, age, pq, CPS)
        torch.cuda.synchronize()
        assert tp.LAUNCHES == {**dict.fromkeys(tp.LAUNCHES, 0), "chip_pass_q": 1}, cycle
        window = chunks[max(0, cycle - WINDOW_CHUNKS + 1):cycle + 1]
        full_v, full_c = tp.evaluate_fleet_qc(torch.cat([w[0] for w in window], dim=1),
                                              torch.cat([w[1] for w in window], dim=1),
                                              age, bounds, pq)
        assert torch.equal(v, full_v) and torch.equal(c, full_c), cycle
        assert torch.equal(vu, v) and torch.equal(cu, c), cycle
        np.testing.assert_array_equal(v.cpu().numpy(), expected[cycle], err_msg=str(cycle))
    assert torch.equal(tp.chip_pass_q(state[0], state[1], age, pq),
                       tp.chip_pass_q_plain(state[0], state[1], age, pq))
    assert len(chunks) == STREAM_CYCLES and chunks[0][0].shape == (CHIPS, CHUNK_SAMPLES)


@pytest.mark.gpu
@pytest.mark.parametrize("fleet", FLEETS)
def test_sharded_one_rank_nccl_matches_single_device(cuda, tmp_path, fleet):
    """Every sharded evaluator in a one-rank NCCL group equals the
    single-device evaluation on the card, each one launch of its pass and
    none of a slice reduction kernel (the sharded paths all-reduce counts)."""
    import torch.distributed as dist

    from tpu_pruner_torch.policy import sharded

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        C, T, S = fleet
        inputs, expected = tp.make_example_fleet(C, T, S, idle_fraction=0.5, device=cuda)
        q = tp.quantize_fleet_inputs(inputs)
        bounds = tp.slice_bounds(inputs[4], S, device=cuda)
        ref_v, ref_c = tp.evaluate_fleet(*inputs, num_slices=S)
        runs = {
            "evaluate_fleet_sharded": lambda: tp.evaluate_fleet_sharded(*inputs, num_slices=S),
            "evaluate_fleet_sharded_q": lambda: tp.evaluate_fleet_sharded_q(*q, num_slices=S),
            "evaluate_fleet_sharded_qc": lambda: tp.evaluate_fleet_sharded_qc(
                q[0], q[1], q[2], bounds, q[4]),
            "evaluate_fleet_sharded_qu": lambda: tp.evaluate_fleet_sharded_qu(
                q[0], q[1], q[2], q[4], C // S),
            "make_sharded_evaluator": lambda: sharded.run_local(
                tp.make_sharded_evaluator, S, *inputs),
            "make_sharded_evaluator_q": lambda: sharded.run_local(
                tp.make_sharded_evaluator_q, S, *q),
            "make_sharded_evaluator_qc": lambda: sharded.run_local(
                tp.make_sharded_evaluator_qc, S, q[0], q[1], q[2],
                tp.shard_bounds(bounds, 1, C, device=cuda), q[4]),
            "make_sharded_evaluator_qu": lambda: sharded.run_local(
                tp.make_sharded_evaluator_qu, C // S, q[0], q[1], q[2], q[4]),
        }
        for name, run in runs.items():
            before = sum(tp.LAUNCHES.values())
            v, c = run()
            torch.cuda.synchronize()
            assert sum(tp.LAUNCHES.values()) == before + 1, name
            np.testing.assert_array_equal(v.cpu().numpy(), expected, err_msg=name)
            assert torch.equal(v, ref_v) and torch.equal(c, ref_c), name
        # the stream step over more cycles than its ring of 3 holds: one launch
        # a cycle, each cycle's verdicts those of update_window + _qu
        tc_new = [q[0][:, i:i + 1].contiguous() for i in range(5)]
        hbm_new = [q[1][:, i:i + 1].contiguous() for i in range(5)]
        before = dict(tp.LAUNCHES)
        cycles = sharded.run_stream_local(C // S, 3, tc_new, hbm_new, q[2], q[4])
        torch.cuda.synchronize()
        assert {k: tp.LAUNCHES[k] - before[k] for k in tp.LAUNCHES} == {
            **dict.fromkeys(tp.LAUNCHES, 0), "chip_pass_q": len(tc_new)}
        state = tp.init_window(C, 3, device=cuda)
        for cycle, (v, *_) in enumerate(cycles):
            state = tp.update_window(state, tc_new[cycle], hbm_new[cycle])
            assert torch.equal(v, tp.evaluate_window_qu(state, q[2], q[4], C // S)[0]), cycle
        assert torch.equal(cycles[-1][0], ref_v)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_dryrun_multichip_gloo_on_card(cuda, tmp_path):
    """dryrun_multichip over four gloo ranks on the one card, each running
    every sharded path on its rows of a 131,072 x 360 fleet (the uneven case
    131,069 chips) against the single-device results: each rank launches
    each pass once a path and the streaming step once a cycle, and no slice
    reduction kernel."""
    summaries = entry.dryrun_multichip(DRYRUN_RANKS, device="cuda", backend="gloo",
                                       chips_per_rank=CHIPS // DRYRUN_RANKS,
                                       num_samples=SAMPLES, timeout_s=600, workdir=tmp_path)
    want = {"make_sharded_evaluator": {"chip_pass": 1},
            "evaluate_fleet_sharded": {"chip_pass": 1},
            "evaluate_fleet_sharded_q": {"chip_pass_q": 1},
            "evaluate_fleet_sharded_qc": {"chip_pass_q": 1},
            "evaluate_fleet_sharded_qu": {"chip_pass_q": 1},
            "make_sharded_stream_step": {"chip_pass_q": entry.STREAM_CHUNKS + 2}}
    want = {path: {name: w.get(name, 0) for name in tp.LAUNCHES} for path, w in want.items()}
    assert len(summaries) == DRYRUN_RANKS
    for rank, s in enumerate(summaries):
        assert s["launches"] == want, rank
        assert s["num_chips"] == CHIPS and s["odd_chips"] % DRYRUN_RANKS, (rank, s)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(INPUT_CASES))
def test_engine_inputs_on_card_match_cpu(cuda, case):
    """Slice ids outside [0, S), bf16, f16 and f64 samples, an integer mask,
    f64 ages and strided views through the f32 and int8 paths on the card:
    the CPU's verdicts, each kernel equal to its plain version, and a launch
    after the case succeeds (a bad id leaves the CUDA context usable)."""
    engine_input_check(cuda, case, INPUT_CASES[case])
    tc, hbm, valid, age = adversarial_on(cuda, 12)
    parr = torch.tensor(INT8_PARAMS[0], device=cuda)
    assert torch.equal(tp.chip_pass(tc, hbm, valid, age, parr),
                       tp.chip_pass_plain(tc, hbm, valid, age, parr))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(Q_INPUT_CASES))
def test_q_inputs_on_card_match_cpu(cuda, case):
    """int16, uint8 and f32 samples on the int8 paths (evaluate_fleet_q,
    _qc, _qu, evaluate_fleet_cuda_q, _cuda_qc): mapped to int8, one launch
    of the int8 kernel a path and of the gate or the scatter reduction where
    the path reduces, the CPU's verdicts and candidates."""
    q_input_check(cuda, case, Q_INPUT_CASES[case])


@pytest.mark.gpu
def test_bad_bounds_on_card_match_cpu(cuda):
    """Bounds outside [0, C] through evaluate_fleet_c, _qc and
    evaluate_fleet_cuda_qc equal the CPU's; then every kernel launches once
    more and equals its plain version, so the context survived them."""
    make = INPUT_CASES["bf16 samples"]
    bounds_input_check(cuda, make)
    probe = make(cuda)
    f32_pass = normalize_inputs(*probe[:4], probe[5])
    q = tp.quantize_fleet_inputs(probe)
    q_pass = normalize_inputs_q(*q[:3], q[4])
    S = 64
    bounds = tp.slice_bounds(probe[4], S, device=cuda)
    ids = kernels.normalize_slice_ids(probe[4])
    before = dict(tp.LAUNCHES)
    candidate = tp.chip_pass(*f32_pass)
    assert torch.equal(candidate, tp.chip_pass_plain(*f32_pass))
    assert torch.equal(tp.chip_pass_q(*q_pass), tp.chip_pass_q_plain(*q_pass))
    assert torch.equal(kernels.slice_gate(candidate, bounds),
                       kernels.slice_gate_plain(candidate, bounds))
    assert torch.equal(kernels.slice_scatter(candidate, ids, S),
                       kernels.slice_scatter_plain(candidate, ids, S))
    rings = q[0][:64, :12].contiguous(), q[1][:64, :12].contiguous()
    rows, keys = tp.WindowRows.of(np.arange(64), 0), np.arange(-1, 63)
    runs, kept, _, _ = engine.rekey_plain(rows, keys, 1, 12)
    want = kernels.window_gather_plain(*(r.cpu() for r in rings), torch.from_numpy(runs),
                                       64 + len(kept))
    got = tp.rekey_window((*rings, torch.zeros((), dtype=torch.int32, device=cuda)), rows, keys,
                          1).state
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got[:2], want))
    grid = (np.array([4, 31], np.int32), np.array([0.0, 3000.0], np.float32),
            np.array([0.05, np.inf], np.float32))
    masks = kernels.sweep_pass(*f32_pass[:4], *grid)
    assert torch.equal(masks.cpu(), kernels.sweep_pass_plain(*(x.cpu() for x in f32_pass[:4]),
                                                             *grid))
    swept = kernels.sweep_scatter(masks, ids, S, 4)
    assert all(torch.equal(a.cpu(), b)
               for a, b in zip(swept, kernels.sweep_scatter_plain(masks.cpu(), ids.cpu(), S, 4)))
    torch.cuda.synchronize()
    assert all(tp.LAUNCHES[k] == before[k] + 1 for k in tp.LAUNCHES), tp.LAUNCHES


@pytest.mark.gpu
def test_window_cursor_and_branches_on_card_match_cpu(cuda):
    """update_window and update_window_ with every cursor in -2K..2K write
    the same column and return the same next cursor on the card as on the
    CPU; update_window leaves a branched state as it was."""
    K = 3
    new = torch.arange(8, dtype=torch.int8).view(4, 2)
    for cursor in range(-2 * K, 2 * K + 1):
        for form in (tp.update_window, tp.update_window_):
            out = []
            for dev in (cuda, torch.device("cpu")):
                ring, ring2, _ = tp.init_window(4, K, device=dev)
                c = torch.tensor(cursor, dtype=torch.int32, device=dev)
                out.append(form((ring, ring2, c), new.to(dev), new.to(dev)))
            assert all(torch.equal(a.cpu(), b) for a, b in zip(*out)), (cursor, form)
    s0 = tp.init_window(4, K, device=cuda)
    s1 = tp.update_window(s0, torch.zeros_like(new, device=cuda),
                          torch.zeros_like(new, device=cuda))
    tp.update_window(s0, new.to(cuda), new.to(cuda))
    assert int(s0[0].max()) == -1 and int(s1[0].max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_slice_gate_matches_plain(cuda, case):
    """The slice gate on torch_kernel_cases.gate_cases (large: also the main
    path's shapes and the mixed fleet of 1,048,576 chips), the candidate at
    each of GATE_OFFSETS off a 16-byte boundary: one launch (none where
    S = 0), bit-equal to the plain version on the card and on the CPU."""
    cand_np, bounds_np = GATE_CASES[case]
    bounds = torch.from_numpy(bounds_np).to(cuda)
    S = bounds_np.size - 1
    want_cpu = kernels.slice_gate_plain(torch.from_numpy(cand_np), torch.from_numpy(bounds_np))
    for k in GATE_OFFSETS:
        cand = gate_on(cuda, cand_np, k)
        want = kernels.slice_gate_plain(cand, bounds)
        assert torch.equal(want.cpu(), want_cpu)
        before = kernels.LAUNCHES["slice_gate"]
        got = kernels.slice_gate(cand, bounds)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["slice_gate"] - before == int(S > 0), k
        assert torch.equal(got, want), k


def assert_each_kernel_matches_plain(inputs, q, bounds, num_slices: int) -> None:
    """Both passes, the gate and the scatter reduction on a fleet's own
    inputs equal their plain versions."""
    candidate = tp.chip_pass_q(q[0], q[1], q[2], q[4])
    assert torch.equal(candidate, tp.chip_pass_q_plain(q[0], q[1], q[2], q[4]))
    assert torch.equal(tp.chip_pass(*inputs[:4], inputs[5]),
                       tp.chip_pass_plain(*inputs[:4], inputs[5]))
    assert torch.equal(kernels.slice_gate(candidate, bounds),
                       kernels.slice_gate_plain(candidate, bounds))
    assert torch.equal(kernels.slice_scatter(candidate, inputs[4], num_slices),
                       kernels.slice_scatter_plain(candidate, inputs[4], num_slices))


@pytest.mark.gpu
@pytest.mark.parametrize("fleet", FLEETS)
def test_contiguous_paths_launch_the_gate_once(cuda, fleet):
    """evaluate_fleet_c, _qc, evaluate_fleet_cuda_qc, evaluate_window_qc and
    analyze.evaluate_loaded each launch their pass once, in the design its
    plan promises, and the slice gate once, and give the expected verdicts;
    the uniform path (evaluate_fleet_qu) and evaluate_fleet launch their
    pass and no gate. Each kernel equals its plain version on the fleet."""
    C, T, S = fleet
    gpu_inputs, expected = tp.make_example_fleet(C, T, S, idle_fraction=0.5, device=cuda)
    q = tp.quantize_fleet_inputs(gpu_inputs)
    bounds = tp.slice_bounds(gpu_inputs[4], S, device=cuda)
    state = tp.init_window(C, WINDOW_CHUNKS, device=cuda)
    state = tp.update_window_(state, q[0][:, :CHUNK_SAMPLES].contiguous(),
                              q[1][:, :CHUNK_SAMPLES].contiguous())
    fleet_np = tuple(x.cpu().numpy() for x in gpu_inputs[:5])

    def uniform():
        assert tp.assert_uniform_slices(gpu_inputs[4], C // S) == S
        return tp.evaluate_fleet_qu(q[0], q[1], q[2], q[4], C // S)

    gate, scatter = {"slice_gate": 1}, {"slice_scatter": 1}
    runs = {
        "evaluate_fleet_c": ("chip_pass", gate, lambda: tp.evaluate_fleet_c(
            *gpu_inputs[:4], bounds, gpu_inputs[5])),
        "evaluate_fleet_qc": ("chip_pass_q", gate, lambda: tp.evaluate_fleet_qc(
            q[0], q[1], q[2], bounds, q[4])),
        "evaluate_fleet_cuda_qc": ("chip_pass_q", gate, lambda: tp.evaluate_fleet_cuda_qc(
            q[0], q[1], q[2], bounds, q[4])),
        "evaluate_window_qc": ("chip_pass_q", gate, lambda: tp.evaluate_window_qc(
            state, q[2], bounds, q[4])),
        "evaluate_loaded": ("chip_pass", gate, lambda: evaluate_loaded(
            fleet_np, S, tp.PolicyParams(), False, cuda)),
        "evaluate_loaded --quantize": ("chip_pass_q", gate, lambda: evaluate_loaded(
            fleet_np, S, tp.PolicyParams(), True, cuda)),
        "evaluate_fleet": ("chip_pass", scatter, lambda: tp.evaluate_fleet(
            *gpu_inputs, num_slices=S)),
        "evaluate_fleet_qu": ("chip_pass_q", {}, uniform),
    }
    for name, (kind, reduction, run) in runs.items():
        tp.reset_launches()
        v, _ = run()
        torch.cuda.synchronize()
        assert tp.LAUNCHES == {**dict.fromkeys(tp.LAUNCHES, 0), kind: 1, **reduction}, name
        if name == "evaluate_window_qc":
            assert kernels.DESIGN_LAUNCHES == {"rows": 1, "tiles": 0}, name
            continue
        if kind == "chip_pass":
            design = f32_expected_design(C, T)
            assert kernels.F32_DESIGN_LAUNCHES[design] == 1, name
        else:
            assert kernels.DESIGN_LAUNCHES[q_design(C, T)] == 1, name
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        np.testing.assert_array_equal(v, expected, err_msg=name)
    assert_each_kernel_matches_plain(gpu_inputs, q, bounds, S)


@pytest.mark.gpu
def test_slice_gate_empty_inputs(cuda):
    """S = 0 launches nothing; C = 0 with slices launches once, and its
    verdicts are the bounds' differences, as the plain version's are."""
    cand = torch.ones(16, dtype=torch.bool, device=cuda)
    tp.reset_launches()
    for bounds in (torch.tensor([3], device=cuda), torch.empty(0, dtype=torch.int32,
                                                               device=cuda)):
        out = kernels.slice_gate(cand, bounds.to(torch.int32))
        assert out.shape == (0,) and out.dtype == torch.bool
    assert tp.LAUNCHES["slice_gate"] == 0
    empty = torch.ones(0, dtype=torch.bool, device=cuda)
    bounds = torch.tensor([0, 0, 3, -1, 2, 2], dtype=torch.int32, device=cuda)
    got = kernels.slice_gate(empty, bounds)
    torch.cuda.synchronize()
    assert tp.LAUNCHES["slice_gate"] == 1
    assert got.tolist() == [False, True, False, True, False]
    assert torch.equal(got, kernels.slice_gate_plain(empty, bounds))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_slice_scatter_matches_plain(cuda, case):
    """The scatter reduction on torch_kernel_cases.scatter_cases, the
    candidate at each of GATE_OFFSETS off a 16-byte boundary: one launch
    (none where S = 0 or C = 0), bit-equal to the plain version on the card
    and on the CPU."""
    cand_np, ids_np, S = SCATTER_CASES[case]
    ids = torch.from_numpy(ids_np).to(cuda)
    want_cpu = kernels.slice_scatter_plain(torch.from_numpy(cand_np), torch.from_numpy(ids_np), S)
    for k in GATE_OFFSETS:
        cand = gate_on(cuda, cand_np, k)
        before = kernels.LAUNCHES["slice_scatter"]
        got = kernels.slice_scatter(cand, ids, S)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["slice_scatter"] - before == int(S > 0 and cand_np.size > 0), k
        assert torch.equal(got.cpu(), want_cpu), k
        assert torch.equal(got, kernels.slice_scatter_plain(cand, ids, S)), k


@pytest.mark.gpu
def test_slice_scatter_large_fleets_match_plain(cuda):
    """torch_kernel_cases.scatter_fleets, with int32 and int64 ids and the
    candidate at each of GATE_OFFSETS: the cell's 260,000 chips in 23,149
    groups in host order, 1,048,576 chips in 65,536 shuffled slices, one
    slice of 1,048,576 chips and 1,048,576 one-chip slices; one launch each,
    bit-equal to the plain version on the card and on the CPU."""
    for name, (cand_np, ids_np, S) in scatter_fleets(np.random.default_rng(5)).items():
        want_cpu = kernels.slice_scatter_plain(torch.from_numpy(cand_np),
                                               torch.from_numpy(ids_np), S)
        for dtype in (torch.int32, torch.int64):
            ids = torch.from_numpy(ids_np).to(cuda, dtype)
            for k in GATE_OFFSETS:
                cand = gate_on(cuda, cand_np, k)
                before = kernels.LAUNCHES["slice_scatter"]
                got = kernels.slice_scatter(cand, ids, S)
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["slice_scatter"] == before + 1, (name, dtype, k)
                assert torch.equal(got.cpu(), want_cpu), (name, dtype, k)
                assert torch.equal(got, kernels.slice_scatter_plain(cand, ids, S)), (name, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("fleet", FLEETS)
def test_scatter_paths_launch_the_scatter_once(cuda, fleet):
    """evaluate_fleet, _q, evaluate_fleet_cuda and _cuda_q each launch their
    pass once, in the design its plan promises, and the scatter reduction
    once, beside no gate, and give the expected verdicts; obs.summary()
    counts the launches."""
    from tpu_pruner_torch import obs

    C, T, S = fleet
    inputs, expected = tp.make_example_fleet(C, T, S, idle_fraction=0.5, device=cuda)
    q = tp.quantize_fleet_inputs(inputs)
    runs = {
        "evaluate_fleet": ("chip_pass", lambda: tp.evaluate_fleet(*inputs, num_slices=S)),
        "evaluate_fleet_cuda": ("chip_pass", lambda: tp.evaluate_fleet_cuda(*inputs,
                                                                           num_slices=S)),
        "evaluate_fleet_q": ("chip_pass_q", lambda: tp.evaluate_fleet_q(*q, num_slices=S)),
        "evaluate_fleet_cuda_q": ("chip_pass_q", lambda: tp.evaluate_fleet_cuda_q(
            *q, num_slices=S)),
    }
    for name, (kind, run) in runs.items():
        tp.reset_launches()
        v, _ = run()
        torch.cuda.synchronize()
        assert tp.LAUNCHES == {**dict.fromkeys(tp.LAUNCHES, 0), kind: 1,
                               "slice_scatter": 1}, name
        if kind == "chip_pass":
            assert kernels.F32_DESIGN_LAUNCHES[f32_expected_design(C, T)] == 1, name
        else:
            assert kernels.DESIGN_LAUNCHES[q_design(C, T)] == 1, name
        np.testing.assert_array_equal(v.cpu().numpy(), expected, err_msg=name)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span("scatter"):
            tp.evaluate_fleet(*inputs, num_slices=S)
    assert obs.summary()["counters"]["launches.slice_scatter"] == 1


@pytest.mark.gpu
def test_evaluate_fleet_puts_at_most_six_operations_on_the_card(cuda):
    """One evaluate_fleet call on the cut gke-65k layout at T = 360, with its
    two readbacks: the pass, the scatter reduction's memset and two kernels,
    two copies; no index_add_ and no eager reduction kernel."""
    cand, ids_np, S = SCATTER_CASES["cut gke-65k layout in host order"]
    C, T = cand.size, 360
    tc = torch.from_numpy(~cand).to(cuda, torch.float32)[:, None].expand(C, T).contiguous()
    args = (tc, torch.zeros_like(tc), torch.ones((C, T), dtype=torch.bool, device=cuda),
            torch.full((C,), 7200.0, device=cuda), torch.from_numpy(ids_np).to(cuda),
            tp.params_array(tp.PolicyParams(), device=cuda))

    def call():
        verdicts, candidates = tp.evaluate_fleet(*args, num_slices=S)
        return verdicts.cpu(), candidates.cpu()

    verdicts, candidates = call()
    assert torch.equal(candidates, torch.from_numpy(cand))
    assert torch.equal(verdicts, kernels.slice_scatter_plain(candidates,
                                                             torch.from_numpy(ids_np), S))
    ops = launch_counts("evaluate_fleet, cut gke-65k layout", call)
    assert ops is not None and ops["total"] <= 6, ops
    names = " ".join(ops["by_name"])
    assert "chip_pass_long_kernel" in names, names
    assert "slice_marks_kernel" in names and "slice_verdict_kernel" in names, names
    assert "index" not in names and "elementwise" not in names, names


# A small dump: two idle chips of ml/idle, a busy slice, an HBM-active one
# and a young pod; every run must find ml/idle and its 2 chips.
CLI_DUMP = {"hbm_threshold": 0.05, "chips": [
    {"slice": "ml/idle", "tc": [0.0] * 6, "hbm": [0.0] * 6, "pod_age_s": 7200},
    {"slice": "ml/busy", "tc": [0.0, 0.7, 0.0], "hbm": [0.1] * 3, "pod_age_s": 7200},
    {"slice": "ml/idle", "tc": [0.0] * 6, "hbm": [0.0] * 6, "pod_age_s": 7200},
    {"slice": "ml/hbm-active", "tc": [0.0] * 6, "hbm": [0.2] * 6, "pod_age_s": 7200},
    {"slice": "ml/busy", "tc": [0.0] * 3, "hbm": [0.1] * 3, "pod_age_s": 7200},
    {"slice": "ml/young", "tc": [0.0] * 6, "pod_age_s": 60},
]}


def run_cli(argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = analyze.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.gpu
def test_analyze_cli_on_card(cuda, tmp_path):
    """The analyze CLI on the card: batch, --quantize, --shard and --shard
    --quantize (a one-rank NCCL group) and two --stream cycles. Each run
    launches its pass once in the design its plan promises, and the slice
    gate once where it evaluates on one device (batch and --stream; --shard
    all-reduces slice counts instead), and finds the idle slice."""
    path, state = tmp_path / "dump.json", tmp_path / "state.npz"
    runs = [("batch", [], "chip_pass", 1), ("--quantize", ["--quantize"], "chip_pass_q", 1),
            ("--shard", ["--shard"], "chip_pass", 0),
            ("--shard --quantize", ["--shard", "--quantize"], "chip_pass_q", 0),
            ("--stream, cycle 1", ["--stream", str(state)], "chip_pass_q", 1),
            ("--stream, cycle 2", ["--stream", str(state)], "chip_pass_q", 1)]
    for cycle, (name, extra, kind, gates) in enumerate(runs):
        path.write_text(json.dumps({**CLI_DUMP, "timestamp": 1000.0 + 180 * cycle}))
        tp.reset_launches()
        rc, out, err = run_cli([str(path), "--device", "cuda", *extra])
        torch.cuda.synchronize()
        assert rc == 0, (name, err)
        assert tp.LAUNCHES == {**dict.fromkeys(tp.LAUNCHES, 0), kind: 1,
                               "slice_gate": gates}, name
        if kind == "chip_pass":
            assert kernels.F32_DESIGN_LAUNCHES == {"groups": 1, "long": 0}, name
        else:
            assert kernels.DESIGN_LAUNCHES == {"rows": 1, "tiles": 0}, name
        result = json.loads(out.strip().splitlines()[-1])
        assert result["reclaimable_slices"] == ["ml/idle"] and result["idle_chips"] == 2, name
    assert result["window"]["filled"] == 2 and result["newly_reclaimable"] == []


@pytest.mark.gpu
def test_analyze_cli_dump_width_on_card(cuda, tmp_path):
    """The analyze CLI without --quantize on an audit dump's width, 131,072
    chips x 8 samples in 8,192 slices (make_example_fleet's, every seventh
    chip cut to 1-7 samples), written by port_bench.dumpfile: one launch of
    the f32 pass, in the group design, and of the slice gate; verdicts
    equal to evaluate_fleet on load_fleet's arrays and to the fleet's
    expected ones."""
    inputs, expected = tp.make_example_fleet(CHIPS, DUMP_SAMPLES, SLICES, idle_fraction=0.5,
                                             seed=0, device="cpu")
    tc, hbm, valid, age, slice_id = (x.numpy() for x in inputs[:5])
    short = np.arange(CHIPS) % 7 == 3
    cut = np.arange(CHIPS)[short] // 7 % 7 + 1  # leading samples each short series lacks
    valid[short] = np.arange(DUMP_SAMPLES)[None, :] >= cut[:, None]
    names = [f"ml/slice-{s:05d}" for s in range(SLICES)]
    chip_ids = [f"pod-{i:07d}/tpu" for i in range(CHIPS)]  # sorted as written
    params = tp.PolicyParams()
    path = tmp_path / "dump.json"
    dumpfile.write(path, tc, hbm, valid, age, slice_id, names, chip_ids, np.arange(CHIPS),
                   params.lookback_s, params.hbm_threshold)
    tp.reset_launches()
    rc, out, err = run_cli([str(path), "--device", "cuda"])
    torch.cuda.synchronize()
    assert rc == 0, err[-2000:]
    assert tp.LAUNCHES == {**dict.fromkeys(tp.LAUNCHES, 0), "chip_pass": 1, "slice_gate": 1}
    assert kernels.F32_DESIGN_LAUNCHES == {"groups": 1, "long": 0}
    result = json.loads(out.strip().splitlines()[-1])
    with open(path) as f:
        fleet, loaded_names, _, _ = analyze.load_fleet(json.load(f))
    assert loaded_names == names and fleet[0].shape == (CHIPS, DUMP_SAMPLES)
    np.testing.assert_array_equal(fleet[2], valid)
    single = tp.evaluate_fleet(*tp.fleet_from_numpy((*fleet, inputs[5].numpy()), cuda),
                               num_slices=SLICES)
    np.testing.assert_array_equal(single[0].cpu().numpy(), expected)
    idle = [names[i] for i in np.flatnonzero(single[0].cpu().numpy())]
    assert result["reclaimable_slices"] == idle
    assert result["idle_chips"] == int(single[1].sum()) == CHIPS // 2


# --- the keyed window (rekey_window) ----------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows, chunks, view, scattered", [
    (1, 12, False, False), (1003, 12, False, True), (1003, 5, False, False),
    (1003, 12, True, False), (263_000, 12, False, False), (263_000, 12, False, True)])
def test_window_gather_matches_plain(cuda, rows, chunks, view, scattered):
    """The row gather by a row index against the plain version by its runs:
    4-byte words (K = 12) and bytes (K = 5, or rings off a 4-byte
    boundary), runs of moved rows with new ones among them (the carry's
    shape) and a row index a row (scattered), one launch each."""
    g = torch.Generator().manual_seed(rows + chunks)
    tc = torch.randint(-1, 128, (rows + 1, chunks), generator=g, dtype=torch.int8)
    hbm = torch.randint(-1, 128, (rows + 1, chunks), generator=g, dtype=torch.int8)
    if view:  # rows of 12 bytes from the second byte on: no 4-byte words
        tc = tc.view(-1)[1:1 + rows * chunks].view(rows, chunks)
        hbm = hbm.view(-1)[1:1 + rows * chunks].view(rows, chunks)
    else:
        tc, hbm = tc[:rows], hbm[:rows]
    out_rows = rows + rows // 100 + 2
    if scattered:
        gather = torch.randint(-1, rows, (out_rows,), generator=g)
    else:
        gather = (torch.arange(out_rows) + 3) % rows
        gather[torch.randperm(out_rows, generator=g)[:out_rows // 50 + 1]] = -1
    runs = torch.from_numpy(engine.gather_runs(gather.numpy()))
    want = kernels.window_gather_plain(tc, hbm, runs, out_rows)
    index = gather.to(torch.int32).to(cuda)
    before = kernels.LAUNCHES["window_gather"]
    got = kernels.window_gather(tc.to(cuda), hbm.to(cuda), index)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["window_gather"] == before + 1
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert all(torch.equal(b, torch.where(gather[:, None] >= 0, r[gather.clamp(min=0)], -1).to(
        torch.int8)) for b, r in zip(want, (tc, hbm)))
    empty = kernels.window_gather(tc.to(cuda), hbm.to(cuda), index[:0])
    assert empty[0].shape == (0, chunks) and kernels.LAUNCHES["window_gather"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_window_join_matches_plain(cuda, case):
    """The card's join through rekey_window against rekey_plain at the
    join's edges (keys at INT64_MIN, -1 and INT64_MAX, a fleet all new, rows
    all dropped, an empty fleet and window, an unchanged fleet): the rings,
    the kept rows' keys and cycles and the four counts bit for bit, one
    launch of the join and one wait; then a second call from the rows the
    first left on the card. A repeated key, among the chips (new or
    carried) or the rows, raises rekey_plain's ValueError and leaves the
    state as it was."""
    rows, keys, cycle, K = JOIN_CASES[case]
    R = len(rows.keys) + len(rows.kept_keys)
    g = torch.Generator().manual_seed(R + len(keys))
    rings = [torch.randint(-1, 100, (R, K), generator=g, dtype=torch.int8) for _ in range(2)]
    state = (*(r.to(cuda) for r in rings), torch.zeros((), dtype=torch.int32, device=cuda))
    try:
        want = engine.rekey_plain(rows, keys, cycle, K)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tp.rekey_window(state, rows, keys, cycle)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(state[:2], rings))
        return
    for step in range(2):
        runs, kept_keys, kept_seen, counts = want
        R = len(rows.keys) + len(rows.kept_keys)
        before = dict(obs.counts), dict(tp.LAUNCHES)
        r = tp.rekey_window(state, rows, keys, cycle)
        grew = {k: obs.counts[k] - before[0][k] for k in before[0]}
        launches = {k: tp.LAUNCHES[k] - before[1][k] for k in tp.LAUNCHES}
        assert np.array_equal(r.rows.kept_keys, kept_keys), (case, step)
        assert np.array_equal(r.rows.kept_seen, kept_seen), (case, step)
        assert tuple(grew[f"window_rows_{k}"] for k in ("new", "retained", "dropped",
                                                         "moved")) == counts, (case, step)
        assert (grew["rekey_card"], grew["rekey_native"], grew["host_syncs"]) == (1, 0, 1)
        moves = int(len(keys) + len(kept_keys) != R or counts != (0, len(kept_keys), 0, 0))
        assert launches == {**dict.fromkeys(launches, 0), "window_join": 1,
                            "window_gather": moves}, (case, step)
        wanted = kernels.window_gather_plain(*(x.cpu() for x in state[:2]),
                                             torch.from_numpy(runs), len(keys) + len(kept_keys))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(r.state[:2], wanted)), (case, step)
        card = r.rows.on_card
        on_card = card.keys.cpu().numpy()
        assert np.array_equal(on_card[:card.present], r.rows.keys)
        assert np.array_equal(on_card[card.present:card.present + card.kept], r.rows.kept_keys)
        assert np.array_equal(on_card[card.seen_at:card.seen_at + card.kept], r.rows.kept_seen)
        # the next cycle: the chips reversed, from the rows on the card
        state, rows, keys, cycle = r.state, r.rows, keys[::-1].copy(), cycle + 1
        want = engine.rekey_plain(rows, keys, cycle, K)


@pytest.mark.gpu
def test_rekey_window_at_the_cells_size_matches_cpu(cuda):
    """The cell stream-260k-churn-k12's daemon cycles at full size (260,000
    chips in 23,149 groups, K = 12), 20 cycles of a churned pool with the
    Multislice group's burst: rekey_window, update_window_ and
    evaluate_window_qc on the card give the rings, verdicts and candidates
    of the same calls on the CPU (the native join) bit for bit, and the same
    kept rows' keys and cycles and the four window_rows counts; each cycle
    launches the join once (rekey_card on every call on the card, the
    native join on the CPU), the int8 pass once, in the row design, and the
    slice gate once, and a cycle that re-keys the row gather once; a cycle
    whose chips are those of the last launches no gather; each rekey_window
    on the card waits for the card once and reads back once, the join's
    counts and kept rows (the host needs the row count for the rings)."""
    from port_bench import churn

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "port_bench/configs/gke-65k-jobset-churn.json").read_text())
    mix = json.loads((root / "port_bench/traffic/stream-churn-k12.json").read_text())
    mix = dict(mix, pool_cycles=20, burst_every=10)
    pool = churn.Churn(cfg, mix, 2**31 + 303, cuda)
    cycles = [pool.cycle(t, mix) for t in range(20)]
    cycles.insert(5, cycles[4])  # a cycle whose chips are the last one's
    parr = np.array([cfg["lookback_s"], cfg["hbm_threshold"]], dtype=np.float32)
    pq = torch.from_numpy(tp.quantize_params(parr))
    K = cfg["window_chunks"]
    states = {d: tp.init_window(0, K, device=d) for d in ("cpu", "cuda")}
    rows = {d: tp.WindowRows.of(np.zeros(0, dtype=np.int64), 0) for d in states}
    gathers = 0
    for i, c in enumerate(cycles):
        out, grew = {}, {}
        for d in ("cuda", "cpu"):
            tp.reset_launches()
            before = dict(obs.counts)
            r = tp.rekey_window(states[d], rows[d], c.keys, i)
            grew[d] = {k: obs.counts[k] - before[k] for k in before}
            rows[d] = r.rows
            tc, hbm, valid, age, _, _ = tp.fleet_from_numpy(
                (c.tc, c.hbm, c.valid, c.age, c.slice_id, parr), d)
            states[d] = tp.update_window_(r.state, tp.quantize_samples_device(tc, valid),
                                          tp.quantize_samples_device(hbm, valid))
            bounds = tp.slice_bounds(c.slice_id, c.slices, device=d)
            out[d] = tp.evaluate_window_qc(states[d], age, bounds, pq.to(d))
            if d == "cuda":
                torch.cuda.synchronize()
                launches = dict(tp.LAUNCHES)
        assert launches == {**dict.fromkeys(tp.LAUNCHES, 0), "chip_pass_q": 1, "slice_gate": 1,
                            "window_join": 1, "window_gather": int(i != 5)}, i
        gathers += launches["window_gather"]
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out["cuda"], out["cpu"])), i
        assert all(torch.equal(a.cpu(), b) for a, b in zip(states["cuda"][:2], states["cpu"][:2]))
        assert np.array_equal(rows["cuda"].kept_keys, rows["cpu"].kept_keys), i
        assert np.array_equal(rows["cuda"].kept_seen, rows["cpu"].kept_seen), i
        counted = ("window_rows_new", "window_rows_retained", "window_rows_dropped",
                   "window_rows_moved")
        assert [grew["cuda"][k] for k in counted] == [grew["cpu"][k] for k in counted], i
        retained = grew["cuda"]["window_rows_retained"]
        assert (grew["cuda"]["rekey_card"], grew["cuda"]["rekey_native"],
                grew["cuda"]["host_syncs"], grew["cuda"]["d2h_bytes"]) == (
                    1, 0, 1, 8 * (kernels.JOIN_COUNTS + 2 * retained)), i
        assert (grew["cpu"]["rekey_card"], grew["cpu"]["rekey_native"],
                grew["cpu"]["host_syncs"], grew["cpu"]["d2h_bytes"]) == (0, 1, 0, 0), i
    assert gathers == len(cycles) - 1
    assert states["cuda"][0].shape[0] > len(cycles[-1].keys)  # rows kept for absent chips


# --- the policy sweep -----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SWEEP_PASS_CASES))
def test_sweep_pass_matches_plain(cuda, case):
    """The sweep pass on torch_kernel_cases.sweep_pass_cases against its plain
    version on the CPU, bit for bit, one launch a call."""
    tc, hbm, valid, age, samples, lookbacks, cutoffs = SWEEP_PASS_CASES[case]
    cpu = [torch.from_numpy(x) for x in (tc, hbm, valid, age)]
    want = kernels.sweep_pass_plain(*cpu, samples, lookbacks, cutoffs)
    before = kernels.LAUNCHES["sweep_pass"]
    got = kernels.sweep_pass(*(x.to(cuda) for x in cpu), samples, lookbacks, cutoffs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sweep_pass"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SWEEP_SCATTER_CASES))
def test_sweep_scatter_matches_plain(cuda, case):
    """The sweep's slice reduction on torch_kernel_cases.sweep_scatter_cases
    against its plain version on the CPU; one call where it has a chip and a
    slice, none otherwise."""
    masks, ids, S, P = SWEEP_SCATTER_CASES[case]
    want = kernels.sweep_scatter_plain(torch.from_numpy(masks), torch.from_numpy(ids), S, P)
    before = kernels.LAUNCHES["sweep_scatter"]
    got = kernels.sweep_scatter(torch.from_numpy(masks).to(cuda), torch.from_numpy(ids).to(cuda),
                                S, P)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sweep_scatter"] == before + int(S > 0 and ids.size > 0)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_sweep_scatter_large_fleets_match_plain(cuda):
    """torch_kernel_cases.scatter_fleets' layouts (the gke-65k cluster in host
    order, with its 50,944-chip group; 1,048,576 shuffled chips; one slice of
    1,048,576; 1,048,576 one-chip slices), each chip's mask its slice's word
    with bits lacking where it is busy, at 64 policies."""
    rng = np.random.default_rng(6)
    for name, (cand, ids, S) in scatter_fleets(rng).items():
        words = rng.integers(-2**63, 2**63 - 1, size=S, dtype=np.int64, endpoint=True)
        lack = np.left_shift(np.int64(1), rng.integers(0, 64, ids.size).astype(np.int64))
        masks = np.where(cand, words[ids], words[ids] & ~lack)
        want = kernels.sweep_scatter_plain(torch.from_numpy(masks), torch.from_numpy(ids), S, 64)
        got = kernels.sweep_scatter(torch.from_numpy(masks).to(cuda),
                                    torch.from_numpy(ids).to(cuda), S, 64)
        assert torch.equal(got[0].cpu(), want[0]), name
        assert torch.equal(got[1].cpu(), want[1]), name


@pytest.mark.gpu
def test_sweep_at_the_cells_size_matches_the_reference(cuda):
    """evaluate_fleet_sweep at the sweep-260k-t1440-d8h8 cell's size (260,000
    chips x 1,440 samples in 23,149 groups, drawn on the card as the cell
    draws them) against port_bench/reference/sweep.py, computed in blocks on
    the host, under both of its grids; each call one launch of the sweep
    pass and one call of the slice reduction, and one pass over the
    window."""
    from port_bench import gen, sweep
    from port_bench.reference import sweep as ref

    root = Path(__file__).resolve().parents[1] / "port_bench"
    cfg = json.loads((root / "configs" / "gke-65k-policy-sweep.json").read_text())
    mix = json.loads((root / "traffic" / "sweep-d8h8.json").read_text())
    C, S, T = cfg["chips"], cfg["slices"], cfg["window_samples"]
    fleet = sweep.make_fleet(cfg, mix, 2**31 + 25, cuda)
    g = gen.generator(2**31 + 25, cuda, 2)
    block = mix["block_rows"]
    parts = [sweep.samples(fleet, mix, g, T, r0, min(C, r0 + block)) for r0 in range(0, C, block)]
    tc, hbm, valid = (torch.cat([p[k] for p in parts]) for k in range(3))
    blocks = [tuple(x.cpu().numpy() for x in p) for p in parts]
    del parts
    for swept in sweep.grids_of(cfg):
        before = dict(kernels.LAUNCHES)
        passes = obs.counts["sweep_window_passes"]
        got = tp.evaluate_fleet_sweep(tc, hbm, valid, fleet.age, fleet.slice_id, swept, S)
        got = [x.cpu() for x in got]
        assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == {
            **dict.fromkeys(before, 0), "sweep_pass": 1, "sweep_scatter": 1}
        assert obs.counts["sweep_window_passes"] == passes + 1
        want = ref.sweep(blocks, fleet.age.cpu().numpy(), fleet.slice_id.cpu().numpy(), S,
                         swept.durations_s, swept.hbm_thresholds, swept.grace_s, swept.step_s)
        for got_x, want_x, what in zip(got, want, ("slices", "chips", "counts")):
            assert torch.equal(got_x, want_x), (swept.grace_s, what)
        assert 0 < int(got[2][:, 0].sum()) and int(got[2][:, 0].max()) < S
