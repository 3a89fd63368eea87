"""tpu_pruner_torch on the card: each CUDA kernel against its plain version.

Tests marked ``gpu`` skip without a CUDA device. This file imports no JAX,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (F32_LAYOUTS, F32_PARAMS, GATE_OFFSETS, INT8_LAYOUTS, INT8_PARAMS,
                        SWEEP_C, SWEEP_T, adversarial_fleet, engine_input_check,
                        f32_design_cases, f32_edge_fleet, f32_expected_design, gate_cases,
                        gate_on, input_cases, int8_design_cases, int8_edge_fleet, int8_on,
                        launch_counts, scatter_cases, scatter_fleets)
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.analyze import evaluate_loaded
from tpu_pruner_torch.policy import kernels

PARAMS = [(2100.0, 0.05), (2100.0, float("inf")), (0.0, 1e-40), (2e-40, 0.5)]
INPUT_CASES = input_cases(5)
GATE_CASES = gate_cases(77)
SCATTER_CASES = scatter_cases(78)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def adversarial_on(device, T, seed=7, C=1003):
    tc, hbm, valid, age = adversarial_fleet(np.random.default_rng(seed), C, T)
    return [torch.from_numpy(x).to(device) for x in (tc, hbm, valid, age)]


@pytest.mark.gpu
@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("T", [1, 31, 360, 361])
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


@pytest.mark.gpu
@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("T", [1, 12, 31, 360, 361, 10080])
def test_chip_pass_q_matches_plain(cuda, T, params):
    tc, hbm, valid, age = adversarial_on(cuda, T)
    tc_q = tp.quantize_samples_device(tc, valid)
    hbm_q = tp.quantize_samples_device(hbm, valid)
    np.testing.assert_array_equal(tc_q.cpu().numpy(),
                                  tp.quantize_samples(tc.cpu().numpy(), valid.cpu().numpy()))
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
    tc, hbm, age = int8_edge_fleet(np.random.default_rng(3), 131072, 360)
    assert_q_matches_plain(cuda, int8_on(cuda, tc, layout, 1), int8_on(cuda, hbm, layout, 2),
                           torch.from_numpy(age).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("T", SWEEP_T)
def test_chip_pass_q_design_sweep(cuda, T):
    """chip_smoke.py phase 2's sweep at one T: every C of the sweep, bases
    at every offset (0 and 1 above 4,097 chips), bit-equal to the plain
    version in the design the plan promises; short rows take both designs."""
    took = {"rows": 0, "tiles": 0}
    for C in SWEEP_C:
        for design, n in int8_design_cases(cuda, T, C, np.random.default_rng(T * 31 + C)).items():
            took[design] += n
    torch.cuda.synchronize()
    assert took["tiles"] > 0 and (took["rows"] > 0) == (T in kernels._Q_ROWS_T)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 7, 8, 32, 33, 257, 360, 384, 385, 513, 2880])
def test_chip_pass_designs_match_plain(cuda, T):
    """Each design of the f32 pass that takes T-sample rows, forced, equals
    the plain version on adversarial rows with invalid padding; chip_pass
    launches the design its plan promises, on contiguous tensors and on
    views off a 16-byte boundary, and equals the plain version there."""
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
@pytest.mark.parametrize("T", [1, 2, 3, 7, 8, 9, 16, 31, 32, 33, 64, 256, 257, 300, 360, 384,
                               385, 512, 513, 720])
def test_chip_pass_design_sweep(cuda, T):
    """chip_smoke.py phase 2's f32 sweep at one T: every C of the sweep,
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
def test_sharded_one_rank_nccl_matches_single_device(cuda, tmp_path):
    """Every sharded evaluator in a one-rank NCCL group equals the
    single-device evaluation on the card."""
    import torch.distributed as dist

    from tpu_pruner_torch.policy import sharded

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        C, S = 4096, 256
        inputs, expected = tp.make_example_fleet(C, 64, S, idle_fraction=0.5, device=cuda)
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
        cycles = sharded.run_stream_local(C // S, 3, [q[0][:, i:i + 1] for i in range(5)],
                                          [q[1][:, i:i + 1] for i in range(5)], q[2], q[4])
        assert torch.equal(cycles[-1][0], ref_v)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(INPUT_CASES))
def test_engine_inputs_on_card_match_cpu(cuda, case):
    """Slice ids outside [0, S), bf16, f16 and f64 samples, an integer mask,
    f64 ages and strided views through the f32 and int8 paths on the card:
    the CPU's verdicts, each kernel equal to its plain version, and a launch
    after the case succeeds (a bad id leaves the CUDA context usable)."""
    assert engine_input_check(cuda, case, INPUT_CASES[case]) == 0
    tc, hbm, valid, age = adversarial_on(cuda, 12)
    parr = torch.tensor(PARAMS[0], device=cuda)
    assert torch.equal(tp.chip_pass(tc, hbm, valid, age, parr),
                       tp.chip_pass_plain(tc, hbm, valid, age, parr))


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
    """The slice gate on chip_smoke.gate_cases, the candidate at each of
    GATE_OFFSETS off a 16-byte boundary: one launch (none where S = 0),
    bit-equal to the plain version on the card and on the CPU."""
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


@pytest.mark.gpu
def test_contiguous_paths_launch_the_gate_once(cuda):
    """evaluate_fleet_c, _qc, evaluate_fleet_cuda_qc, evaluate_window_qc and
    analyze.evaluate_loaded each launch the slice gate once, beside one pass,
    and give the CPU's verdicts; the scatter and uniform paths never launch
    it."""
    C, S = 4096, 256
    gpu_inputs, expected = tp.make_example_fleet(C, 64, S, idle_fraction=0.5, device=cuda)
    q = tp.quantize_fleet_inputs(gpu_inputs)
    bounds = tp.slice_bounds(gpu_inputs[4], S, device=cuda)
    state = tp.init_window(C, 12, device=cuda)
    state = tp.update_window_(state, q[0][:, :6].contiguous(), q[1][:, :6].contiguous())
    fleet_np = tuple(x.cpu().numpy() for x in gpu_inputs[:5])
    runs = {
        "evaluate_fleet_c": (1, lambda: tp.evaluate_fleet_c(*gpu_inputs[:4], bounds,
                                                            gpu_inputs[5])),
        "evaluate_fleet_qc": (1, lambda: tp.evaluate_fleet_qc(q[0], q[1], q[2], bounds, q[4])),
        "evaluate_fleet_cuda_qc": (1, lambda: tp.evaluate_fleet_cuda_qc(q[0], q[1], q[2],
                                                                        bounds, q[4])),
        "evaluate_window_qc": (1, lambda: tp.evaluate_window_qc(state, q[2], bounds, q[4])),
        "evaluate_loaded": (1, lambda: evaluate_loaded(fleet_np, S, tp.PolicyParams(), False,
                                                       cuda)),
        "evaluate_loaded --quantize": (1, lambda: evaluate_loaded(fleet_np, S, tp.PolicyParams(),
                                                                  True, cuda)),
        "evaluate_fleet": (0, lambda: tp.evaluate_fleet(*gpu_inputs, num_slices=S)),
        "evaluate_fleet_qu": (0, lambda: tp.evaluate_fleet_qu(q[0], q[1], q[2], q[4], C // S)),
    }
    for name, (gates, run) in runs.items():
        tp.reset_launches()
        v, _ = run()
        torch.cuda.synchronize()
        assert tp.LAUNCHES["slice_gate"] == gates, name
        assert tp.LAUNCHES["chip_pass"] + tp.LAUNCHES["chip_pass_q"] == 1, name
        if name != "evaluate_window_qc":
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            np.testing.assert_array_equal(v, expected, err_msg=name)


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
    """The scatter reduction on chip_smoke.scatter_cases, the candidate at
    each of GATE_OFFSETS off a 16-byte boundary: one launch (none where
    S = 0 or C = 0), bit-equal to the plain version on the card and on the
    CPU."""
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
    """chip_smoke.scatter_fleets, with int32 and int64 ids: the cell's 260,000
    chips in 23,149 groups in host order, 1,048,576 chips in 65,536 shuffled
    slices, one slice of 1,048,576 chips and 1,048,576 one-chip slices."""
    for name, (cand_np, ids_np, S) in scatter_fleets(np.random.default_rng(5)).items():
        cand = torch.from_numpy(cand_np).to(cuda)
        for dtype in (torch.int32, torch.int64):
            ids = torch.from_numpy(ids_np).to(cuda, dtype)
            assert torch.equal(kernels.slice_scatter(cand, ids, S),
                               kernels.slice_scatter_plain(cand, ids, S)), (name, dtype)


@pytest.mark.gpu
def test_scatter_paths_launch_the_scatter_once(cuda):
    """evaluate_fleet, _q, evaluate_fleet_cuda and _cuda_q each launch the
    scatter reduction once, beside one pass and no gate, and give the
    expected verdicts; obs.summary() counts the launches."""
    from tpu_pruner_torch import obs

    C, S = 4096, 256
    inputs, expected = tp.make_example_fleet(C, 64, S, idle_fraction=0.5, device=cuda)
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
    assert "slice_marks_kernel" in names and "slice_verdict_kernel" in names, names
    assert "index" not in names and "elementwise" not in names, names

