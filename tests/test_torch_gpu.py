"""tpu_pruner_torch on the card: each CUDA kernel against its plain version.

Tests marked ``gpu`` skip without a CUDA device. This file imports no JAX,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (INT8_LAYOUTS, INT8_PARAMS, adversarial_fleet, int8_edge_fleet,
                        int8_on)
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.analyze import evaluate_loaded

PARAMS = [(2100.0, 0.05), (2100.0, float("inf")), (0.0, 1e-40), (2e-40, 0.5)]


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
