"""Explicit-kernel entry points: the fleet evaluation with the chip pass in CUDA.

Counterpart of the ``evaluate_fleet_pallas*`` wrappers of
tpu_pruner/policy/pallas_engine.py. Unlike the engine's functions, which
run the plain versions on CPU tensors, these demand CUDA tensors and
always launch the kernels. Nothing is padded: the kernels mask their own
ragged edge, so any chip count goes straight through. Inputs are
normalized as the engine's are (``normalize_inputs``).
"""

from __future__ import annotations

import torch

from .engine import (normalize_inputs, normalize_inputs_q, slice_verdicts,
                     slice_verdicts_contiguous)
from .kernels import chip_pass, chip_pass_q


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA entry points take CUDA tensors, got {t.device}")


def evaluate_fleet_cuda(tc_util, hbm_util, valid, pod_age_s, slice_id, params_arr,
                        num_slices: int):
    """engine.evaluate_fleet with the f32 chip pass in CUDA."""
    _require_cuda(tc_util)
    candidate = chip_pass(*normalize_inputs(tc_util, hbm_util, valid, pod_age_s,
                                            params_arr))
    return slice_verdicts(candidate, slice_id, num_slices), candidate


def evaluate_fleet_cuda_q(tc_q, hbm_q, pod_age_s, slice_id, params_arr_q,
                          num_slices: int):
    """engine.evaluate_fleet_q with the int8 chip pass in CUDA."""
    _require_cuda(tc_q)
    candidate = chip_pass_q(*normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q))
    return slice_verdicts(candidate, slice_id, num_slices), candidate


def evaluate_fleet_cuda_qc(tc_q, hbm_q, pod_age_s, bounds, params_arr_q):
    """engine.evaluate_fleet_qc with the int8 chip pass in CUDA (contiguous
    slices, cumsum reduction)."""
    _require_cuda(tc_q)
    candidate = chip_pass_q(*normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q))
    return slice_verdicts_contiguous(candidate, bounds), candidate
