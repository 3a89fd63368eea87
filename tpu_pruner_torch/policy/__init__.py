"""Fleet-scale idleness policy engine in PyTorch, with CUDA kernels for Hopper.

Counterpart of tpu_pruner/policy (the JAX reference). The per-chip pass
runs in hand-written CUDA kernels on the card (``kernels.py``,
``csrc/chip_pass.cu``) and in their plain PyTorch versions on the CPU; the
slice reductions are plain PyTorch. The sharded forms (``sharded.py``) run
one program per rank of a torch.distributed group, NCCL on the card and
gloo on the CPU, where the reference shards a device mesh.

Which evaluator for which fleet, on one device and over a process group:

==========================  =========================  ===========================
fleet layout                single device              process group
==========================  =========================  ===========================
uniform contiguous          ``evaluate_fleet_qu``      ``evaluate_fleet_sharded_qu``
(all slices equal-size;     (reshape + all)            (whole slices per rank,
``assert_uniform_slices``                              no collective)
at ingest)
heterogeneous contiguous    ``evaluate_fleet_qc`` /    ``evaluate_fleet_sharded_qc``
(sorted by slice;           ``evaluate_fleet_c``       (per-rank cumsum + one
``slice_bounds`` at         (cumsum + boundary          all-reduce of slice counts)
ingest)                     gather)
arbitrary order             ``evaluate_fleet_q`` /     ``evaluate_fleet_sharded_q`` /
                            ``evaluate_fleet``         ``evaluate_fleet_sharded``
                            (index_add_ scatter)       (index_add_ + all-reduce)
streaming (daemon loop)     ``update_window(_)`` +     ``make_sharded_stream_step``
                            ``evaluate_window_qu/qc``  (fused update + verdict per
                                                       rank, no collective)
==========================  =========================  ===========================

int8 quantized storage (``quantize_fleet_inputs``) is the recommended form:
the pass is bandwidth-bound, and it moves 2 bytes per chip-sample instead
of 9. ``update_window`` returns fresh rings, as the reference does;
``update_window_`` writes the caller's rings in place, for a loop that owns
its state alone.
"""

from tpu_pruner_torch.policy.cuda_engine import (
    evaluate_fleet_cuda,
    evaluate_fleet_cuda_q,
    evaluate_fleet_cuda_qc,
)
from tpu_pruner_torch.policy.engine import (
    INVALID_Q,
    UTIL_SCALE,
    PolicyParams,
    assert_uniform_slices,
    evaluate_chips,
    evaluate_chips_q,
    evaluate_fleet,
    evaluate_fleet_c,
    evaluate_fleet_q,
    evaluate_fleet_qc,
    evaluate_fleet_qu,
    evaluate_window_qc,
    evaluate_window_qu,
    fleet_from_numpy,
    init_window,
    make_example_fleet,
    params_array,
    quantize_fleet_inputs,
    quantize_params,
    quantize_samples,
    quantize_samples_device,
    slice_bounds,
    slice_verdicts,
    slice_verdicts_contiguous,
    update_window,
    update_window_,
    window_from_numpy,
)
from tpu_pruner_torch.policy.kernels import (
    LAUNCHES,
    chip_pass,
    chip_pass_plain,
    chip_pass_q,
    chip_pass_q_plain,
    reset_launches,
)
from tpu_pruner_torch.policy.sharded import (
    evaluate_fleet_sharded,
    evaluate_fleet_sharded_q,
    evaluate_fleet_sharded_qc,
    evaluate_fleet_sharded_qu,
    make_sharded_evaluator,
    make_sharded_evaluator_q,
    make_sharded_evaluator_qc,
    make_sharded_evaluator_qu,
    make_sharded_stream_step,
    shard_bounds,
)

__all__ = [
    "INVALID_Q",
    "LAUNCHES",
    "UTIL_SCALE",
    "PolicyParams",
    "assert_uniform_slices",
    "chip_pass",
    "chip_pass_plain",
    "chip_pass_q",
    "chip_pass_q_plain",
    "evaluate_chips",
    "evaluate_chips_q",
    "evaluate_fleet",
    "evaluate_fleet_c",
    "evaluate_fleet_cuda",
    "evaluate_fleet_cuda_q",
    "evaluate_fleet_cuda_qc",
    "evaluate_fleet_q",
    "evaluate_fleet_qc",
    "evaluate_fleet_qu",
    "evaluate_fleet_sharded",
    "evaluate_fleet_sharded_q",
    "evaluate_fleet_sharded_qc",
    "evaluate_fleet_sharded_qu",
    "evaluate_window_qc",
    "evaluate_window_qu",
    "fleet_from_numpy",
    "init_window",
    "make_example_fleet",
    "make_sharded_evaluator",
    "make_sharded_evaluator_q",
    "make_sharded_evaluator_qc",
    "make_sharded_evaluator_qu",
    "make_sharded_stream_step",
    "params_array",
    "quantize_fleet_inputs",
    "quantize_params",
    "quantize_samples",
    "quantize_samples_device",
    "reset_launches",
    "shard_bounds",
    "slice_bounds",
    "slice_verdicts",
    "slice_verdicts_contiguous",
    "update_window",
    "update_window_",
    "window_from_numpy",
]
