"""tpu-pruner's fleet idleness policy engine, ported to PyTorch and CUDA.

A second package beside ``tpu_pruner``: it imports ``torch`` and numpy and
nothing of the JAX package, which stays the reference it is tested against.

- ``tpu_pruner_torch.policy`` — the engine: per-chip idle verdicts in
  hand-written CUDA kernels for Hopper (sm_90a), slice verdicts in PyTorch;
- ``tpu_pruner_torch.analyze`` — the offline audit CLI: the batch fleet
  evaluation (``python -m tpu_pruner_torch.analyze dump.json [--quantize]
  [--device cpu]``), ``--stream``, ``--shard``, and the report modes over
  the daemon's records (``--explain``, ``--fleet-report``, ``--replay``,
  ``--gym``, ``--capacity-report``, ``--signal-report``, ``--trace``,
  ``--slow``);
- ``tpu_pruner_torch.dump`` — exports a dump from Prometheus,
  ``python -m tpu_pruner_torch.dump --prometheus-url URL``;
- ``tpu_pruner_torch.native`` — builds the daemon's C++ core from
  ``native/`` at first use and binds what the replay, gym and capacity
  reports call.
"""

__version__ = "0.1.0"
