"""Benchmark of tpu_pruner_torch, the PyTorch and CUDA port of the policy engine.

One run measures one cell of ``BENCHMARK.json`` on the card:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``, which
names a driver in ``drivers/``) and its per-layer metrics (``metrics/<name>.py``).
Nothing here imports JAX or the JAX package ``tpu_pruner``; the plain
reference that decides ``correct`` (``reference/``) imports nothing of the port.
"""
