"""The plain reference that decides ``correct``: NumPy only.

It imports nothing of ``jax``, ``tpu_pruner`` or ``tpu_pruner_torch``, and
takes nothing the program made: it works from the inputs the benchmark
generated, with its own quantization, its own window and its own slice
grouping.
"""
