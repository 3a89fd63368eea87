"""Megabytes (1e6 bytes) that one streaming cycle copies from the host to
the card: the program's ``h2d_bytes`` counter (``tpu_pruner_torch.obs``),
its growth over the traced cycles. None where the program has no such
counter, or copied nothing (on the CPU)."""

import importlib


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    nbytes = obs.summary()["counters"].get("h2d_bytes")
    return nbytes / run.ops / 1e6 if nbytes else None
