"""Host time of the ``engine.rekey`` spans of one daemon cycle on a changing
fleet, in ms: the join of the rows' keys with the cycle's chips, the gather's
upload and the row gather's launch (the program's own span,
``tpu_pruner_torch.obs``, summed over the traced cycles). None where the
program has no such span."""

import importlib


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    span = obs.summary()["spans"].get("engine.rekey")
    return span["total_ms"] / run.ops if span else None
