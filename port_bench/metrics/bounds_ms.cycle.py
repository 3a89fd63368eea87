"""Host time of the ``engine.bounds`` spans of one streaming cycle, in ms:
``slice_bounds`` over the fleet's slice ids and their upload (the program's
own span, ``tpu_pruner_torch.obs``, summed over the traced cycles). None
where the program has no such span."""

import importlib


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    span = obs.summary()["spans"].get("engine.bounds")
    return span["total_ms"] / run.ops if span else None
