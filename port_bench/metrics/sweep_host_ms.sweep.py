"""Host time of the ``engine.sweep`` spans of one ``evaluate_fleet_sweep``
call, in ms: the inputs' checks, the grid's arguments and the launches,
which return before the card is done (the program's own span,
``tpu_pruner_torch.obs``, summed over the traced calls). None where the
program has no such span."""

import importlib


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    span = obs.summary()["spans"].get("engine.sweep")
    return span["total_ms"] / run.ops if span else None
