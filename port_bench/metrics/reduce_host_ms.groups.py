"""Host time of the ``engine.reduce`` spans of one ``evaluate_fleet`` call,
in ms: the scatter reduction's launches (``slice_counts``: two
``index_add_`` over the group ids and the eager operations around them),
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
    span = obs.summary()["spans"].get("engine.reduce")
    return span["total_ms"] / run.ops if span else None
