"""Host time of one ``analyze.report`` span in an audit, in ms: the slice
counts, the printed table and the JSON line (the program's own span,
``tpu_pruner_torch.obs``, read after the traced window). None where the
program has no such span."""

import importlib


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    span = obs.summary()["spans"].get("analyze.report")
    return span["total_ms"] / span["count"] if span else None
