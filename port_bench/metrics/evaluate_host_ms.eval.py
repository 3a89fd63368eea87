"""Host time of the ``engine.evaluate`` spans of one evaluation, in ms: the
inputs' normalisation, the launch plans and the kernels' launches, which
return before the card is done (the program's own span,
``tpu_pruner_torch.obs``, summed over the traced evaluations). None where
the program has no such span."""

import importlib


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    span = obs.summary()["spans"].get("engine.evaluate")
    return span["total_ms"] / run.ops if span else None
