"""Passes over the window's samples that one ``evaluate_fleet_sweep`` call
makes, whatever its policies: the program's ``sweep_window_passes`` counter
(``tpu_pruner_torch.obs``), its growth over the traced calls. None where
the program has no such counter."""

import importlib


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    passes = obs.summary()["counters"].get("sweep_window_passes")
    return passes / run.ops if passes else None
