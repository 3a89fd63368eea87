"""Rows of the streaming window that one daemon cycle on a changing fleet
re-keys: rows added for new chips, moved to another place and dropped (the
program's counters ``window_rows_new``, ``_moved`` and ``_dropped``,
``tpu_pruner_torch.obs``, their growth over the traced cycles). None where
the program has no such counters."""

import importlib

COUNTERS = ("window_rows_new", "window_rows_moved", "window_rows_dropped")


def read(run):
    if run.trace is None or not run.ops:
        return None
    try:
        obs = importlib.import_module("tpu_pruner_torch.obs")
    except ImportError:
        return None
    counters = obs.summary()["counters"]
    if not all(name in counters for name in COUNTERS):
        return None
    return sum(counters[name] for name in COUNTERS) / run.ops
