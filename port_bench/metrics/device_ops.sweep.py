"""Device operations (kernels, memsets, copies) that one
``evaluate_fleet_sweep`` call puts on the card, its readbacks included,
from the profiler trace of the traced calls."""


def read(run):
    if run.trace is None or not run.ops or not run.trace.device:
        return None
    return len(run.trace.device) / run.ops
