"""Device operations (kernels, memsets, copies) that one daemon cycle on a
changing fleet puts on the card, the carry of its rows included, from the
profiler trace of the traced cycles."""


def read(run):
    if run.trace is None or not run.ops or not run.trace.device:
        return None
    return len(run.trace.device) / run.ops
