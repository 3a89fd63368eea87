"""Device operations (kernels, memsets, copies) that one streaming cycle
puts on the card, from the profiler trace of the traced cycles."""


def read(run):
    if run.trace is None or not run.ops or not run.trace.device:
        return None
    return len(run.trace.device) / run.ops
