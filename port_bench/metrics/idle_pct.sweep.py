"""Share (%) of the traced window in which no device operation (kernel,
copy or memset) ran: the union of their intervals, from the trace."""

from port_bench.trace import busy_s


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return (1.0 - busy_s(run.trace) / run.trace.window_s) * 100.0
