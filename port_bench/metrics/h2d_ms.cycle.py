"""Device time of the host-to-device copies of one streaming cycle, in ms
(the profiler's Memcpy HtoD operations, summed over the traced cycles)."""

from port_bench.trace import device_seconds


def read(run):
    if run.trace is None or not run.ops:
        return None
    seconds = device_seconds(run.trace, "h2d")
    return seconds / run.ops * 1e3 if seconds > 0 else None
