"""Share (%) of the bandwidth bound of one ``evaluate_fleet_sweep`` call on
resident inputs: its logical bytes (``work_sweep.sweep_bytes``) at the
card's peak, over the summed time of every kernel of the call (copies and
memsets left out)."""

from port_bench import work_sweep
from port_bench.trace import device_seconds


def read(run):
    if run.trace is None or not run.ops:
        return None
    shape = run.shape
    nbytes = work_sweep.sweep_bytes(shape["chips"], shape["samples"], shape["slices"],
                                    shape["policies"])
    return work_sweep.roofline_pct(nbytes, device_seconds(run.trace, "kernels") / run.ops)
