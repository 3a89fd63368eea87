"""Share (%) of the bandwidth bound of one f32 ``evaluate_fleet`` call on
resident inputs, chips in any order: its logical bytes
(``work_f32.evaluate_fleet_bytes``) at the card's peak, over the summed time
of every kernel of the call (copies and memsets left out)."""

from port_bench import work_f32
from port_bench.trace import device_seconds


def read(run):
    if run.trace is None or not run.ops:
        return None
    shape = run.shape
    nbytes = work_f32.evaluate_fleet_bytes(shape["chips"], shape["samples"], shape["slices"])
    return work_f32.roofline_pct(nbytes, device_seconds(run.trace, "kernels") / run.ops)
