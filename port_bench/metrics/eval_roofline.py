"""Share (%) of the bandwidth bound of one ``evaluate_fleet_qc`` call on a
resident window: its logical bytes (``work.eval_qc_bytes``) at the card's
peak, over the summed time of every kernel of the call."""

from port_bench import work
from port_bench.trace import device_seconds


def read(run):
    if run.trace is None or not run.ops:
        return None
    shape = run.shape
    nbytes = work.eval_qc_bytes(shape["chips"], shape["samples"], shape["slices"])
    return work.roofline_pct(nbytes, device_seconds(run.trace, "kernels") / run.ops)
