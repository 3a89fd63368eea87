"""Share (%) of the bandwidth bound of the daemon cycles on a changing
fleet: their logical bytes (``work_churn.cycle_bytes``, the carry of the
rows included, summed by the driver over the traced cycles) at the card's
peak, over the summed time of their kernels (copies and memsets left
out)."""

from port_bench import work_churn
from port_bench.trace import device_seconds


def read(run):
    if run.trace is None or not run.ops or not run.shape.get("cycles"):
        return None
    return work_churn.roofline_pct(run.shape["bytes"], device_seconds(run.trace, "kernels"))
