"""Share (%) of the bandwidth bound of one streaming cycle's kernels: the
cycle's logical bytes (``work.cycle_bytes``) at the card's peak, over the
summed time of its kernels (copies and memsets left out)."""

from port_bench import work
from port_bench.trace import device_seconds


def read(run):
    if run.trace is None or not run.ops:
        return None
    shape = run.shape
    nbytes = work.cycle_bytes(shape["chips"], shape["new_samples"], shape["chunks"],
                              shape["slices"])
    return work.roofline_pct(nbytes, device_seconds(run.trace, "kernels") / run.ops)
