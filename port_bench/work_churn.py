"""The logical bytes of the daemon cycles of a fleet that changes, for
their roofline share at ``work.HBM_BYTES_PER_S``.

As in ``work``: each input byte read once and each output byte written
once, whatever kernels (or how many) do it.
"""

from __future__ import annotations

from port_bench import work
from port_bench.work import I8, HBM_BYTES_PER_S, roofline_pct  # noqa: F401


def cycle_bytes(chips: int, rows: int, carried: int, runs_bytes: int, new_samples: int,
                chunks: int, slices: int) -> int:
    """One cycle: ``work.cycle_bytes`` over its ``chips`` (the upload, the
    quantize, the column write and the window evaluation of the present
    rows), the no-data column of the ``rows - chips`` kept rows, and, where
    the rows were carried (``runs_bytes`` > 0, the runs the gather reads),
    the ``carried`` old rows of both rings read and the new rings written.
    """
    carry = runs_bytes + 2 * carried * chunks * I8 + 2 * rows * chunks * I8 if runs_bytes else 0
    return (work.cycle_bytes(chips, new_samples, chunks, slices) + 2 * (rows - chips) * I8
            + carry)
