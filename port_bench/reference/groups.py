"""The fleet policy over chips in any order, block by block, in plain NumPy.

``fleet.candidates_f32`` over each block of rows of the inputs in turn, so
that a fleet of 260,000 x 360 samples is judged without a whole-fleet
temporary, then ``fleet.slice_verdicts`` over the group ids, which may come
in any order.
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import fleet


def verdicts(blocks, age, slice_id, num_slices: int, lookback: float, threshold: float,
             precision: str = "f32"):
    """(bool[S] slice verdicts, bool[C] candidates) of f32 samples given as
    (tc, hbm, valid) blocks of consecutive rows, ages [C] and ids [C]."""
    parts, r0 = [], 0
    for tc, hbm, valid in blocks:
        r1 = r0 + len(tc)
        parts.append(fleet.candidates_f32(tc, hbm, valid, age[r0:r1], lookback, threshold,
                                          precision))
        r0 = r1
    if r0 != len(age):
        raise ValueError(f"the blocks hold {r0} rows, the ages {len(age)}")
    candidate = np.concatenate(parts) if parts else np.zeros(0, dtype=bool)
    return fleet.slice_verdicts(candidate, slice_id, num_slices), candidate
