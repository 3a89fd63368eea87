"""The logical bytes of one f32 ``evaluate_fleet`` call, for its roofline
share at ``work.HBM_BYTES_PER_S``.

As in ``work``: each input byte read once and each output byte written
once, whatever kernels (or how many) do it.
"""

from __future__ import annotations

from port_bench.work import BOOL, F32, HBM_BYTES_PER_S, I32, roofline_pct  # noqa: F401


def evaluate_fleet_bytes(chips: int, samples: int, slices: int) -> int:
    """One ``evaluate_fleet`` call on resident f32 inputs, chips in any order.

    Read once: tc and hbm f32 [C, T] and valid bool [C, T], the ages, the
    int32 group ids and the two params. Written once: the chip candidates
    and the slice verdicts.
    """
    return (chips * samples * (2 * F32 + BOOL) + chips * F32 + chips * I32 + 2 * F32
            + chips * BOOL + slices * BOOL)
