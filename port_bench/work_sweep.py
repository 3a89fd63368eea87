"""The logical bytes of one ``evaluate_fleet_sweep`` call, for its roofline
share at ``work.HBM_BYTES_PER_S``.

As in ``work``: each input byte read once and each output byte written
once, whatever kernels (or how many) do it.
"""

from __future__ import annotations

from port_bench.work import BOOL, F32, HBM_BYTES_PER_S, I32, roofline_pct  # noqa: F401

I64 = 8
POLICY = 12  # a policy's window (int32), lookback (f32) and cutoff (f32)


def sweep_bytes(chips: int, samples: int, slices: int, policies: int) -> int:
    """One ``evaluate_fleet_sweep`` call on resident f32 inputs, chips in any
    order, ``samples`` the longest window's.

    Read once: tc and hbm f32 and valid bool [C, samples], the ages, the
    int32 group ids and the grid. Written once: the chip masks and slice
    masks (int64) and the counts [P, 2] (int64).
    """
    return (chips * samples * (2 * F32 + BOOL) + chips * (F32 + I32) + policies * POLICY
            + chips * I64 + slices * I64 + policies * 2 * I64)
