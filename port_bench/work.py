"""The yardstick's peak and the logical bytes of one engine call.

The bytes are the work a call needs, from its shapes: each input byte read
once and each output byte written once, whatever kernels (or how many) do
it. A later change that fuses, splits or renames kernels moves the time and
leaves these counts alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM, HBM3, published peak at the 700 W power limit (data sheet).
# A card set below 700 W runs slower under load; every run records its limit.
HBM_BYTES_PER_S = 3.35e12

F32, I32, I8, BOOL = 4, 4, 1, 1


def cycle_bytes(chips: int, new_samples: int, chunks: int, slices: int) -> int:
    """One streaming cycle (quantize, window update, window evaluation).

    Read once: the uploaded chunk (tc and hbm f32, valid bool), the two
    int8 rings [C, K] (after the write), the ages, the slice bounds and the
    two params. Written once: the two ring columns, the slice verdicts and
    the chip candidates.
    """
    chunk = chips * new_samples * (2 * F32 + BOOL)
    rings = 2 * chips * chunks * I8
    column = 2 * chips * I8
    return (chunk + rings + column + chips * F32 + (slices + 1) * I32 + 2 * F32
            + slices * BOOL + chips * BOOL)


def eval_qc_bytes(chips: int, samples: int, slices: int) -> int:
    """One ``evaluate_fleet_qc`` call on a resident int8 window.

    Read once: tc and hbm int8 [C, T], the ages, the slice bounds and the
    two params. Written once: the slice verdicts and the chip candidates.
    """
    return (2 * chips * samples * I8 + chips * F32 + (slices + 1) * I32 + 2 * F32
            + slices * BOOL + chips * BOOL)


def roofline_pct(nbytes: float, kernel_s: float) -> float | None:
    """Share (%) of the bandwidth bound: the least time the bytes take at
    the peak over the kernels' time. None where no kernel time was read."""
    if kernel_s <= 0:
        return None
    return nbytes / HBM_BYTES_PER_S / kernel_s * 100.0
