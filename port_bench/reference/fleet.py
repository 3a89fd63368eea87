"""The fleet policy in plain NumPy, and its lower-precision controls.

A chip is an idle candidate iff it has at least one valid sample, the peak
of its valid tensorcore samples is 0, the peak of its valid HBM samples
stays below the cutoff (a threshold <= 0 disables the cutoff), and its
pod's age is at least the lookback. A slice is reclaimable iff it has
chips and every one of them is a candidate. Values below the smallest
normal f32 read as 0; all arithmetic is f32.

The streaming window keeps the samples of the last K chunks: its peaks are
the maxima over every sample of those chunks, here taken directly.

Precisions: ``f32`` (an audit's samples) with its control ``bf16``
(samples, ages and params rounded to bfloat16 first); ``int8`` (the
window's 1% buckets, q = ceil(util * 100), -1 invalid) with its control
``int4`` (eight levels, q = ceil(util * 7), -1 invalid).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
FLT_MIN = F32(1.1754944e-38)
LEVELS = {"int8": (100, 127), "int4": (7, 7)}  # buckets per unit, top bucket


def flush(x) -> np.ndarray:
    x = np.asarray(x, dtype=F32)
    return np.where(np.abs(x) < FLT_MIN, F32(0), x)


def to_bf16(x) -> np.ndarray:
    """f32 values rounded to the nearest bfloat16 (ties to even), as f32."""
    bits = np.asarray(x, dtype=F32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(F32)


def cutoff(threshold: float) -> np.float32:
    return F32(threshold) if threshold > 0 else F32(np.inf)


def candidates_f32(tc, hbm, valid, age, lookback: float, threshold: float,
                   precision: str = "f32") -> np.ndarray:
    """bool[C] from f32 samples [C, T], validity [C, T] and ages [C]."""
    cut, look = cutoff(threshold), F32(lookback)
    if precision == "bf16":
        tc, hbm, age = to_bf16(tc), to_bf16(hbm), to_bf16(age)
        cut, look = to_bf16(cut)[()], to_bf16(look)[()]
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision}")
    valid = np.asarray(valid, dtype=bool)
    peak_tc = np.where(valid, flush(tc), F32(-1)).max(axis=1)
    peak_hbm = np.where(valid, flush(hbm), F32(-1)).max(axis=1)
    return (valid.any(axis=1) & (peak_tc <= 0) & ~(peak_hbm >= cut)
            & (flush(age) >= flush(look)))


def quantize(util, valid, precision: str = "int8") -> np.ndarray:
    """int8 bucket samples [C, T] of f32 utilization, -1 where invalid."""
    scale, top = LEVELS[precision]
    q = np.ceil(flush(util) * F32(scale))
    q = np.clip(np.nan_to_num(q, nan=0.0), 0, top)
    return np.where(np.asarray(valid, dtype=bool), q, -1).astype(np.int8)


def requantize(q8, precision: str) -> np.ndarray:
    """int8 1% buckets to ``precision``'s buckets, -1 kept."""
    if precision == "int8":
        return np.asarray(q8, dtype=np.int8)
    scale, top = LEVELS[precision]
    q = np.asarray(q8, dtype=np.int32)
    return np.where(q < 0, -1, np.minimum((q * scale + 99) // 100, top)).astype(np.int8)


def cutoff_q(threshold: float, precision: str = "int8") -> np.float32:
    """The cutoff in ``precision``'s buckets; +inf where disabled."""
    if threshold <= 0:
        return F32(np.inf)
    return F32(np.ceil(F32(threshold) * F32(LEVELS[precision][0])))


def peaks_q(q) -> np.ndarray:
    """Row maxima of bucket samples: -1 where a row has no valid sample."""
    return np.asarray(q, dtype=np.int8).max(axis=1)


def window_peaks(chunk_peaks) -> np.ndarray:
    """The window's peaks: the maximum of its chunks' peaks."""
    return np.maximum.reduce(list(chunk_peaks))


def candidates_q(peak_tc, peak_hbm, age, lookback: float, cut_q) -> np.ndarray:
    """bool[C] from bucket peaks [C] (int8, -1 = no data) and ages [C]."""
    return ((np.asarray(peak_tc) == 0) & ~(np.asarray(peak_hbm).astype(F32) >= F32(cut_q))
            & (flush(age) >= flush(F32(lookback))))


def slice_counts(candidate, slice_index, num_slices: int):
    """(chips, candidates) per slice, int64[S] each."""
    chips = np.bincount(slice_index, minlength=num_slices)
    idle = np.bincount(slice_index, weights=np.asarray(candidate, dtype=np.float64),
                       minlength=num_slices).astype(np.int64)
    return chips, idle


def slice_verdicts(candidate, slice_index, num_slices: int) -> np.ndarray:
    """bool[S]: the slice has chips and each is a candidate."""
    chips, idle = slice_counts(candidate, slice_index, num_slices)
    return (chips > 0) & (idle == chips)
