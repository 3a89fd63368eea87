"""The streaming window over a fleet that changes between cycles, in plain
NumPy: per chip id, the history of its chunk peaks.

At cycle i a chip's window is the peaks of the chunks of cycles
max(0, i - K + 1) .. i in which its id was in the dump; a cycle without it
adds nothing (a chunk with no data). Verdicts and candidates are over the
chips of cycle i, in its order, and its groups; the rest is ``fleet``'s
policy on the int8 window (``candidates_q``, ``slice_verdicts``).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import fleet


def chunk_peaks(tc, hbm, valid, precision: str = "int8"):
    """One cycle's chunk peaks of each chip, in ``precision``'s buckets:
    (tc int8 [C], hbm int8 [C]), -1 where a chip has no valid sample."""
    return (fleet.peaks_q(fleet.quantize(tc, valid, precision)),
            fleet.peaks_q(fleet.quantize(hbm, valid, precision)))


def by_id(ids, tc, hbm):
    """A cycle's (ids, tc peaks, hbm peaks) in the order of the ids, which
    ``window_peaks`` then sorts in one pass."""
    order = np.argsort(ids, kind="stable")
    return ids[order], tc[order], hbm[order]


def window_peaks(window, keys):
    """The peaks over ``window`` ((ids, tc peaks, hbm peaks) of each cycle
    of the window) of the chips ``keys``: -1 where none of the window's
    cycles holds a chip's id with a valid sample."""
    keys = np.asarray(keys, dtype=np.int64)
    peak_tc = np.full(len(keys), -1, dtype=np.int8)
    peak_hbm = np.full(len(keys), -1, dtype=np.int8)
    for ids, tc, hbm in window:
        if not len(ids):
            continue
        order = np.argsort(ids, kind="stable")
        at = np.minimum(np.searchsorted(ids[order], keys), len(ids) - 1)
        hit = ids[order][at] == keys
        src = order[at]
        peak_tc = np.where(hit, np.maximum(peak_tc, tc[src]), peak_tc)
        peak_hbm = np.where(hit, np.maximum(peak_hbm, hbm[src]), peak_hbm)
    return peak_tc, peak_hbm


def verdicts(window, keys, age, slice_id, num_slices: int, lookback: float, threshold: float,
             precision: str = "int8"):
    """(bool[S] slice verdicts, bool[C] candidates) of the chips ``keys`` of
    the window's last cycle, with their ages and group ids."""
    peak_tc, peak_hbm = window_peaks(window, keys)
    candidate = fleet.candidates_q(peak_tc, peak_hbm, age, lookback,
                                   fleet.cutoff_q(threshold, precision))
    return fleet.slice_verdicts(candidate, slice_id, num_slices), candidate
