"""A grid of fleet policies, policy by policy, in plain PyTorch on the CPU.

Each policy (duration, threshold) under one grace judges the newest
duration / step samples of each chip: a candidate has a valid sample, a
valid tensorcore peak <= 0 and a valid HBM peak under the cutoff (a
threshold <= 0 disables it), and a pod at least duration + grace old;
values below the smallest normal f32 read as 0, and a NaN peak is not idle
and rescues nothing. A group is reclaimable under the policy iff it has
chips and every one is a candidate. Policy p = d * H + h is bit p of the
int64 masks; ``counts[p]`` holds the reclaimable groups and their chips.

For each duration the window is cut from the samples block by block and
its masked peaks taken; the peaks serve that duration's thresholds and
nothing else. Precisions: ``f32`` and its control ``bf16`` (samples, ages
and params rounded to bfloat16 first). Float32 throughout, TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLT_MIN = 1.1754944e-38


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision}")


def _flush(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def window_peaks(blocks, n: int, precision: str):
    """(tc peak, HBM peak, has data) [C] over the newest ``n`` samples of
    the (tc, hbm, valid) blocks of consecutive rows; -1 where no sample."""
    tcs, hbms, has = [], [], []
    for tc, hbm, valid in blocks:
        v = torch.from_numpy(np.ascontiguousarray(valid[:, -n:]))
        for x, out in ((tc, tcs), (hbm, hbms)):
            x = _flush(_round(torch.from_numpy(np.ascontiguousarray(x[:, -n:])), precision))
            out.append(torch.where(v, x, -1.0).amax(dim=1))
        has.append(v.any(dim=1))
    return torch.cat(tcs), torch.cat(hbms), torch.cat(has)


def sweep(blocks, age, slice_id, num_slices: int, durations_s, thresholds, grace_s: float,
          step_s: float, precision: str = "f32"):
    """(slice masks int64[S], chip masks int64[C], counts int64[P, 2]) of
    f32 samples given as (tc, hbm, valid) numpy blocks of consecutive rows,
    ages [C] and group ids [C] in any order."""
    age = _flush(_round(torch.from_numpy(np.asarray(age, dtype=np.float32)), precision))
    sid = torch.from_numpy(np.asarray(slice_id)).long()
    S, H = num_slices, len(thresholds)
    keep = (sid >= 0) & (sid < S)
    chips = torch.bincount(sid[keep], minlength=S)
    chip_masks = torch.zeros(len(age), dtype=torch.int64)
    slice_masks = torch.zeros(S, dtype=torch.int64)
    counts = torch.zeros((len(durations_s) * H, 2), dtype=torch.int64)
    for d, duration in enumerate(durations_s):
        n = round(duration / step_s)
        peak_tc, peak_hbm, has = window_peaks(blocks, n, precision)
        if len(peak_tc) != len(age):
            raise ValueError(f"the blocks hold {len(peak_tc)} rows, the ages {len(age)}")
        look = _flush(_round(torch.tensor(duration + grace_s, dtype=torch.float32), precision))
        for h, threshold in enumerate(thresholds):
            cut = torch.tensor(threshold if threshold > 0 else float("inf"), dtype=torch.float32)
            cut = _flush(_round(cut, precision))
            candidate = has & (peak_tc <= 0) & ~(peak_hbm >= cut) & (age >= look)
            idle = torch.bincount(sid[keep], weights=candidate[keep].double(), minlength=S)
            ok = (chips > 0) & (idle.long() == chips)
            p = d * H + h
            chip_masks |= candidate.long() << p
            slice_masks |= ok.long() << p
            counts[p, 0], counts[p, 1] = ok.sum(), chips[ok].sum()
    return slice_masks, chip_masks, counts
