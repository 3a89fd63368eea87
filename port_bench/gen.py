"""The traffic generator: a fleet's utilization samples, drawn from a seed.

One generator reads every traffic mix (``traffic/<name>.json``); a mix is
data only. All draws come from one ``torch.Generator`` on the run's device,
in a fixed order and in whole tensors, so a seed fixes the inputs and every
seed does the same amount of work: the shares below are exact counts,
placed at random.

A fleet is ``chips`` chips in ``slices`` contiguous slices of equal size
(slice ids sorted, as ``load_fleet`` returns them). Each slice is in one
state per chunk of samples:

- ``idle``: every chip's tensorcore samples are 0 (some carry subnormals);
- ``busy``: every sample of every chip is busy;
- ``veto``: idle, except one chip with one nonzero sample.

``flip_share`` of the slices change state from one chunk to the next.
Chips of idle and veto slices draw their HBM samples by a mode fixed per
slice (a slice runs one workload): all zero, low, high (rescued), or low
with one chip's one sample near a boundary: the configuration's cutoff, or
the lower edge of the int8 bucket that holds it, at steps of the bfloat16
spacing there. Every ``gap_every``-th chip misses ``gap_samples`` samples
of each chunk (leading ones, where ``gap_leading``); a ``no_data_share`` of
chips has no valid sample in a chunk. Slices draw their pods' age from
``ages`` segments ([share, low, high] each).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

IDLE, BUSY, VETO = 0, 1, 2
STATES = ("idle", "busy", "veto")
HBM_MODES = ("zero", "low", "near", "high")
FLT_MIN = 1.1754944e-38  # smallest normal f32
UTIL_SCALE = 100  # the int8 window's buckets: q = ceil(util * 100), -1 = invalid


@dataclass
class Fleet:
    """A fleet's fixed properties; sample chunks are drawn from it."""

    chips: int
    slices: int
    chips_per_slice: int
    kinds: torch.Tensor      # int8 [chunks, S]: each slice's state per chunk
    veto_chip: torch.Tensor  # int64 [S]: the chip of a veto slice that is busy
    hbm_mode: torch.Tensor   # int64 [S]: index into HBM_MODES
    near_chip: torch.Tensor  # int64 [S]: the chip of a near slice near a boundary
    near: torch.Tensor       # f32 [S]: that chip's near-boundary HBM sample
    subnormal: torch.Tensor  # bool [C]: idle chip that carries subnormal tc
    age: torch.Tensor        # f32 [C]: pod age at chunk 0, seconds

    @property
    def slice_id(self) -> np.ndarray:
        return np.repeat(np.arange(self.slices, dtype=np.int32), self.chips_per_slice)


def labels(shares, n: int, g: torch.Generator, device) -> torch.Tensor:
    """n labels (int64), label k for floor(shares[k] * n) of them (the rest
    to the last), in a random order."""
    counts = [math.floor(s * n) for s in shares]
    counts[-1] = n - sum(counts[:-1])
    out = torch.repeat_interleave(torch.arange(len(counts), device=device),
                                  torch.tensor(counts, device=device))
    return out[torch.randperm(n, generator=g, device=device)]


def boundaries(threshold: float) -> list[float]:
    """The HBM values at which a verdict turns: the cutoff, and the lower
    edge of the int8 bucket that holds it."""
    if threshold <= 0:
        return []
    return [threshold, (math.ceil(threshold * UTIL_SCALE) - 1) / UTIL_SCALE]


def near_values(thresholds, steps) -> np.ndarray:
    """f32 HBM samples at ``steps`` bfloat16 spacings around each boundary."""
    values = set()
    for t in thresholds:
        for b in boundaries(t):
            ulp = 2.0 ** (math.floor(math.log2(b)) - 7)  # bf16: 7 fraction bits
            values.update(float(np.float32(b + k * ulp)) for k in steps)
    return np.array(sorted(values), dtype=np.float32)


def make_fleet(config: dict, mix: dict, seed: int, device, chunks: int = 1) -> Fleet:
    """The fleet of ``config`` under ``mix``, with slice states for
    ``chunks`` chunks."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    C, S = config["chips"], config["slices"]
    cps = C // S
    if cps * S != C:
        raise ValueError("chips must divide into slices")
    states = mix["slice_states"]
    kinds = [labels([states[s] for s in STATES], S, g, device)]
    flips = math.floor(mix["flip_share"] * S)
    for _ in range(1, chunks):
        k = kinds[-1].clone()
        moved = torch.randperm(S, generator=g, device=device)[:flips]
        k[moved] = (k[moved] + 1 + torch.randint(0, 2, (flips,), generator=g,
                                                 device=device)) % 3
        kinds.append(k)
    veto_chip = torch.randint(0, cps, (S,), generator=g, device=device)
    hbm = mix["idle_hbm"]
    hbm_mode = labels([hbm[m] for m in HBM_MODES], S, g, device)
    near_chip = torch.randint(0, cps, (S,), generator=g, device=device)
    table = torch.from_numpy(near_values([config["hbm_threshold"]],
                                        hbm["near_bf16_steps"])).to(device)
    if len(table) == 0:
        table = torch.zeros(1, device=device)
    near = table[torch.randint(0, len(table), (S,), generator=g, device=device)]
    subnormal = torch.rand(C, generator=g, device=device) < mix["subnormal_share"]
    segs = mix["ages"]
    seg = labels([s[0] for s in segs], S, g, device)
    lo = torch.tensor([s[1] for s in segs], dtype=torch.float64, device=device)[seg]
    hi = torch.tensor([s[2] for s in segs], dtype=torch.float64, device=device)[seg]
    age = lo + (hi - lo) * torch.rand(S, generator=g, device=device, dtype=torch.float64)
    age = age.to(torch.float32).repeat_interleave(cps)
    return Fleet(C, S, cps, torch.stack(kinds).to(torch.int8), veto_chip, hbm_mode,
                 near_chip, near, subnormal, age)


def samples(fleet: Fleet, mix: dict, g: torch.Generator, chunk: int, T: int,
            r0: int, r1: int):
    """Chunk ``chunk``'s samples of chips [r0, r1): (tc f32, hbm f32,
    valid bool), each [r1 - r0, T], on the fleet's device."""
    dev = fleet.kinds.device
    n = r1 - r0

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    chip = torch.arange(r0, r1, device=dev)
    sl = chip // fleet.chips_per_slice
    kind = fleet.kinds[chunk].long()[sl]
    busy = (kind == BUSY)[:, None]
    lo, hi = mix["busy_tc"]
    tc = torch.where(busy, lo + (hi - lo) * rand(n, T), 0.0)
    lo, hi = mix["busy_hbm"]
    hbm_busy = lo + (hi - lo) * rand(n, T)
    mode = fleet.hbm_mode[sl][:, None]
    idle_hbm = mix["idle_hbm"]
    low = idle_hbm["low_max"] * rand(n, T)
    lo, hi = idle_hbm["high_range"]
    high = lo + (hi - lo) * rand(n, T)
    hbm_idle = torch.where(mode == HBM_MODES.index("zero"), 0.0,
                           torch.where(mode == HBM_MODES.index("high"), high, low))
    hbm = torch.where(busy, hbm_busy, hbm_idle)

    lo, hi = mix["gap_samples"]
    missing_n = torch.randint(lo, hi + 1, (n, 1), generator=g, device=dev)
    if mix["gap_leading"]:
        missing = torch.arange(T, device=dev)[None, :] < missing_n
    else:
        missing = rand(n, T).argsort(dim=1).argsort(dim=1) < missing_n
    gap = (chip % mix["gap_every"] == 0)[:, None]
    no_data = (rand(n) < mix["no_data_share"])[:, None]
    valid = ~(gap & missing) & ~no_data

    bits = torch.randint(1, 0x00800000, (n, T), generator=g, device=dev,
                         dtype=torch.int32).view(torch.float32)
    sub = fleet.subnormal[r0:r1][:, None] & ~busy & (rand(n, T) < 0.5)
    tc = torch.where(sub, bits, tc)

    # one valid sample of each row, at random, for the veto and near samples
    pos = torch.where(valid, rand(n, T), -1.0).argmax(dim=1)
    has = valid.any(dim=1)
    veto_value = 0.01 + 0.59 * rand(n)
    rows = ((kind == VETO) & (chip % fleet.chips_per_slice == fleet.veto_chip[sl])
            & has).nonzero().squeeze(1)
    tc[rows, pos[rows]] = veto_value[rows]
    rows = ((mode[:, 0] == HBM_MODES.index("near")) & ~busy[:, 0] & has
            & (chip % fleet.chips_per_slice == fleet.near_chip[sl])).nonzero().squeeze(1)
    hbm[rows, pos[rows]] = fleet.near[sl[rows]]
    return tc, hbm, valid


def quantize(util: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int8 window samples: ceil(util * 100) after subnormals read as 0,
    clamped to [0, 127]; -1 where invalid. Utilization here is never NaN."""
    util = torch.where(util < FLT_MIN, 0.0, util)
    q = torch.ceil(util * UTIL_SCALE).clamp_(0, 127)
    return torch.where(valid, q, -1.0).to(torch.int8)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for the samples, apart from make_fleet's: ``stream``
    keeps the draws of different uses of one seed apart."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((seed * 1_000_003 + stream) % (2**63))
    return g
