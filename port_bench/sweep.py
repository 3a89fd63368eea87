"""A day of a GKE cluster's raw samples for a policy sweep, drawn from a seed.

The cluster is ``groups.make_fleet``'s: the configuration's ``groups``
table of JobSet sizes on hosts of ``chips_per_host`` chips, hosts shuffled,
group ids permuted, each group's state (idle, busy, veto; the largest group
always veto), HBM mode and veto and near chips drawn in exact shares. The
window is ``window_samples`` samples ``step_s`` apart, newest last, and a
sweep judges it under the grids of ``grids_of``: windows of the newest
duration / step_s samples, each with the age gate duration + grace. What
turns a verdict of that grid is drawn around its edges, from a generator of
its own, in a fixed order:

- an idle group was busy until it went idle ``idle_since`` samples before
  the newest, log-uniform over ``idle_since_s`` (beyond the window: idle
  throughout); a ``near_share`` of idle groups went idle within one sample
  of a window's edge;
- a veto group is idle but for one sample of one chip, at a distance from
  the newest uniform over the window, a ``near_share`` of them within one
  sample of an edge;
- each group's pods are log-uniform over ``ages_s`` old, an
  ``age_near_share`` of groups within ``age_near_s`` seconds (whole
  seconds, so some equal) of some duration + grace; then a
  ``young_host_share`` of the hosts, an exact count, were restarted, their
  age uniform in ``young_host_age``;
- the near chip of a ``near`` group has one sample at ``near_bf16_steps``
  bfloat16 spacings around some threshold of the grid, in its idle part
  and inside one of the grid's windows, drawn at random; the group's other
  idle samples lie below 0.9 times that threshold, so the near sample is
  its window's peak;
- every ``gap_every``-th chip misses ``gap_samples`` samples at random, and
  a ``stale_share`` of the chips miss their newest ``stale_samples``
  samples (no data in the short windows).

Samples are drawn in blocks of chips (``samples``), as ``groups.samples``
draws them, with tc subnormal on a ``subnormal_share`` of idle chips.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from port_bench import gen, groups
from port_bench.gen import BUSY, HBM_MODES, IDLE, VETO

# The grid of a configuration that names none: a tiny one, as the harness's
# own tests give each cell, of at least 8 samples.
TINY_GRID = {"durations_min": [1, 2, 3, 4, 5, 6, 7, 8], "step_s": 60, "grace_s": [300, 600],
             "hbm_thresholds": [0.0, 0.01, 0.02, 0.03, 0.05, 0.08, 0.1, 0.2]}


def grids_of(config: dict) -> list:
    """The configuration's grid, one ``sweep_grid`` a grace, each over every
    (duration, threshold) pair of its window."""
    import tpu_pruner_torch.policy as tp

    config = {**TINY_GRID, **config}
    return [tp.sweep_grid([60.0 * m for m in config["durations_min"]], config["hbm_thresholds"],
                          float(grace), float(config["step_s"]), config["window_samples"])
            for grace in config["grace_s"]]


@dataclass
class Fleet:
    """The cluster's fixed draws; samples are drawn from it in blocks."""

    base: groups.Fleet        # layout, states, HBM modes, veto and near chips
    idle_since: torch.Tensor  # int64 [S]: samples from the newest that are idle
    veto_at: torch.Tensor     # int64 [S]: a veto group's busy sample, from the newest
    near: torch.Tensor        # f32 [S]: the near chip's HBM sample
    near_cut: torch.Tensor    # f32 [S]: the threshold the near sample lies around
    near_window: torch.Tensor # int64 [S]: the window the near sample lies in, in samples
    stale: torch.Tensor       # int64 [C]: newest samples the chip misses
    age: torch.Tensor         # f32 [C]: pod age, seconds

    @property
    def slice_id(self) -> torch.Tensor:
        return self.base.slice_id


def bf16_step(threshold: float) -> float:
    """The spacing of bfloat16 values at ``threshold`` (7 fraction bits)."""
    return 2.0 ** (math.floor(math.log2(threshold)) - 7)


def near_values(thresholds, steps) -> tuple[np.ndarray, np.ndarray]:
    """f32 HBM samples at ``steps`` bfloat16 spacings around each enabled
    threshold (``gen.near_values`` without the int8 bucket's edge), and the
    threshold each lies around."""
    pairs = [(float(np.float32(t + k * bf16_step(t))), t)
             for t in thresholds if t > 0 for k in steps] or [(0.0, 0.0)]
    values, cuts = zip(*pairs)
    return np.array(values, dtype=np.float32), np.array(cuts, dtype=np.float32)


def _log_uniform(g, device, n: int, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)


def _near_edge(g, device, n: int, edges: torch.Tensor, offsets) -> torch.Tensor:
    """n draws of an edge plus one of ``offsets``, each at random."""
    at = edges[torch.randint(0, len(edges), (n,), generator=g, device=device)]
    off = torch.tensor(offsets, device=device)
    return at + off[torch.randint(0, len(off), (n,), generator=g, device=device)]


def make_fleet(config: dict, mix: dict, seed: int, device) -> Fleet:
    """The cluster of ``config`` under ``mix``, around the edges of its grid."""
    device = torch.device(device)
    grids = grids_of(config)
    # make_fleet's own ages and near samples are drawn and replaced below
    base = groups.make_fleet(dict(config, hbm_threshold=0.0),
                             dict(mix, ages=[[1.0, 0.0, 0.0]], young_host_share=0.0), seed,
                             device)
    g = gen.generator(seed, device, 3)
    S, C, T = base.slices, base.chips, config["window_samples"]
    step = grids[0].step_s
    edges = torch.from_numpy(grids[0].samples).to(device, torch.int64)
    kinds = base.kinds.long()

    lo, hi = mix["idle_since_s"]
    since = (_log_uniform(g, device, S, lo, hi) / step).round().long()
    near = torch.rand(S, generator=g, device=device) < mix["near_share"]
    since = torch.where(near, _near_edge(g, device, S, edges, [-1, 0, 1]), since).clamp(min=1)
    since = torch.where(kinds == IDLE, since, torch.where(kinds == BUSY, 0, T))

    veto_at = torch.randint(0, T, (S,), generator=g, device=device)
    near = torch.rand(S, generator=g, device=device) < mix["near_share"]
    veto_at = torch.where(near, _near_edge(g, device, S, edges, [-2, -1, 0, 1]),
                          veto_at).clamp(0, T - 1)

    values, cuts = near_values(grids[0].hbm_thresholds, mix["idle_hbm"]["near_bf16_steps"])
    pick = torch.randint(0, len(values), (S,), generator=g, device=device)
    near_hbm = torch.from_numpy(values).to(device)[pick]
    near_cut = torch.from_numpy(cuts).to(device)[pick]

    lo, hi = mix["ages_s"]
    age = _log_uniform(g, device, S, lo, hi)
    gates = torch.tensor([d + g_.grace_s for g_ in grids for d in g_.durations_s],
                         dtype=torch.float64, device=device)
    span = mix["age_near_s"]
    close = _near_edge(g, device, S, gates, list(range(-span, span + 1)))
    near = torch.rand(S, generator=g, device=device) < mix["age_near_share"]
    host_age = torch.where(near, close, age).clamp(min=0)
    cph = config.get("chips_per_host", 1)
    host_group = base.group[::cph]  # each host's group (a host's chips are adjacent)
    host_age = host_age[host_group]
    H = C // cph
    young = torch.randperm(H, generator=g, device=device)[:math.floor(mix["young_host_share"] * H)]
    lo, hi = mix["young_host_age"]
    host_age[young] = lo + (hi - lo) * torch.rand(len(young), generator=g, device=device,
                                                  dtype=torch.float64)
    age = host_age.to(torch.float32).repeat_interleave(cph)

    lo, hi = mix["stale_samples"]
    stale = torch.randint(lo, hi + 1, (C,), generator=g, device=device)
    stale = torch.where(torch.rand(C, generator=g, device=device) < mix["stale_share"], stale, 0)
    near_window = edges[torch.randint(0, len(edges), (S,), generator=g, device=device)]
    return Fleet(base, since, veto_at, near_hbm, near_cut, near_window, stale, age)


def samples(fleet: Fleet, mix: dict, g: torch.Generator, T: int, r0: int, r1: int):
    """The samples of chips [r0, r1): (tc f32, hbm f32, valid bool), each
    [r1 - r0, T], on the fleet's device."""
    base = fleet.base
    dev = base.kinds.device
    n = r1 - r0

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    chip = torch.arange(r0, r1, device=dev)
    grp = base.group[r0:r1]
    local = base.local[r0:r1]
    kind = base.kinds.long()[grp]
    dist = torch.arange(T - 1, -1, -1, device=dev)  # each column's distance from the newest
    busy = dist[None, :] >= fleet.idle_since[grp][:, None]
    lo, hi = mix["busy_tc"]
    tc = torch.where(busy, lo + (hi - lo) * rand(n, T), 0.0)
    lo, hi = mix["busy_hbm"]
    hbm_busy = lo + (hi - lo) * rand(n, T)
    mode = base.hbm_mode[grp][:, None]
    idle_hbm = mix["idle_hbm"]
    low = idle_hbm["low_max"] * rand(n, T)
    lo, hi = idle_hbm["high_range"]
    high = lo + (hi - lo) * rand(n, T)
    # a near group's idle samples lie below its near sample's threshold
    near_low = (0.9 / idle_hbm["low_max"]) * fleet.near_cut[grp][:, None] * low
    low = torch.where(mode == HBM_MODES.index("near"), near_low, low)
    hbm_idle = torch.where(mode == HBM_MODES.index("zero"), 0.0,
                           torch.where(mode == HBM_MODES.index("high"), high, low))
    hbm = torch.where(busy, hbm_busy, hbm_idle)

    lo, hi = mix["gap_samples"]
    missing_n = torch.randint(lo, hi + 1, (n, 1), generator=g, device=dev)
    missing = rand(n, T).argsort(dim=1).argsort(dim=1) < missing_n
    gap = (chip % mix["gap_every"] == 0)[:, None]
    valid = ~(gap & missing) & (dist[None, :] >= fleet.stale[r0:r1][:, None])

    bits = torch.randint(1, 0x00800000, (n, T), generator=g, device=dev,
                         dtype=torch.int32).view(torch.float32)
    sub = base.subnormal[r0:r1][:, None] & ~busy & (rand(n, T) < 0.5)
    tc = torch.where(sub, bits, tc)

    rows = ((kind == VETO) & (local == base.veto_chip[grp])).nonzero().squeeze(1)
    tc[rows, T - 1 - fleet.veto_at[grp[rows]]] = 0.01 + 0.59 * rand(len(rows))
    # the near sample: one valid idle sample of the near chip, at random
    # inside its window where it has one there
    idle_ok = valid & ~busy
    inside = idle_ok & (dist[None, :] < fleet.near_window[grp][:, None])
    r = rand(n, T)
    pos = torch.where(inside, 1.0 + r, torch.where(idle_ok, r, -1.0)).argmax(dim=1)
    has = idle_ok.any(dim=1)
    rows = ((mode[:, 0] == HBM_MODES.index("near")) & (kind != BUSY) & has
            & (local == base.near_chip[grp])).nonzero().squeeze(1)
    hbm[rows, pos[rows]] = fleet.near[grp[rows]]
    return tc, hbm, valid
