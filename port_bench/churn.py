"""A cluster whose JobSets come and go, cycle by cycle, drawn from a seed.

The daemon's view of a cluster of JobSet groups (the configuration's
``groups`` table on hosts of ``chips_per_host`` chips, as
``groups.group_sizes`` reads it) over ``pool_cycles`` cycles of
``cycle_s`` seconds. Each cycle's dump holds the chips present then, in
``analyze.load_fleet``'s order: grouped by group name, by chip id within a
group. A chip's id is an int64 key, unique over the pool. What changes, in
exact counts placed at random (the mix's shares a cycle):

- ``replace_share`` (by group size): the group is replaced on its hosts by a
  JobSet of another name, new chip ids and pods of age 0;
- ``restart_share`` of the groups but the largest: the group keeps its name
  and recreates every pod (new ids, age 0); the largest group (the
  Multislice JobSet) does so every ``burst_every`` cycles, from cycle 0;
- ``dropout_share`` of the hosts start to miss their scrapes, for 1 to 3
  cycles, or ``long_dropout_cycles`` ([K, K + 2], K the window) for a
  ``long_dropout_share`` of them; they come back with their ids and their
  pods' grown ages, a ``return_blank_share`` of them with no valid sample in
  their first cycle back (the exporter restarting). A group whose hosts are
  all absent is absent;
- ``flip_share`` of the groups but the largest change state (idle, busy,
  veto), as ``gen.make_fleet``'s slices do.

The pool wraps without a jump: a group's ids, name and age change only at
its events, read around a circle of ``pool_cycles`` cycles (a group with one
event would change nothing, so such events are paired within a size and
the odd one left out), and its state's changes add up to none around it.
Groups that never change hold pods between ``stable_ages`` old, whose ages
grow by the pool's length less at the wrap without crossing the lookback.

Samples come from ``groups.samples`` over each cycle's chips, with the
groups' fixed draws (HBM modes, veto and near chips) from
``groups.make_fleet``, from ``torch.Generator``s on the run's device; the
membership from one on the host, so that a seed gives the same cycles'
chips on any device. Every draw is made in a fixed order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from port_bench import gen, groups

RESTART, REPLACE = 1, 2


@dataclass
class Cycle:
    """One cycle's dump, as host arrays."""

    keys: np.ndarray      # int64 [C]: each chip's id
    slice_id: np.ndarray  # int32 [C]: its group's rank by name this cycle (sorted)
    slices: int           # groups present
    names: np.ndarray     # int64 [slices]: each group's name, as a rank among all names
    age: np.ndarray       # f32 [C]: pod age, seconds
    tc: np.ndarray        # f32 [C, T]
    hbm: np.ndarray       # f32 [C, T]
    valid: np.ndarray     # bool [C, T]


def _spread(total: int, cycles: int, g: torch.Generator) -> np.ndarray:
    """``total`` events over ``cycles`` cycles, as even as whole counts go,
    the remainder on cycles drawn at random."""
    counts = np.full(cycles, total // cycles, dtype=np.int64)
    extra = torch.randperm(cycles, generator=g)[:total % cycles].numpy()
    counts[extra] += 1
    return counts


def _place(events: np.ndarray, members: np.ndarray, counts: np.ndarray, kind: int,
           g: torch.Generator) -> None:
    """Give ``counts[c]`` of ``members`` (group indices) an event of ``kind``
    at cycle c, each a group without an event there."""
    for c, n in enumerate(counts):
        order = members[torch.randperm(len(members), generator=g).numpy()]
        free = order[events[order, c] == 0][:n]
        events[free, c] = kind


def _pair_single_events(events: np.ndarray, sizes: np.ndarray) -> None:
    """A group with one event around the circle would change nothing: move
    each such event to another single-event group of its size (or drop it
    where that group's event is at the same cycle, or none is left)."""
    single = np.flatnonzero((events != 0).sum(axis=1) == 1)
    for size in np.unique(sizes[single]):
        alone = single[sizes[single] == size]
        for a, b in zip(alone[0::2], alone[1::2]):
            c = int(np.flatnonzero(events[a])[0])
            if events[b, c] == 0:
                events[b, c] = events[a, c]
            events[a, c] = 0
        if len(alone) % 2:
            events[alone[-1]] = 0


def _arcs(events: np.ndarray):
    """Per group, its events' cycles (padded with N) and, per cycle, the
    index of the last event at or before it around the circle (0 without
    events): (event cycles [S, E], arc [S, N], events per group [S])."""
    S, N = events.shape
    count = (events != 0).sum(axis=1)
    width = max(1, int(count.max()))
    cycles = np.full((S, width), N, dtype=np.int64)
    rows, cols = np.nonzero(events)
    rank = np.cumsum(events != 0, axis=1)[rows, cols] - 1
    cycles[rows, rank] = cols
    seen = np.cumsum(events != 0, axis=1)  # events at or before each cycle
    arc = np.where(count[:, None] > 0, (seen - 1) % np.maximum(count, 1)[:, None], 0)
    return cycles, arc, count


class Churn:
    """The pool's membership and the groups' fixed draws; ``cycle(t)`` makes
    cycle t's dump."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.dev = torch.device(device)
        self.T, self.K = config["chunk_samples"], config["window_chunks"]
        self.N, self.cycle_s = mix["pool_cycles"], config["cycle_s"]
        self.fleet = groups.make_fleet(config, mix, seed, self.dev)
        size = np.asarray(groups.group_sizes(config), dtype=np.int64)
        S, N = len(size), self.N
        cph = config.get("chips_per_host", 1)
        self.size = size
        big = int(np.argmax(size))
        g = torch.Generator()
        g.manual_seed((seed * 1_000_003 + 7) % (2**63))

        # the events: replacements by size, restarts, the largest group's burst
        events = np.zeros((S, N), dtype=np.int8)
        for chips, share in mix["replace_share"].items():
            members = np.flatnonzero(size == int(chips))
            members = members[members != big]
            total = round(share * len(members) * N)
            _place(events, members, _spread(total, N, g), REPLACE, g)
        others = np.flatnonzero(np.arange(S) != big)
        _place(events, others, _spread(round(mix["restart_share"] * len(others) * N), N, g),
               RESTART, g)
        _pair_single_events(events, size)
        events[big] = 0
        events[big, ::mix["burst_every"]] = RESTART
        self.events = events
        ev_cycles, arc, count = _arcs(events)
        self.arc, self.count = arc, count
        self.start = np.take_along_axis(ev_cycles, arc, axis=1)  # [S, N]: the arc's first cycle

        # ids: one slot a (group, arc, chip), numbered in a random order
        arcs = np.maximum(count, 1)
        self.key_base = np.concatenate([[0], np.cumsum(size * arcs)[:-1]])
        self.keys = torch.randperm(int((size * arcs).sum()), generator=g).numpy()
        # names: a new one at each replacement, kept across a restart
        name_gen = np.zeros((S, int(arcs.max())), dtype=np.int64)
        for s in np.flatnonzero((events == REPLACE).any(axis=1)):
            kinds = events[s][np.sort(np.flatnonzero(events[s]))]
            first = int(np.flatnonzero(kinds == REPLACE)[0])
            name = 0
            for step in range(count[s]):
                a = (first + step) % count[s]
                name += step > 0 and kinds[a] == REPLACE
                name_gen[s, a] = name
        names = name_gen.max(axis=1) + 1
        self.name_base = np.concatenate([[0], np.cumsum(names)[:-1]])
        self.name_gen = name_gen
        self.names = torch.randperm(int(names.sum()), generator=g).numpy()
        lo, hi = mix["stable_ages"]
        self.age0 = (lo + (hi - lo - N * self.cycle_s) * torch.rand(S, generator=g,
                                                                     dtype=torch.float64)).numpy()

        # states: flips around the circle whose changes add up to none
        flips = np.zeros((S, N), dtype=np.int64)
        per = math.floor(mix["flip_share"] * S)
        for c in range(N):
            chosen = others[torch.randperm(len(others), generator=g).numpy()[:per]]
            flips[chosen, c] = 1 + torch.randint(0, 2, (len(chosen),), generator=g).numpy()
        for s in np.flatnonzero(flips.any(axis=1)):
            last = np.flatnonzero(flips[s])[-1]
            flips[s, last] = (flips[s, last] - flips[s].sum()) % 3
        self.kinds = (self.fleet.kinds.cpu().numpy()[:, None] + np.cumsum(flips, axis=1)) % 3

        # hosts missing their scrapes
        H = int(size.sum()) // cph
        absent = np.zeros((H, N), dtype=bool)
        per = math.floor(mix["dropout_share"] * H)
        lo, hi = mix["dropout_cycles"]
        long_lo, long_hi = (self.K + d for d in mix["long_dropout_cycles"])
        for c in range(N):
            hosts = torch.randperm(H, generator=g).numpy()[:per]
            long = torch.rand(per, generator=g).numpy() < mix["long_dropout_share"]
            spans = np.where(long, torch.randint(long_lo, long_hi + 1, (per,), generator=g).numpy(),
                             torch.randint(lo, hi + 1, (per,), generator=g).numpy())
            for h, d in zip(hosts, spans):
                absent[h, (c + np.arange(d)) % N] = True
        self.absent = absent
        back = ~absent & np.roll(absent, 1, axis=1)  # the first cycle back
        self.blank = back & (torch.rand(H, N, generator=g).numpy() < mix["return_blank_share"])

        # each chip of the table: its group, place in it, and host
        self.group = np.repeat(np.arange(S), size)
        self.local = np.arange(int(size.sum())) - np.repeat(np.cumsum(size) - size, size)
        self.host = np.arange(int(size.sum())) // cph
        self.samples_g = gen.generator(seed, self.dev, 3)

    def cycle(self, t: int, mix: dict) -> Cycle:
        """Cycle t's dump (t in [0, pool_cycles)); call in order of t, as the
        samples come from one generator."""
        present = ~self.absent[self.host, t]
        grp, loc = self.group[present], self.local[present]
        arc = self.arc[grp, t]
        key = self.keys[self.key_base[grp] + arc * self.size[grp] + loc]
        name = self.names[self.name_base[grp] + self.name_gen[grp, arc]]
        order = np.lexsort((key, name))
        grp, loc, key, name = grp[order], loc[order], key[order], name[order]
        first = np.concatenate([[True], name[1:] != name[:-1]])
        slice_id = (np.cumsum(first) - 1).astype(np.int32)
        grown = self.count[grp] > 0
        age = np.where(grown, ((t - self.start[grp, t]) % self.N) * self.cycle_s,
                       self.age0[grp] + t * self.cycle_s).astype(np.float32)
        chips = torch.from_numpy(np.flatnonzero(present)[order]).to(self.dev)
        f = self.fleet
        view = groups.Fleet(len(key), len(self.size), f.slice_id, torch.from_numpy(grp).to(self.dev),
                            torch.from_numpy(loc).to(self.dev), f.size,
                            torch.from_numpy(self.kinds[:, t].astype(np.int8)).to(self.dev),
                            f.veto_chip, f.hbm_mode, f.near_chip, f.near, f.subnormal[chips],
                            torch.from_numpy(age).to(self.dev))
        tc, hbm, valid = groups.samples(view, mix, self.samples_g, self.T, 0, len(key))
        valid[torch.from_numpy(self.blank[self.host[present][order], t]).to(self.dev)] = False
        return Cycle(key.astype(np.int64), slice_id, int(first.sum()), name[first].astype(np.int64),
                     age, tc.cpu().numpy(), hbm.cpu().numpy(), valid.cpu().numpy())
