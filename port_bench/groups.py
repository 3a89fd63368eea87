"""A fleet of JobSet groups of mixed sizes, chips in host order, drawn from a seed.

The counterpart of ``gen.make_fleet`` and ``gen.samples`` for a deployment
whose groups are not equal and whose chips are not in group order. The
configuration's ``groups`` table ([count, chips] pairs) expands into
``slices`` groups in table order; a group's chips lie on hosts of
``chips_per_host`` chips each. A configuration without the table has equal
groups of ``chips // slices`` chips.

The mix's ``host_order`` is ``shuffled``: the hosts lie in a random order
across the fleet (the chips of one host stay adjacent), as node names that
carry a node-pool hash list them. Its ``group_ids`` is ``permuted``: the
groups are numbered in a random order unrelated to position.

States, HBM modes and the near-boundary samples are drawn per group as
``gen`` draws them per slice, in exact shares over groups. The largest group
(the Multislice JobSet) is always ``veto``: idle but for one sample of one
chip, on a host drawn from the seed. Ages are drawn per group from ``ages``;
then ``young_host_share`` of the hosts, an exact count, have their pods'
age redrawn in ``young_host_age``: a restarted worker. All draws come from
one ``torch.Generator`` on the run's device, in a fixed order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from port_bench.gen import BUSY, HBM_MODES, STATES, VETO, labels, near_values


@dataclass
class Fleet:
    """A fleet's fixed properties; samples are drawn from it in blocks."""

    chips: int
    slices: int
    slice_id: torch.Tensor   # int32 [C]: each chip's group id
    group: torch.Tensor      # int64 [C]: each chip's group, in table order
    local: torch.Tensor      # int64 [C]: the chip's index within its group
    size: torch.Tensor       # int64 [S]: each group's chips, in table order
    kinds: torch.Tensor      # int8 [S]: each group's state
    veto_chip: torch.Tensor  # int64 [S]: the chip of a veto group that is busy
    hbm_mode: torch.Tensor   # int64 [S]: index into HBM_MODES
    near_chip: torch.Tensor  # int64 [S]: the chip of a near group near a boundary
    near: torch.Tensor       # f32 [S]: that chip's near-boundary HBM sample
    subnormal: torch.Tensor  # bool [C]: idle chip that carries subnormal tc
    age: torch.Tensor        # f32 [C]: pod age, seconds


def group_sizes(config: dict) -> list[int]:
    """Each group's chips, in table order; raises if the table does not give
    the configuration's chips and slices in whole hosts."""
    C, S = config["chips"], config["slices"]
    cph = config.get("chips_per_host", 1)
    table = config.get("groups") or [[S, C // S]]
    sizes = [chips for count, chips in table for _ in range(count)]
    if len(sizes) != S or sum(sizes) != C:
        raise ValueError(f"groups give {sum(sizes)} chips in {len(sizes)} groups, "
                         f"not {C} in {S}")
    if any(n <= 0 or n % cph for n in sizes):
        raise ValueError(f"every group must be whole hosts of {cph} chips")
    return sizes


def _draw(g: torch.Generator, device, n: int, lo, hi) -> torch.Tensor:
    """n f64 draws, uniform in [lo, hi) (lo and hi scalars or [n] tensors)."""
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def make_fleet(config: dict, mix: dict, seed: int, device) -> Fleet:
    """The fleet of ``config`` under ``mix``."""
    if (mix["host_order"], mix["group_ids"]) != ("shuffled", "permuted"):
        raise ValueError("the layout takes host_order 'shuffled' and group_ids 'permuted'")
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    C, S = config["chips"], config["slices"]
    cph = config.get("chips_per_host", 1)
    size = torch.tensor(group_sizes(config), dtype=torch.int64, device=device)
    H = C // cph

    hosts = size // cph
    host_group = torch.repeat_interleave(torch.arange(S, device=device), hosts)
    first_host = torch.cumsum(hosts, 0) - hosts
    host_local = torch.arange(H, device=device) - first_host[host_group]
    order = torch.randperm(H, generator=g, device=device)
    ids = torch.randperm(S, generator=g, device=device)
    host = order.repeat_interleave(cph)  # the table's host of each chip
    group = host_group[host]
    local = host_local[host] * cph + torch.arange(C, device=device) % cph

    states = mix["slice_states"]
    kinds = labels([states[s] for s in STATES], S, g, device)
    big = int(torch.argmax(size))  # the first of the largest: the Multislice JobSet
    vetos = (kinds == VETO).nonzero().squeeze(1)
    swap = torch.randint(0, max(1, len(vetos)), (1,), generator=g, device=device)
    if kinds[big] != VETO and len(vetos):
        kinds[vetos[swap]] = kinds[big].clone()  # the shares stay exact counts
    kinds[big] = VETO

    veto_chip = _draw(g, device, S, 0, size).long()
    hbm = mix["idle_hbm"]
    hbm_mode = labels([hbm[m] for m in HBM_MODES], S, g, device)
    near_chip = _draw(g, device, S, 0, size).long()
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
    host_age = _draw(g, device, S, lo, hi)[host_group]
    young = torch.randperm(H, generator=g, device=device)
    young = young[:math.floor(mix["young_host_share"] * H)]
    lo, hi = mix["young_host_age"]
    host_age[young] = _draw(g, device, len(young), lo, hi)
    age = host_age.to(torch.float32)[host]
    return Fleet(C, S, ids[group].to(torch.int32), group, local, size, kinds.to(torch.int8),
                 veto_chip, hbm_mode, near_chip, near, subnormal, age)


def samples(fleet: Fleet, mix: dict, g: torch.Generator, T: int, r0: int, r1: int):
    """The samples of chips [r0, r1): (tc f32, hbm f32, valid bool), each
    [r1 - r0, T], on the fleet's device; as ``gen.samples`` draws a slice's,
    with each chip's group and place in it from the layout."""
    dev = fleet.kinds.device
    n = r1 - r0

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    chip = torch.arange(r0, r1, device=dev)
    grp = fleet.group[r0:r1]
    local = fleet.local[r0:r1]
    kind = fleet.kinds.long()[grp]
    busy = (kind == BUSY)[:, None]
    lo, hi = mix["busy_tc"]
    tc = torch.where(busy, lo + (hi - lo) * rand(n, T), 0.0)
    lo, hi = mix["busy_hbm"]
    hbm_busy = lo + (hi - lo) * rand(n, T)
    mode = fleet.hbm_mode[grp][:, None]
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
    rows = ((kind == VETO) & (local == fleet.veto_chip[grp]) & has).nonzero().squeeze(1)
    tc[rows, pos[rows]] = veto_value[rows]
    rows = ((mode[:, 0] == HBM_MODES.index("near")) & ~busy[:, 0] & has
            & (local == fleet.near_chip[grp])).nonzero().squeeze(1)
    hbm[rows, pos[rows]] = fleet.near[grp[rows]]
    return tc, hbm, valid
