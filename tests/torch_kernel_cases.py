"""Inputs and checks for the port's kernels, shared by the tests and chip_smoke.py.

The adversarial, edge and design-sweep fleets of both chip passes, the
slice gate's bounds cases and the scatter reduction's id cases, the engine
inputs that the kernel wrappers refuse, the streaming window's chunks, the
seeded fleets that chip_smoke.py times, and ``launch_counts``, the device
operations of one call as torch.profiler traces them. Everything is numpy
or PyTorch; nothing here imports JAX, so the card's tests (``--noconftest``)
and chip_smoke.py use it on a machine that has only PyTorch.

The check helpers (``int8_design_cases``, ``f32_design_cases``,
``engine_input_check``, ``q_input_check``, ``bounds_input_check``) raise
AssertionError on the first difference, as a test's assert does.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pruner_torch.policy import (
    LAUNCHES, PolicyParams, chip_pass, chip_pass_plain, chip_pass_q, chip_pass_q_plain,
    evaluate_fleet, evaluate_fleet_c, evaluate_fleet_cuda, evaluate_fleet_cuda_q,
    evaluate_fleet_cuda_qc, evaluate_fleet_q, evaluate_fleet_qc, evaluate_fleet_qu, params_array,
    WindowRows, quantize_fleet_inputs, quantize_params, slice_bounds)
from tpu_pruner_torch.policy.engine import normalize_inputs, normalize_inputs_q
from tpu_pruner_torch.policy.kernels import (
    _F32_GROUPS_MAX_T, _Q_ROWS_MAX_BYTES, _Q_ROWS_T, DESIGN_LAUNCHES, F32_DESIGN_LAUNCHES,
    F32_DESIGNS, _choose_plan_f32)

CHIPS, SAMPLES, SLICES = 131072, 360, 8192  # the main path's fleet
CPS = CHIPS // SLICES  # the example fleet is uniform: 16 chips a slice
XL_CHIPS, XL_SLICES = 1048576, 65536  # bench.py's XL point, 16 chips a slice too
WINDOW_CHUNKS, CHUNK_SAMPLES, STREAM_CYCLES = 12, 6, 14  # the daemon's window shape
DRYRUN_RANKS = 4
DRYRUN_CHIPS = CHIPS // DRYRUN_RANKS  # the dry run's rows a rank
DUMP_SAMPLES = 8  # an audit dump's series: dump.py's 2100 s window at its 300 s step


def adversarial_fleet(rng, C: int, T: int):
    """numpy fleet salted with every value the numeric rules care about."""
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-40, -1e-40, -0.5,
                         1.1754944e-38, 0.05, 1.0], dtype=np.float32)

    def samples(busy_scale):
        x = np.where(rng.uniform(size=(C, T)) < 0.5,
                     rng.uniform(0, busy_scale, size=(C, T)), 0.0).astype(np.float32)
        quiet = rng.uniform(size=C) < 0.5  # rows of zeros, so chips can be idle
        x[quiet] = 0.0
        salt = rng.uniform(size=(C, T)) < 0.03
        x[salt] = rng.choice(specials, size=int(salt.sum()))
        return x

    tc, hbm = samples(1.0), samples(0.2)
    valid = rng.uniform(size=(C, T)) < 0.9
    valid[rng.uniform(size=C) < 0.05] = False  # absent series
    age = rng.uniform(0, 4000, size=C).astype(np.float32)
    age[rng.uniform(size=C) < 0.02] = 1e-40
    return tc, hbm, valid, age


def int8_edge_fleet(rng, C: int, T: int):
    """numpy int8 fleet for the quantized kernel's edges: quiet rows of -1/0
    (idle candidates), busy rows, rows of all -1 (no data), and the int8
    extremes -128 and 127 both salted and as whole rows."""
    tc = np.where(rng.uniform(size=(C, T)) < 0.3, -1, 0).astype(np.int8)
    busy = rng.uniform(size=C) < 0.4
    tc[busy] = rng.integers(-1, 128, size=(int(busy.sum()), T))
    hbm = rng.integers(-1, 8, size=(C, T)).astype(np.int8)
    for x in (tc, hbm):
        x[rng.uniform(size=C) < 0.05] = -1
        x[rng.uniform(size=C) < 0.02] = -128
        x[rng.uniform(size=C) < 0.02] = 127
        salt = rng.uniform(size=(C, T)) < 0.01
        x[salt] = rng.choice(np.array([-128, 127], np.int8), size=int(salt.sum()))
    age = rng.uniform(0, 4000, size=C).astype(np.float32)
    return tc, hbm, age


INT8_LAYOUTS = ("contiguous", "row_offset", "byte_offset")


def int8_on(dev, x: np.ndarray, layout: str, k: int) -> torch.Tensor:
    """x on the card as a contiguous tensor or as a view whose data pointer is
    off a 16-byte boundary: x[k:] of a [C+k, T] tensor, or 3 + 8k bytes into
    a flat buffer (so two arrays get different misalignments)."""
    C, T = x.shape
    if layout == "contiguous":
        return torch.from_numpy(x).to(dev)
    if layout == "row_offset":
        big = torch.empty((C + k, T), dtype=torch.int8, device=dev)
        big[k:] = torch.from_numpy(x).to(dev)
        return big[k:]
    off = 3 + 8 * k
    flat = torch.empty(C * T + off, dtype=torch.int8, device=dev)
    view = flat[off:].view(C, T)
    view.copy_(torch.from_numpy(x).to(dev))
    return view


INT8_PARAMS = [(2100.0, 0.05), (2100.0, float("inf")), (0.0, 1e-40), (2e-40, 0.5)]

# The sweep of the int8 pass's two designs: short rows and long, on either
# side of each limit of the row design (T up to 64, at most 5 vectors of each
# array a thread, not 5: 5, 9, 36 and 60 are outside), ragged and full-width
# chip counts (32,768 the dry run's rows a rank), and bases off a 16-byte
# boundary; then the two sides of its 16 MiB limit at T = 64 (BYTES_EDGE).
SWEEP_T = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16, 20, 24, 31, 32, 33, 36, 40, 48, 60,
           64, 65)
SWEEP_C = (1, 3, 4, 5, 131, 4097, 32768, 131072)
BYTES_EDGE = ((_Q_ROWS_MAX_BYTES // 64, 64), (_Q_ROWS_MAX_BYTES // 64 + 1, 64))


def rows_taken(C: int, T: int) -> bool:
    """Whether the plan takes the row design for aligned [C, T] inputs."""
    return T in _Q_ROWS_T and C * T <= _Q_ROWS_MAX_BYTES


def sweep_layouts(C: int) -> list:
    """(tc, hbm, age) byte offsets of the sweep's views: each offset of tc
    (all 16 up to 4,097 chips, 0 and 1 above) with hbm elsewhere, then hbm
    alone and the ages alone off a 16-byte boundary."""
    offsets = range(16) if C <= 4097 else (0, 1)
    return [(k, 7 * k % 16, 0) for k in offsets] + [(0, 8, 0), (0, 0, 4)]


def int8_design_cases(dev, T: int, C: int, rng) -> dict:
    """chip_pass_q against its plain version on one (C, T) fleet in every
    layout of sweep_layouts: bit-equal verdicts, and each launch in the design
    that the plan promises (rows when rows_taken(C, T) and every base is on
    a 16-byte boundary, else tiles). Returns the launches by design."""
    tc, hbm, age = int8_edge_fleet(rng, C, T)
    src = [torch.from_numpy(x).to(dev).view(-1) for x in (tc, hbm)]
    flat = [torch.empty(C * T + 16, dtype=torch.int8, device=dev) for _ in src]
    ages = torch.from_numpy(age).to(dev)
    age_flat = torch.empty(C + 1, device=dev)
    age_flat[1:] = ages
    took = {"rows": 0, "tiles": 0}
    for i, (k_tc, k_hbm, k_age) in enumerate(sweep_layouts(C)):
        views = []
        for buf, x, k in zip(flat, src, (k_tc, k_hbm)):
            views.append(buf[k:k + C * T].view(C, T))
            views[-1].view(-1).copy_(x)
        age_v = age_flat[k_age // 4:k_age // 4 + C] if k_age else ages
        params_q = torch.from_numpy(
            quantize_params(np.array(INT8_PARAMS[i % len(INT8_PARAMS)], np.float32))).to(dev)
        want_design = "rows" if rows_taken(C, T) and not (k_tc or k_hbm or k_age) else "tiles"
        before = dict(DESIGN_LAUNCHES)
        got = chip_pass_q(*views, age_v, params_q)
        design = [d for d in DESIGN_LAUNCHES if DESIGN_LAUNCHES[d] != before[d]]
        what = f"T={T}, C={C}, offsets (tc, hbm, age) {(k_tc, k_hbm, k_age)}"
        assert design == [want_design], f"chip_pass_q took {design} for {what}"
        want = chip_pass_q_plain(*views, age_v, params_q)
        assert torch.equal(got, want), (f"chip_pass_q != plain for {what}: "
                                        f"{int((got != want).sum())} chips differ")
        took[want_design] += 1
    return took


def f32_edge_fleet(rng, C: int, T: int):
    """numpy f32 fleet for the f32 kernel's designs: adversarial_fleet's
    values (NaN, +-inf, -0.0, +-subnormals, absent series, young pods); a
    third of the rows right-aligned behind invalid padding, as
    analyze.load_fleet writes a dump's shorter series; and a tenth of the
    rows quiet but for their last sample, valid, which holds a busy, NaN,
    +-inf, -0.0, subnormal or negative value in tc or in hbm, so that a
    design that walks a row in chunks meets it in the row's last chunk."""
    tc, hbm, valid, age = adversarial_fleet(rng, C, T)
    short = rng.uniform(size=C) < 0.3
    valid[short] &= np.arange(T)[None, :] >= rng.integers(0, T + 1, size=int(short.sum()))[:, None]
    last = np.flatnonzero(rng.uniform(size=C) < 0.1)
    tc[last], hbm[last], valid[last, -1] = 0.0, 0.0, True
    in_tc = rng.uniform(size=last.size) < 0.5
    x = rng.choice(np.array([0.7, np.nan, np.inf, -np.inf, -0.0, 1e-40, -0.5, 0.05],
                            np.float32), size=last.size)
    tc[last[in_tc], -1], hbm[last[~in_tc], -1] = x[in_tc], x[~in_tc]
    return tc, hbm, valid, age


# The f32 pass's parameter sets: those of the int8 pass and a negative
# cutoff, under which an invalid sample's -1 rescues and padding must not.
F32_PARAMS = INT8_PARAMS + [(2100.0, -5.0)]
# Row lengths at which each design of the f32 pass is forced on adversarial
# rows: both sides of the group design's lane counts, and long rows.
F32_ADVERSARIAL_T = (1, 2, 7, 8, 9, 16, 32, 33, 257, 360, 384, 385, 513, 2880)
# The sweep of the f32 pass through its plan: every T up to 64, the group
# design's threshold on either side, and the long-row design's rows on either
# side of each of its limits: one chunk of 12 samples a lane (384), of 16
# (512), two chunks of 12 (768 > 720), and rows of several chunks.
F32_SWEEP_T = tuple(range(1, 65)) + (_F32_GROUPS_MAX_T, _F32_GROUPS_MAX_T + 1, 300, 359, 360,
                                     361, 383, 384, 385, 512, 513, 720, 1024, 2880)


def f32_expected_design(C: int, T: int) -> str:
    """The design that chip_pass must launch for [C, T] inputs."""
    return F32_DESIGNS[type(_choose_plan_f32(C, T))]


# (tc, hbm, valid, age) element offsets of the f32 sweep's views: on
# 16-byte boundaries, then each array at another offset.
F32_LAYOUTS = ((0, 0, 0, 0), (1, 3, 5, 0), (2, 1, 10, 1), (3, 2, 15, 3))


def f32_design_cases(dev, T: int, C: int, rng) -> dict:
    """chip_pass against its plain version on one (C, T) fleet in every
    layout of F32_LAYOUTS: bit-equal verdicts, each launch in the design
    that the plan promises, whatever the bases' alignment. Returns the
    launches by design."""
    tc, hbm, valid, age = f32_edge_fleet(rng, C, T)
    srcs = [torch.from_numpy(x).to(dev).view(-1) for x in (tc, hbm, valid, age)]
    flats = [torch.empty(x.numel() + 16, dtype=x.dtype, device=dev) for x in srcs]
    took = {d: 0 for d in F32_DESIGN_LAUNCHES}
    for i, offsets in enumerate(F32_LAYOUTS):
        views = []
        for flat, x, k in zip(flats, srcs, offsets):
            views.append(flat[k:k + x.numel()])
            views[-1].copy_(x)
        views[:3] = [v.view(C, T) for v in views[:3]]
        params = torch.tensor(F32_PARAMS[i % len(F32_PARAMS)], device=dev)
        want_design = f32_expected_design(C, T)
        before = dict(F32_DESIGN_LAUNCHES)
        got = chip_pass(*views, params)
        design = [d for d in F32_DESIGN_LAUNCHES if F32_DESIGN_LAUNCHES[d] != before[d]]
        what = f"T={T}, C={C}, offsets (tc, hbm, valid, age) {offsets}"
        assert design == [want_design], f"chip_pass took {design} for {what}"
        want = chip_pass_plain(*views, params)
        assert torch.equal(got, want), (f"chip_pass != plain for {what}: "
                                        f"{int((got != want).sum())} chips differ")
        took[want_design] += 1
    return took


# Bounds outside [0, C] on 16 chips (chips 5 and 14 busy), as
# tests/test_torch_parity.py's BOUND_CASES, and bounds whose difference
# wraps: in int32 (-2^31 to 2^31 - 1 is -1, the reverse 1, over all chips)
# and in int64 (differences of 2^32 and more; the int64 extremes).
GATE_BOUND_CASES = {
    "past the end": [0, 4, 8, 12, 20],
    "far negative": [-40, -17, -3, 0, 16],
    "out of order, past the end": [0, 4, 20, 8, 16],
    "all past the end": [0, 100, 200, 300, 400],
    "negative, descending past the start": [-1, -2, -3, -17, -18],
    "empty, inverted and one-chip slices": [3, 3, 2, 6, 7, 7, 8, 15, 16, 16],
}
GATE_WRAP_CASES = {
    "int32 wrap": (np.int32, [-2**31, 2**31 - 1, -2**31, 5, 6, 2**31 - 1, 0]),
    "int64 wrap": (np.int64, [0, 2**32 + 8, 2**33 + 9, 3, 3 + 2**32, -2**32 + 2, 7,
                              2**31 + 7, 2**32 + 1, -2**63, 2**63 - 1, 4, 2**31 + 4]),
}
GATE_OFFSETS = (0, 1, 7, 15)  # the candidate's bytes off a 16-byte boundary


MIXED = "mixed: 16-chip slices, one of 4,096, 8,960 and 65,536 chips"
MIXED_LONG = {100: 4096, 701: 8960, 1202: 65536}  # slice index -> its chips


def mixed_sizes(num_chips: int) -> np.ndarray:
    """Slice sizes of a heterogeneous fleet of num_chips chips: 16-chip
    slices, with the long ones of MIXED_LONG among them."""
    short = num_chips - sum(MIXED_LONG.values())
    assert short % 16 == 0 and short // 16 > max(MIXED_LONG), num_chips
    sizes = np.full(short // 16 + len(MIXED_LONG), 16, np.int64)
    for at, chips in MIXED_LONG.items():
        sizes[at] = chips
    return sizes


def gate_fleet(rng, sizes, busy_per_slice=3) -> tuple:
    """Candidate bytes (bool[C]) and sorted int32 bounds for slices of the
    given sizes: every other slice idle, the rest with up to busy_per_slice
    busy chips, at the slice's first chip, its last, or anywhere."""
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    cand = np.ones(int(bounds[-1]), bool)
    for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if s % 2 == 0 or hi == lo:
            continue
        where = rng.integers(0, 3)
        at = [lo] if where == 0 else [hi - 1] if where == 1 else \
            rng.integers(lo, hi, size=rng.integers(1, busy_per_slice + 1))
        cand[np.asarray(at)] = False
    return cand, bounds


def gate_cases(seed: int, large: bool = False) -> dict:
    """name -> (candidate bool[C], bounds [S+1]) as numpy: the slice gate's
    adversarial inputs. Bounds outside [0, C], out of order, empty,
    inverted and one-chip slices, in int32, int64, int8, int16 and uint8;
    differences that wrap in int32 and int64; slices of 1 chip; one slice of
    all chips, idle or with one busy chip at its first, middle or last
    chip; random fleets of uneven slices (some empty) whose busy chips sit
    at a slice's first or last chip or anywhere, also with a tenth of the
    bounds thrown outside [0, C]; S = 0 and C = 0. With large, also the
    main path's shapes, 131,072 chips in 8,192 slices, one slice of
    1,048,576 chips and the mixed fleet at 1,048,576 chips."""
    rng = np.random.default_rng(seed)
    cases = {}
    cand16 = np.ones(16, bool)
    cand16[[5, 14]] = False
    for name, b in GATE_BOUND_CASES.items():
        for dtype in (np.int32, np.int64, np.int8, np.int16, np.uint8):
            cases[f"{name}, {np.dtype(dtype).name}"] = (cand16, np.array(b).astype(dtype))
    cand40 = np.ones(40, bool)
    cand40[[0, 6, 39]] = False
    for name, (dtype, b) in GATE_WRAP_CASES.items():
        cases[name] = (cand40, np.array(b, dtype))
    for C in (1, 17, 1003):
        cand = rng.uniform(size=C) < 0.9
        cases[f"1-chip slices, C={C}"] = (cand, np.arange(C + 1, dtype=np.int32))
    for C in (1, 1003, 70001) + ((XL_CHIPS,) if large else ()):
        b = np.array([0, C], np.int32)
        cases[f"one slice of {C} chips, idle"] = (np.ones(C, bool), b)
        for where, at in (("first", 0), ("middle", C // 2), ("last", C - 1)):
            cand = np.ones(C, bool)
            cand[at] = False
            cases[f"one slice of {C} chips, busy at its {where} chip"] = (cand, b)
    sizes = (rng.integers(0, 40, size=97) * (rng.uniform(size=97) < 0.9)).astype(np.int64)
    cand, bounds = gate_fleet(rng, sizes)
    cases["97 uneven slices, some empty"] = (cand, bounds)
    thrown = bounds.copy()
    at = rng.uniform(size=thrown.size) < 0.1
    thrown[at] = rng.integers(-2 * cand.size, 2 * cand.size, size=int(at.sum()))
    cases["97 uneven slices, a tenth of the bounds thrown"] = (cand, thrown)
    cases["3 slices of 20,000-30,000 chips"] = gate_fleet(rng, [20000, 30001, 25000])
    cases[MIXED] = gate_fleet(rng, mixed_sizes(102592))
    cases["2,500 uneven slices of 0-240 chips"] = gate_fleet(rng, rng.integers(0, 241, 2500))
    cases["S = 0"] = (cand16, np.array([4], np.int32))
    cases["C = 0"] = (np.ones(0, bool), np.array([0, 0, 3, -1, 2, 2], np.int32))
    if large:
        cases[f"{CHIPS} chips in {SLICES} slices"] = gate_fleet(rng, np.full(SLICES, CPS))
        cases[f"{CHIPS} chips in 5,000 uneven slices"] = gate_fleet(
            rng, rng.multinomial(CHIPS, np.full(5000, 1 / 5000)))
        cases[f"{XL_CHIPS} chips, {MIXED}"] = gate_fleet(rng, mixed_sizes(XL_CHIPS))
    return cases


def gate_on(dev, x: np.ndarray, k: int) -> torch.Tensor:
    """bool x on the card, its data pointer k bytes past a 16-byte boundary."""
    flat = torch.empty(x.size + 32, dtype=torch.bool, device=dev)
    at = (-flat.data_ptr()) % 16 + k
    view = flat[at:at + x.size]
    view.copy_(torch.from_numpy(x).to(dev))
    return view


# The gke-65k-nodes-mixed deployment's JobSet groups ([count, chips] pairs):
# 260,000 chips on 65,000 4-chip hosts in 23,149 groups, one of 50,944; and
# the same sizes with the counts cut, as tests/test_torch_groups.py's CUT.
GKE_GROUPS = ((1, 50944), (4, 8960), (64, 256), (256, 64), (4096, 16), (18728, 4))
GKE_CUT = ((1, 50944), (1, 8960), (1, 256), (1, 64), (4, 16), (8, 4))
CHIPS_PER_HOST = 4


def with_kinds(rng, group_of_chip: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Candidate bytes (bool[C]) for chips of the given groups: half the
    groups idle, a quarter busy (every chip), a quarter idle but one chip
    anywhere in the group, the largest group always so."""
    kinds = rng.permutation(np.arange(sizes.size) % 4)  # 0, 1 idle; 2 busy; 3 one busy chip
    kinds[np.argmax(sizes)] = 3
    cand = (kinds != 2)[group_of_chip]
    order = np.argsort(group_of_chip, kind="stable")
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    veto = np.flatnonzero((kinds == 3) & (sizes > 0))
    cand[order[start[veto] + rng.integers(0, sizes[veto])]] = False
    return cand


def host_order_fleet(rng, table) -> tuple:
    """Candidate bytes (bool[C]) and int32 group ids of JobSet groups of the
    table's sizes in host order, as the eval-260k-t360-f32-groups cell lays
    them out: a host's CHIPS_PER_HOST chips adjacent, the hosts shuffled over
    the fleet, the group ids permuted; candidates as with_kinds draws them."""
    sizes = np.array([chips for count, chips in table for _ in range(count)])
    hosts = np.repeat(np.arange(sizes.size), sizes // CHIPS_PER_HOST)
    rng.shuffle(hosts)
    group_of_chip = np.repeat(hosts, CHIPS_PER_HOST)
    ids = rng.permutation(sizes.size)[group_of_chip].astype(np.int32)
    return with_kinds(rng, group_of_chip, sizes), ids


def shuffled_fleet(rng, num_chips: int, num_slices: int) -> tuple:
    """Candidate bytes and int32 ids of num_slices equal slices whose chips
    are shuffled over the fleet, chip by chip."""
    group_of_chip = rng.permutation(np.repeat(np.arange(num_slices), num_chips // num_slices))
    sizes = np.full(num_slices, num_chips // num_slices)
    return with_kinds(rng, group_of_chip, sizes), group_of_chip.astype(np.int32)


def scatter_cases(seed: int) -> dict:
    """name -> (candidate bool[C], ids [C], S) as numpy: the scatter slice
    reduction's inputs. Ids outside [0, S) in int32 and int64; int64 ids at
    and past 2^31 and 2^32 and the int64 extremes, which must count nowhere;
    empty slices; one slice of all chips, idle or with one busy chip at its
    first, middle or last chip; 1-chip slices in order and shuffled; sorted
    16-chip slices; runs of one id across warp edges; the cut gke-65k layout
    in host order; S = 0, S = 1 and C = 0. scatter_fleets has the large
    shapes."""
    rng = np.random.default_rng(seed)
    cases = {}
    cand = rng.uniform(size=1003) < 0.97
    for dtype in (np.int32, np.int64):
        name = np.dtype(dtype).name
        cases[f"ids outside [0, S), {name}"] = (cand, rng.integers(-5, 69, 1003).astype(dtype), 64)
        cases[f"empty slices, {name}"] = (cand, rng.integers(0, 40, 1003).astype(dtype), 100)
        cases[f"1-chip slices, {name}"] = (cand, np.arange(1003, dtype=dtype), 1003)
        cases[f"1-chip slices shuffled, {name}"] = (cand, rng.permutation(1003).astype(dtype),
                                                    1003)
    # busy chips whose ids, cut to 32 bits, would veto slices 0 and 3; alone,
    # idle chips whose ids would make slices 0 and 3 idle
    far = np.array([2**31, 2**31 + 3, 2**32, 2**32 + 3, -2**32 + 3, 2**63 - 1, -2**63, -1, 8])
    wide = rng.permutation(np.concatenate([far, rng.integers(0, 8, 1003 - far.size)]))
    cases["int64 ids past 2^31 and 2^32"] = (
        (wide >= 0) & (wide < 8), wide.astype(np.int64), 8)
    cases["int64 ids past 2^32 alone"] = (np.ones(far.size, bool), far.astype(np.int64), 8)
    for C in (1, 1003, 70001):
        ids = np.zeros(C, np.int32)
        cases[f"one slice of {C} chips, idle"] = (np.ones(C, bool), ids, 1)
        for where, at in (("first", 0), ("middle", C // 2), ("last", C - 1)):
            one = np.ones(C, bool)
            one[at] = False
            cases[f"one slice of {C} chips, busy at its {where} chip"] = (one, ids, 1)
    sorted16 = np.repeat(np.arange(256, dtype=np.int32), 16)
    cases["4,096 chips in 256 sorted slices"] = (
        with_kinds(rng, sorted16, np.full(256, 16)), sorted16, 256)
    runs = np.repeat(rng.permutation(300), rng.integers(1, 100, 300)).astype(np.int32)
    cases["runs of 1-99 chips across warp edges"] = (rng.uniform(size=runs.size) < 0.97,
                                                     runs, 300)
    cases["cut gke-65k layout in host order"] = (*host_order_fleet(rng, GKE_CUT),
                                                 sum(n for n, _ in GKE_CUT))
    cases["S = 0"] = (cand, rng.integers(-2, 3, 1003).astype(np.int32), 0)
    around = rng.integers(-1, 2, 1003).astype(np.int32)
    cases["S = 1"] = (around == 0, around, 1)  # idle: the busy chips' ids lie outside
    cases["C = 0"] = (np.ones(0, bool), np.zeros(0, np.int32), 5)
    return cases


def scatter_fleets(rng) -> dict:
    """name -> (candidate, int32 ids, S) as numpy: the scatter reduction's
    large shapes. The eval-260k-t360-f32-groups cell's layout; 1,048,576
    chips in 65,536 shuffled 16-chip slices; one slice of 1,048,576 chips,
    all idle but one; 1,048,576 one-chip slices, every other busy."""
    one = np.ones(XL_CHIPS, bool)
    one[XL_CHIPS // 3] = False
    return {
        f"{sum(n * c for n, c in GKE_GROUPS)} chips in {sum(n for n, _ in GKE_GROUPS)} "
        "groups, host order": (*host_order_fleet(rng, GKE_GROUPS),
                               sum(n for n, _ in GKE_GROUPS)),
        f"{XL_CHIPS} chips in {XL_SLICES} shuffled slices": (
            *shuffled_fleet(rng, XL_CHIPS, XL_SLICES), XL_SLICES),
        f"one slice of {XL_CHIPS} chips, idle but one": (one, np.zeros(XL_CHIPS, np.int32), 1),
        f"{XL_CHIPS} one-chip slices": (np.arange(XL_CHIPS) % 2 == 0,
                                        np.arange(XL_CHIPS, dtype=np.int32), XL_CHIPS),
    }


INPUT_SLICES = 64


def _strided(x: torch.Tensor) -> torch.Tensor:
    """x as every other column of a tensor twice as wide, on x's device."""
    wide = torch.zeros((x.shape[0], 2 * x.shape[1]), dtype=x.dtype, device=x.device)
    wide[:, ::2] = x
    return wide[:, ::2]


def input_cases(seed: int, C: int = 1003, T: int = 31) -> dict:
    """name -> fn(device) giving evaluate_fleet's inputs (tc, hbm, valid, age,
    slice_id, params) that the engine takes and the kernel wrappers do not:
    slice ids outside [0, S) (int32 and int64: 7-like, -1, S and -S; int8
    clipped into its range; uint8 mod 256, all still outside), bf16, f16 and
    f64 samples, an integer mask, f64 ages, and strided views. Views are
    made on the device itself, since a copy across devices is contiguous.
    The slice ids of the other cases are sorted."""
    rng = np.random.default_rng(seed)
    tc, hbm, valid, age = adversarial_fleet(rng, C, T)
    sid = np.sort(rng.integers(0, INPUT_SLICES, size=C))
    # the even slices quiet, some of their chips salted with -0.0, an f32
    # subnormal, an f16 subnormal and NaN, so that slices are idle or vetoed
    quiet = sid % 2 == 0
    tc[quiet], hbm[quiet], valid[quiet, 0], age[quiet] = 0.0, 0.0, True, 7200.0
    salt = np.flatnonzero(quiet & (rng.uniform(size=C) < 0.1))
    tc[salt, rng.integers(0, T, size=salt.size)] = rng.choice(
        np.array([-0.0, 1e-40, 6e-8, np.nan], np.float32), size=salt.size)
    # a third of the chips moved outside [0, S); the first four 7S, -1, S, -S
    bad = np.where(rng.uniform(size=C) < 1 / 3,
                   rng.choice([-1, 1], size=C) * rng.integers(INPUT_SLICES, 2 * INPUT_SLICES,
                                                               size=C), sid)
    bad[:4] = (7 * INPUT_SLICES, -1, INPUT_SLICES, -INPUT_SLICES)
    tc, hbm, valid, age = (torch.from_numpy(x) for x in (tc, hbm, valid, age))
    ids = torch.from_numpy(sid.astype(np.int32))
    params = torch.tensor([2100.0, 0.05])

    def fleet(dev, tc=tc, hbm=hbm, valid=valid, age=age, ids=ids, view=None):
        arrays = [x.to(dev) for x in (tc, hbm, valid)]
        if view is not None:
            arrays = [view(x) for x in arrays]
        return (*arrays, age.to(dev), ids.to(dev), params.to(dev))

    return {
        "slice ids outside [0, S), int32": lambda dev: fleet(
            dev, ids=torch.from_numpy(bad.astype(np.int32))),
        "slice ids outside [0, S), int64": lambda dev: fleet(dev, ids=torch.from_numpy(bad)),
        "slice ids outside [0, S), int8": lambda dev: fleet(
            dev, ids=torch.from_numpy(np.clip(bad, -128, 127).astype(np.int8))),
        "slice ids outside [0, S), uint8": lambda dev: fleet(
            dev, ids=torch.from_numpy((bad % 256).astype(np.uint8))),
        "bf16 samples": lambda dev: fleet(dev, tc=tc.bfloat16(), hbm=hbm.bfloat16()),
        "f16 samples": lambda dev: fleet(dev, tc=tc.half(), hbm=hbm.half()),
        "f64 samples and ages, uint8 mask": lambda dev: fleet(
            dev, tc=tc.double(), hbm=hbm.double(), valid=valid.to(torch.uint8),
            age=age.double()),
        "strided views": lambda dev: fleet(dev, view=_strided),
        "column-major views": lambda dev: fleet(dev, view=lambda x: x.t().contiguous().t()),
    }


def engine_input_check(dev, name: str, make) -> None:
    """One input case through the f32 and int8 engine paths on the card: one
    launch of each kernel and of the scatter reduction, the same verdicts
    and candidates as the CPU's plain versions on the same inputs, and each
    kernel equal to its plain version on the card."""
    gpu, cpu = make(dev), make("cpu")
    for kind, evaluate, evaluate_cuda in (("chip_pass", evaluate_fleet, evaluate_fleet_cuda),
                                          ("chip_pass_q", evaluate_fleet_q,
                                           evaluate_fleet_cuda_q)):
        if kind == "chip_pass":
            g_in, c_in = gpu, cpu
            g_pass = normalize_inputs(*gpu[:4], gpu[5])
            kernel, plain = chip_pass(*g_pass), chip_pass_plain(*g_pass)
        else:
            g_in, c_in = quantize_fleet_inputs(gpu), quantize_fleet_inputs(cpu)
            g_pass = normalize_inputs_q(*g_in[:3], g_in[4])
            kernel, plain = chip_pass_q(*g_pass), chip_pass_q_plain(*g_pass)
        before = dict(LAUNCHES)
        v, c = evaluate(*g_in, num_slices=INPUT_SLICES)
        vc, cc = evaluate_cuda(*g_in, num_slices=INPUT_SLICES)
        torch.cuda.synchronize()
        for counted_kind in (kind, "slice_scatter"):
            assert LAUNCHES[counted_kind] == before[counted_kind] + 2, (
                f"{name}: {counted_kind} launched "
                f"{LAUNCHES[counted_kind] - before[counted_kind]} times for two evaluations")
        want_v, want_c = evaluate(*c_in, num_slices=INPUT_SLICES)
        assert (torch.equal(v.cpu(), want_v) and torch.equal(c.cpu(), want_c)
                and torch.equal(vc, v) and torch.equal(cc, c)), \
            f"{name}: {kind} path on the card differs from the CPU's plain version"
        assert torch.equal(kernel, plain) and torch.equal(kernel, c), \
            f"{name}: {kind} differs from its plain version"
        assert 0 < int(want_v.sum()) < INPUT_SLICES, f"{name}: the {kind} verdicts are vacuous"


Q_CHIPS = 1024  # 64 slices of 16: uniform and sorted, so qc and qu apply


def q_input_cases(seed: int, T: int = 31) -> dict:
    """name -> fn(device) giving evaluate_fleet_q's inputs (tc_q, hbm_q, age,
    slice_id, params_q) with samples the int8 wrapper refuses: int16 (salted
    past int8's range), uint8 (salted over 127) and f32 (salted with NaN,
    +-inf, -0.0, +-subnormals and values at and around the cutoff of 5).
    The even slices are quiet: tc 0 or -1, hbm under the cutoff."""
    rng = np.random.default_rng(seed)
    C, S = Q_CHIPS, INPUT_SLICES
    sid = np.repeat(np.arange(S, dtype=np.int32), C // S)
    quiet = sid % 2 == 0
    tc = np.where(rng.uniform(size=(C, T)) < 0.5, rng.integers(1, 101, size=(C, T)), 0)
    tc[quiet] = np.where(rng.uniform(size=(int(quiet.sum()), T)) < 0.2, -1, 0)
    hbm = rng.integers(-1, 5, size=(C, T))
    age = np.where(rng.uniform(size=C) < 0.01, 60.0, 7200.0).astype(np.float32)

    def salted(x, values):
        x = x.astype(np.float64)
        rows = np.flatnonzero(rng.uniform(size=C) < 1 / 40)
        x[rows, rng.integers(0, T, size=rows.size)] = rng.choice(values, size=rows.size)
        return x

    samples = {
        torch.int16: (salted(tc, [300, -300, 1000, 128, -129]),
                      salted(hbm, [4, 5, 6, 300, -300])),
        torch.uint8: (salted(np.maximum(tc, 0), [200, 255, 128]),
                      salted(np.maximum(hbm, 0), [5, 6, 200, 255])),
        torch.float32: (salted(tc, [np.nan, np.inf, -np.inf, -0.0, 1e-40, -1e-40, 0.5]),
                        salted(hbm, [4.999, 5.0, 5.001, np.nan, np.inf, -np.inf, 1e-40])),
    }
    rest = (torch.from_numpy(age), torch.from_numpy(sid), torch.tensor([2100.0, 5.0]))

    def case(dtype):
        tc_q, hbm_q = (torch.from_numpy(x).to(dtype) for x in samples[dtype])
        return lambda dev: tuple(x.to(dev) for x in (tc_q, hbm_q, *rest))

    return {f"{str(dtype).split('.')[1]} q-samples": case(dtype) for dtype in samples}


def q_input_check(dev, name: str, make) -> None:
    """One q-sample case through evaluate_fleet_q, _qc, _qu and the CUDA
    entry points on the card: one launch of the int8 kernel a path, and of
    the slice gate or the scatter reduction where the path reduces, the CPU's
    verdicts and candidates, and the kernel equal to its plain version on the
    mapped samples."""
    gpu, cpu = make(dev), make("cpu")
    g_pass = normalize_inputs_q(*gpu[:3], gpu[4])
    assert g_pass[0].dtype == g_pass[1].dtype == torch.int8, f"{name}: not mapped to int8"
    kernel, plain = chip_pass_q(*g_pass), chip_pass_q_plain(*g_pass)
    assert torch.equal(kernel, plain), f"{name}: chip_pass_q differs from its plain version"

    def bounds(x):
        return slice_bounds(x[3], INPUT_SLICES, device=x[0].device)

    def q(x):
        return evaluate_fleet_q(*x, num_slices=INPUT_SLICES)

    def qc(x):
        return evaluate_fleet_qc(x[0], x[1], x[2], bounds(x), x[4])

    def qu(x):
        return evaluate_fleet_qu(x[0], x[1], x[2], x[4], Q_CHIPS // INPUT_SLICES)

    runs = {  # path: (run on the card, run on the CPU, slice_gate and slice_scatter launches)
        "evaluate_fleet_q": (q, q, 0, 1),
        "evaluate_fleet_cuda_q": (lambda x: evaluate_fleet_cuda_q(*x, num_slices=INPUT_SLICES),
                                  q, 0, 1),
        "evaluate_fleet_qc": (qc, qc, 1, 0),
        "evaluate_fleet_cuda_qc": (lambda x: evaluate_fleet_cuda_qc(
            x[0], x[1], x[2], bounds(x), x[4]), qc, 1, 0),
        "evaluate_fleet_qu": (qu, qu, 0, 0),
    }
    for path, (run, on_cpu, gates, scatters) in runs.items():
        before = dict(LAUNCHES)
        v, c = run(gpu)
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        want = {**dict.fromkeys(LAUNCHES, 0), "chip_pass_q": 1, "slice_gate": gates,
                "slice_scatter": scatters}
        assert launched == want, f"{name}: {path} launched {launched}, expected {want}"
        want_v, want_c = on_cpu(cpu)
        assert (torch.equal(v.cpu(), want_v) and torch.equal(c.cpu(), want_c)
                and torch.equal(c, kernel)), \
            f"{name}: {path} on the card differs from the CPU's plain version"
        assert 0 < int(want_v.sum()) < INPUT_SLICES, f"{name}: {path} verdicts are vacuous"


def bounds_input_check(dev, make) -> None:
    """Slice bounds outside [0, C] (past the end, far negative, a few from
    the end, and out of order) through evaluate_fleet_c, evaluate_fleet_qc
    and evaluate_fleet_cuda_qc on the card, against the CPU's: each path
    launches its pass and the slice gate once, the gate reads the bounds as
    the reference's clamping gather does, and the card asserts nothing."""
    gpu, cpu = make(dev), make("cpu")
    gq, cq = quantize_fleet_inputs(gpu), quantize_fleet_inputs(cpu)
    C = gpu[0].shape[0]
    bad = slice_bounds(cpu[4], INPUT_SLICES, device="cpu")
    bad[-1], bad[5], bad[9], bad[20], bad[30] = C + 700, -5000, -3, C + 1, bad[40]
    bad_g = bad.to(dev)
    want_qc = evaluate_fleet_qc(*cq[:3], bad, cq[4])
    runs = {
        "evaluate_fleet_c": ("chip_pass", lambda: evaluate_fleet_c(*gpu[:4], bad_g, gpu[5]),
                             evaluate_fleet_c(*cpu[:4], bad, cpu[5])),
        "evaluate_fleet_qc": ("chip_pass_q", lambda: evaluate_fleet_qc(*gq[:3], bad_g, gq[4]),
                              want_qc),
        "evaluate_fleet_cuda_qc": ("chip_pass_q", lambda: evaluate_fleet_cuda_qc(
            *gq[:3], bad_g, gq[4]), want_qc),
    }
    for path, (kind, run, (want_v, want_c)) in runs.items():
        before = dict(LAUNCHES)
        v, c = run()
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        assert launched == {**dict.fromkeys(LAUNCHES, 0), kind: 1, "slice_gate": 1}, \
            f"bad bounds: {path} launched {launched}, expected {kind} and slice_gate once"
        assert torch.equal(v.cpu(), want_v) and torch.equal(c.cpu(), want_c), \
            f"bad bounds: {path} on the card differs from the CPU's"
        assert 0 < int(want_v.sum()) < INPUT_SLICES, f"bad bounds: {path} verdicts are vacuous"


def stream_chunks(dev):
    """STREAM_CYCLES chunks of CHUNK_SAMPLES new int8 samples for the
    full-width fleet, and per cycle the slice verdicts they were built for.

    A slice's role is its id mod 4: idle throughout; busy in every cycle;
    busy only in cycle 0; busy only in cycle 1. The last two turn idle
    exactly when their busy chunk leaves the window (cycles 12 and 13), and
    the last is idle before its busy cycle too. About 10% of the samples are
    invalid (-1), never the first of a chunk, so every chip has data.
    """
    rng = np.random.default_rng(2024)
    role = np.arange(SLICES) % 4
    chip_role = np.repeat(role, CPS)
    chunks, expected = [], []
    for cycle in range(STREAM_CYCLES):
        busy = (chip_role == 1) | ((chip_role == 2) & (cycle == 0)) \
            | ((chip_role == 3) & (cycle == 1))
        invalid = rng.uniform(size=(CHIPS, CHUNK_SAMPLES)) < 0.1
        invalid[:, 0] = False
        tc = np.where(busy[:, None], rng.integers(1, 101, size=(CHIPS, CHUNK_SAMPLES)), 0)
        hbm = rng.integers(0, 40, size=(CHIPS, CHUNK_SAMPLES))
        chunks.append(tuple(torch.from_numpy(np.where(invalid, -1, x).astype(np.int8)).to(dev)
                            for x in (tc, hbm)))
        window = range(max(0, cycle - WINDOW_CHUNKS + 1), cycle + 1)
        expected.append(~((role == 1) | ((role == 2) & (0 in window))
                          | ((role == 3) & (1 in window))))
    return chunks, expected


_I64 = np.iinfo(np.int64)


def join_cases() -> dict:
    """The window's key join at its edges: name -> (WindowRows, this
    cycle's keys, cycle, K). Keys at INT64_MIN, -1 and INT64_MAX, a fleet
    all new, rows all dropped, an empty fleet and an empty window, an
    unchanged fleet, and each kind of repeated key: a chip key repeated
    that is new and one that is carried, a row key repeated among the
    last cycle's chips and the kept rows, and one among the kept rows."""
    def rows(keys, cycle, kept=(), seen=()):
        return WindowRows(np.array(keys, dtype=np.int64), cycle, np.array(kept, dtype=np.int64),
                          np.array(seen, dtype=np.int64))

    def chips(*keys):
        return np.array(keys, dtype=np.int64)

    lo, hi = int(_I64.min), int(_I64.max)
    return {
        "int64-extremes": (rows([lo, -1, hi, 5, 0], 3, [7, hi - 1, lo + 1], [1, 3, 2]),
                           chips(hi, 9, -1, lo + 1, lo, 0), 4, 3),
        "all-new": (rows([1, 2, 3], 3, [4], [2]), chips(10, 11, 12, 13), 4, 3),
        "all-dropped": (rows([1, 2, 3], 0, [4], [0]), chips(10), 5, 3),
        "empty-fleet": (rows([1, 2, 3], 3), chips(), 4, 3),
        "empty-window": (rows([], 0), chips(5, 6, 7), 1, 3),
        "unchanged": (rows([5, 6, 7], 0, [9], [0]), chips(5, 6, 7), 1, 3),
        "repeated-new-chip": (rows([1, 2, 3], 0), chips(1, 9, 9), 1, 3),
        "repeated-carried-chip": (rows([1, 2, 3], 0), chips(2, 1, 2), 1, 3),
        "repeated-row": (rows([1, 2, 3], 2, [2], [1]), chips(3, 1), 3, 3),
        "repeated-kept-row": (rows([1, 2], 2, [7, 7], [1, 1]), chips(1, 2), 3, 3),
    }


def join_fleet(rng, rows: int, kept: int, left: int, back: int, new: int, places: int,
               cycle: int = 100, K: int = WINDOW_CHUNKS):
    """A window of ``rows`` rows (the last cycle's chips, then ``kept`` rows
    of absent chips, last seen 1 to K cycles back) and this cycle's chips:
    the last cycle's in their order less ``left`` at random places, ``back``
    of the kept rows' chips back at random places, and ``new`` new keys in
    ``places`` runs at random places. The keys are distinct int64 spread
    over the whole range. Returns (WindowRows, keys, cycle, K)."""
    odd = np.uint64(0xD6E8FEB86659FD93)  # times an odd number: distinct keys stay distinct
    with np.errstate(over="ignore"):
        keys = (rng.permutation(rows + new).astype(np.uint64) * odd).view(np.int64)
    present = rows - kept
    prev, kept_keys, fresh = keys[:present], keys[present:rows], keys[rows:]
    kept_seen = cycle - rng.integers(1, K + 1, size=kept)
    stay = np.delete(prev, rng.choice(present, size=left, replace=False))
    pieces = [[k] for k in rng.choice(kept_keys, size=back, replace=False)]
    pieces += np.array_split(fresh, places)
    at = np.sort(rng.integers(0, len(stay) + 1, size=len(pieces)))
    out, start = [], 0
    for a, k in zip(at, rng.permutation(len(pieces))):
        out += [stay[start:a], pieces[k]]
        start = a
    out.append(stay[start:])
    return (WindowRows(prev, cycle - 1, kept_keys, kept_seen), np.concatenate(out), cycle, K)


def seeded_fleet(dev, C: int, T: int, S: int, cut: bool = False):
    """make_example_fleet's layout (uniform slices, the first half idle,
    busy tc in [0.2, 1), hbm in [0.1, 0.9), pods 7200 s old, default params)
    at C chips x T samples in S slices, drawn on the device with a seeded
    torch.Generator; every sample valid, or with cut every seventh chip's
    series cut to its last 1 to T - 1 samples behind invalid padding, as a
    dump's shorter series load. Returns (evaluate_fleet's inputs, expected
    verdicts)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tc = torch.rand((C, T), generator=gen, device=dev).mul_(0.8).add_(0.2)
    hbm = torch.rand((C, T), generator=gen, device=dev).mul_(0.8).add_(0.1)
    tc[:C // 2] = 0.0
    hbm[:C // 2] = 0.0
    valid = torch.ones((C, T), dtype=torch.bool, device=dev)
    if cut and T > 1:
        rows = torch.arange(3, C, 7, device=dev)
        lack = rows // 7 % (T - 1) + 1
        valid[rows] = torch.arange(T, device=dev)[None, :] >= lack[:, None]
    age = torch.full((C,), 7200.0, device=dev)
    slice_id = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(C // S)
    return (tc, hbm, valid, age, slice_id, params_array(PolicyParams(), device=dev)), \
        np.arange(S) < S // 2


def launch_counts(name: str, fn) -> dict | None:
    """The device operations (kernels, memsets, copies) that one eager call
    of fn puts on the card, by name, with each name's device time in ms
    (the trace's duration of each operation, added up), from a
    torch.profiler trace of a warm call; None, and "not measured" in the
    log, if the trace holds no device event. The trace opens with a spin
    kernel that is not counted: on the H100 a trace could lose its first
    device operation. Uses only the engine's public API, so it can count
    another commit's engine too."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # a profiler that cannot trace the card
        print(f"{name} device operations per call: not measured ({e})", flush=True)
        return None
    ops, ms = {}, {}
    for event in prof.events():
        if (event.device_type == torch.autograd.DeviceType.CUDA
                and not any(w in event.name for w in ("spin_kernel", "sleep"))):
            key = event.name[:80]
            ops[key] = ops.get(key, 0) + 1
            ms[key] = ms.get(key, 0.0) + event.time_range.elapsed_us() / 1e3
    if not ops:
        print(f"{name} device operations per call: not measured (no device event "
              "in the trace)", flush=True)
        return None
    print(f"{name} device operations per call: {sum(ops.values())} "
          f"{ {k: (n, round(ms[k], 5)) for k, n in ops.items()} } (count, traced ms); "
          f"{sum(ms.values()):.5f} ms traced in all", flush=True)
    return {"total": sum(ops.values()), "by_name": ops, "ms_by_name": ms,
            "traced_ms": sum(ms.values())}


# --- the policy sweep --------------------------------------------------------

def sweep_grid_cases(T: int) -> dict:
    """name -> (samples [D], lookbacks [D], cutoffs [H]) of grids over rows of
    T samples: one policy on the whole row; 16 and 64 policies whose windows
    end on every kind of place in the kernel's walk (a step of 32 samples and
    a chunk of 32 x 12: at an edge, one inside, one outside, one sample, the
    whole row, twice the same window); cutoffs of the fleet's special values
    (0.05 and 1.0 exactly), a subnormal one, 0.5 and +inf (disabled); age
    gates at the fleet's special ages and around 2,000 s."""
    inf = np.float32(np.inf)
    ends = sorted({1, T} | {n for n in (2, 31, 32, 33, 63, 64, 65, 383, 384, 385, 767, 1000)
                            if n < T})
    pick = [ends[round(i * (len(ends) - 1) / 7)] for i in range(8)]
    look8 = np.array([0, 1e-40, 1999, 2000, 2001, 3000, 3999.5, 4000], np.float32)
    cut8 = np.array([0.05, 1.0, 1e-40, 0.5, inf, 0.2, 0.01, 0.05], np.float32)
    return {
        "P=1": (np.array([T], np.int32), np.array([2000.0], np.float32), np.array([inf])),
        "P=16": (np.array([T, pick[3], pick[1], pick[3]], np.int32), look8[[2, 3, 4, 0]],
                 cut8[[0, 4, 3, 1]]),
        "P=64": (np.array(pick[::-1], np.int32), look8, cut8),
    }


def sweep_pass_cases(seed: int) -> dict:
    """name -> (tc, hbm, valid, age, samples, lookbacks, cutoffs) as numpy:
    adversarial_fleet's rows (NaN, infinities, signed zeros, subnormals, the
    smallest normal, exact cutoffs, absent series), with a quarter of the
    rows quiet but for their oldest samples, so that short windows find idle
    chips, under each grid of sweep_grid_cases, at row lengths around the
    kernel's steps and chunks and at the cell's 1,440."""
    rng = np.random.default_rng(seed)
    cases = {}
    for T in (1, 31, 32, 33, 385, 1440):
        tc, hbm, valid, age = adversarial_fleet(rng, 523, T)
        quiet = rng.uniform(size=523) < 0.25
        recent = np.arange(T)[None, :] >= rng.integers(0, T, 523)[:, None]
        tc[quiet[:, None] & recent] = 0.0
        hbm[quiet[:, None] & recent] = 0.0
        age[rng.uniform(size=523) < 0.1] = 2000.0
        for name, grid in sweep_grid_cases(T).items():
            cases[f"T={T}, {name}"] = (tc, hbm, valid, age, *grid)
    return cases


def sweep_scatter_cases(seed: int) -> dict:
    """name -> (masks int64 [C], ids [C], S, P) as numpy: scatter_cases'
    ids, each chip's mask its slice's random 64-bit word (bit 63 in half of
    them) with a few chips lacking a bit or two, under P = 1, 16 and 64."""
    rng = np.random.default_rng(seed)
    cases = {}
    for name, (cand, ids, S) in scatter_cases(seed).items():
        base = rng.integers(-2**63, 2**63 - 1, size=max(S, 1), dtype=np.int64, endpoint=True)
        inside = (ids >= 0) & (ids < S)
        masks = np.where(inside, base[np.where(inside, ids, 0)], rng.integers(
            -2**63, 2**63 - 1, size=ids.size, dtype=np.int64, endpoint=True))
        lack = np.left_shift(np.int64(1), rng.integers(0, 64, ids.size).astype(np.int64))
        masks = np.where(cand, masks, masks & ~lack)
        for P in (1, 16, 64):
            cases[f"{name}, P={P}"] = (masks, ids, S, P)
    return cases
