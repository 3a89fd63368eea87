"""The per-chip idle-candidate pass: CUDA kernels and their plain versions.

Counterpart of tpu_pruner/policy/pallas_engine.py. The fleet evaluation's
hot op reads every byte of the ``[chips, samples]`` tensors once and reduces
each row to one verdict: a bandwidth-bound pass with no tensor-core work.

- ``chip_pass`` (f32 samples + bool mask) launches ``tp_chip_pass`` from
  ``csrc/chip_pass.cu``, which replaces ``_chip_kernel``, in one of two
  designs that ``_choose_plan_f32`` picks: the group design
  (``tp_chip_pass_groups``) for short rows, such as an audit dump's, and
  the long-row design (``tp_chip_pass_long``) for the rest; the first
  port's warp design runs only where a caller forces its plan, as the
  timing control;
- ``chip_pass_q`` (int8 samples, -1 = invalid) launches ``tp_chip_pass_q``,
  which replaces ``_chip_kernel_q``, in one of two designs that
  ``_choose_plan_q`` picks: the row design (``tp_chip_pass_q_rows``) for
  short rows, such as the streaming window's, and the tile design for the
  rest;
- ``slice_gate`` (chip verdicts + contiguous slice bounds) launches
  ``tp_slice_gate``, which has no Pallas counterpart: it is the cumsum slice
  reduction that the reference leaves to XLA inside its jitted
  ``evaluate_fleet_c`` and ``_qc``. It splits the work per slice, inside
  the kernel: a thread reads a short slice alone, and a block reads the
  long slices of its threads together;
- ``slice_scatter`` (chip verdicts + slice ids in any order) launches
  ``tp_slice_scatter``, which has no Pallas counterpart either: it is the
  reference's ``segment_sum`` reduction of ``evaluate_fleet`` and ``_q``,
  with two idempotent marks a slice in place of two counts.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version beside it. The plain versions apply the
same numeric rules as the kernels, which are the reference's XLA rules:
subnormals read as zero, NaN propagates into a row's peak, and an ``+inf``
cutoff rescues only an ``+inf`` HBM sample.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels; ``DESIGN_LAUNCHES`` counts the int8
pass's launches per design and ``F32_DESIGN_LAUNCHES`` the f32 pass's;
``reset_launches`` zeroes all three.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build

_FLT_MIN = 1.1754944e-38  # smallest normal f32; XLA flushes below it

LAUNCHES = {"chip_pass": 0, "chip_pass_q": 0, "slice_gate": 0, "slice_scatter": 0}
DESIGN_LAUNCHES = {"rows": 0, "tiles": 0}  # chip_pass_q's launches, by design
F32_DESIGN_LAUNCHES = {"groups": 0, "long": 0, "warps": 0}  # chip_pass's, by design


def reset_launches() -> None:
    for counts in (LAUNCHES, DESIGN_LAUNCHES, F32_DESIGN_LAUNCHES):
        for name in counts:
            counts[name] = 0


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Subnormal values read as 0, as XLA on the CPU and the TPU treat them."""
    return torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)


def _check(specs: dict) -> torch.device:
    """Validate {name: (tensor, dtype, shape)}; return the common device."""
    device = next(iter(specs.values()))[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, (t, dtype, shape) in specs.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return device


def _rows(samples: torch.Tensor) -> tuple[int, int]:
    if samples.dim() != 2 or samples.shape[1] == 0:
        raise ValueError("samples must be 2-D [chips, samples] with at least one "
                         f"sample per chip, got {tuple(samples.shape)}")
    return samples.shape[0], samples.shape[1]


def chip_pass_plain(tc, hbm, valid, age, params) -> torch.Tensor:
    """Plain PyTorch version of the f32 chip pass (bool[C])."""
    neg = torch.tensor(-1.0, dtype=torch.float32, device=tc.device)
    peak_tc = torch.where(valid, flush_subnormal(tc), neg).amax(dim=1)
    peak_hbm = torch.where(valid, flush_subnormal(hbm), neg).amax(dim=1)
    has_data = valid.any(dim=1)
    lookback, cutoff = flush_subnormal(params).unbind()
    idle = (peak_tc <= 0.0) & has_data            # `== 0` idle predicate
    hbm_active = peak_hbm >= cutoff               # `unless` corroboration
    eligible = flush_subnormal(age) >= lookback   # age gate
    return idle & ~hbm_active & eligible


def chip_pass(tc, hbm, valid, age, params) -> torch.Tensor:
    """Per-chip idle-candidate mask (bool[C]) over f32 samples.

    tc, hbm: f32[C, T]; valid: bool[C, T]; age: f32[C];
    params: f32[2] = [lookback_s, hbm_cutoff], the cutoff +inf when disabled.
    """
    C, T = _rows(tc)
    device = _check({"tc": (tc, torch.float32, (C, T)),
                     "hbm": (hbm, torch.float32, (C, T)),
                     "valid": (valid, torch.bool, (C, T)),
                     "age": (age, torch.float32, (C,)),
                     "params": (params, torch.float32, (2,))})
    if device.type == "cpu":
        return chip_pass_plain(tc, hbm, valid, age, params)
    if not C:
        return torch.empty(0, dtype=torch.bool, device=device)
    return _launch_f32(tc, hbm, valid, age, params, _choose_plan_f32(C, T)).view(torch.bool)


# Launch plans of tp_chip_pass. Rows of up to _F32_GROUPS_MAX_T samples take
# the group design: a power of two of lanes a row, each lane up to 4 samples
# of a row of at most 8, else up to 8; longer rows the long-row design, one
# warp a row walked in chunks of 32 * K samples. The warp design (one warp
# a row, one sample of each array in flight a lane) is only forced, as the
# timing control. Where each measured faster on the H100 is in PERF.md.
_F32_GROUPS_MAX_T = 256
_F32_GROUPS_K = frozenset({4, 8})  # samples a lane with a kernel (GroupsK)
_F32_LONG_K = frozenset({12, 16})  # samples a lane a chunk with a kernel (LongK)
_F32_WARPS_PER_BLOCK = 8  # kWarpsPerBlock in csrc/chip_pass.cu


class PlanWarps(NamedTuple):
    grid: int  # blocks of _F32_WARPS_PER_BLOCK warps, one row each


class PlanGroups(NamedTuple):
    lanes_per_row: int     # a power of two up to 32
    samples_per_lane: int  # one of _F32_GROUPS_K; lanes_per_row * this >= T
    grid: int              # blocks of _F32_WARPS_PER_BLOCK warps, 32 / lanes rows each


class PlanLong(NamedTuple):
    samples_per_lane: int  # one of _F32_LONG_K: a chunk is 32 * this samples
    grid: int              # blocks of _F32_WARPS_PER_BLOCK warps, one row each


F32_DESIGNS = {PlanWarps: "warps", PlanGroups: "groups", PlanLong: "long"}


def _plan_groups(num_chips: int, num_samples: int) -> PlanGroups:
    """Launch plan of the group design for [num_chips, num_samples] rows."""
    k = 4 if num_samples <= 8 else 8
    lanes = min(32, 1 << (_cdiv(num_samples, k) - 1).bit_length())
    return PlanGroups(lanes, k, _cdiv(num_chips, _F32_WARPS_PER_BLOCK * (32 // lanes)))


def _plan_long(num_chips: int, num_samples: int) -> PlanLong:
    """Launch plan of the long-row design for [num_chips, num_samples] rows:
    16 samples a lane where that takes the row in one chunk and 12 do not,
    else 12, which measured faster on the H100 for rows of several chunks."""
    k = 16 if 32 * 12 < num_samples <= 32 * 16 else 12
    return PlanLong(k, _cdiv(num_chips, _F32_WARPS_PER_BLOCK))


def _choose_plan_f32(num_chips: int, num_samples: int) -> PlanGroups | PlanLong:
    """The design of tp_chip_pass and its launch plan: the group design up
    to _F32_GROUPS_MAX_T samples a row, the long-row design above."""
    if num_samples <= _F32_GROUPS_MAX_T:
        return _plan_groups(num_chips, num_samples)
    return _plan_long(num_chips, num_samples)


def _f32_plans(num_chips: int, num_samples: int) -> dict:
    """{design: plan} of every design of tp_chip_pass that takes
    [num_chips, num_samples] rows: the plan's and the warp design."""
    plan = _choose_plan_f32(num_chips, num_samples)
    return {"warps": PlanWarps(_cdiv(num_chips, _F32_WARPS_PER_BLOCK)),
            F32_DESIGNS[type(plan)]: plan}


def _launch_f32(tc, hbm, valid, age, params,
                plan: PlanWarps | PlanGroups | PlanLong) -> torch.Tensor:
    """tp_chip_pass in the design of ``plan`` on CUDA tensors that chip_pass
    has checked (C > 0); returns the uint8[C] verdicts. The C entry points
    refuse a plan that does not fit the inputs."""
    C, T = tc.shape
    out = torch.empty(C, dtype=torch.uint8, device=tc.device)
    lib = _build.load()
    warps = isinstance(plan, PlanWarps)
    entry = {PlanWarps: lib.tp_chip_pass, PlanGroups: lib.tp_chip_pass_groups,
             PlanLong: lib.tp_chip_pass_long}[type(plan)]
    with torch.cuda.device(tc.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = entry(tc.data_ptr(), hbm.data_ptr(), valid.view(torch.uint8).data_ptr(),
                       age.data_ptr(), params.data_ptr(), out.data_ptr(), C, T,
                       *(() if warps else plan), stream)
    _build.check(status, entry.__name__)
    LAUNCHES["chip_pass"] += 1
    F32_DESIGN_LAUNCHES[F32_DESIGNS[type(plan)]] += 1
    return out


# Launch plan of tp_chip_pass_q. A block bulk-copies one tile of R rows of
# each sample array, in parts of at most _Q_PART_BYTES, through a ring of
# stages in shared memory, and four warps reduce it; by default each block
# has one tile, and many blocks share an SM. _Q_CARRY_ROWS and _Q_SMEM_MAX
# must agree with csrc/chip_pass.cu.
_Q_PART_BYTES = 6 * 1024
_Q_CARRY_ROWS = 16
_Q_SMEM_MAX = 48 * 1024  # dynamic shared memory a block has without opting in


class PlanQ(NamedTuple):
    rows_per_tile: int   # a multiple of 16, so every tile starts 16-byte aligned
    part_bytes: int      # bytes of each sample array per stage, a multiple of 16
    parts: int           # stages a tile takes; > 1 only for rows over 384 samples
    stages: int          # ring depth: 2 to stream a tile in parts, else 1
    lanes_per_row: int   # a power of two: the lanes that share a row's words
    smem_bytes: int      # dynamic shared memory of one block
    grid: int            # blocks: one tile each


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _q_smem(rows: int, part_bytes: int, stages: int) -> int:
    """Dynamic shared memory of a block: per stage, each sample array's part
    and the tile's ages, each with 16 bytes of slack for a misaligned base."""
    return stages * (2 * (part_bytes + 16) + 4 * rows + 16)


def _plan_q(num_chips: int, num_samples: int, sm_count: int) -> PlanQ:
    """Launch plan of the int8 kernel for a [num_chips, num_samples] fleet."""
    T = num_samples
    # as many rows as fill a part, but few enough that a small fleet still
    # gives every SM two blocks
    rows_fit = _Q_PART_BYTES // T // 16 * 16
    rows_spread = _cdiv(_cdiv(num_chips, 2 * sm_count), 16) * 16
    rows = max(_Q_CARRY_ROWS, min(rows_fit, rows_spread))
    tile_bytes = rows * T
    part = min(tile_bytes, _Q_PART_BYTES)
    parts = _cdiv(tile_bytes, part)
    stages = 1 if parts == 1 else 2
    # about 64 samples a lane: T=12 -> 1 lane a row, T=360 -> 8, T>1024 -> 32
    lanes = min(32, 1 << (_cdiv(T, 64) - 1).bit_length())
    return PlanQ(rows, part, parts, stages, lanes, _q_smem(rows, part, stages),
                 grid=_cdiv(num_chips, rows))


# Launch plan of the row design (tp_chip_pass_q_rows): each thread owns the
# fewest consecutive rows whose bytes are whole 16-byte vectors and reduces
# them from registers. csrc/chip_pass.cu has a kernel (RowsT) for each row
# length of _Q_ROWS_T: up to 64 samples, at most 5 vectors of each array a
# thread, but not 5 (16 rows of 5 vectors a thread). The plan takes it
# there, up to _Q_ROWS_MAX_BYTES an array: where it measured faster than
# the tile design on the H100.
_Q_ROWS_T = frozenset({1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64})
_Q_ROWS_MAX_BYTES = 16 * 2**20
_Q_ROWS_THREADS = 128  # a block's threads; kRowsThreads in csrc/chip_pass.cu


class PlanRows(NamedTuple):
    rows_per_thread: int  # 16 / gcd(T, 16): its rows start on a 16-byte boundary
    grid: int             # blocks, each of _Q_ROWS_THREADS * rows_per_thread rows


def _plan_q_rows(num_chips: int, num_samples: int) -> PlanRows:
    """Launch plan of the row design for a [num_chips, num_samples] fleet."""
    g = 16 // math.gcd(num_samples, 16)
    return PlanRows(g, _cdiv(_cdiv(num_chips, g), _Q_ROWS_THREADS))


def _choose_plan_q(num_chips: int, num_samples: int, sm_count: int,
                   aligned: bool) -> PlanQ | PlanRows:
    """The design of tp_chip_pass_q and its launch plan: the row design for
    the short rows of _Q_ROWS_T, at most _Q_ROWS_MAX_BYTES an array, when
    the samples and ages start on 16-byte boundaries (aligned); else the
    tile design, which also takes views off such a boundary."""
    if (aligned and num_samples in _Q_ROWS_T
            and num_chips * num_samples <= _Q_ROWS_MAX_BYTES):
        return _plan_q_rows(num_chips, num_samples)
    return _plan_q(num_chips, num_samples, sm_count)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chip_pass_q_plain(tc_q, hbm_q, age, params_q) -> torch.Tensor:
    """Plain PyTorch version of the int8 chip pass (bool[C])."""
    peak_tc = tc_q.amax(dim=1)
    peak_hbm = hbm_q.amax(dim=1)
    lookback, cutoff = flush_subnormal(params_q).unbind()
    idle = peak_tc == 0                                   # exact `== 0`
    hbm_active = peak_hbm.to(torch.float32) >= cutoff     # `unless`
    eligible = flush_subnormal(age) >= lookback           # age gate
    return idle & ~hbm_active & eligible


def chip_pass_q(tc_q, hbm_q, age, params_q) -> torch.Tensor:
    """Per-chip idle-candidate mask (bool[C]) over int8 quantized samples.

    tc_q, hbm_q: int8[C, T] with -1 for invalid samples; age: f32[C];
    params_q: f32[2] = [lookback_s, quantized cutoff] (quantize_params).
    """
    C, T = _rows(tc_q)
    device = _check({"tc_q": (tc_q, torch.int8, (C, T)),
                     "hbm_q": (hbm_q, torch.int8, (C, T)),
                     "age": (age, torch.float32, (C,)),
                     "params_q": (params_q, torch.float32, (2,))})
    if device.type == "cpu":
        return chip_pass_q_plain(tc_q, hbm_q, age, params_q)
    if not C:
        return torch.empty(0, dtype=torch.bool, device=device)
    plan = _plan_for(tc_q, hbm_q, age, _sm_count(device))
    return _launch_q(tc_q, hbm_q, age, params_q, plan).view(torch.bool)


def _plan_for(tc_q, hbm_q, age, sm_count: int) -> PlanQ | PlanRows:
    """The plan chip_pass_q launches for these tensors."""
    C, T = tc_q.shape
    aligned = all(x.data_ptr() % 16 == 0 for x in (tc_q, hbm_q, age))
    return _choose_plan_q(C, T, sm_count, aligned)


def _launch_q(tc_q, hbm_q, age, params_q, plan: PlanQ | PlanRows) -> torch.Tensor:
    """tp_chip_pass_q in the design of ``plan`` on CUDA tensors that
    chip_pass_q has checked (C > 0); returns the uint8[C] verdicts. The C
    entry point refuses a plan that does not fit the inputs."""
    C, T = tc_q.shape
    out = torch.empty(C, dtype=torch.uint8, device=tc_q.device)
    lib = _build.load()
    rows = isinstance(plan, PlanRows)
    entry = lib.tp_chip_pass_q_rows if rows else lib.tp_chip_pass_q
    with torch.cuda.device(tc_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = entry(tc_q.data_ptr(), hbm_q.data_ptr(), age.data_ptr(), params_q.data_ptr(),
                       out.data_ptr(), C, T, *plan, stream)
    _build.check(status, entry.__name__)
    LAUNCHES["chip_pass_q"] += 1
    DESIGN_LAUNCHES["rows" if rows else "tiles"] += 1
    return out


# --- the contiguous slice gate -----------------------------------------------
#
# The work split of tp_slice_gate, which the kernel decides per slice (see
# csrc/chip_pass.cu); the wrapper only launches a thread a slice. The
# constants must agree with the kernel's (a CPU test compares them).
_GATE_THREADS = 512  # kGateThreads: a block, which walks its long slices together
_GATE_LANE_GRANULES = 8  # kGateLaneGranules: the longest slice a thread reads alone
_GATE_CHIPS_PER_BLOCK = 16384  # kGateChipsPerBlock: few slices spread over C / this blocks
_GATE_WALK_GRANULES = 8  # kGateWalkGranules: a thread's granules a round of the walk
# bounds dtype -> (width and signedness of its difference); int8, int16 and
# uint8 bounds are widened to int64 for the kernel, which then wraps their
# difference at their own width
_GATE_BOUNDS = {torch.int32: (32, True), torch.int64: (32, True), torch.int8: (8, True),
                torch.int16: (16, True), torch.uint8: (8, False)}


def slice_counts_contiguous(candidate, bounds):
    """Per-slice (busy chips, chips) as int32[S] each, by cumsum + gather.

    The C + 1 prefix sums are gathered once at all S + 1 bounds, as the
    reference's gather reads them: a negative bound counts from the end,
    and the result is clamped into [0, C], so no bound is ever out of range
    (which would raise on the CPU and assert on the card). The chip counts
    are the raw bounds' differences, as in the reference, so an empty or
    inverted slice is never idle.
    """
    busy_cum = torch.cumsum(~candidate, dim=0, dtype=torch.int32)
    busy_cum = torch.cat([busy_cum.new_zeros(1), busy_cum])
    num = busy_cum.shape[0]
    at = busy_cum[bounds.long().clamp(-num, num - 1)]
    return at[1:] - at[:-1], (bounds[1:] - bounds[:-1]).to(torch.int32)


def slice_gate_plain(candidate, bounds) -> torch.Tensor:
    """Plain PyTorch version of the slice gate (bool[S]): the cumsum and
    boundary gather of slice_counts_contiguous."""
    busy, chips = slice_counts_contiguous(candidate, bounds)
    return (busy == 0) & (chips > 0)


def slice_gate(candidate, bounds) -> torch.Tensor:
    """Slice verdicts (bool[S]) of slice-contiguous chips: slice s is idle
    iff int32(bounds[s+1] - bounds[s]) > 0 and none of the chips between its
    two bounds, read as slice_gate_plain reads them, is busy.

    candidate: bool[C]; bounds: [S+1] of int32 or int64 (the main path's),
    or int8, int16 or uint8. Bool, float and other integer bounds raise
    TypeError, as the reference refuses or the plain version cannot take
    them.
    """
    if candidate.dtype != torch.bool:
        raise TypeError(f"candidate must be torch.bool, got {candidate.dtype}")
    if bounds.dtype not in _GATE_BOUNDS:
        raise TypeError(f"bounds must be int32 or int64 (or int8, int16, uint8), "
                        f"got {bounds.dtype}")
    for name, t in (("candidate", candidate), ("bounds", bounds)):
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    device = candidate.device
    if bounds.device != device:
        raise ValueError(f"bounds is on {bounds.device}, expected {device}")
    if device.type == "cpu":
        return slice_gate_plain(candidate, bounds)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    num_slices = bounds.shape[0] - 1
    if num_slices <= 0:  # a grid of no blocks is a launch error
        return torch.empty(0, dtype=torch.bool, device=device)
    return _launch_gate(candidate, bounds)


def _launch_gate(candidate, bounds) -> torch.Tensor:
    """tp_slice_gate on CUDA tensors that slice_gate has checked (S > 0);
    returns the bool[S] verdicts. A chip count of 0 still launches: its
    verdicts are the bounds' differences."""
    wrap_bits, wrap_signed = _GATE_BOUNDS[bounds.dtype]
    if bounds.dtype not in (torch.int32, torch.int64):
        bounds = bounds.to(torch.int64)  # off the main path: one more device op
    num_slices = bounds.shape[0] - 1
    out = torch.empty(num_slices, dtype=torch.bool, device=candidate.device)
    lib = _build.load()
    with torch.cuda.device(candidate.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tp_slice_gate(candidate.data_ptr(), bounds.data_ptr(), out.data_ptr(),
                                   candidate.shape[0], num_slices, bounds.element_size(),
                                   wrap_bits, int(wrap_signed), stream)
    _build.check(status, "tp_slice_gate")
    LAUNCHES["slice_gate"] += 1
    return out


# --- the scatter slice reduction ---------------------------------------------


def normalize_slice_ids(slice_id: torch.Tensor) -> torch.Tensor:
    """Slice ids as index_add_ takes them: int32 and int64 ids as they are,
    any other integer dtype widened to int64. Bool and float ids raise
    TypeError, as the reference's segment_sum refuses them."""
    if slice_id.dtype in (torch.int32, torch.int64):
        return slice_id
    if slice_id.dtype == torch.bool or slice_id.is_floating_point() or slice_id.is_complex():
        raise TypeError(f"slice ids must be integers, got {slice_id.dtype}")
    return slice_id.to(torch.int64)


def slice_counts(candidate, slice_id, num_slices: int):
    """Per-slice (busy chips, chips) as int32[S] each, by index_add_ scatter.

    A chip whose id lies outside [0, S) counts in neither, as the
    reference's segment_sum drops it: it is added into one extra segment
    that is cut off, so no id is ever out of range for index_add_ (which
    raises on the CPU and asserts on the card) and nothing syncs the host.
    Ids of any integer dtype are taken (normalize_slice_ids).
    """
    slice_id = normalize_slice_ids(slice_id)
    keep = (slice_id >= 0) & (slice_id < num_slices)
    index = torch.where(keep, slice_id, num_slices)
    busy = torch.zeros(num_slices + 1, dtype=torch.int32, device=candidate.device)
    busy.index_add_(0, index, (~candidate).to(torch.int32))
    chips = torch.zeros(num_slices + 1, dtype=torch.int32, device=candidate.device)
    chips.index_add_(0, index, torch.ones_like(index, dtype=torch.int32))
    return busy[:num_slices], chips[:num_slices]


def slice_scatter_plain(candidate, slice_id, num_slices: int) -> torch.Tensor:
    """Plain PyTorch version of the scatter reduction (bool[S]): the
    index_add_ counts of slice_counts."""
    busy, chips = slice_counts(candidate, slice_id, num_slices)
    return (busy == 0) & (chips > 0)


def slice_scatter(candidate, slice_id, num_slices: int) -> torch.Tensor:
    """Slice verdicts (bool[S]) of chips in any order: slice s is idle iff
    some chip has id s and none of those chips is busy. An id outside
    [0, S) counts nowhere, so a slice with no chip is never idle.

    candidate: bool[C]; slice_id: int32 or int64 [C] (engine.slice_verdicts
    widens other integer ids first). Bool, float and other ids raise
    TypeError.
    """
    if candidate.dtype != torch.bool:
        raise TypeError(f"candidate must be torch.bool, got {candidate.dtype}")
    if slice_id.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"slice ids must be int32 or int64, got {slice_id.dtype}")
    for name, t in (("candidate", candidate), ("slice_id", slice_id)):
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if slice_id.shape != candidate.shape:
        raise ValueError(f"slice_id must have shape {tuple(candidate.shape)}, "
                         f"got {tuple(slice_id.shape)}")
    device = candidate.device
    if slice_id.device != device:
        raise ValueError(f"slice_id is on {slice_id.device}, expected {device}")
    if num_slices < 0:
        raise ValueError(f"num_slices must be >= 0, got {num_slices}")
    if device.type == "cpu":
        return slice_scatter_plain(candidate, slice_id, num_slices)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not num_slices:  # a grid of no blocks is a launch error
        return torch.empty(0, dtype=torch.bool, device=device)
    if not candidate.shape[0]:  # no chip: no slice is idle
        return torch.zeros(num_slices, dtype=torch.bool, device=device)
    return _launch_scatter(candidate, slice_id, num_slices)


def _launch_scatter(candidate, slice_id, num_slices: int) -> torch.Tensor:
    """tp_slice_scatter on CUDA tensors that slice_scatter has checked
    (C > 0, S > 0): a memset of its marks, then its two kernels; returns
    the bool[S] verdicts."""
    marks = torch.empty(2 * num_slices, dtype=torch.uint8, device=candidate.device)
    out = torch.empty(num_slices, dtype=torch.bool, device=candidate.device)
    lib = _build.load()
    with torch.cuda.device(candidate.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tp_slice_scatter(candidate.data_ptr(), slice_id.data_ptr(),
                                      marks.data_ptr(), out.data_ptr(), candidate.shape[0],
                                      int(num_slices), slice_id.element_size(), stream)
    _build.check(status, "tp_slice_scatter")
    LAUNCHES["slice_scatter"] += 1
    return out
