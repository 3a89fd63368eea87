"""Batched idle-verdict evaluation over fleet metric tensors, in PyTorch.

Counterpart of tpu_pruner/policy/engine.py, single device. Data model
(structure-of-arrays, one row per TPU chip):

- ``tc_util``  f32[C, T]: tensorcore utilization samples (0-1);
- ``hbm_util`` f32[C, T]: HBM memory-bandwidth utilization samples (0-1);
- ``valid``   bool[C, T]: sample validity (scrape gaps, chip attach time);
- ``pod_age_s`` f32[C]: age of the owning pod;
- ``slice_id`` i32[C]: slice membership (0..S-1).

The per-chip pass, and the contiguous slice gate or the scatter slice
reduction after it, run in the hand-written CUDA kernels of ``kernels.py``
when the tensors lie on the card, and in their plain PyTorch versions when
they lie on the CPU. The reshape slice reduction runs as plain PyTorch ops.
Functions follow the device of the tensors they are given; functions that
create tensors take ``device=`` (default ``"cuda"``) and raise when no card
is present, unless the caller asked for ``"cpu"``.

The evaluators take what the reference takes: samples of any float or
integer dtype (widened or rounded to f32 first, as JAX does with x64 off),
validity masks of any dtype (nonzero is valid), f64 or integer ages, and
strided views (``normalize_inputs``); int8-path samples of any dtype
(``normalize_inputs_q``); slice ids of any integer dtype
(``normalize_slice_ids``); and contiguous bounds outside ``[0, C]``, read
as the reference's clamping gather reads them. The kernel wrappers stay
strict.

Each entry is one span of ``obs`` (``engine.upload``, ``.quantize``,
``.update``, ``.params``, ``.bounds``, ``.evaluate``, ``.rekey``,
``.sweep``); inside
``evaluate_fleet`` and ``_q`` the scatter reduction is one more
(``engine.reduce``). Each copy between the host and a device goes through
``obs.to_device`` or ``obs.to_host``, which count its bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import hostlib, obs
from .kernels import (_FLT_MIN, JOIN_COUNTS, SWEEP_MAX_POLICIES, CardRows, chip_pass, chip_pass_q,
                      flush_subnormal, gather_runs, normalize_slice_ids, slice_gate, slice_scatter,
                      sweep_pass, sweep_scatter, window_gather, window_gather_plain, window_join)
# the sharded paths' per-rank counts
from .kernels import slice_counts, slice_counts_contiguous  # noqa: F401


def resolve_device(device) -> torch.device:
    """The device to create tensors on; raises if it is CUDA and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@dataclass(frozen=True)
class PolicyParams:
    """Mirror of the daemon's eligibility semantics.

    lookback_s: duration*60 + grace_period.
    hbm_threshold: the `unless` corroboration threshold; <= 0 disables it.
    """

    lookback_s: float = 30 * 60 + 300
    hbm_threshold: float = 0.0

    def hbm_cutoff(self) -> float:
        # Disabled threshold -> +inf so no finite HBM peak ever rescues a chip.
        return self.hbm_threshold if self.hbm_threshold > 0 else float("inf")


def params_array(params: PolicyParams, device="cuda") -> torch.Tensor:
    """f32[2] = [lookback_s, hbm_cutoff] on ``device``."""
    return obs.to_device(torch.tensor([params.lookback_s, params.hbm_cutoff()],
                                      dtype=torch.float32), resolve_device(device))


def _param_pair(lookback_s, hbm_cutoff, like: torch.Tensor) -> torch.Tensor:
    if isinstance(lookback_s, torch.Tensor) and isinstance(hbm_cutoff, torch.Tensor):
        return torch.stack([lookback_s, hbm_cutoff]).to(torch.float32)
    return obs.to_device(torch.tensor([float(lookback_s), float(hbm_cutoff)],
                                      dtype=torch.float32), like.device)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def normalize_inputs(tc_util, hbm_util, valid, pod_age_s, params_arr):
    """The f32 chip pass's inputs in the dtypes and layout its kernel takes.

    Samples, ages and params become contiguous f32: exact for bf16 and f16,
    round-to-nearest for f64, so subnormals are judged after the cast, as in
    the reference. A mask that is not bool reads nonzero as valid. Inputs
    that already conform are returned as they are, with no device work.
    """
    return (*normalize_samples(tc_util, hbm_util, valid, pod_age_s), _f32(params_arr))


def normalize_samples(tc_util, hbm_util, valid, pod_age_s):
    """``normalize_inputs`` without the params: (tc, hbm, valid, age), the
    inputs that every f32 evaluator shares."""
    if valid.dtype != torch.bool:
        valid = valid != 0
    return _f32(tc_util), _f32(hbm_util), valid.contiguous(), _f32(pod_age_s)


def _sign_q(x: torch.Tensor) -> torch.Tensor:
    """int8 samples whose row maximum has the sign of x's (NaN counts as
    positive): all that the int8 pass's ``peak == 0`` reads of tc.

    A float is read as the reference reads it, cast to f32 and then flushed,
    so an f16 subnormal is positive and a bf16 one zero; NaN propagates into
    the reference's peak, which is then not 0.
    """
    if x.is_floating_point():
        x = flush_subnormal(x.to(torch.float32))
        return ((x > 0) | x.isnan()).to(torch.int8) - (x < 0).to(torch.int8)
    if x.dtype == torch.bool or not x.is_signed():
        return (x != 0).to(torch.int8)
    return x.clamp(-1, 1).to(torch.int8)


def _at_least_q(x: torch.Tensor, cutoff: torch.Tensor) -> torch.Tensor:
    """int8 0/1 samples, 1 where the reference's ``peak >= cutoff`` would
    hold for x alone: the f32 value of x (flushed, for floats) against the
    flushed cutoff. A row with a NaN is all 0, since its peak is NaN."""
    if not x.is_floating_point():
        return (x.to(torch.float32) >= cutoff).to(torch.int8)
    x = flush_subnormal(x.to(torch.float32))
    return ((x >= cutoff) & ~x.isnan().any(dim=-1, keepdim=True)).to(torch.int8)


def normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q):
    """normalize_inputs for the int8 pass: (tc_q, hbm_q, age, params_q).

    int8 samples stay as they are. Samples of any other dtype, which the
    reference takes as they come (its max runs in their own dtype), are
    mapped to int8 so that both of its predicates stay exact: tc to the
    sign of each sample (``peak == 0`` needs no more), hbm to 1 where the
    sample alone meets the cutoff and 0 elsewhere, with the returned
    params' cutoff then 1.0. Integers are read without the wrap that JAX's
    x64-off narrowing gives int64, as ``normalize_inputs`` reads them.
    """
    params_arr_q = _f32(params_arr_q)
    if tc_q.dtype != torch.int8:
        tc_q = _sign_q(tc_q)
    if hbm_q.dtype != torch.int8:
        hbm_q = _at_least_q(hbm_q, flush_subnormal(params_arr_q[1]))
        params_arr_q = torch.stack([params_arr_q[0], params_arr_q.new_ones(())])
    return tc_q.contiguous(), hbm_q.contiguous(), _f32(pod_age_s), params_arr_q


@obs.spanned("engine.evaluate")
def evaluate_chips(tc_util, hbm_util, valid, pod_age_s, lookback_s, hbm_cutoff):
    """Per-chip idle-candidate mask (bool[C]).

    A chip is a candidate iff it has at least one valid sample, its peak
    utilization over the window is zero, its peak HBM bandwidth stays below
    the cutoff, and its pod cleared the age gate.
    """
    return chip_pass(*normalize_inputs(tc_util, hbm_util, valid, pod_age_s,
                                       _param_pair(lookback_s, hbm_cutoff, tc_util)))


def slice_verdicts(candidate, slice_id, num_slices: int):
    """Reduce chip candidacy to per-slice all-idle verdicts (bool[S]).

    One busy chip anywhere in the slice vetoes it; a slice id with no chips
    is never idle, and an id outside [0, S) counts nowhere. On the card one
    launch of the scatter kernel (kernels.slice_scatter), on the CPU its
    plain version, the index_add_ counts of slice_counts. Ids of any integer
    dtype are taken (normalize_slice_ids).
    """
    return slice_scatter(candidate.contiguous(), normalize_slice_ids(slice_id).contiguous(),
                         num_slices)


@obs.spanned("engine.evaluate")
def evaluate_fleet(tc_util, hbm_util, valid, pod_age_s, slice_id, params_arr,
                   num_slices: int):
    """Single-device evaluation: (slice_idle bool[S], chip_candidate bool[C]).

    params_arr: f32[2] = [lookback_s, hbm_cutoff] (params_array).
    """
    candidate = chip_pass(*normalize_inputs(tc_util, hbm_util, valid, pod_age_s,
                                            params_arr))
    with obs.span("engine.reduce"):
        return slice_verdicts(candidate, slice_id, num_slices), candidate


# --- a grid of policies in one pass: the sweep --------------------------------
#
# An operator tuning the daemon asks what each of several windows (-t) and
# HBM thresholds would pause, over one dump of raw samples. The grid is the
# product of D windows and H thresholds; policy p = d * H + h is bit p of an
# int64 mask (bit 63 the sign bit), a chip's and a slice's.


@dataclass(frozen=True, eq=False)
class SweepGrid:
    """A grid of policies over windows of ``num_samples`` samples taken
    every ``step_s`` seconds (``sweep_grid``). Held on the host: the kernels
    take it by value, so a call copies nothing to the card for it."""

    durations_s: tuple[float, ...]      # D windows, in the caller's order
    hbm_thresholds: tuple[float, ...]   # H thresholds; <= 0 disables
    grace_s: float
    step_s: float
    num_samples: int
    samples: np.ndarray     # int32 [D]: the newest samples of each window
    lookback_s: np.ndarray  # f32 [D]: duration + grace, each window's age gate
    cutoffs: np.ndarray     # f32 [H]: the threshold, or +inf where disabled

    @property
    def num_policies(self) -> int:
        return len(self.durations_s) * len(self.hbm_thresholds)

    def policy(self, p: int) -> tuple[float, float]:
        """(duration_s, hbm_threshold) of policy ``p``."""
        d, h = divmod(p, len(self.hbm_thresholds))
        return self.durations_s[d], self.hbm_thresholds[h]


def sweep_grid(durations_s, hbm_thresholds, grace_s: float, step_s: float,
               num_samples: int) -> SweepGrid:
    """The grid of every (duration, threshold) pair over a window of
    ``num_samples`` samples ``step_s`` apart: policy d * H + h judges the
    newest duration_d / step_s samples, with the age gate duration_d +
    grace_s and the cutoff of hbm_thresholds[h] (PolicyParams.hbm_cutoff).

    Raises ValueError for a grid of no policy or of more than 64, a
    duration that is not a whole number of steps, and one of no step or of
    more steps than ``num_samples``.
    """
    durations = tuple(float(d) for d in durations_s)
    thresholds = tuple(float(t) for t in hbm_thresholds)
    P = len(durations) * len(thresholds)
    if not 1 <= P <= SWEEP_MAX_POLICIES:
        raise ValueError(f"a sweep takes 1 to {SWEEP_MAX_POLICIES} policies, got "
                         f"{len(durations)} durations x {len(thresholds)} thresholds = {P}")
    if not step_s > 0 or num_samples < 1:
        raise ValueError(f"a sweep needs step_s > 0 and samples, got step_s={step_s}, "
                         f"num_samples={num_samples}")
    samples = []
    for duration in durations:
        n = round(duration / step_s)
        if n * step_s != duration:
            raise ValueError(f"duration {duration:g} s is not a whole number of "
                             f"{step_s:g}-s steps")
        if not 1 <= n <= num_samples:
            raise ValueError(f"duration {duration:g} s is {n} steps; the window holds "
                             f"1 to {num_samples}")
        samples.append(n)
    lookback = np.array([d + grace_s for d in durations], dtype=np.float32)
    cutoffs = np.array([PolicyParams(hbm_threshold=t).hbm_cutoff() for t in thresholds],
                       dtype=np.float32)
    return SweepGrid(durations, thresholds, float(grace_s), float(step_s), int(num_samples),
                     np.array(samples, dtype=np.int32), lookback, cutoffs)


@obs.spanned("engine.sweep")
def evaluate_fleet_sweep(tc_util, hbm_util, valid, pod_age_s, slice_id, grid: SweepGrid,
                         num_slices: int):
    """Every policy of ``grid`` over one fleet, chips in any order, in one
    pass of the window: (slice masks int64[S], chip masks int64[C],
    counts int64[P, 2]).

    Bit p of a chip's mask is evaluate_fleet's candidate under policy p on
    the newest samples[d] samples (d, h = divmod(p, H)), with lookback_s =
    duration_d + grace_s and threshold h. Bit p of a slice's mask is set iff
    the slice has chips and each has bit p; ``counts[p]`` holds the slices
    with bit p and the chips in them. Bits from P on are 0. The inputs are
    evaluate_fleet's (normalize_samples, normalize_slice_ids), with
    ``grid.num_samples`` samples a chip. On the card one launch of
    ``kernels.sweep_pass`` and one call of ``kernels.sweep_scatter``,
    whatever P is; on the CPU their plain versions. The ``obs`` counters
    ``sweep_policies`` and ``sweep_window_passes`` count the policies judged
    and the passes over the samples (one a call).
    """
    if tc_util.dim() != 2 or tc_util.shape[1] != grid.num_samples:
        raise ValueError(f"the grid is for windows of {grid.num_samples} samples, got "
                         f"samples of shape {tuple(tc_util.shape)}")
    tc, hbm, valid, age = normalize_samples(tc_util, hbm_util, valid, pod_age_s)
    masks = sweep_pass(tc, hbm, valid, age, grid.samples, grid.lookback_s, grid.cutoffs)
    slice_masks, counts = sweep_scatter(masks, normalize_slice_ids(slice_id).contiguous(),
                                        num_slices, grid.num_policies)
    obs.count("sweep_policies", grid.num_policies)
    obs.count("sweep_window_passes")
    return slice_masks, masks, counts


# --- int8 quantized sample storage ------------------------------------------
#
# q = ceil(util * 100), invalid samples stored in-band as -1. ceil maps 0 to
# 0 and (0, inf) to >= 1, so the `== 0` idle predicate is exact, and the -1
# sentinel folds the validity mask into the same byte. A NaN sample maps to
# bucket 0 in both quantizers, as in the reference: the int8 path then reads
# it as idle where the f32 path reads it as busy.

UTIL_SCALE = 100  # 1% buckets
INVALID_Q = -1  # in-band validity sentinel; peak == -1 <=> no data


def quantize_samples(util, valid) -> np.ndarray:
    """f32 utilization + validity mask -> int8 samples (numpy, ingest-side).

    Float32 end-to-end, like quantize_params and quantize_samples_device,
    so a sample exactly at the cutoff lands in the cutoff's bucket.
    """
    util = np.asarray(util, dtype=np.float32)
    util = np.where(util < np.float32(_FLT_MIN), np.float32(0), util)
    q = np.ceil(util * np.float32(UTIL_SCALE))
    q = np.clip(np.nan_to_num(q, nan=0.0), 0, 127)
    return np.where(np.asarray(valid, dtype=bool), q, INVALID_Q).astype(np.int8)


@obs.spanned("engine.quantize")
def quantize_samples_device(util: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """quantize_samples on the tensors' device, bit-identical to the numpy one.

    NaN is mapped to 0 before the int8 cast, whose result for NaN is not
    defined on either device.
    """
    util = util.to(torch.float32)
    util = torch.where(util < _FLT_MIN, torch.zeros_like(util), util)
    q = torch.ceil(util * UTIL_SCALE)
    q = torch.nan_to_num(q, nan=0.0).clamp(0, 127)
    if valid.dtype != torch.bool:
        valid = valid != 0
    return torch.where(valid, q, torch.full_like(q, INVALID_Q)).to(torch.int8)


@obs.spanned("engine.params")
def quantize_params(params_arr) -> np.ndarray:
    """[lookback_s, hbm_cutoff] -> [lookback_s, ceil(cutoff * SCALE)].

    A disabled cutoff (+inf) stays +inf.
    """
    if isinstance(params_arr, torch.Tensor):
        params_arr = obs.to_host(params_arr).numpy()
    arr = np.asarray(params_arr, dtype=np.float32)
    return np.array([arr[0], np.ceil(arr[1] * UTIL_SCALE)], dtype=np.float32)


@obs.spanned("engine.evaluate")
def evaluate_chips_q(tc_q, hbm_q, pod_age_s, lookback_s, hbm_cutoff_q):
    """evaluate_chips over int8 quantized samples (bool[C])."""
    return chip_pass_q(*normalize_inputs_q(tc_q, hbm_q, pod_age_s,
                                           _param_pair(lookback_s, hbm_cutoff_q, tc_q)))


@obs.spanned("engine.evaluate")
def evaluate_fleet_q(tc_q, hbm_q, pod_age_s, slice_id, params_arr_q, num_slices: int):
    """evaluate_fleet over int8 quantized samples.

    params_arr_q: f32[2] = [lookback_s, quantized cutoff] (quantize_params).
    """
    candidate = chip_pass_q(*normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q))
    with obs.span("engine.reduce"):
        return slice_verdicts(candidate, slice_id, num_slices), candidate


# --- contiguous-slice (sorted) fleets: the slice gate --------------------------
#
# When chips are grouped by slice, a slice's verdict needs only the chips
# between its two bounds. The reference reads them with an inclusive cumsum
# plus one gather at the segment boundaries, jitted into one program with
# the chip pass; on the card the port runs one kernel launch for it
# (kernels.slice_gate), whose plain version is that cumsum and gather
# (kernels.slice_counts_contiguous, which the sharded qc path also uses).


_NATIVE_ID_TYPES = (np.dtype(np.int32), np.dtype(np.int64))
_INT32_LIMIT = 1 << 31


@obs.spanned("engine.bounds")
def slice_bounds(slice_id, num_slices: int, device="cuda") -> torch.Tensor:
    """Host-side segment bounds (int32[S+1]) for slice-contiguous fleets.

    Requires slice_id sorted ascending, and raises otherwise: wrong bounds
    would merge neighbour slices' verdicts. Empty slices get start == end
    and are never idle.

    int32 and int64 ids in one C-contiguous row take one native pass over
    the ids (``csrc/slice_bounds.cpp``), which checks their order and writes
    the bounds; every other input, ids the pass does not find ascending, and
    a host without the library take the plain version, whose bounds and
    errors the pass gives bit for bit. The ``obs`` counters
    ``bounds_native`` and ``bounds_fallback`` count each.
    """
    if isinstance(slice_id, torch.Tensor):
        slice_id = obs.to_host(slice_id).numpy()
    sid = np.asarray(slice_id)
    bounds = _slice_bounds_native(sid, num_slices)
    if bounds is None:
        obs.count("bounds_fallback")
        bounds = slice_bounds_plain(sid, num_slices)
    else:
        obs.count("bounds_native")
    return obs.to_device(torch.from_numpy(bounds), resolve_device(device))


def slice_bounds_plain(sid: np.ndarray, num_slices) -> np.ndarray:
    """slice_bounds' plain version, the reference's body: ``np.diff``'s
    order check and a binary search per bound."""
    if sid.size and (np.diff(sid) < 0).any():
        raise ValueError(
            "slice_id must be sorted ascending for the contiguous evaluator; "
            "sort chips by slice at ingest or use evaluate_fleet")
    return np.searchsorted(sid, np.arange(num_slices + 1)).astype(np.int32)


def _slice_bounds_native(sid: np.ndarray, num_slices) -> np.ndarray | None:
    """The native pass's bounds, or None where it does not take the input."""
    if not (sid.ndim == 1 and sid.dtype in _NATIVE_ID_TYPES and sid.flags.c_contiguous
            and sid.flags.aligned and sid.size < _INT32_LIMIT
            and isinstance(num_slices, (int, np.integer)) and 0 <= num_slices < _INT32_LIMIT):
        return None
    lib = hostlib.load()
    if lib is None:
        return None
    bounds = np.empty(int(num_slices) + 1, dtype=np.int32)
    if lib.tp_slice_bounds(sid.ctypes.data, sid.itemsize, sid.size, int(num_slices),
                           bounds.ctypes.data) != 0:
        return None
    return bounds


def slice_verdicts_contiguous(candidate, bounds):
    """slice_verdicts for slice-contiguous chips (bool[S]): on the card one
    launch of the slice gate kernel, on the CPU its plain version, the
    cumsum + boundary gather. Bounds outside [0, C] are read as the
    reference's clamping gather reads them; bool and float bounds raise
    TypeError, as the reference refuses them (kernels.slice_gate)."""
    return slice_gate(candidate.contiguous(), bounds.contiguous())


@obs.spanned("engine.evaluate")
def evaluate_fleet_c(tc_util, hbm_util, valid, pod_age_s, bounds, params_arr):
    """evaluate_fleet for slice-contiguous fleets (bounds = slice_bounds)."""
    candidate = chip_pass(*normalize_inputs(tc_util, hbm_util, valid, pod_age_s,
                                            params_arr))
    return slice_verdicts_contiguous(candidate, bounds), candidate


@obs.spanned("engine.evaluate")
def evaluate_fleet_qc(tc_q, hbm_q, pod_age_s, bounds, params_arr_q):
    """evaluate_fleet_q for slice-contiguous fleets (int8 storage + cumsum)."""
    candidate = chip_pass_q(*normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q))
    return slice_verdicts_contiguous(candidate, bounds), candidate


def assert_uniform_slices(slice_id, chips_per_slice: int) -> int:
    """Host-side precondition for evaluate_fleet_qu; returns num_slices.

    The reshape reduction cannot detect a heterogeneous or ungrouped fleet
    on its own: a wrong layout would silently merge neighbour slices'
    verdicts. Run this at ingest, where the layout is decided.
    """
    if isinstance(slice_id, torch.Tensor):
        slice_id = obs.to_host(slice_id).numpy()
    sid = np.asarray(slice_id)
    if sid.size % chips_per_slice != 0:
        raise ValueError(
            f"{sid.size} chips do not divide into slices of {chips_per_slice}")
    num_slices = sid.size // chips_per_slice
    expected = np.repeat(np.arange(num_slices, dtype=sid.dtype), chips_per_slice)
    if not np.array_equal(sid, expected):
        raise ValueError(
            "fleet is not uniform-contiguous (expected slice ids "
            f"repeat(arange({num_slices}), {chips_per_slice})); use "
            "evaluate_fleet_qc with slice_bounds instead")
    return num_slices


@obs.spanned("engine.evaluate")
def evaluate_fleet_qu(tc_q, hbm_q, pod_age_s, params_arr_q, chips_per_slice: int):
    """Uniform-fleet path: int8 storage + equal-size contiguous slices.

    The slice reduction is a reshape to [S, chips_per_slice] and an AND over
    the minor axis. The layout contract is not detectable in here: validate
    it at ingest with assert_uniform_slices.
    """
    candidate = chip_pass_q(*normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q))
    return candidate.view(-1, chips_per_slice).all(dim=1), candidate


# --- streaming sliding-window evaluation ------------------------------------
#
# Each daemon cycle brings only the samples of one check interval, so the
# window keeps a ring of K per-chunk maxima per chip (one chunk = one
# cycle's samples): a cycle reduces its new chunk, writes one ring column,
# and the verdict pass reads [C, K] chunk maxima instead of [C, T] samples.
# Eviction is the overwrite of the oldest column. An unfilled or all-invalid
# chunk has maximum -1, "no data", so partial windows and scrape gaps need
# no special case. The rings stay row-major [C, K], the layout the int8
# kernel reads, and are written one column at a time. Where the fleet
# changes from cycle to cycle, rekey_window carries the rows by chip key:
# this cycle's chips first, then rows kept for absent chips, whose column
# update_window_ writes as no data; the evaluations read the first rows.


def init_window(num_chips: int, num_chunks: int, device="cuda"):
    """Fresh streaming state (tc_ring, hbm_ring, cursor), all no-data.

    The rings are int8[C, K] of INVALID_Q; the cursor, the column the next
    chunk goes to, is a 0-d int32 tensor on the rings' device.
    """
    device = resolve_device(device)
    ring = torch.full((num_chips, num_chunks), INVALID_Q, dtype=torch.int8,
                      device=device)
    return ring, ring.clone(), torch.zeros((), dtype=torch.int32, device=device)


@obs.spanned("engine.update")
def update_window(state, tc_q_new, hbm_q_new):
    """Fold one cycle's new int8 samples ([C, T_new]) into the rings.

    Overwrites the oldest chunk (sliding-window eviction). Returns fresh
    rings and cursor and leaves ``state`` as it was, as the reference does,
    so a state kept by the caller (a what-if, a retry) stays valid; the copy
    is 2*C*K bytes. ``update_window_`` writes the rings in place instead.
    """
    tc_ring, hbm_ring, cursor = state
    return update_window_((tc_ring.clone(), hbm_ring.clone(), cursor), tc_q_new, hbm_q_new)


@obs.spanned("engine.update")
def update_window_(state, tc_q_new, hbm_q_new):
    """update_window that writes the column into ``state``'s own rings.

    No ring is allocated per cycle; any other state built on these rings
    sees the write. Returns the same rings and the advanced cursor.

    The cursor follows the reference's dynamic_update_slice, on the device:
    column clamp(c + K*(c < 0), 0, K-1), which is clamp(c, -K, K-1) mod K,
    and next cursor (c + 1) mod K, both Python-style.

    Rings with more rows than the new samples (rekey_window's: rows kept
    for chips absent this cycle follow the present ones) get INVALID_Q in
    the column of those rows: the cycle brought them no data.
    """
    tc_ring, hbm_ring, cursor = state
    num_chunks = tc_ring.shape[1]
    present = tc_q_new.shape[0]
    if present > tc_ring.shape[0]:
        raise ValueError(f"{present} rows of new samples for a window of "
                         f"{tc_ring.shape[0]} rows")
    cursor = obs.to_device(torch.as_tensor(cursor, dtype=torch.int32), tc_ring.device)
    column = cursor.view(1).long().clamp_(-num_chunks, num_chunks - 1).remainder_(num_chunks)
    if present == tc_ring.shape[0]:
        tc_ring.index_copy_(1, column, tc_q_new.amax(dim=1, keepdim=True))
        hbm_ring.index_copy_(1, column, hbm_q_new.amax(dim=1, keepdim=True))
    else:
        for ring, new in ((tc_ring, tc_q_new), (hbm_ring, hbm_q_new)):
            ring[:present].index_copy_(1, column, new.amax(dim=1, keepdim=True))
            ring[present:].index_fill_(1, column, INVALID_Q)
    return tc_ring, hbm_ring, (cursor + 1) % num_chunks


@obs.spanned("engine.evaluate")
def evaluate_window_qc(state, pod_age_s, bounds, params_arr_q):
    """Slice verdicts from streaming state (contiguous fleets).

    The ring of chunk maxima is a valid [C, K] sample tensor for the qc
    evaluator: the max over chunk maxima is the max over every sample in
    the window, and all-sentinel rows stay non-candidates. Rings with more
    rows than ``pod_age_s`` (rekey_window's) are judged on their first
    rows, this cycle's chips, a view of the row-major rings.
    """
    tc_ring, hbm_ring = _present_rows(state, pod_age_s)
    return evaluate_fleet_qc(tc_ring, hbm_ring, pod_age_s, bounds, params_arr_q)


@obs.spanned("engine.evaluate")
def evaluate_window_qu(state, pod_age_s, params_arr_q, chips_per_slice: int):
    """evaluate_window_qc for uniform fleets (the reshape reduction)."""
    tc_ring, hbm_ring = _present_rows(state, pod_age_s)
    return evaluate_fleet_qu(tc_ring, hbm_ring, pod_age_s, params_arr_q,
                             chips_per_slice)


def _present_rows(state, pod_age_s):
    """The rings' rows of the chips that ``pod_age_s`` has, the first ones."""
    tc_ring, hbm_ring, _ = state
    present = pod_age_s.shape[0]
    if present < tc_ring.shape[0]:
        return tc_ring[:present], hbm_ring[:present]
    return tc_ring, hbm_ring


# --- a fleet that changes between cycles: the window's rows keyed by chip ------


class WindowRows(NamedTuple):
    """Which chip each row of a streaming window holds: the chips of the
    last cycle first, in its order, then rows kept for chips absent then.
    Keys are int64, one chip each; the cycles are the caller's numbers."""

    keys: np.ndarray        # int64 [C]: the last cycle's chips, the first rows
    cycle: int              # the cycle they were present in
    kept_keys: np.ndarray   # int64 [R - C]: the kept rows' chips
    kept_seen: np.ndarray   # int64 [R - C]: the last cycle each was present in
    # the same keys and cycles on the card, where rekey_window left them
    # there; None where they are on the host alone
    on_card: CardRows | None = None

    @classmethod
    def of(cls, keys, cycle: int) -> "WindowRows":
        """The rows of a window whose rows are ``keys``' chips alone, as
        ``init_window(len(keys), K)`` starts one, present in ``cycle``."""
        none = np.zeros(0, dtype=np.int64)
        return cls(np.ascontiguousarray(keys, dtype=np.int64), int(cycle), none, none)

    def all_keys(self) -> np.ndarray:
        return np.concatenate([self.keys, self.kept_keys])

    def all_seen(self) -> np.ndarray:
        return np.concatenate([np.full(len(self.keys), self.cycle, dtype=np.int64),
                               self.kept_seen])


class Rekeyed(NamedTuple):
    """rekey_window's result."""

    state: tuple        # (tc_ring, hbm_ring, cursor): this cycle's chips, then kept rows
    rows: WindowRows    # the chip of each row
    present: int        # this cycle's chips, the first rows


@obs.spanned("engine.rekey")
def rekey_window(state, rows: WindowRows, keys, cycle: int) -> Rekeyed:
    """Carry the streaming window's rows to this cycle's chips, by chip key.

    ``state``'s rings hold one row a chip of ``rows`` (WindowRows: the
    rows' int64 keys and the cycle each was last present in); ``keys``
    (int64 [C], unique) are this cycle's chips in the order their samples
    come (as ``analyze.load_fleet`` gives them), and ``cycle`` this cycle's
    number. At cycle i a chip's window is the chunk maxima of cycles
    max(0, i-K+1) .. i, a cycle in which its key was absent counting as a
    chunk with no data. So the result's rings hold, in this order:

    - this cycle's chips, in ``keys``' order: a key among the rows keeps its
      row; a new key gets K chunks of no data;
    - the rows of absent keys that may still hold data (absent fewer than
      K cycles), in their order: a chip that misses a scrape comes back with
      its history, and is not judged on its one chunk;
    - no row absent K cycles or more: it holds only chunks of no data.

    update_window_ then writes the present rows from this cycle's samples
    and the kept rows as no data, and evaluate_window_qc judges the first
    C rows, over this cycle's slices alone; nothing else changes.

    Where the rings lie on the card, the join runs there
    (``kernels.window_join``, a hash join over the int64 keys): this
    cycle's keys go up once, from pinned memory, the rows' keys are those the
    last call left on the card (``WindowRows.on_card``; uploaded where a
    caller has none),
    and the host waits once for the counts and the kept rows, which the
    join writes into pinned host memory; ``kernels.window_gather`` then
    moves the rows by the join's row index, on the card. Where they lie on
    the host, the join runs there (``csrc/window_keys.cpp``, or the plain
    version ``rekey_plain`` where the library is missing or refuses the
    input) and ``window_gather_plain`` moves the rows by the runs of its
    row index (``gather_runs``). Either way, where every row stays in place
    and none comes or goes, it returns ``state`` as it is, with no gather,
    and keeps ``keys`` as the rows' first keys without a copy. A repeated
    key, among the chips or the rows, raises ValueError and leaves
    ``state`` as it was. The ``obs`` counters ``window_rows_new``,
    ``_retained``, ``_dropped`` and ``_moved`` (rows that changed place)
    count its rows, and ``rekey_card``, ``rekey_native`` and
    ``rekey_plain`` the calls each join answered.
    """
    tc_ring, hbm_ring, cursor = state
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    rows = WindowRows(np.ascontiguousarray(rows.keys, dtype=np.int64), int(rows.cycle),
                      np.ascontiguousarray(rows.kept_keys, dtype=np.int64),
                      np.ascontiguousarray(rows.kept_seen, dtype=np.int64), rows.on_card)
    total = len(rows.keys) + len(rows.kept_keys)
    if (tc_ring.dim() != 2 or tc_ring.shape[0] != total or keys.ndim != 1
            or rows.keys.ndim != 1 or rows.kept_seen.shape != rows.kept_keys.shape):
        raise ValueError(f"rekey_window takes rings [R, K] with R rows of keys, and [C] keys; "
                         f"got rings {tuple(tc_ring.shape)}, {len(rows.keys)} + "
                         f"{rows.kept_keys.shape} rows, keys {keys.shape}")
    num_chunks = tc_ring.shape[1]
    if tc_ring.is_cuda:
        out, index, counts = _rekey_card(tc_ring.device, rows, keys, int(cycle), num_chunks)
    else:
        out, runs, counts = _rekey_host(rows, keys, int(cycle), num_chunks)
    new, retained, dropped, moved = counts
    for name, n in (("new", new), ("retained", retained), ("dropped", dropped),
                    ("moved", moved)):
        obs.count(f"window_rows_{name}", n)
    rows_out = len(keys) + len(out.kept_keys)
    if rows_out == total and not (new or dropped or moved):
        return Rekeyed(state, out, len(keys))
    if tc_ring.is_cuda:
        tc_ring, hbm_ring = window_gather(tc_ring, hbm_ring, index)
    else:
        tc_ring, hbm_ring = window_gather_plain(tc_ring, hbm_ring, torch.from_numpy(runs),
                                                rows_out)
    return Rekeyed((tc_ring, hbm_ring, cursor), out, len(keys))


def _rekey_host(rows: WindowRows, keys, cycle: int, num_chunks: int):
    """The join on the host: (the rows out, their runs, the counts)."""
    joined = _rekey_native(rows, keys, cycle, num_chunks)
    if joined is None:
        joined = rekey_plain(rows, keys, cycle, num_chunks)
        obs.count("rekey_plain")
    else:
        obs.count("rekey_native")
    runs, kept_keys, kept_seen, counts = joined
    return WindowRows(keys, cycle, kept_keys, kept_seen), runs, counts


def _rekey_card(device, rows: WindowRows, keys, cycle: int, num_chunks: int):
    """The join on the card: (the rows out, with their keys left on the
    card; the row index on the card, [rows out]; the counts). The keys go
    up in the join's own copy, from pinned memory; the rows' keys too where
    the last call did not leave them on the card. One wait."""
    on_card = rows.on_card
    if on_card is None or on_card.keys.device != device:
        P, Q = len(rows.keys), len(rows.kept_keys)
        up = np.concatenate([rows.keys, rows.kept_keys, rows.kept_seen])
        on_card = CardRows(obs.to_device(torch.from_numpy(up), device), P, Q, P + Q)
    joined = window_join(on_card, keys, rows.cycle, cycle, num_chunks)
    obs.count("h2d_bytes", keys.nbytes)
    torch.cuda.current_stream(device).synchronize()  # the join's counts and kept rows
    obs.count("host_syncs")
    host = joined.host.numpy()
    flags, new, retained, dropped, moved = (int(x) for x in host[:5])
    obs.count("d2h_bytes", 8 * (JOIN_COUNTS + 2 * retained))
    if flags:
        _refuse_repeated(chips=bool(flags & 1))
    obs.count("rekey_card")
    total = len(rows.keys) + len(rows.kept_keys)
    kept_keys = host[JOIN_COUNTS:JOIN_COUNTS + retained]
    kept_seen = host[JOIN_COUNTS + total:JOIN_COUNTS + total + retained]
    out = WindowRows(keys, cycle, kept_keys, kept_seen,
                     CardRows(joined.keys, len(keys), retained, len(keys) + total))
    return out, joined.index[:len(keys) + retained], (new, retained, dropped, moved)


def _refuse_repeated(chips: bool):
    if chips:
        raise ValueError("this cycle's chip keys repeat: the window keys each row by one chip")
    raise ValueError("the window's row keys repeat")


def rekey_plain(rows: WindowRows, keys, cycle: int, num_chunks: int):
    """rekey_window's join in plain NumPy: a sort of the rows' keys and a
    binary search a chip. Returns (the rows' runs, ``gather_runs``; the kept
    rows' keys and last-seen cycles; (new, retained, dropped, moved));
    raises ValueError where a key repeats."""
    row_keys, row_seen = rows.all_keys(), rows.all_seen()
    if np.unique(keys).size != keys.size:
        _refuse_repeated(chips=True)
    if np.unique(row_keys).size != row_keys.size:
        _refuse_repeated(chips=False)
    hit = np.zeros(len(keys), dtype=bool)
    found = np.full(len(keys), -1, dtype=np.int64)
    if len(row_keys):
        order = np.argsort(row_keys, kind="stable")
        at = np.minimum(np.searchsorted(row_keys[order], keys), len(row_keys) - 1)
        hit = row_keys[order][at] == keys
        found[hit] = order[at][hit]
    carried = np.zeros(len(row_keys), dtype=bool)
    carried[found[hit]] = True
    absent = np.flatnonzero(~carried)
    kept = absent[cycle - row_seen[absent] < num_chunks]
    gather = np.concatenate([found, kept]).astype(np.int32)
    moved = int(((gather >= 0) & (gather != np.arange(len(gather)))).sum())
    return (gather_runs(gather), row_keys[kept], row_seen[kept],
            (int((~hit).sum()), len(kept), len(absent) - len(kept), moved))


def _rekey_native(rows: WindowRows, keys, cycle: int, num_chunks: int):
    """rekey_plain's result from the native join, or None where the host
    library is missing or refuses the input (a repeated key)."""
    lib = hostlib.load()
    most = len(rows.keys) + len(rows.kept_keys)
    if lib is None or len(keys) + most >= _INT32_LIMIT:
        return None
    runs = np.empty((2, len(keys) + most), dtype=np.int32)
    kept_keys = np.empty(most, dtype=np.int64)
    kept_seen = np.empty(most, dtype=np.int64)
    counts = np.zeros(6, dtype=np.int64)
    if lib.tp_rekey(rows.keys.ctypes.data, len(rows.keys), rows.cycle, rows.kept_keys.ctypes.data,
                    rows.kept_seen.ctypes.data, len(rows.kept_keys), keys.ctypes.data, len(keys),
                    cycle, num_chunks, runs[0].ctypes.data, runs[1].ctypes.data,
                    kept_keys.ctypes.data, kept_seen.ctypes.data, counts.ctypes.data) != 0:
        return None
    kept, m = int(counts[2]), int(counts[5])
    return (np.ascontiguousarray(runs[:, :m]), kept_keys[:kept], kept_seen[:kept],
            tuple(int(x) for x in counts[1:5]))


@obs.spanned("engine.upload")
def window_from_numpy(state, device="cuda"):
    """Streaming state as numpy (int8 rings, an integer cursor) -> tensors.

    Carries a window across from the JAX package's (tc_ring, hbm_ring,
    cursor), or from an ``analyze --stream`` state file of either package.
    """
    device = resolve_device(device)
    tc_ring, hbm_ring, cursor = state
    # copies: update_window_ writes the rings in place, and on the CPU
    # from_numpy would share (possibly read-only) numpy memory
    rings = tuple(obs.to_device(torch.from_numpy(np.array(x, dtype=np.int8, order="C")),
                                device) for x in (tc_ring, hbm_ring))
    return (*rings, obs.to_device(torch.tensor(int(cursor), dtype=torch.int32), device))


@obs.spanned("engine.quantize")
def quantize_fleet_inputs(inputs):
    """Convert evaluate_fleet's input tuple to evaluate_fleet_q's, on its device.

    (tc, hbm, valid, age, slice_id, params) ->
    (tc_q, hbm_q, age, slice_id, params_q)
    """
    tc, hbm, valid, age, slice_id, params_arr = inputs
    return (
        quantize_samples_device(tc, valid),
        quantize_samples_device(hbm, valid),
        age,
        slice_id,
        obs.to_device(torch.from_numpy(quantize_params(params_arr)), tc.device),
    )


@obs.spanned("engine.upload")
def fleet_from_numpy(inputs, device="cuda"):
    """The JAX package's evaluate_fleet input tuple, as numpy, -> tensors.

    (tc, hbm, valid, age, slice_id[, params_arr]) keep their dtypes: f32
    samples, bool validity, f32 age, int32 slice ids, f32[2] params; a
    fleet without params (a sweep's) gives five tensors. The engine has no
    learned weights: these tensors and the params are its whole state.
    """
    device = resolve_device(device)
    if len(inputs) not in (5, 6):
        raise ValueError(f"a fleet is 5 arrays, or 6 with its params; got {len(inputs)}")
    dtypes = (np.float32, np.float32, bool, np.float32, np.int32, np.float32)
    return tuple(
        obs.to_device(torch.from_numpy(np.ascontiguousarray(x, dtype=dt)), device)
        for x, dt in zip(inputs, dtypes))


def make_example_fleet(
    num_chips: int = 256,
    num_samples: int = 16,
    num_slices: int = 16,
    idle_fraction: float = 0.5,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
):
    """Synthetic fleet: contiguous equal slices, a fraction fully idle.

    Draws the same numbers in the same order as the JAX package's
    make_example_fleet, so both build bit-identical fleets; ``dtype`` is
    the samples' (tc and hbm), cast from f32 with round-to-nearest-even as
    the reference's is. Returns (inputs tuple for evaluate_fleet minus
    num_slices, on ``device``; expected per-slice verdicts as a numpy array).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    chips_per_slice = num_chips // num_slices
    if chips_per_slice * num_slices != num_chips:
        raise ValueError("chips must divide slices")

    slice_id = np.repeat(np.arange(num_slices, dtype=np.int32), chips_per_slice)
    idle_slices = np.zeros(num_slices, dtype=bool)
    idle_slices[: int(num_slices * idle_fraction)] = True

    chip_idle = idle_slices[slice_id]
    tc = rng.uniform(0.2, 1.0, size=(num_chips, num_samples)).astype(np.float32)
    tc[chip_idle] = 0.0
    hbm = rng.uniform(0.1, 0.9, size=(num_chips, num_samples)).astype(np.float32)
    hbm[chip_idle] = 0.0
    valid = np.ones((num_chips, num_samples), dtype=bool)
    age = np.full((num_chips,), 7200.0, dtype=np.float32)

    params = PolicyParams()
    parr = np.array([params.lookback_s, params.hbm_cutoff()], dtype=np.float32)
    tc, hbm, *rest = fleet_from_numpy((tc, hbm, valid, age, slice_id, parr), device)
    return (tc.to(dtype), hbm.to(dtype), *rest), idle_slices
