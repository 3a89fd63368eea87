"""Sharded fleet evaluation over a torch.distributed process group.

Counterpart of the mesh-sharded evaluators of tpu_pruner/policy/engine.py.
The reference splits the chip axis over a device mesh with ``shard_map``;
here every rank of a process group runs the same program on its own block
of chip rows (SPMD), and ``psum`` becomes ``dist.all_reduce(SUM)``.
``group=None`` means the default group, which must be initialized.

- ``make_sharded_evaluator*`` build a function that takes the calling
  rank's shard, as the reference's ``shard_map`` bodies do. Its results
  follow the reference's ``out_specs``: slice verdicts that the reference
  replicates (``P()``) are summed over the ranks and equal on every rank;
  chip candidates, and the uniform path's verdicts (``P(axis)``), are the
  rank's own part.
- ``evaluate_fleet_sharded*`` take the global tensors, pad the chip axis to
  a multiple of the world size with verdict-neutral rows, evaluate the
  rank's rows, and return the same global (verdicts, candidates) on every
  rank.

Global candidates and uniform verdicts are assembled with one
``all_reduce(SUM)`` over a zeroed int32 vector in which each rank fills its
own rows: the gloo backend supports only broadcast and all-reduce on CUDA
tensors, so there is no all-gather to lean on.

``spawn_ranks`` runs functions on n local ranks of a fresh group (gloo on
the CPU, NCCL on the card), for the entry point's dry run and the tests;
``run_local`` and ``run_stream_local`` call a built evaluator or the
stream step on the rank's rows.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .engine import (INVALID_Q, evaluate_fleet_qu, init_window, normalize_inputs,
                     normalize_inputs_q, normalize_slice_ids, resolve_device,
                     slice_counts, slice_counts_contiguous, update_window)
from .kernels import chip_pass, chip_pass_q


def _world(group):
    """(world size, rank) of ``group``; raises if torch.distributed is not up."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed has no initialized process group; call "
            "torch.distributed.init_process_group first, or use the "
            "single-device evaluators")
    return dist.get_world_size(group), dist.get_rank(group)


def local_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of x's rows: the chip axis cut into world-size equal
    parts, as ``P(axis)`` places a sharded array on a mesh."""
    n, rank = _world(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} equal shards")
    size = x.shape[0] // n
    return x[rank * size:(rank + 1) * size]


def _counts_verdicts(busy, chips, group):
    """Sum per-slice busy and chip counts over the ranks -> bool[S] verdicts."""
    counts = torch.stack([busy, chips])
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    return (counts[0] == 0) & (counts[1] > 0)


def _make_sharded_impl(num_slices: int, group, quantized: bool):
    """Shared body of the two segment-sum builders.

    Each rank computes its local per-slice busy and chip counts with
    ``index_add_``, and one all-reduce gives the global counts: slices may
    span ranks freely. Verdicts are replicated; candidates stay local.
    """
    _world(group)

    def local_eval(*args):
        *chip_args, slice_id, params_arr = args
        if quantized:
            candidate = chip_pass_q(*normalize_inputs_q(*chip_args, params_arr))
        else:
            candidate = chip_pass(*normalize_inputs(*chip_args, params_arr))
        busy, chips = slice_counts(candidate, slice_id, num_slices)
        return _counts_verdicts(busy, chips, group), candidate

    return local_eval


def make_sharded_evaluator(num_slices: int, group=None):
    """f32 sharded evaluator: fn(tc, hbm, valid, age, slice_id, params) on
    the rank's rows -> (replicated verdicts bool[S], local candidates)."""
    return _make_sharded_impl(num_slices, group, quantized=False)


def make_sharded_evaluator_q(num_slices: int, group=None):
    """int8 form of make_sharded_evaluator: fn(tc_q, hbm_q, age, slice_id,
    params_q) on the rank's rows."""
    return _make_sharded_impl(num_slices, group, quantized=True)


def _assemble(local: torch.Tensor, offset: int, total: int, group) -> torch.Tensor:
    """Every rank's part at its offset in one global vector, on every rank:
    one all-reduce(SUM) of a zeroed int32 [total] that each rank fills at
    its own rows."""
    out = torch.zeros(total, dtype=torch.int32, device=local.device)
    out[offset:offset + local.shape[0]] = local.to(torch.int32)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(torch.bool)


def _padded_rows(x: torch.Tensor, start: int, stop: int, pad_value) -> torch.Tensor:
    """Rows [start, stop) of x, with rows past x's end filled with pad_value.

    Only the rank's own rows are copied; the global tensor is never padded
    as a whole.
    """
    part = x[start:min(stop, x.shape[0])]
    missing = stop - start - part.shape[0]
    if missing <= 0:
        return part
    fill = torch.full((missing, *x.shape[1:]), pad_value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([part, fill])


def _evaluate_sharded_impl(chip_arrays, pad_values, params_arr, num_slices: int,
                           group, quantized: bool):
    """Shared pad-and-dispatch path of the two segment-sum entry points.

    Chips are padded to a world-size multiple with verdict-neutral rows
    (valid=False for f32 storage, the -1 sentinel for int8: an all-invalid
    chip is never a candidate) whose slice id is a sentinel segment
    ``num_slices``, one extra segment that is sliced off the output. The
    ids are widened first (normalize_slice_ids), so the sentinel fits them.
    """
    n, rank = _world(group)
    num_chips = chip_arrays[0].shape[0]
    shard = -(-num_chips // n)
    start = rank * shard
    *samples, slice_id = chip_arrays
    rows = [_padded_rows(x, start, start + shard, pv)
            for x, pv in zip((*samples, normalize_slice_ids(slice_id)), pad_values)]
    evaluator = _make_sharded_impl(num_slices + 1, group, quantized)
    verdicts, candidate = evaluator(*rows, params_arr)
    candidates = _assemble(candidate, start, n * shard, group)
    return verdicts[:num_slices], candidates[:num_chips]


def evaluate_fleet_sharded(tc_util, hbm_util, valid, pod_age_s, slice_id, params_arr,
                           num_slices: int, group=None):
    """evaluate_fleet over the ranks of ``group``, any chip count. Every rank
    passes the same global tensors and gets the same global results."""
    return _evaluate_sharded_impl(
        (tc_util, hbm_util, valid, pod_age_s, slice_id),
        (0.0, 0.0, False, 0.0, num_slices),
        params_arr, num_slices, group, quantized=False)


def evaluate_fleet_sharded_q(tc_q, hbm_q, pod_age_s, slice_id, params_arr_q,
                             num_slices: int, group=None):
    """evaluate_fleet_q over the ranks of ``group`` (int8 storage). Samples
    of another dtype are mapped to int8 (normalize_inputs_q) before the -1
    padding, on the global tensors."""
    *arrays, params_arr_q = normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q)
    return _evaluate_sharded_impl(
        (*arrays, slice_id),
        (INVALID_Q, INVALID_Q, 0.0, num_slices),
        params_arr_q, num_slices, group, quantized=True)


# --- sharded forms of the recommended evaluators ----------------------------
#
# qu and streaming cut shards on slice boundaries (whole slices per rank),
# so their verdicts are local and need no collective. qc slices may span
# ranks: each rank runs its cumsum over bounds clipped to its rows, and one
# all-reduce merges the per-slice busy and chip counts.


def shard_bounds(bounds, n_shards: int, shard_size: int, device="cuda") -> torch.Tensor:
    """Per-shard clipped segment bounds (int32[n_shards, S+1], host-side).

    Shard d holds global chips [d*shard_size, (d+1)*shard_size); clipping the
    global bounds into that range gives, for every slice, the part of it
    that lives on shard d (possibly empty).
    """
    if isinstance(bounds, torch.Tensor):
        bounds = bounds.cpu().numpy()
    b = np.asarray(bounds)
    offs = np.arange(n_shards, dtype=np.int64) * shard_size
    local = np.clip(b[None, :] - offs[:, None], 0, shard_size).astype(np.int32)
    return torch.from_numpy(local).to(resolve_device(device))


def make_sharded_evaluator_qc(num_slices: int, group=None):
    """int8 + per-rank cumsum + all-reduced per-slice counts:
    fn(tc_q, hbm_q, age, local_bounds, params_q) on the rank's rows, where
    local_bounds is the rank's row of shard_bounds ([S+1] or [1, S+1])."""
    _world(group)
    del num_slices  # the shape comes with local_bounds

    def local_eval(tc_q, hbm_q, pod_age_s, local_bounds, params_arr):
        candidate = chip_pass_q(*normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr))
        busy, chips = slice_counts_contiguous(candidate, local_bounds.reshape(-1))
        return _counts_verdicts(busy, chips, group), candidate

    return local_eval


def make_sharded_evaluator_qu(chips_per_slice: int, group=None):
    """int8 + uniform reshape per rank, with no collective: ranks hold whole
    slices, so fn(tc_q, hbm_q, age, params_q) returns the rank's verdicts
    and candidates."""
    _world(group)

    def local_eval(tc_q, hbm_q, pod_age_s, params_arr):
        return evaluate_fleet_qu(tc_q, hbm_q, pod_age_s, params_arr, chips_per_slice)

    return local_eval


def evaluate_fleet_sharded_qc(tc_q, hbm_q, pod_age_s, bounds, params_arr_q, group=None):
    """evaluate_fleet_qc over the ranks of ``group``: per-rank cumsum + one
    all-reduce. Chips are padded to a world-size multiple with -1 rows,
    which lie outside every bound, after normalize_inputs_q."""
    n, rank = _world(group)
    *arrays, params_arr_q = normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q)
    num_chips = tc_q.shape[0]
    shard = -(-num_chips // n)
    start = rank * shard
    rows = [_padded_rows(x, start, start + shard, pv)
            for x, pv in zip(arrays, (INVALID_Q, INVALID_Q, 0.0))]
    local_bounds = shard_bounds(bounds, n, shard, device=tc_q.device)[rank]
    evaluator = make_sharded_evaluator_qc(bounds.shape[0] - 1, group)
    verdicts, candidate = evaluator(*rows, local_bounds, params_arr_q)
    return verdicts, _assemble(candidate, start, n * shard, group)[:num_chips]


def evaluate_fleet_sharded_qu(tc_q, hbm_q, pod_age_s, params_arr_q,
                              chips_per_slice: int, group=None):
    """evaluate_fleet_qu over the ranks of ``group``, with no collective for
    the verdicts. Slices are padded to a world-size multiple with whole
    all-invalid slices, never idle and sliced off the output, after
    normalize_inputs_q. Validate the layout with assert_uniform_slices at
    ingest."""
    n, rank = _world(group)
    *arrays, params_arr_q = normalize_inputs_q(tc_q, hbm_q, pod_age_s, params_arr_q)
    num_chips = tc_q.shape[0]
    if num_chips % chips_per_slice != 0:
        raise ValueError(
            f"{num_chips} chips do not divide into slices of {chips_per_slice}")
    num_slices = num_chips // chips_per_slice
    slices_per_rank = -(-num_slices // n)
    shard = slices_per_rank * chips_per_slice
    start = rank * shard
    rows = [_padded_rows(x, start, start + shard, pv)
            for x, pv in zip(arrays, (INVALID_Q, INVALID_Q, 0.0))]
    evaluator = make_sharded_evaluator_qu(chips_per_slice, group)
    verdicts, candidate = evaluator(*rows, params_arr_q)
    verdicts = _assemble(verdicts, rank * slices_per_rank, n * slices_per_rank, group)
    candidates = _assemble(candidate, start, n * shard, group)
    return verdicts[:num_slices], candidates[:num_chips]


def make_sharded_stream_step(chips_per_slice: int, group=None):
    """One fused streaming cycle per rank, with no collective: fold the new
    int8 samples into the rank's rings and evaluate its uniform window
    verdicts.

    Returned step(state, tc_new, hbm_new, age, params_q) -> (state, verdicts),
    where state = (tc_ring, hbm_ring, cursor) holds the rank's rows of the
    rings and the cursor, equal on every rank. The step returns fresh rings
    (update_window) and leaves the state it was given as it was, as the
    reference's jitted step does. The caller cuts shards on slice
    boundaries: chips % (world * chips_per_slice) == 0.
    """
    _world(group)

    def step(state, tc_q_new, hbm_q_new, pod_age_s, params_arr_q):
        state = update_window(state, tc_q_new, hbm_q_new)
        verdicts, _ = evaluate_fleet_qu(state[0], state[1], pod_age_s, params_arr_q,
                                        chips_per_slice)
        return state, verdicts

    return step


# --- local ranks -------------------------------------------------------------


def _to_device(obj, device):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(x, device) for x in obj)
    return obj


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def run_local(builder, build_arg, *args):
    """Build ``builder(build_arg)`` and call it on this rank's rows of every
    argument but the last, which every rank takes whole: the reference's
    ``shard_map`` with ``in_specs`` of ``P(axis)`` for the chip arrays and
    ``P()`` for the parameters."""
    *rows, params = args
    return builder(build_arg)(*(local_rows(x) for x in rows), params)


def run_stream_local(chips_per_slice: int, num_chunks: int, tc_chunks, hbm_chunks,
                     pod_age_s, params_arr_q):
    """Drive make_sharded_stream_step from a fresh window over a sequence of
    global chunks ([C, T_new] each), each rank on its rows. Returns, per
    cycle, this rank's (verdicts, tc_ring, hbm_ring, cursor); each cycle's
    rings are its own, since the step returns fresh ones."""
    age = local_rows(pod_age_s)
    step = make_sharded_stream_step(chips_per_slice)
    state = init_window(age.shape[0], num_chunks, device=age.device)
    cycles = []
    for tc_new, hbm_new in zip(tc_chunks, hbm_chunks):
        state, verdicts = step(state, local_rows(tc_new), local_rows(hbm_new), age,
                               params_arr_q)
        cycles.append((verdicts, *state))
    return cycles


def _rank_main(rank, world_size, init_method, backend, device, calls, results):
    """One spawned rank: join the group, run each fn(*args) of calls with
    numpy arrays moved to the rank's device, and send back the results as
    numpy (or a traceback)."""
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=120))
        try:
            out = [_to_host(fn(*_to_device(args, device))) for fn, args in calls]
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))


def spawn_ranks(n: int, calls, device="cuda", backend=None,
                timeout_s: float = 300.0, workdir=None) -> list:
    """Run each (fn, args) of calls, in order, on n spawned local ranks of a
    fresh process group; returns each rank's list of results, in rank order.

    Each fn must be importable by name (a module-level function); numpy
    arrays in args, also inside lists and tuples, arrive as tensors on the
    rank's device ("cuda" is card ``rank % device_count``), and tensors in
    the results come back as numpy.

    The backend defaults to NCCL on the card and gloo on the CPU; NCCL needs
    a card per rank and raises when fewer are visible. The rendezvous is a
    file store in ``workdir`` (a fresh temporary directory by default). If a
    rank fails, or the ranks outlive ``timeout_s``, every rank is killed and
    RuntimeError (TimeoutError) is raised.
    """
    device = resolve_device(device).type
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(f"nccl needs {n} CUDA devices, "
                           f"{torch.cuda.device_count()} are visible")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, n, init_method, backend, device, list(calls),
                                   results))
                 for rank in range(n)]
        for p in procs:
            p.start()
        try:
            out = _collect(procs, results, n, time.monotonic() + timeout_s)
        except BaseException:
            for p in procs:
                p.kill()
            raise
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return out


def _collect(procs, results, n: int, deadline: float) -> list:
    """Drain the ranks' results before they are joined; fail fast on the
    first error, a rank that died without a result, or the deadline."""
    out = [None] * n
    pending = set(range(n))
    while pending:
        try:
            rank, error, value = results.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result") from None
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(pending)} did not finish in time") \
                    from None
            continue
        if error is not None:
            raise RuntimeError(f"rank {rank} failed:\n{error}")
        out[rank] = value
        pending.discard(rank)
    return out
