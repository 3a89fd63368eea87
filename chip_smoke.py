#!/usr/bin/env python3
"""Kernel timer of tpu_pruner_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

The port's correctness on the card is held by its ``gpu``-marked tests
(``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py``);
this script builds the kernels and times them, in two phases, each of which
exits non-zero on failure:

1. build the CUDA kernels from tpu_pruner_torch/policy/csrc with nvcc
   (sm_90a), print each kernel's registers, shared memory and spills
   (a second nvcc with -Xptxas -v, started with the build; the int8 pass's
   row design at T = 12, and its registers and spills over every T it has a
   kernel for; the f32 pass's group design for each samples-a-lane it has a
   kernel for, and its long-row design for each samples a lane a chunk;
   the slice gate; the scatter reduction's two kernels; the row gather;
   the key join's three kernels), and print the
   card's name and power limit;
2. ("phase 4" in the log, as the records cite it) time each kernel with CUDA
   events (median over many launches) beside its plain version and its
   bound at the card's published rates: warm (back to back) and cold (a
   256 MB scratch buffer zeroed before each launch, outside the events, so
   the 50 MB L2 holds none of the inputs); the f32 kernel in each design
   that takes the rows (the plan's, and the long-row design beside the
   group design at short rows), warm and cold; the int8 kernel also at
   T = 12, the streaming window's shape, in both designs warm and cold, and
   plain (also on the dry run's 32,768 rows a rank); and, end to end,
   evaluate_fleet, evaluate_fleet_c, evaluate_fleet_qc, evaluate_fleet_qu
   and one streaming cycle in each form (update_window_ in place, or
   update_window with fresh rings, + evaluate_window_qc or _qu): device
   time, warm and cold, from replays of a CUDA graph of one call, eager host
   wall time per call, and for the four evaluate_fleet paths and the two
   in-place cycles the device operations one eager call puts on the card,
   each with its traced device time, from a torch.profiler trace
   (launch_counts); and the slice gate on the fleet's own candidate, warm
   and cold beside its bound, its plain version and an empty kernel. All of
   it twice: on the main path's fleet, 131,072 chips x 360 samples in 8,192
   slices, and at bench.py's XL point, 1,048,576 chips x 360 samples in
   65,536 slices, built on the card with a seeded torch.Generator. Then both
   designs of the int8 kernel for each T that has a row kernel at 32,768,
   131,072 and 1,048,576 chips, warm and cold, and whether the row design
   was the faster wherever the plan takes it. Then the f32 kernel at the
   dump's width, 8 samples a chip with padded short series, in each design
   at the same three sizes, warm and cold, beside its bound, its plain
   version and an empty kernel; evaluate_fleet_c end to end at 131,072 x 8,
   with its device operations; the slice gate on one slice of 1,048,576
   chips, on 1,048,576 slices of one chip, on mixed fleets (16-chip slices
   and one each of 4,096, 8,960 and 65,536 chips) and by average slice
   length at 131,072 and 1,048,576 chips (gate_fleets); the scatter
   reduction (one call: its memset and two kernels) warm and cold beside
   its plain version, an empty kernel and its bound, on the gke-65k layout
   (260,000 chips in 23,149 groups, host order), 1,048,576 chips in 65,536
   shuffled slices, one slice of 1,048,576 chips idle but one, and
   1,048,576 one-chip slices (scatter_rows); the streaming window's row
   gather (one launch moves both rings by a row index) warm and cold beside
   its plain version (by the index's runs), an empty kernel and its bound,
   at the stream-260k-churn-k12 cell's shape (263,000 rows out of 263,000,
   3,000 of them new, the rest moved), at its burst (50,944 new) and at
   1,048,576 rows (gather_rows); the window's key join (one call: a memset
   and three kernels) warm and cold beside its bound and an empty kernel,
   the host's joins it replaces (native and plain) and rekey_window on the
   card on the host's clock with its device operations, at the cell's shape
   (263,000 rows, 260,000 chips, 3,000 new in 1,500 places), its burst and
   1,048,576 rows (join_rows); the policy sweep's pass and slice reduction
   (each against its plain version first) warm and cold beside their
   bounds, evaluate_fleet_sweep whole, and the port's only other way to the
   same answers, evaluate_fleet once a policy on suffix views of the
   window, at the sweep-260k-t1440-d8h8 cell's cluster (260,000 x 1,440
   under its 64-policy grid, and under one policy) and at 1,048,576 x 360 in
   65,536 groups of 16 under 64 policies (sweep_rows);
   and the f32 designs for each T of f32_timing_t(C) at the three sizes
   (rows of 1 to 2,880 samples; the long-row design also at its other
   samples a lane), and where the plan's design was not the fastest.

Each timed kernel is first held against its plain version on the inputs it
is timed on. The fleets and shapes come from tests/torch_kernel_cases.py,
which the tests share.

The line before the last is {"kernels": [...]}, each kernel's row with its
XL times under "xl" (the int8 kernel also its T = 12 times under "window"
and its sweep under "design_sweep", the f32 kernel its times at the dump's
width and its sweep under "dump", the slice gate, which has no Pallas
counterpart, its other fleets and sweep under "fleets", and the scatter
reduction, the row gather, the key join and the sweep's two kernels, which
have none either, their shapes under "fleets"); the line
before it is {"end_to_end": {...}}, the end-to-end times at both sizes; the
last line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from port_bench.work import HBM_BYTES_PER_S
from port_bench import gen, sweep, work_sweep
from tpu_pruner_torch.policy import (
    PolicyParams, _build, chip_pass, chip_pass_plain, chip_pass_q, chip_pass_q_plain,
    evaluate_fleet, evaluate_fleet_c, evaluate_fleet_qc, evaluate_fleet_qu, evaluate_fleet_sweep,
    evaluate_window_qc, evaluate_window_qu, init_window, make_example_fleet, params_array,
    quantize_fleet_inputs, slice_bounds, sweep_grid, update_window, update_window_)
from tpu_pruner_torch.policy.engine import _rekey_native, rekey_plain, rekey_window
from tpu_pruner_torch.policy.kernels import (
    _F32_GROUPS_K, _F32_LONG_K, _Q_ROWS_T, F32_DESIGNS, JOIN_COUNTS, CardRows, PlanLong, PlanRows,
    _choose_plan_q, _f32_plans, _launch_f32, _launch_q, _plan_q, _plan_q_rows, _sm_count,
    gather_runs, slice_gate, slice_gate_plain, slice_scatter, slice_scatter_plain, sweep_pass,
    sweep_pass_plain, sweep_scatter, sweep_scatter_plain, window_gather, window_gather_plain,
    window_join)

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_kernel_cases import (  # noqa: E402
    CHIPS, CHUNK_SAMPLES, CPS, DRYRUN_CHIPS, DUMP_SAMPLES, MIXED, SAMPLES, SLICES,
    WINDOW_CHUNKS, XL_CHIPS, XL_SLICES, f32_expected_design, gate_fleet, join_fleet,
    mixed_sizes, launch_counts, rows_taken, scatter_fleets, seeded_fleet)

SCALAR_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA data sheet)
# Scalar operations per (chip, sample): f32 pass -- per array a flush
# (abs, compare, select), the validity select and the max, plus the OR of
# has_data; int8 pass -- one widening max per array.
OPS_PER_SAMPLE = {"chip_pass": 11, "chip_pass_q": 2}
REPLACES = {
    "chip_pass": "tpu_pruner/policy/pallas_engine.py:33",
    "chip_pass_q": "tpu_pruner/policy/pallas_engine.py:104",
}
SOURCE = "tpu_pruner_torch/policy/csrc/chip_pass.cu"
KERNEL_SYMBOLS = {"chip_pass_q": "chip_pass_q_kernel",
                  f"chip_pass_q, row design, T={WINDOW_CHUNKS}":
                  f"chip_pass_q_rows_kernelILi{WINDOW_CHUNKS}E",
                  "slice_gate, int32 bounds": "slice_gate_kernelIiE",
                  "slice_scatter marks, int32 ids": "slice_marks_kernelIiE",
                  "slice_scatter marks, int64 ids": "slice_marks_kernelIlE",
                  "slice_scatter verdicts": "slice_verdict_kernel",
                  "window_gather, 4-byte words": "window_gather_kernelIjE",
                  "window_gather, bytes": "window_gather_kernelIhE",
                  "window_join, build": "join_build_kernel",
                  "window_join, probe": "join_probe_kernel",
                  "window_join, compaction": "join_compact_kernel",
                  "sweep_pass": "sweep_pass_kernel",
                  "sweep_scatter marks, int32 ids": "sweep_marks_kernelIiE",
                  "sweep_scatter marks, int64 ids": "sweep_marks_kernelIlE",
                  "sweep_scatter slices": "sweep_slices_kernel",
                  "sweep_scatter chips, int32 ids": "sweep_chips_kernelIiE"}
# templated kernels: name -> (symbol pattern, the instantiations the plan uses)
INSTANTIATIONS = {
    "chip_pass_q, row design, T": (r"chip_pass_q_rows_kernelILi(\d+)E", _Q_ROWS_T),
    "chip_pass, group design, samples a lane": (r"chip_pass_groups_kernelILi(\d+)E",
                                                _F32_GROUPS_K),
    "chip_pass, long-row design, samples a lane a chunk": (r"chip_pass_long_kernelILi(\d+)E",
                                                           _F32_LONG_K),
}
FLUSH_BYTES = 256 * 2**20  # > 5x the H100's 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def mask_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item()) if a.numel() else 0


def time_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median device time of fn over reps launches, queued behind a stall so
    that host overhead does not leak into the events. With flush, the buffer
    is zeroed before each launch, outside its event pair, so the launch finds
    none of its inputs in L2."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3  # host time to queue one call
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    # keep the card busy while the launches queue: at least twice the host
    # time of the whole queue, in cycles at up to 2 GHz
    torch.cuda._sleep(int(max(5e7, 4e9 * host_s * reps)))
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def graph_of(fn) -> torch.cuda.CUDAGraph:
    """fn captured as a CUDA graph, after warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def end_to_end_ms(name: str, fn, flush: torch.Tensor) -> dict:
    """Device time of one call of fn, warm and cold, from replays of a CUDA
    graph of it, and its eager host wall time per call. A call is a dozen
    small launches, so queued eager calls run at the host's pace."""
    graph = graph_of(fn)
    warm, cold = time_ms(graph.replay, 200), time_ms(graph.replay, 200, flush)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 50 * 1e3
    log(f"phase 4: {name} end to end: device {warm:.4f} ms warm, {cold:.4f} ms cold "
        f"(CUDA graph replay); eager host wall {wall:.4f} ms per call")
    return {"ms": warm, "ms_cold": cold, "wall_ms": wall}



def engine_launches() -> dict:
    """launch_counts of evaluate_fleet_c, _qc and _qu on the main path's
    fleet, for whichever engine ``tpu_pruner_torch`` resolves to. Phase 4
    counts this checkout's; to count another commit's in the same call, load
    this file with that checkout first on sys.path and call this function."""
    dev = torch.device("cuda")
    _build.build()
    inputs, _ = make_example_fleet(CHIPS, SAMPLES, SLICES, idle_fraction=0.5, seed=0,
                                   device=dev)
    q = quantize_fleet_inputs(inputs)
    bounds = slice_bounds(inputs[4], SLICES, device=dev)
    at = f"{CHIPS}x{SAMPLES}"
    return {
        "evaluate_fleet_c": launch_counts(f"{at} evaluate_fleet_c", lambda: evaluate_fleet_c(
            *inputs[:4], bounds, inputs[5])),
        "evaluate_fleet_qc": launch_counts(f"{at} evaluate_fleet_qc", lambda: evaluate_fleet_qc(
            q[0], q[1], q[2], bounds, q[4])),
        "evaluate_fleet_qu": launch_counts(f"{at} evaluate_fleet_qu", lambda: evaluate_fleet_qu(
            q[0], q[1], q[2], q[4], CPS)),
    }


def phase_timing(inputs, q, num_slices: int, flush: torch.Tensor):
    """Phase 4 on one fleet: each kernel warm, cold and plain against its
    bound, the int8 kernel at T = 12, and the end-to-end paths. Returns
    ({kernel: row}, {path: times})."""
    tc, hbm, valid, age, slice_id, parr = inputs
    tc_q, hbm_q = q[0], q[1]
    parr_q = q[4]
    C, T = tc.shape
    cps = C // num_slices
    at = f"{C}x{T}"
    work = {
        "chip_pass": (lambda: chip_pass(tc, hbm, valid, age, parr),
                      lambda: chip_pass_plain(tc, hbm, valid, age, parr),
                      sum(x.nbytes for x in (tc, hbm, valid, age, parr)) + C),
        "chip_pass_q": (lambda: chip_pass_q(tc_q, hbm_q, age, parr_q),
                        lambda: chip_pass_q_plain(tc_q, hbm_q, age, parr_q),
                        sum(x.nbytes for x in (tc_q, hbm_q, age, parr_q)) + C),
    }
    rows = {}
    for name, (kernel, plain, nbytes) in work.items():
        err = mask_err(kernel(), plain())
        check(err == 0, f"{at} {name} differs from its plain version")
        bound_ms, bound_by = bound_ms_of(name, nbytes, C, T)
        ms = time_ms(kernel, 200)
        ms_cold = time_ms(kernel, 200, flush)
        plain_ms = time_ms(plain, 20)
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "max_abs_err": err, "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bytes": nbytes,
        }
        log(f"phase 4: {at} {name}: kernel {ms:.4f} ms warm, {ms_cold:.4f} ms cold, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes; "
            f"{bound_ms / ms:.3f} of the bound warm, {bound_ms / ms_cold:.3f} cold)")
    # the f32 pass in each design that takes these rows: the plan's, and at
    # short rows the long-row design beside it as the control, in the same run
    f32_args = (tc, hbm, valid, age, parr)
    rows["chip_pass"]["designs"] = f32_design_times(f32_args, flush)
    log_f32_designs(at, rows["chip_pass"]["designs"], f32_expected_design(C, T),
                    rows["chip_pass"]["bound_ms"], rows["chip_pass"]["bytes"])

    # the streaming window's shape: a full ring of 12 chunk maxima per chip,
    # both designs of the int8 pass, also on the dry run's 32,768 rows a rank
    tc_new, hbm_new = tc_q[:, :CHUNK_SAMPLES].contiguous(), hbm_q[:, :CHUNK_SAMPLES].contiguous()
    state = init_window(C, WINDOW_CHUNKS, device=tc.device)
    for _ in range(WINDOW_CHUNKS):
        state = update_window_(state, tc_new, hbm_new)
    for n in (C, DRYRUN_CHIPS) if C == CHIPS else (C,):
        rows["chip_pass_q"]["window" if n == C else f"window_{n}"] = window_timing(
            (state[0][:n], state[1][:n], age[:n], parr_q), flush)

    bounds = slice_bounds(slice_id, num_slices, device=tc.device)
    e2e = {
        "evaluate_fleet": lambda: evaluate_fleet(tc, hbm, valid, age, slice_id, parr,
                                                 num_slices=num_slices),
        "evaluate_fleet_c": lambda: evaluate_fleet_c(tc, hbm, valid, age, bounds, parr),
        "evaluate_fleet_qc": lambda: evaluate_fleet_qc(tc_q, hbm_q, age, bounds, parr_q),
        "evaluate_fleet_qu": lambda: evaluate_fleet_qu(tc_q, hbm_q, age, parr_q, cps),
    }
    # one cycle's work; the cursor does not advance between timed calls. The
    # in-place form writes the timed state's rings, the functional form
    # copies them first (2*C*K bytes).
    for update in (update_window_, update_window):
        e2e[f"streaming cycle, {update.__name__} + evaluate_window_qc"] = (
            lambda update=update: evaluate_window_qc(update(state, tc_new, hbm_new), age,
                                                     bounds, parr_q))
        e2e[f"streaming cycle, {update.__name__} + evaluate_window_qu"] = (
            lambda update=update: evaluate_window_qu(update(state, tc_new, hbm_new), age,
                                                     parr_q, cps))
    end_to_end = {name: end_to_end_ms(f"{at} {name}", fn, flush) for name, fn in e2e.items()}
    # the slice gate on this fleet's int8 candidate (half the slices idle)
    candidate = chip_pass_q(tc_q, hbm_q, age, parr_q)
    rows["slice_gate"] = gate_timing(f"{at} in {num_slices} slices", candidate, bounds, flush)
    for name in ("evaluate_fleet", "evaluate_fleet_c", "evaluate_fleet_qc", "evaluate_fleet_qu",
                 "streaming cycle, update_window_ + evaluate_window_qc",
                 "streaming cycle, update_window_ + evaluate_window_qu"):
        end_to_end[name]["device_ops"] = launch_counts(f"{at} {name}", e2e[name])
    amax_ms = time_ms(lambda: torch.amax(tc, 1), 50)
    log(f"context (not a port of either kernel): {at} torch.amax(tc, 1) {amax_ms:.4f} ms")
    return rows, end_to_end


def design_times(args, flush: torch.Tensor) -> dict:
    """Warm and cold times of each design of tp_chip_pass_q on args (tc_q,
    hbm_q, age, params_q: CUDA tensors on 16-byte boundaries), each first
    held against the plain version; the row design where it has a kernel."""
    C, T = args[0].shape
    sm = _sm_count(args[0].device)
    plans = {"tiles": _plan_q(C, T, sm)}
    if T in _Q_ROWS_T:
        plans["rows"] = _plan_q_rows(C, T)
    want = chip_pass_q_plain(*args)
    times = {}
    for design, plan in plans.items():
        check(torch.equal(_launch_q(*args, plan).view(torch.bool), want),
              f"the {design} design differs from the plain version at {C}x{T}")
        times[design] = {"ms": time_ms(lambda plan=plan: _launch_q(*args, plan), 200),
                         "ms_cold": time_ms(lambda plan=plan: _launch_q(*args, plan), 200, flush),
                         "plan": plan._asdict()}
    return times


def window_timing(args, flush: torch.Tensor) -> dict:
    """chip_pass_q on a window ring: both designs warm and cold against the
    bound, the plain version, and which design the plan takes."""
    C, T = args[0].shape
    nbytes = sum(x.nbytes for x in args) + C
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    plan = _choose_plan_q(C, T, _sm_count(args[0].device), aligned=True)
    chosen = "rows" if isinstance(plan, PlanRows) else "tiles"
    designs = design_times(args, flush)
    plain_ms = time_ms(lambda: chip_pass_q_plain(*args), 20)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)  # an empty kernel, timed alike
    for design, t in designs.items():
        log(f"phase 4: {C}x{T} chip_pass_q, {design} design"
            f"{' (the plan)' if design == chosen else ''}: {t['ms']:.4f} ms warm, "
            f"{t['ms_cold']:.4f} ms cold, bound {bound:.4f} ms ({nbytes} bytes; "
            f"{bound / t['ms']:.3f} of the bound warm, {bound / t['ms_cold']:.3f} cold); "
            f"plan {t['plan']}")
    log(f"phase 4: {C}x{T} chip_pass_q plain {plain_ms:.4f} ms; an empty kernel "
        f"{floor_ms:.4f} ms")
    return {"T": T, "design": chosen, "ms": designs[chosen]["ms"],
            "ms_cold": designs[chosen]["ms_cold"], "plain_ms": plain_ms, "bound_ms": bound,
            "bytes": nbytes, "launch_floor_ms": floor_ms, "plan": plan._asdict(),
            "designs": designs}


def design_sweep(dev, C: int, flush: torch.Tensor) -> dict:
    """Both designs of tp_chip_pass_q at C chips for each T that has a row
    kernel, warm and cold, on seeded samples drawn on the card; and the
    shapes where the plan takes the row design and it was not the faster."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(C)
    age = torch.full((C,), 7200.0, device=dev)
    params_q = torch.tensor([2100.0, 1.0], device=dev)
    by_t = {}
    for T in sorted(_Q_ROWS_T):
        tc = torch.randint(-1, 3, (C, T), generator=gen, device=dev).to(torch.int8)
        hbm = torch.randint(-1, 2, (C, T), generator=gen, device=dev).to(torch.int8)
        by_t[T] = {d: [t["ms"], t["ms_cold"]]
                   for d, t in design_times((tc, hbm, age, params_q), flush).items()}
        del tc, hbm
    slower = {when: [T for T in by_t if rows_taken(C, T)
                     and by_t[T]["rows"][i] >= by_t[T]["tiles"][i]]
              for i, when in enumerate(("warm", "cold"))}
    log(f"phase 4: {C} chips, chip_pass_q by T, ms warm/cold: " + "; ".join(
        f"T={T} " + ", ".join(f"{d} {w:.4f}/{c:.4f}" for d, (w, c) in t.items())
        for T, t in by_t.items()))
    log(f"phase 4: {C} chips: the plan takes the row design at T in "
        f"{[T for T in by_t if rows_taken(C, T)]}; of these it was not the faster at "
        f"{slower}")
    return {"by_T": by_t, "rows_not_faster_where_taken": slower}



def bound_ms_of(name: str, nbytes: int, C: int, T: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the scalar operations over the f32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_SAMPLE[name] * C * T / SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def f32_design_times(args, flush: torch.Tensor, other_k: bool = False) -> dict:
    """Warm and cold times of each design of the f32 pass that takes args'
    rows (tc, hbm, valid, age, params: CUDA tensors), each first held
    against the plain version; with other_k, where the plan takes the
    long-row design, also at the samples a lane that it does not take
    ("long, K=...")."""
    C, T = args[0].shape
    want = chip_pass_plain(*args)
    plans = _f32_plans(C, T)
    if other_k and f32_expected_design(C, T) == "long":
        k = min(_F32_LONG_K - {plans["long"].samples_per_lane})
        plans[f"long, K={k}"] = PlanLong(k, plans["long"].grid)
    times = {}
    for design, plan in plans.items():
        check(torch.equal(_launch_f32(*args, plan).view(torch.bool), want),
              f"the f32 {design} design differs from the plain version at {C}x{T}")
        times[design] = {
            "ms": time_ms(lambda plan=plan: _launch_f32(*args, plan), 200),
            "ms_cold": time_ms(lambda plan=plan: _launch_f32(*args, plan), 200, flush),
            "plan": plan._asdict()}
    return times


def f32_timing_t(C: int) -> tuple:
    """The row lengths of phase 4's f32 sweep at C chips: short rows for the
    group design, long rows for the long-row design; at 1,048,576 chips up
    to 720 samples (6.8 GB of inputs), at 131,072 also 2,880."""
    short = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 24, 32, 33, 48, 64, 96, 128, 192, 256)
    long = (300, 360, 384, 512, 720) + ((1024,) if C < XL_CHIPS else ())
    return short + long + ((2880,) if C == CHIPS else ())


def f32_design_sweep(dev, C: int, flush: torch.Tensor) -> dict:
    """Every design of the f32 pass at C chips for each T of
    f32_timing_t(C), warm and cold, on seeded_fleet's rows (the long-row
    design also at its other samples a lane above the group design's rows);
    and the shapes where the
    plan's design was not the fastest of the designs."""
    by_t = {}
    for T in f32_timing_t(C):
        inputs, _ = seeded_fleet(dev, C, T, C // CPS, cut=True)
        by_t[T] = {d: [t["ms"], t["ms_cold"]] for d, t in
                   f32_design_times((*inputs[:4], inputs[5]), flush, other_k=True).items()}
        del inputs
        torch.cuda.empty_cache()
    slower = {when: [T for T, t in by_t.items()
                     if min(x[i] for d, x in t.items() if d in F32_DESIGNS.values())
                     < t[f32_expected_design(C, T)][i]]
              for i, when in enumerate(("warm", "cold"))}
    log(f"phase 4: {C} chips, chip_pass by T, ms warm/cold: " + "; ".join(
        f"T={T} " + ", ".join(f"{d} {w:.4f}/{c:.4f}" for d, (w, c) in t.items())
        for T, t in by_t.items()))
    log(f"phase 4: {C} chips: the plan's design was not the fastest at {slower}")
    return {"by_T": by_t, "plan_not_fastest": slower}


def log_f32_designs(at: str, designs: dict, chosen: str, bound: float, nbytes: int) -> None:
    """One line a design of f32_design_times: its times and share of the bound."""
    for design, t in designs.items():
        log(f"phase 4: {at} chip_pass, {design} design"
            f"{' (the plan)' if design == chosen else ''}: {t['ms']:.4f} ms warm, "
            f"{t['ms_cold']:.4f} ms cold, bound {bound:.4f} ms ({nbytes} bytes; "
            f"{bound / t['ms']:.3f} of the bound warm, {bound / t['ms_cold']:.3f} cold); "
            f"plan {t['plan']}")


GATE_REPLACES = ("tpu_pruner/policy/engine.py:233 (slice_verdicts_contiguous: no Pallas kernel; "
                 "the cumsum and gather XLA fuses into the jitted evaluate_fleet_c and _qc)")


def gate_bytes(candidate, bounds) -> int:
    """The bytes the slice gate must move on these inputs: the bounds read
    once, the verdicts written once, and of each slice whose difference is
    positive the chips it must read: every chip of an idle slice, one of a
    busy slice (the data decides how many a kernel that stops at the first
    busy chip needs)."""
    n = candidate.numel() + 1
    at = bounds.long().clamp(-n, n - 1)
    at = torch.where(at < 0, at + n, at)
    span = (at[1:] - at[:-1]).abs()
    open_ = (bounds[1:] - bounds[:-1]).to(torch.int32) > 0
    need = torch.where(slice_gate_plain(candidate, bounds), span, (span > 0).long())
    return bounds.nbytes + (bounds.numel() - 1) + int(need[open_].sum())


def time_fn(fn, flush: torch.Tensor | None = None) -> float:
    """time_ms with 200 launches, or 20 where one launch takes over 1 ms."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    fn()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return time_ms(fn, 200 if t0.elapsed_time(t1) < 1.0 else 20, flush)


def gate_timing(what: str, candidate, bounds, flush: torch.Tensor) -> dict:
    """The slice gate on (candidate, bounds), first held against the plain
    version: warm and cold beside the plain version, an empty kernel and
    the bound."""
    C, S = candidate.numel(), bounds.numel() - 1
    check(torch.equal(slice_gate(candidate, bounds), slice_gate_plain(candidate, bounds)),
          f"slice gate differs from the plain version at {what}")
    ms = time_fn(lambda: slice_gate(candidate, bounds))
    ms_cold = time_fn(lambda: slice_gate(candidate, bounds), flush)
    nbytes = gate_bytes(candidate, bounds)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    plain_ms = time_fn(lambda: slice_gate_plain(candidate, bounds))
    plain_cold = time_fn(lambda: slice_gate_plain(candidate, bounds), flush)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)  # an empty kernel, timed alike
    log(f"phase 4: {what}: slice_gate {ms:.4f} ms warm, {ms_cold:.4f} ms cold, bound "
        f"{bound:.5f} ms ({nbytes} bytes); plain {plain_ms:.4f} ms warm, {plain_cold:.4f} ms "
        f"cold; an empty kernel {floor_ms:.4f} ms")
    return {"name": "slice_gate", "route": "cuda", "source": SOURCE, "replaces": GATE_REPLACES,
            "pallas_counterpart": None, "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms,
            "plain_ms_cold": plain_cold, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "bytes": nbytes, "launch_floor_ms": floor_ms, "chips": C,
            "slices": S, "max_abs_err": 0}


def gate_fleets(dev, flush: torch.Tensor) -> dict:
    """Phase 4's slice gate beyond the main path's fleets: one slice of
    1,048,576 chips, all idle, so every chip is read; 1,048,576 slices of
    one chip, every other busy; the mixed fleets (16-chip slices and one
    each of 4,096, 8,960 and 65,536 chips, half the slices idle) at 131,072
    and 1,048,576 chips; then the average slice length swept at 131,072 and
    1,048,576 chips, all idle. Where the gate was slower than the plain
    version, warm or cold, is logged and recorded."""
    out = {}
    idle = torch.ones(XL_CHIPS, dtype=torch.bool, device=dev)
    one = torch.tensor([0, XL_CHIPS], dtype=torch.int32, device=dev)
    out["one slice"] = gate_timing(f"one slice of {XL_CHIPS} chips, all idle", idle, one, flush)
    alternate = torch.arange(XL_CHIPS, device=dev) % 2 == 0
    each = torch.arange(XL_CHIPS + 1, dtype=torch.int32, device=dev)
    out["1-chip slices"] = gate_timing(f"{XL_CHIPS} slices of 1 chip", alternate, each, flush)
    rng = np.random.default_rng(4242)
    for C in (CHIPS, XL_CHIPS):
        cand, bounds = gate_fleet(rng, mixed_sizes(C))
        out[f"mixed {C}"] = gate_timing(f"{C} chips, {MIXED}",
                                        torch.from_numpy(cand).to(dev),
                                        torch.from_numpy(bounds).to(dev), flush)
    sweep = {}
    for C, counts in ((CHIPS, (1, 8, 64, 512, 2048, 8192, 32768, CHIPS)),
                      (XL_CHIPS, (1, 16, 128, 1024, 4096, 16384, XL_SLICES, 262144, XL_CHIPS))):
        cand = torch.ones(C, dtype=torch.bool, device=dev)
        for S in counts:
            bounds = (torch.arange(S + 1, device=dev) * C // S).to(torch.int32)
            t = gate_timing(f"{C} chips in {S} slices, all idle", cand, bounds, flush)
            sweep[f"{C}/{S}"] = [t["ms"], t["ms_cold"], t["plain_ms"], t["plain_ms_cold"]]
    slower = [k for k, t in {**{k: [v["ms"], v["ms_cold"], v["plain_ms"], v["plain_ms_cold"]]
                                for k, v in out.items()}, **sweep}.items()
              if t[0] > t[2] or t[1] > t[3]]
    log(f"phase 4: slice_gate slower than its plain version at {slower}")
    out["sweep"] = {"by_fleet": sweep, "slower_than_plain": slower}
    return out


SCATTER_REPLACES = ("tpu_pruner/policy/engine.py:73 (slice_verdicts: no Pallas kernel; the two "
                    "segment_sum XLA lowers to a scatter-add in the jitted evaluate_fleet and _q)")


def scatter_timing(what: str, candidate, ids, num_slices: int, flush: torch.Tensor) -> dict:
    """The scatter reduction on (candidate, ids), first held against the
    plain version: one call (a memset and two kernels) warm and cold beside
    the plain version, an empty kernel and the bound, which counts the
    candidates and ids read once and the verdicts written once."""
    C, S = candidate.numel(), num_slices
    check(torch.equal(slice_scatter(candidate, ids, S), slice_scatter_plain(candidate, ids, S)),
          f"slice_scatter differs from the plain version at {what}")
    ms = time_fn(lambda: slice_scatter(candidate, ids, S))
    ms_cold = time_fn(lambda: slice_scatter(candidate, ids, S), flush)
    nbytes = candidate.nbytes + ids.nbytes + S
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    plain_ms = time_fn(lambda: slice_scatter_plain(candidate, ids, S))
    plain_cold = time_fn(lambda: slice_scatter_plain(candidate, ids, S), flush)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)  # an empty kernel, timed alike
    log(f"phase 4: {what}: slice_scatter {ms:.4f} ms warm, {ms_cold:.4f} ms cold, bound "
        f"{bound:.5f} ms ({nbytes} bytes, {bound / ms:.3f} of it warm); plain {plain_ms:.4f} "
        f"ms warm, {plain_cold:.4f} ms cold; an empty kernel {floor_ms:.4f} ms")
    return {"name": "slice_scatter", "route": "cuda", "source": SOURCE,
            "replaces": SCATTER_REPLACES, "pallas_counterpart": None, "ms": ms,
            "ms_cold": ms_cold, "plain_ms": plain_ms, "plain_ms_cold": plain_cold,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None, "bytes": nbytes,
            "launch_floor_ms": floor_ms, "chips": C, "slices": S, "max_abs_err": 0}


def scatter_rows(dev, flush: torch.Tensor) -> dict:
    """Phase 4's scatter reduction at each shape of scatter_fleets."""
    rows = {}
    for name, (cand, ids, S) in scatter_fleets(np.random.default_rng(8642)).items():
        rows[name] = scatter_timing(name, torch.from_numpy(cand).to(dev),
                                    torch.from_numpy(ids).to(dev), S, flush)
    return rows


GATHER_REPLACES = ("none: the reference starts its window over when the fleet changes "
                   "(tpu_pruner/analyze.py:194); engine.rekey_window carries the rows instead")


def gather_timing(what: str, rings, gather, flush: torch.Tensor) -> dict:
    """The row gather of both rings by a row index (``gather``), first held
    against the plain version, which moves them by the index's runs: warm
    and cold beside the plain version, an empty kernel and the bound, which
    counts the index and the carried rows read once and both rings written
    once."""
    rows, chunks = gather.numel(), rings[0].shape[1]
    index = gather.to(torch.int32)
    runs = torch.from_numpy(gather_runs(gather.cpu().numpy())).to(gather.device)
    check(all(torch.equal(a, b) for a, b in zip(window_gather(*rings, index),
                                                window_gather_plain(*rings, runs, rows))),
          f"window_gather differs from the plain version at {what}")
    ms = time_fn(lambda: window_gather(*rings, index))
    ms_cold = time_fn(lambda: window_gather(*rings, index), flush)
    carried = int((gather >= 0).sum())
    nbytes = index.nbytes + 2 * carried * chunks + 2 * rows * chunks
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    plain_ms = time_fn(lambda: window_gather_plain(*rings, runs, rows))
    plain_cold = time_fn(lambda: window_gather_plain(*rings, runs, rows), flush)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)  # an empty kernel, timed alike
    log(f"phase 4: {what}: window_gather {ms:.4f} ms warm, {ms_cold:.4f} ms cold, bound "
        f"{bound:.5f} ms ({nbytes} bytes, {bound / ms:.3f} of it warm); plain {plain_ms:.4f} "
        f"ms warm, {plain_cold:.4f} ms cold; an empty kernel {floor_ms:.4f} ms")
    return {"name": "window_gather", "route": "cuda", "source": SOURCE,
            "replaces": GATHER_REPLACES, "pallas_counterpart": None, "ms": ms,
            "ms_cold": ms_cold, "plain_ms": plain_ms, "plain_ms_cold": plain_cold,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None, "bytes": nbytes,
            "launch_floor_ms": floor_ms, "rows": rows, "carried": carried,
            "runs": runs.shape[1], "chunks": chunks, "max_abs_err": 0}


def gather_rows(dev, flush: torch.Tensor) -> dict:
    """Phase 4's row gather: K = 12 rings, rows new at random places and
    the carried rows moved (each a few places on, as a fleet's changes shift
    them), at the churn cell's shape (3,000 new rows in 1,500 places, about
    3,000 runs), its burst (50,944 new rows in one run) and 1,048,576 rows."""
    g = torch.Generator(device=dev)
    g.manual_seed(9753)
    out = {}
    for what, rows, places, new in (
            ("263,000 rows, 3,000 new", 263_000, 1_500, 2),
            ("263,000 rows, 50,944 new (the burst)", 263_000, 1, 50_944),
            ("1,048,576 rows, 12,000 new", 1_048_576, 6_000, 2)):
        rings = tuple(torch.randint(-1, 101, (rows, WINDOW_CHUNKS), generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
        gather = (torch.arange(rows, device=dev) + 4) % rows
        at = torch.randperm(rows - new, generator=g, device=dev)[:places]
        gather[(at[:, None] + torch.arange(new, device=dev)).view(-1)] = -1
        out[what] = gather_timing(what, rings, gather, flush)
    return out


JOIN_REPLACES = ("none: the reference starts its window over when the fleet changes "
                 "(tpu_pruner/analyze.py:194); on the card's path it replaces the host's "
                 "join, tp_rekey in tpu_pruner_torch/csrc/window_keys.cpp")


def host_ms(fn, reps: int = 30) -> float:
    """Median host wall time of fn (which ends in its own wait, if any) over
    reps calls, after one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def join_timing(what: str, dev, rows, keys, cycle: int, K: int, flush: torch.Tensor) -> dict:
    """The window's key join on the card (one call: the keys' copy up from
    pinned memory, a memset and three kernels) at one shape, first held
    against the plain version (the kept rows, the counts, the keys left on
    the card and the row index's runs): warm and cold beside an empty kernel
    and the bound; the host's joins it replaces (the native join and the
    plain version, on the host's clock); and rekey_window on the card on the
    host's clock, from the rows' keys on the card, with its wait and its
    gather, beside the keys' upload alone, pageable and through pinned
    memory, with its device operations."""
    R, C = len(rows.keys) + len(rows.kept_keys), len(keys)
    on_card = CardRows(torch.from_numpy(np.concatenate([rows.keys, rows.kept_keys,
                                                        rows.kept_seen])).to(dev),
                       len(rows.keys), len(rows.kept_keys), R)
    runs, kept_keys, kept_seen, counts = rekey_plain(rows, keys, cycle, K)
    kept = len(kept_keys)

    def join():
        return window_join(on_card, keys, rows.cycle, cycle, K)

    joined = join()
    torch.cuda.synchronize()
    host = joined.host.numpy()
    check(int(host[0]) == 0 and tuple(int(x) for x in host[1:5]) == counts
          and np.array_equal(host[JOIN_COUNTS:JOIN_COUNTS + kept], kept_keys)
          and np.array_equal(host[JOIN_COUNTS + R:JOIN_COUNTS + R + kept], kept_seen)
          and np.array_equal(joined.keys[:C].cpu().numpy(), keys)
          and np.array_equal(joined.keys[C:C + kept].cpu().numpy(), kept_keys)
          and np.array_equal(joined.keys[C + R:C + R + kept].cpu().numpy(), kept_seen)
          and np.array_equal(gather_runs(joined.index[:C + kept].cpu().numpy()), runs),
          f"window_join differs from the plain version at {what}")
    ms = time_fn(join)
    ms_cold = time_fn(join, flush)
    # the keys and kept rows' cycles read once, this cycle's keys, the index
    # and the kept rows written once (the keys and kept rows on the card,
    # the kept rows and counts on the host)
    nbytes = (8 * (R + len(rows.kept_seen) + C) + 8 * C + 4 * (C + kept) + 2 * 16 * kept
              + 8 * JOIN_COUNTS)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    native_ms = host_ms(lambda: _rekey_native(rows, keys, cycle, K))
    plain_ms = host_ms(lambda: rekey_plain(rows, keys, cycle, K), 10)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)  # an empty kernel, timed alike
    g = torch.Generator(device=dev)
    g.manual_seed(R)
    state = (*(torch.randint(-1, 101, (R, K), generator=g, device=dev, dtype=torch.int8)
               for _ in range(2)), torch.zeros((), dtype=torch.int32, device=dev))
    on_rows = rows._replace(on_card=on_card)  # the rows' keys on the card, as a cycle finds them

    def carry():
        rekey_window(state, on_rows, keys, cycle)
        torch.cuda.synchronize()

    carry_ms = host_ms(carry)
    upload_ms = host_ms(lambda: (torch.from_numpy(keys).to(dev), torch.cuda.synchronize()))
    pinned = torch.from_numpy(keys).pin_memory()
    pinned_ms = host_ms(lambda: (pinned.numpy().__setitem__(slice(None), keys),
                                 pinned.to(dev, non_blocking=True), torch.cuda.synchronize()))
    ops = launch_counts(f"{what}: rekey_window", carry)
    log(f"phase 4: {what}: window_join {ms:.4f} ms warm, {ms_cold:.4f} ms cold, bound "
        f"{bound:.5f} ms ({nbytes} bytes, {bound / ms:.3f} of it warm); an empty kernel "
        f"{floor_ms:.4f} ms; on the host: the native join {native_ms:.4f} ms, the plain "
        f"version {plain_ms:.4f} ms; rekey_window on the card {carry_ms:.4f} ms on the host's "
        f"clock; the keys' upload alone {upload_ms:.4f} ms pageable, {pinned_ms:.4f} ms through "
        f"pinned memory ({kept} rows kept, {counts[0]} new, {counts[3]} moved)")
    return {"name": "window_join", "route": "cuda", "source": SOURCE,
            "replaces": JOIN_REPLACES, "pallas_counterpart": None, "ms": ms,
            "ms_cold": ms_cold, "plain_ms": plain_ms, "plain_ms_cold": None,
            "plain_on": "host", "native_ms": native_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "bytes": nbytes,
            "launch_floor_ms": floor_ms, "rekey_window_ms": carry_ms,
            "upload_ms": upload_ms, "pinned_upload_ms": pinned_ms, "device_ops": ops,
            "rows": R, "chips": C, "kept": kept, "counts": counts, "max_abs_err": 0}


def join_rows(dev, flush: torch.Tensor) -> dict:
    """Phase 4's key join (join_fleet): the churn cell's shape (263,000
    rows, 260,000 chips, 3,000 of them new in 1,500 places), its burst
    (50,944 new in one run) and 1,048,576 rows."""
    rng = np.random.default_rng(8642)
    out = {}
    for what, shape in (
            ("263,000 rows, 260,000 chips, 3,000 new", (263_000, 6_000, 1_000, 1_000, 3_000,
                                                        1_500)),
            ("263,000 rows, 50,944 new (the burst)", (263_000, 6_000, 50_944, 1_000, 50_944,
                                                      1)),
            ("1,048,576 rows, 12,000 new", (1_048_576, 24_576, 4_000, 4_000, 12_000, 6_000))):
        out[what] = join_timing(what, dev, *join_fleet(rng, *shape), flush)
    return out


SWEEP_REPLACES = ("none: the reference judges one policy a call (evaluate_fleet); "
                  "engine.evaluate_fleet_sweep judges a grid of up to 64 in one pass")


def sweep_fleets() -> dict:
    """name -> (configuration, durations in minutes, thresholds) of phase 4's
    sweeps: the sweep cell's cluster under its grid and under one policy,
    and 1,048,576 chips x 360 samples in 65,536 groups of 16 under 64."""
    root = Path(__file__).resolve().parent / "port_bench"
    cell = json.loads((root / "configs" / "gke-65k-policy-sweep.json").read_text())
    xl = dict(cell, chips=XL_CHIPS, slices=XL_SLICES, groups=[[XL_SLICES, XL_CHIPS // XL_SLICES]],
              window_samples=SAMPLES, durations_min=[45 * k for k in range(1, 9)])
    return {
        f"{cell['chips']}x{cell['window_samples']}, P=64": (
            cell, cell["durations_min"], cell["hbm_thresholds"]),
        f"{cell['chips']}x{cell['window_samples']}, P=1": (
            cell, [cell["window_samples"]], [0.05]),
        f"{XL_CHIPS}x{SAMPLES}, P=64": (xl, xl["durations_min"], cell["hbm_thresholds"]),
    }


def sweep_rows(dev, flush: torch.Tensor) -> dict:
    """Phase 4's policy sweep at each shape of sweep_fleets: {name: {"sweep_pass": row,
    "sweep_scatter": row}}, and evaluate_fleet_sweep's and the one-policy
    path's times on each pass row."""
    root = Path(__file__).resolve().parent / "port_bench"
    mix = json.loads((root / "traffic" / "sweep-d8h8.json").read_text())
    rows, drawn = {}, None
    for name, (cfg, minutes, thresholds) in sweep_fleets().items():
        C, S, T = cfg["chips"], cfg["slices"], cfg["window_samples"]
        if drawn is None or drawn[0] is not cfg:
            drawn = None
            torch.cuda.empty_cache()
            fleet = sweep.make_fleet(cfg, mix, 2**31 + 2513, dev)
            g = gen.generator(2**31 + 2513, dev, 2)
            parts = [sweep.samples(fleet, mix, g, T, r0, min(C, r0 + 65536))
                     for r0 in range(0, C, 65536)]
            arrays = [torch.cat([p[k] for p in parts]) for k in range(3)]
            del parts
            drawn = (cfg, *arrays, fleet.age, fleet.slice_id)
        _, tc, hbm, valid, age, ids = drawn
        grid = sweep_grid([60.0 * m for m in minutes], thresholds, 300.0, 60.0, T)
        P, n_max = grid.num_policies, int(grid.samples.max())
        args = (grid.samples, grid.lookback_s, grid.cutoffs)
        masks = sweep_pass(tc, hbm, valid, age, *args)
        check(torch.equal(masks, sweep_pass_plain(tc, hbm, valid, age, *args)),
              f"sweep_pass differs from the plain version at {name}")
        got = sweep_scatter(masks, ids, S, P)
        want = sweep_scatter_plain(masks, ids, S, P)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"sweep_scatter differs from the plain version at {name}")
        pass_bytes = C * n_max * 9 + C * 4 + P * 12 + C * 8
        scatter_bytes = C * 8 + ids.nbytes + S * 8 + P * 16
        out = {}
        for kernel, fn, nbytes in (
                ("sweep_pass", lambda: sweep_pass(tc, hbm, valid, age, *args), pass_bytes),
                ("sweep_scatter", lambda: sweep_scatter(masks, ids, S, P), scatter_bytes)):
            ms, ms_cold = time_fn(fn), time_fn(fn, flush)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            out[kernel] = {"name": kernel, "route": "cuda", "source": SOURCE,
                           "replaces": SWEEP_REPLACES, "pallas_counterpart": None, "ms": ms,
                           "ms_cold": ms_cold, "bound_ms": bound, "bound_by": "bytes",
                           "library_ms": None, "bytes": nbytes, "chips": C, "samples": T,
                           "slices": S, "policies": P, "max_abs_err": 0}
            log(f"phase 4: {name}: {kernel} {ms:.4f} ms warm, {ms_cold:.4f} ms cold, bound "
                f"{bound:.4f} ms ({nbytes} bytes, {bound / ms:.3f} of it warm, "
                f"{bound / ms_cold:.3f} cold)")
        whole = lambda: evaluate_fleet_sweep(tc, hbm, valid, age, ids, grid, S)  # noqa: E731
        params = [params_array(PolicyParams(lookback_s=float(grid.lookback_s[p // len(thresholds)]),
                                            hbm_threshold=thresholds[p % len(thresholds)]),
                               device=dev) for p in range(P)]
        windows = [int(grid.samples[p // len(thresholds)]) for p in range(P)]

        def one_by_one():
            for n, parr in zip(windows, params):
                evaluate_fleet(tc[:, -n:], hbm[:, -n:], valid[:, -n:], age, ids, parr, S)

        total = work_sweep.sweep_bytes(C, n_max, S, P)
        out["sweep_pass"].update(
            whole_ms=time_fn(whole), whole_ms_cold=time_fn(whole, flush),
            whole_bound_ms=total / HBM_BYTES_PER_S * 1e3, whole_bytes=total,
            plain_ms=time_fn(one_by_one), plain_path="evaluate_fleet a policy, suffix views")
        r = out["sweep_pass"]
        log(f"phase 4: {name}: evaluate_fleet_sweep {r['whole_ms']:.4f} ms warm, "
            f"{r['whole_ms_cold']:.4f} ms cold (bound {r['whole_bound_ms']:.4f} ms, "
            f"{total} bytes); evaluate_fleet once a policy on suffix views {r['plain_ms']:.4f} ms")
        rows[name] = out
    del drawn
    torch.cuda.empty_cache()
    return rows


def phase_dump_width(dev, flush: torch.Tensor) -> dict:
    """Phase 4 at an audit dump's width, 8 samples a chip: the f32 pass in
    each design at 32,768, 131,072 and 1,048,576 chips, warm and cold, beside
    its bound, the plain version and an empty kernel; evaluate_fleet_c end
    to end at 131,072 chips; then the f32 design sweep by T."""
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)  # an empty kernel, timed alike
    rows = {}
    for C in (DRYRUN_CHIPS, CHIPS, XL_CHIPS):
        inputs, _ = seeded_fleet(dev, C, DUMP_SAMPLES, C // CPS, cut=True)
        args = (*inputs[:4], inputs[5])
        nbytes = sum(x.nbytes for x in args) + C
        bound, bound_by = bound_ms_of("chip_pass", nbytes, C, DUMP_SAMPLES)
        chosen = f32_expected_design(C, DUMP_SAMPLES)
        designs = f32_design_times(args, flush)
        plain_ms = time_ms(lambda: chip_pass_plain(*args), 20)
        at = f"{C}x{DUMP_SAMPLES}"
        log_f32_designs(at, designs, chosen, bound, nbytes)
        log(f"phase 4: {at} chip_pass plain {plain_ms:.4f} ms; an empty kernel {floor_ms:.4f} ms")
        rows[f"{C} chips"] = {
            "T": DUMP_SAMPLES, "design": chosen, "ms": designs[chosen]["ms"],
            "ms_cold": designs[chosen]["ms_cold"], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "bytes": nbytes, "launch_floor_ms": floor_ms,
            "designs": designs}
        if C == CHIPS:
            bounds = slice_bounds(inputs[4], C // CPS, device=dev)
            path = lambda: evaluate_fleet_c(*inputs[:4], bounds, inputs[5])  # noqa: E731
            rows[f"{C} chips"]["evaluate_fleet_c"] = end_to_end_ms(
                f"{at} evaluate_fleet_c", path, flush)
            rows[f"{C} chips"]["evaluate_fleet_c"]["device_ops"] = launch_counts(
                f"{at} evaluate_fleet_c", path)
        del inputs, args
    torch.cuda.empty_cache()
    rows["design_sweep"] = {C: f32_design_sweep(dev, C, flush)
                            for C in (DRYRUN_CHIPS, CHIPS, XL_CHIPS)}
    return rows


def phase_xl(dev, flush: torch.Tensor):
    """Phase 4 at bench.py's 1,048,576-chip point: the fleet built on the
    card (seeded_fleet), then phase_timing."""
    t0 = time.perf_counter()
    inputs, _ = seeded_fleet(dev, XL_CHIPS, SAMPLES, XL_SLICES)
    q = quantize_fleet_inputs(inputs)
    torch.cuda.synchronize()
    log(f"phase 4: {XL_CHIPS}x{SAMPLES} in {XL_SLICES} slices built on the card in "
        f"{time.perf_counter() - t0:.3f} s; {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB peak")
    return phase_timing(inputs, q, XL_SLICES, flush)


def ptxas_report(proc: subprocess.Popen) -> None:
    """Registers, shared memory and spills of each kernel, from nvcc -Xptxas -v."""
    out = proc.communicate()[0]
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{out}")
    lines = out.splitlines()
    for name, symbol in KERNEL_SYMBOLS.items():
        at = next((i for i, line in enumerate(lines)
                   if "Compiling entry function" in line and symbol in line), None)
        check(at is not None, f"ptxas reported nothing for {symbol}")
        info = [line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                if "spill" in line or "Used" in line]
        log(f"phase 1: {name}: {'; '.join(info)}")
    for name, (pattern, planned) in INSTANTIATIONS.items():
        regs, spilled = {}, []
        for i, line in enumerate(lines):
            m = re.search(pattern, line) if "Compiling entry function" in line else None
            if m:
                props = " ".join(lines[i + 1:i + 4])
                regs[int(m.group(1))] = int(re.search(r"Used (\d+) registers", props).group(1))
                if not re.search(r"0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                                 r"loads", props):
                    spilled.append(int(m.group(1)))
        check(sorted(regs) == sorted(planned),
              f"ptxas reported {name} in {sorted(regs)}, the plan has {sorted(planned)}")
        log(f"phase 1: {name} in {sorted(planned)}: {min(regs.values())}-"
            f"{max(regs.values())} registers (by instantiation: {regs}); stack frame or "
            f"spills at {sorted(spilled)}")



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS[:4], "-Xptxas", "-v", "-c",
         "-o", str(_build.BUILD_DIR / "ptxas_report.o"), str(_build.SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _build.build()
    except BaseException:
        ptxas.kill()  # leave no process behind
        ptxas.wait()
        raise
    log(f"phase 1: built {SOURCE} in {time.perf_counter() - t0:.3f} s")
    ptxas_report(ptxas)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    inputs, _ = make_example_fleet(CHIPS, SAMPLES, SLICES, idle_fraction=0.5, seed=0,
                                   device=dev)
    rows, end_to_end = phase_timing(inputs, quantize_fleet_inputs(inputs), SLICES, flush)
    del inputs
    xl_rows, xl_end_to_end = phase_xl(dev, flush)
    for name, row in rows.items():
        row["max_abs_err"] = max(row["max_abs_err"], xl_rows[name]["max_abs_err"])
        row["xl"] = {k: v for k, v in xl_rows[name].items()
                     if k not in ("name", "route", "source", "replaces", "library_ms")}
    del xl_rows
    torch.cuda.empty_cache()
    rows["chip_pass_q"]["design_sweep"] = {
        n: design_sweep(dev, n, flush) for n in (DRYRUN_CHIPS, CHIPS, XL_CHIPS)}
    rows["chip_pass"]["dump"] = phase_dump_width(dev, flush)
    rows["slice_gate"]["fleets"] = gate_fleets(dev, flush)
    scatter = scatter_rows(dev, flush)
    rows["slice_scatter"] = {**next(iter(scatter.values())), "fleets": scatter}
    gathers = gather_rows(dev, flush)
    rows["window_gather"] = {**next(iter(gathers.values())), "fleets": gathers}
    joins = join_rows(dev, flush)
    rows["window_join"] = {**next(iter(joins.values())), "fleets": joins}
    sweeps = sweep_rows(dev, flush)
    for name in ("sweep_pass", "sweep_scatter"):
        shapes = {k: v[name] for k, v in sweeps.items()}
        rows[name] = {**next(iter(shapes.values())), "fleets": shapes}
    print(json.dumps({"end_to_end": {f"{CHIPS} chips": end_to_end,
                                     f"{XL_CHIPS} chips": xl_end_to_end}}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
