#!/usr/bin/env python3
"""Smoke run of tpu_pruner_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each of which exits non-zero on failure:

1. build the CUDA kernels from tpu_pruner_torch/policy/csrc with nvcc
   (sm_90a), print each kernel's registers, shared memory and spills
   (a second nvcc with -Xptxas -v, started with the build; the int8 pass's
   row design at T = 12, and its registers and spills over every T it has a
   kernel for; the f32 pass's group design for each samples-a-lane it has a
   kernel for, and its long-row design for each samples a lane a chunk;
   the slice gate; the scatter reduction's two kernels), and print the
   card's name and power limit;
2. hold the slice gate against its plain version bit for bit on
   gate_cases (bounds outside [0, C], out of order, empty, inverted and
   one-chip slices in five integer dtypes, differences that wrap in int32
   and int64, one slice of all chips, 1-chip slices, random uneven fleets
   with busy chips at a slice's first and last chip, 16-chip slices mixed
   with long ones, S = 0, C = 0, the main path's shapes, a mixed fleet of
   1,048,576 chips), the candidate at four offsets off a 16-byte boundary,
   one launch a case (none where S = 0); then the scatter reduction
   likewise on scatter_cases (ids outside [0, S) in int32 and int64, int64
   ids past 2^31 and 2^32, empty slices, one slice of all chips, 1-chip
   slices, the gke-65k layout cut and whole, S = 0, S = 1, C = 0; none
   launches where S = 0 or C = 0); then hold each
   chip pass against its plain PyTorch version on an adversarial
   fleet (ragged chip counts, T in {1, 12, 31, 360, 361}, all-invalid rows,
   NaN, subnormals, -0.0, +-inf, finite/+inf/subnormal cutoffs, young
   pods): the masks must be equal, and so must the card's int8 quantizer
   and the numpy one. Then the int8 kernel alone on its edges: T in
   {1, 12, 31, 360, 361, 10080}, C in {1, 17, 1003}, contiguous tensors and
   views whose data pointers are off a 16-byte boundary (x[1:] of a
   [C+1, T] tensor, and arbitrary byte offsets), rows of all -1, -128 and
   127, and one full-width 131,072 x 360 view. Then the int8 kernel's two
   designs (SWEEP_T x SWEEP_C, bases at byte offsets 0-15, hbm alone and the
   ages alone off a 16-byte boundary): bit-equal to the plain version, each
   launch in the design that its plan promises. Then the f32 kernel's
   designs, each forced, on adversarial rows with invalid padding and
   special values in a row's last sample at T in F32_ADVERSARIAL_T, and
   through its plan on the F32_SWEEP_T x SWEEP_C sweep (bases on and off
   16-byte boundaries; rows up to 2,880 samples): bit-equal to the plain
   version, each launch in the design its plan promises. Then the engine on the inputs
   the reference takes and the kernel wrappers refuse (input_cases: slice
   ids outside [0, S) as int32, int64, int8 and uint8, bf16, f16 and f64
   samples, an integer mask, f64 ages, strided views) through
   evaluate_fleet(_cuda) and evaluate_fleet_q(_cuda), each one launch of
   its pass and of the scatter reduction; int16, uint8 and f32
   samples on the int8 paths (q_input_cases) through evaluate_fleet_q, _qc,
   _qu and evaluate_fleet_cuda_q, _qc; and bounds outside [0, C] through
   evaluate_fleet_c, _qc and evaluate_fleet_cuda_qc (each one launch of
   its pass and of the slice gate): the CPU's verdicts, each kernel equal
   to its plain version, and every kernel launches, and equals its plain
   version, after the bad-bounds case;
3. drive the main path at full width -- 131,072 chips x 360 samples in
   8,192 slices -- through evaluate_fleet, evaluate_fleet_cuda,
   evaluate_fleet_q, evaluate_fleet_cuda_q, evaluate_fleet_c,
   quantize_fleet_inputs + evaluate_fleet_qc, the uniform path
   (assert_uniform_slices + evaluate_fleet_qu: the fleet is 16 chips a
   slice), the analyze evaluation, and the analyze CLI (batch, --shard in a
   one-rank group, --stream over two cycles), then the analyze CLI without
   --quantize on an audit dump's width, 131,072 chips x 8 samples written
   in the dump format (every seventh chip's series 1-7 samples long), whose
   verdicts must also equal evaluate_fleet's on load_fleet's arrays, with
   its host wall time; verdicts must equal the
   fleet's expected verdicts, each path (counts zeroed just before it, read
   just after) must launch its own pass exactly once and the other never,
   and the slice gate exactly once on every contiguous path (_c, _qc,
   evaluate_fleet_cuda_qc, analyze's evaluation and CLI without --shard)
   and the scatter reduction exactly once on every scatter path
   (evaluate_fleet, _q and their CUDA entry points), and neither elsewhere,
   and each kernel must equal its plain version on the main path's inputs;
4. time each kernel with CUDA events (median over many launches) beside
   its plain version and its bound at the card's published rates: warm
   (back to back) and cold (a 256 MB scratch buffer zeroed before each
   launch, outside the events, so the 50 MB L2 holds none of the inputs);
   the f32 kernel in each of its designs that takes the rows (the plan's
   and the warp design), warm and cold; the int8 kernel also at T = 12,
   the streaming window's shape, in both designs warm and cold, and plain
   (also on the dry run's 32,768 rows a rank); and, end to end,
   evaluate_fleet and evaluate_fleet_c (again with the f32 pass's warp
   design forced), evaluate_fleet_qc, evaluate_fleet_qu and one streaming
   cycle in each form (update_window_ in place, or update_window with fresh
   rings, + evaluate_window_qc or _qu): device time, warm and cold, from
   replays of a CUDA graph of one call, eager host wall time per call, and
   for the four evaluate_fleet paths and the two in-place cycles the device
   operations one eager call puts on the card, each with its traced device
   time, from a torch.profiler trace (launch_counts); and the slice gate on
   the fleet's own candidate, warm and cold beside its bound, its plain
   version and an empty kernel. All of it
   twice: on the main path's fleet, and at bench.py's XL point, 1,048,576
   chips x 360 samples in 65,536 slices, built on the card with a seeded
   torch.Generator, whose qc, qu and f32 verdicts and both kernels are
   checked first. Then both designs of the int8 kernel for each T of
   SWEEP_TIMING_T at 32,768, 131,072 and 1,048,576 chips, warm and cold,
   and whether the row design was the faster wherever the plan takes it.
   Then the f32 kernel at the dump's width, 8 samples a chip with padded
   short series, in each design at the same three sizes, warm and cold,
   beside its bound, its plain version and an empty kernel;
   evaluate_fleet_c end to end at 131,072 x 8, with its device operations;
   the slice gate on one slice of 1,048,576 chips, on 1,048,576 slices
   of one chip, on mixed fleets (16-chip slices and one each of 4,096,
   8,960 and 65,536 chips) and by average slice length at 131,072 and
   1,048,576 chips (gate_fleets); the scatter reduction (one call: its
   memset and two kernels) warm and cold beside its plain version, an
   empty kernel and its bound, on the gke-65k layout (260,000 chips in
   23,149 groups, host order), 1,048,576 chips in 65,536 shuffled slices,
   one slice of 1,048,576 chips idle but one, and 1,048,576 one-chip slices
   (scatter_rows); and the f32 designs for
   each T of f32_timing_t(C) at the three sizes (rows of 1 to 2,880
   samples; the long-row design also at its other samples a lane), and
   where the plan's design was not the fastest;
5. the streaming window at full width, K = 12 chunks of 6 new samples a
   cycle, 14 cycles (the ring wraps): each cycle's evaluate_window_qc and
   _qu must equal evaluate_fleet_qc over the last <= 12 chunks and the
   verdicts the chunks were built for; some slices turn idle exactly when
   their busy chunk is evicted; each window evaluation launches the int8
   kernel once, and the qc evaluation the slice gate once; the rings of
   update_window_ (the counted cycle, as analyze --stream runs it) equal
   those of update_window every cycle;
6. every sharded evaluator and the stream step in a one-rank NCCL group
   (file:// rendezvous), at full width, against the single-device results
   (no slice gate: the sharded qc path all-reduces slice counts);
7. dryrun_multichip(4) with gloo: four ranks on the one card, each running
   every sharded path on its rows of a 131,072 x 360 fleet (the uneven
   case 131,069 chips) against the single-device results; each rank
   reports its launches per path;
8. the port's host tooling, which runs no kernel: build the C++ core from
   native/ with g++ (tpu_pruner_torch.native.ensure_built: the library,
   the daemon, the unit-test runner and the fuzz binary), run the unit
   runner and 20,000 fuzz iterations, then the replay smoke (what `python
   -m tpu_pruner_torch.testing.replay_smoke` runs: two daemon cycles
   against the port's fakes, then `python -m tpu_pruner_torch.analyze
   --replay` on each capsule); no module of jax or of tpu_pruner may be
   loaded afterwards. Prints the build and smoke seconds beside the card's
   name and power limit.

The line before the last is {"kernels": [...]}, with each kernel's launches
per path of phases 3 and 5-7, the passes' launches by design in phases 3, 5
and 6
and its XL times under "xl" (the int8 kernel also its T = 12 times under
"window" and its sweep under "design_sweep", the f32 kernel its times at
the dump's width and its sweep under "dump", the slice gate, which has no
Pallas counterpart, its other fleets and sweep under "fleets", and the
scatter reduction, which has none either, its shapes under "fleets"); the
line before
it is {"end_to_end": {...}}, phase 4's end-to-end times at both sizes; the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tpu_pruner_torch import analyze, entry
from tpu_pruner_torch.policy import (
    LAUNCHES, PolicyParams, _build, assert_uniform_slices, chip_pass, chip_pass_plain,
    chip_pass_q, chip_pass_q_plain, evaluate_fleet, evaluate_fleet_c, evaluate_fleet_cuda,
    evaluate_fleet_cuda_q, evaluate_fleet_cuda_qc, evaluate_fleet_q, evaluate_fleet_qc,
    evaluate_fleet_qu, evaluate_fleet_sharded, evaluate_fleet_sharded_q,
    evaluate_fleet_sharded_qc, evaluate_fleet_sharded_qu, evaluate_window_qc,
    evaluate_window_qu, fleet_from_numpy, init_window, make_example_fleet, make_sharded_evaluator,
    make_sharded_evaluator_q,
    make_sharded_evaluator_qc, make_sharded_evaluator_qu, quantize_fleet_inputs,
    params_array, quantize_params, quantize_samples, quantize_samples_device, reset_launches,
    shard_bounds, slice_bounds, update_window, update_window_)
from tpu_pruner_torch.policy import kernels
from tpu_pruner_torch.policy.engine import normalize_inputs, normalize_inputs_q
from tpu_pruner_torch.policy.kernels import (
    _F32_GROUPS_K, _F32_GROUPS_MAX_T, _F32_LONG_K, _Q_ROWS_MAX_BYTES, _Q_ROWS_T, DESIGN_LAUNCHES,
    _F32_WARPS_PER_BLOCK, F32_DESIGN_LAUNCHES, F32_DESIGNS, PlanLong, PlanRows, PlanWarps,
    _choose_plan_f32, _choose_plan_q, _f32_plans, _launch_f32, _launch_q, _plan_q, _plan_q_rows,
    _sm_count, normalize_slice_ids, slice_gate, slice_gate_plain, slice_scatter,
    slice_scatter_plain)
from tpu_pruner_torch.policy.sharded import run_local, run_stream_local

CHIPS, SAMPLES, SLICES = 131072, 360, 8192
CPS = CHIPS // SLICES  # the example fleet is uniform: 16 chips a slice
XL_CHIPS, XL_SLICES = 1048576, 65536  # bench.py's XL point, 16 chips a slice too
WINDOW_CHUNKS, CHUNK_SAMPLES, STREAM_CYCLES = 12, 6, 14  # the daemon's window shape
DRYRUN_RANKS = 4
DRYRUN_CHIPS = CHIPS // DRYRUN_RANKS  # the dry run's rows a rank
# H100 SXM published peaks (NVIDIA data sheet) at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12  # f32 outside the tensor cores
# Scalar operations per (chip, sample): f32 pass -- per array a flush
# (abs, compare, select), the validity select and the max, plus the OR of
# has_data; int8 pass -- one widening max per array.
OPS_PER_SAMPLE = {"chip_pass": 11, "chip_pass_q": 2}
REPLACES = {
    "chip_pass": "tpu_pruner/policy/pallas_engine.py:33",
    "chip_pass_q": "tpu_pruner/policy/pallas_engine.py:104",
}
SOURCE = "tpu_pruner_torch/policy/csrc/chip_pass.cu"
KERNEL_SYMBOLS = {"chip_pass, warp design": "chip_pass_kernel",
                  "chip_pass_q": "chip_pass_q_kernel",
                  f"chip_pass_q, row design, T={WINDOW_CHUNKS}":
                  f"chip_pass_q_rows_kernelILi{WINDOW_CHUNKS}E",
                  "slice_gate, int32 bounds": "slice_gate_kernelIiE",
                  "slice_scatter marks, int32 ids": "slice_marks_kernelIiE",
                  "slice_scatter marks, int64 ids": "slice_marks_kernelIlE",
                  "slice_scatter verdicts": "slice_verdict_kernel"}
# templated kernels: name -> (symbol pattern, the instantiations the plan uses)
INSTANTIATIONS = {
    "chip_pass_q, row design, T": (r"chip_pass_q_rows_kernelILi(\d+)E", _Q_ROWS_T),
    "chip_pass, group design, samples a lane": (r"chip_pass_groups_kernelILi(\d+)E",
                                                _F32_GROUPS_K),
    "chip_pass, long-row design, samples a lane a chunk": (r"chip_pass_long_kernelILi(\d+)E",
                                                           _F32_LONG_K),
}
DUMP_SAMPLES = 8  # an audit dump's series: dump.py's 2100 s window at its 300 s step
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


def int8_case_err(dev, tc, hbm, age, what: str) -> int:
    """chip_pass_q against its plain version, on the card, for every
    parameter set; fails the run on any difference."""
    err = 0
    for params in INT8_PARAMS:
        params_q = torch.from_numpy(quantize_params(np.array(params, np.float32))).to(dev)
        got = chip_pass_q(tc, hbm, age, params_q)
        want = chip_pass_q_plain(tc, hbm, age, params_q)
        check(torch.equal(got, want), f"chip_pass_q != plain for {what}, params {params}: "
              f"{int((got != want).sum())} chips differ")
        err = max(err, mask_err(got, want))
    return err


def phase_int8_edges(dev) -> int:
    rng = np.random.default_rng(4321)
    err = cases = 0
    for T in (1, 12, 31, 360, 361, 10080):
        for C in (1, 17, 1003):
            tc, hbm, age = int8_edge_fleet(rng, C, T)
            age_t = torch.from_numpy(age).to(dev)
            for layout in INT8_LAYOUTS:
                err = max(err, int8_case_err(dev, int8_on(dev, tc, layout, 1),
                                             int8_on(dev, hbm, layout, 2), age_t,
                                             f"T={T}, C={C}, {layout}"))
                cases += 1
    tc, hbm, age = int8_edge_fleet(rng, CHIPS, SAMPLES)
    err = max(err, int8_case_err(dev, int8_on(dev, tc, "row_offset", 1),
                                 int8_on(dev, hbm, "row_offset", 2),
                                 torch.from_numpy(age).to(dev), f"{CHIPS}x{SAMPLES} x[1:] view"))
    torch.cuda.synchronize()
    log(f"phase 2: chip_pass_q equals its plain version on {cases + 1} edge layouts "
        f"x {len(INT8_PARAMS)} parameter sets")
    return err


# Phase 2's sweep of the int8 pass's two designs: short rows and long, on
# either side of each limit of the row design (T up to 64, at most 5 vectors
# of each array a thread, not 5: 5, 9, 36 and 60 are outside), ragged and full-width
# chip counts (32,768 the dry run's rows a rank), and bases off a 16-byte
# boundary; then the two sides of its 16 MiB limit at T = 64.
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
        check(design == [want_design], f"chip_pass_q took {design} for {what}, "
              f"expected {want_design}")
        want = chip_pass_q_plain(*views, age_v, params_q)
        check(torch.equal(got, want), f"chip_pass_q != plain for {what}: "
              f"{int((got != want).sum())} chips differ")
        took[want_design] += 1
    return took


def phase_int8_designs(dev) -> None:
    rng = np.random.default_rng(8765)
    t0 = time.perf_counter()
    took = {"rows": 0, "tiles": 0}
    for C, T in [(C, T) for T in SWEEP_T for C in SWEEP_C] + list(BYTES_EDGE):
        for design, n in int8_design_cases(dev, T, C, rng).items():
            took[design] += n
    torch.cuda.synchronize()
    check(took["rows"] > 0 and took["tiles"] > 0, f"the sweep launched {took}")
    log(f"phase 2: chip_pass_q equals its plain version bit for bit on {sum(took.values())} "
        f"(C, T, offset) cases, T in {SWEEP_T}, C in {SWEEP_C}, and (C, T) in {BYTES_EDGE}, "
        f"each in the design its plan promises: {took} launches (the row design at T in "
        f"{sorted(_Q_ROWS_T)} up to {_Q_ROWS_MAX_BYTES} bytes an array), "
        f"{time.perf_counter() - t0:.3f} s")


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


# The f32 pass's parameter sets: PARAMS of the int8 pass and a negative
# cutoff, under which an invalid sample's -1 rescues and padding must not.
F32_PARAMS = INT8_PARAMS + [(2100.0, -5.0)]
F32_ADVERSARIAL_T = (2, 7, 8, 9, 16, 32, 33, 257, 360, 513)
# Phase 2's sweep of the f32 pass: every T up to 64, the group design's
# threshold on either side, and the long-row design's rows on either side
# of each of its limits: one chunk of 12 samples a lane (384), of 16 (512),
# two chunks of 12 (768 > 720), and rows of several chunks.
F32_SWEEP_T = tuple(range(1, 65)) + (_F32_GROUPS_MAX_T, _F32_GROUPS_MAX_T + 1, 300, 359, 360,
                                     361, 383, 384, 385, 512, 513, 720, 1024, 2880)


def f32_expected_design(C: int, T: int) -> str:
    """The design that chip_pass must launch for [C, T] inputs."""
    return F32_DESIGNS[type(_choose_plan_f32(C, T))]


# The f32 designs that the plan takes for some row length (the warp design
# runs only where it is forced, as the timing control).
F32_PLANNED = sorted({f32_expected_design(1, T) for T in F32_SWEEP_T})


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
        check(design == [want_design], f"chip_pass took {design} for {what}, "
              f"expected {want_design}")
        want = chip_pass_plain(*views, params)
        check(torch.equal(got, want), f"chip_pass != plain for {what}: "
              f"{int((got != want).sum())} chips differ")
        took[want_design] += 1
    return took


def phase_f32_designs(dev) -> int:
    """Every design of the f32 pass, forced, on adversarial short rows; then
    the (C, T, offset) sweep through chip_pass and its plan."""
    rng = np.random.default_rng(2468)
    t0 = time.perf_counter()
    forced = {d: 0 for d in F32_DESIGN_LAUNCHES}
    err = 0
    for T in F32_ADVERSARIAL_T:
        C = 1003
        args = [torch.from_numpy(x).to(dev) for x in f32_edge_fleet(rng, C, T)]
        for params in F32_PARAMS:
            parr = torch.tensor(params, device=dev)
            want = chip_pass_plain(*args, parr)
            for design, plan in _f32_plans(C, T).items():
                got = _launch_f32(*args, parr, plan).view(torch.bool)
                check(torch.equal(got, want), f"chip_pass, {design} design, != plain at T={T}, "
                      f"params {params}: {int((got != want).sum())} chips differ")
                err = max(err, mask_err(got, want))
                forced[design] += 1
    took = {d: 0 for d in F32_DESIGN_LAUNCHES}
    cases = [(C, T) for T in F32_SWEEP_T for C in SWEEP_C]
    for C, T in cases:
        for design, n in f32_design_cases(dev, T, C, rng).items():
            took[design] += n
    torch.cuda.synchronize()
    check(all(bool(n) == (d in F32_PLANNED) for d, n in took.items()),
          f"the f32 sweep launched {took}, expected every design of {F32_PLANNED} and no other")
    log(f"phase 2: chip_pass, each design forced, equals its plain version bit for bit on "
        f"adversarial rows at T in {F32_ADVERSARIAL_T} x {len(F32_PARAMS)} parameter "
        f"sets: {forced} launches; and, through its plan, on {sum(took.values())} (C, T, "
        f"offset) cases, T in 1-64, {F32_SWEEP_T[64:]}, C in {SWEEP_C}, each in the design "
        f"its plan promises: {took} launches (the group design up to T = "
        f"{_F32_GROUPS_MAX_T}, the long-row design above), "
        f"{time.perf_counter() - t0:.3f} s")
    return err


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
    main path's shapes, 131,072 chips in 8,192 slices, and one slice of
    1,048,576 chips."""
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
    for C in (1, 1003, 70001) + ((1048576,) if large else ()):
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


def phase_gate(dev) -> int:
    """The slice gate on gate_cases, the candidate at each of GATE_OFFSETS:
    bit-equal to its plain version on the card and on the CPU, one launch a
    case and none where S = 0."""
    t0 = time.perf_counter()
    err, launches = 0, 0
    cases = gate_cases(1357, large=True)
    for name, (cand_np, bounds_np) in cases.items():
        bounds_cpu = torch.from_numpy(bounds_np)
        bounds = bounds_cpu.to(dev)
        S = bounds_np.size - 1
        want_cpu = slice_gate_plain(torch.from_numpy(cand_np), bounds_cpu)
        for k in GATE_OFFSETS:
            cand = gate_on(dev, cand_np, k)
            want = slice_gate_plain(cand, bounds)
            check(torch.equal(want.cpu(), want_cpu), f"gate {name}: the plain version differs "
                  "between the card and the CPU")
            before = LAUNCHES["slice_gate"]
            got = slice_gate(cand, bounds)
            check(LAUNCHES["slice_gate"] - before == int(S > 0),
                  f"gate {name}, offset {k}: {LAUNCHES['slice_gate'] - before} launches")
            launches += LAUNCHES["slice_gate"] - before
            check(torch.equal(got, want), f"slice_gate != plain for {name}, offset {k}: "
                  f"{int((got != want).sum())} slices differ")
            err = max(err, mask_err(got, want))
    torch.cuda.synchronize()
    log(f"phase 2: slice_gate equals its plain version bit for bit on {len(cases)} "
        f"bounds cases x {len(GATE_OFFSETS)} candidate offsets ({launches} launches), "
        f"{time.perf_counter() - t0:.3f} s")
    return err


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


def scatter_cases(seed: int, large: bool = False) -> dict:
    """name -> (candidate bool[C], ids [C], S) as numpy: the scatter slice
    reduction's inputs. Ids outside [0, S) in int32 and int64; int64 ids at
    and past 2^31 and 2^32 and the int64 extremes, which must count nowhere;
    empty slices; one slice of all chips, idle or with one busy chip at its
    first, middle or last chip; 1-chip slices in order and shuffled; sorted
    16-chip slices; runs of one id across warp edges; the cut gke-65k layout
    in host order; S = 0, S = 1 and C = 0. With large, also the cell's layout
    (260,000 chips in 23,149 groups), 1,048,576 chips in 65,536 shuffled
    slices, one slice of 1,048,576 chips and 1,048,576 one-chip slices."""
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
    if large:
        cases.update(scatter_fleets(rng))
    return cases


def scatter_fleets(rng) -> dict:
    """name -> (candidate, int32 ids, S) as numpy: the shapes phase 4 times
    the scatter reduction at. The cell's layout; 1,048,576 chips in 65,536
    shuffled 16-chip slices; one slice of 1,048,576 chips, all idle but one;
    1,048,576 one-chip slices, every other busy."""
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


def phase_scatter(dev) -> int:
    """The scatter reduction on scatter_cases, the candidate at each of
    GATE_OFFSETS: bit-equal to its plain version on the card and on the CPU,
    one launch a case and none where S = 0 or C = 0."""
    t0 = time.perf_counter()
    err, launches = 0, 0
    cases = scatter_cases(2468, large=True)
    for name, (cand_np, ids_np, S) in cases.items():
        ids_cpu = torch.from_numpy(ids_np)
        ids = ids_cpu.to(dev)
        want_cpu = slice_scatter_plain(torch.from_numpy(cand_np), ids_cpu, S)
        for k in GATE_OFFSETS:
            cand = gate_on(dev, cand_np, k)
            want = slice_scatter_plain(cand, ids, S)
            check(torch.equal(want.cpu(), want_cpu), f"scatter {name}: the plain version "
                  "differs between the card and the CPU")
            before = LAUNCHES["slice_scatter"]
            got = slice_scatter(cand, ids, S)
            check(LAUNCHES["slice_scatter"] - before == int(S > 0 and cand_np.size > 0),
                  f"scatter {name}, offset {k}: {LAUNCHES['slice_scatter'] - before} launches")
            launches += LAUNCHES["slice_scatter"] - before
            check(torch.equal(got, want), f"slice_scatter != plain for {name}, offset {k}: "
                  f"{int((got != want).sum())} slices differ")
            err = max(err, mask_err(got, want))
    torch.cuda.synchronize()
    log(f"phase 2: slice_scatter equals its plain version bit for bit on {len(cases)} "
        f"id cases x {len(GATE_OFFSETS)} candidate offsets ({launches} launches), "
        f"{time.perf_counter() - t0:.3f} s")
    return err


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


def engine_input_check(dev, name: str, make) -> int:
    """One input case through the f32 and int8 engine paths on the card: one
    launch of each kernel and of the scatter reduction, the same verdicts
    and candidates as the CPU's plain versions on the same inputs, and each
    kernel equal to its plain version on the card. Returns the largest mask
    difference (0)."""
    gpu, cpu = make(dev), make("cpu")
    err = 0
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
            check(LAUNCHES[counted_kind] == before[counted_kind] + 2,
                  f"{name}: {counted_kind} launched "
                  f"{LAUNCHES[counted_kind] - before[counted_kind]} times for two evaluations")
        want_v, want_c = evaluate(*c_in, num_slices=INPUT_SLICES)
        check(torch.equal(v.cpu(), want_v) and torch.equal(c.cpu(), want_c)
              and torch.equal(vc, v) and torch.equal(cc, c),
              f"{name}: {kind} path on the card differs from the CPU's plain version")
        check(torch.equal(kernel, plain) and torch.equal(kernel, c),
              f"{name}: {kind} differs from its plain version")
        check(0 < int(want_v.sum()) < INPUT_SLICES, f"{name}: the {kind} verdicts are vacuous")
        err = max(err, mask_err(kernel, plain))
    return err


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


def q_input_check(dev, name: str, make) -> int:
    """One q-sample case through evaluate_fleet_q, _qc, _qu and the CUDA
    entry points on the card: one launch of the int8 kernel a path, and of
    the slice gate or the scatter reduction where the path reduces, the CPU's
    verdicts and candidates, and the kernel equal to its plain version on the
    mapped samples. Returns the largest mask difference (0)."""
    gpu, cpu = make(dev), make("cpu")
    g_pass = normalize_inputs_q(*gpu[:3], gpu[4])
    check(g_pass[0].dtype == g_pass[1].dtype == torch.int8, f"{name}: not mapped to int8")
    kernel, plain = chip_pass_q(*g_pass), chip_pass_q_plain(*g_pass)
    check(torch.equal(kernel, plain), f"{name}: chip_pass_q differs from its plain version")

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
        check(launched == want, f"{name}: {path} launched {launched}, expected {want}")
        want_v, want_c = on_cpu(cpu)
        check(torch.equal(v.cpu(), want_v) and torch.equal(c.cpu(), want_c)
              and torch.equal(c, kernel),
              f"{name}: {path} on the card differs from the CPU's plain version")
        check(0 < int(want_v.sum()) < INPUT_SLICES, f"{name}: {path} verdicts are vacuous")
    return mask_err(kernel, plain)


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
        check(launched == {**dict.fromkeys(LAUNCHES, 0), kind: 1, "slice_gate": 1},
              f"bad bounds: {path} launched {launched}, expected {kind} and slice_gate once")
        check(torch.equal(v.cpu(), want_v) and torch.equal(c.cpu(), want_c),
              f"bad bounds: {path} on the card differs from the CPU's")
        check(0 < int(want_v.sum()) < INPUT_SLICES, f"bad bounds: {path} verdicts are vacuous")


def phase_engine_inputs(dev) -> int:
    """Every input case of input_cases and q_input_cases on the card, then
    the bad bounds; then one more launch of each kernel, equal to its plain
    version, which proves the CUDA context survived the bad ids and bounds."""
    cases = input_cases(99)
    err = max(engine_input_check(dev, name, make) for name, make in cases.items())
    q_cases = q_input_cases(98)
    err = max(err, *(q_input_check(dev, name, make) for name, make in q_cases.items()))
    bounds_input_check(dev, cases["bf16 samples"])
    probe = cases["bf16 samples"](dev)
    f32_pass = normalize_inputs(*probe[:4], probe[5])
    q = quantize_fleet_inputs(probe)
    q_pass = normalize_inputs_q(*q[:3], q[4])
    probe_bounds = slice_bounds(probe[4], INPUT_SLICES, device=dev)
    probe_ids = normalize_slice_ids(probe[4])
    before = dict(LAUNCHES)
    candidate = chip_pass(*f32_pass)
    check(torch.equal(candidate, chip_pass_plain(*f32_pass))
          and torch.equal(chip_pass_q(*q_pass), chip_pass_q_plain(*q_pass))
          and torch.equal(slice_gate(candidate, probe_bounds),
                          slice_gate_plain(candidate, probe_bounds))
          and torch.equal(slice_scatter(candidate, probe_ids, INPUT_SLICES),
                          slice_scatter_plain(candidate, probe_ids, INPUT_SLICES)),
          "a kernel differs from its plain version after the bad bounds")
    torch.cuda.synchronize()
    check(all(LAUNCHES[k] == before[k] + 1 for k in LAUNCHES),
          "every kernel must launch after the bad bounds")
    log(f"phase 2: the engine on {len(cases)} input cases the wrappers refuse "
        f"({', '.join(cases)}), {len(q_cases)} q-sample cases ({', '.join(q_cases)}) "
        "and out-of-range bounds equals the CPU's plain versions, each kernel one launch "
        "a path (the slice gate on the qc paths, the scatter reduction on the others but qu); "
        "every kernel launches, and equals its plain version, after the bad bounds")
    return err


def phase_adversarial(dev) -> dict:
    rng = np.random.default_rng(1234)
    err = {"chip_pass": 0, "chip_pass_q": 0}
    cases = candidates = chips = 0
    for T in (1, 12, 31, 360, 361):
        C = 1003  # not a multiple of the rows a block covers
        tc, hbm, valid, age = adversarial_fleet(rng, C, T)
        t = {k: torch.from_numpy(v).to(dev) for k, v in
             dict(tc=tc, hbm=hbm, valid=valid, age=age).items()}
        for q_util in (tc, hbm):
            q_dev = quantize_samples_device(torch.from_numpy(q_util).to(dev), t["valid"])
            check(np.array_equal(q_dev.cpu().numpy(), quantize_samples(q_util, valid)),
                  f"T={T}: device quantizer differs from numpy quantize_samples")
        for lookback, cutoff in ((2100.0, 0.05), (2100.0, float("inf")),
                                 (0.0, 1e-40), (2e-40, 0.5)):
            params = torch.tensor([lookback, cutoff], dtype=torch.float32, device=dev)
            got = chip_pass(t["tc"], t["hbm"], t["valid"], t["age"], params)
            want = chip_pass_plain(t["tc"], t["hbm"], t["valid"], t["age"], params)
            check(torch.equal(got, want),
                  f"chip_pass != plain at T={T}, params={[lookback, cutoff]}: "
                  f"{int((got != want).sum())} chips differ")
            err["chip_pass"] = max(err["chip_pass"], mask_err(got, want))

            params_q = torch.from_numpy(quantize_params(params.cpu().numpy())).to(dev)
            tc_q = quantize_samples_device(t["tc"], t["valid"])
            hbm_q = quantize_samples_device(t["hbm"], t["valid"])
            got_q = chip_pass_q(tc_q, hbm_q, t["age"], params_q)
            want_q = chip_pass_q_plain(tc_q, hbm_q, t["age"], params_q)
            check(torch.equal(got_q, want_q),
                  f"chip_pass_q != plain at T={T}, params_q={params_q.tolist()}: "
                  f"{int((got_q != want_q).sum())} chips differ")
            err["chip_pass_q"] = max(err["chip_pass_q"], mask_err(got_q, want_q))
            candidates += int(want.sum()) + int(want_q.sum())
            chips += 2 * C
            cases += 1
    torch.cuda.synchronize()
    check(0 < candidates < chips, f"adversarial fleet is vacuous: {candidates} of "
          f"{chips} chips are candidates")
    log(f"phase 2: {cases} adversarial cases x 2 kernels equal their plain versions")
    return err


DESIGNS_BY_PATH = {}  # chip_pass_q's launches by design, per counted path
F32_DESIGNS_BY_PATH = {}  # chip_pass's launches by design, per counted path


def counted(by_path: dict, path: str, run):
    """run() with the kernel counts zeroed just before it and read just after;
    the counts are recorded under path, each kernel's designs under path in
    DESIGNS_BY_PATH and F32_DESIGNS_BY_PATH (added up
    over repeated runs of a path)."""
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    by_path[path] = dict(LAUNCHES)
    for by_design, counts in ((DESIGNS_BY_PATH, DESIGN_LAUNCHES),
                              (F32_DESIGNS_BY_PATH, F32_DESIGN_LAUNCHES)):
        seen = by_design.setdefault(path, dict.fromkeys(counts, 0))
        for design, n in counts.items():
            seen[design] += n
    return out


def expect_launches(by_path: dict, path: str, want: dict) -> None:
    want = {name: want.get(name, 0) for name in LAUNCHES}
    check(by_path[path] == want, f"{path} launched {by_path[path]}, expected {want}")


def analyze_cli_check(dev, by_path: dict) -> None:
    """A small dump through the CLI: batch, --quantize, --shard [--quantize]
    (a one-rank group on the card) and two --stream cycles; each run must
    launch its pass once, and the slice gate once where it evaluates on one
    device (batch and --stream; --shard all-reduces slice counts instead)."""
    doc = {"hbm_threshold": 0.05, "chips": [
        {"slice": "ml/idle", "tc": [0.0] * 6, "hbm": [0.0] * 6, "pod_age_s": 7200},
        {"slice": "ml/busy", "tc": [0.0, 0.7, 0.0], "hbm": [0.1] * 3, "pod_age_s": 7200},
        {"slice": "ml/idle", "tc": [0.0] * 6, "hbm": [0.0] * 6, "pod_age_s": 7200},
        {"slice": "ml/hbm-active", "tc": [0.0] * 6, "hbm": [0.2] * 6, "pod_age_s": 7200},
        {"slice": "ml/busy", "tc": [0.0] * 3, "hbm": [0.1] * 3, "pod_age_s": 7200},
        {"slice": "ml/young", "tc": [0.0] * 6, "pod_age_s": 60},
    ]}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dump.json")
        state = os.path.join(tmp, "state.npz")
        runs = [("analyze CLI", [], {"chip_pass": 1, "slice_gate": 1}),
                ("analyze CLI --quantize", ["--quantize"], {"chip_pass_q": 1, "slice_gate": 1}),
                ("analyze CLI --shard", ["--shard"], {"chip_pass": 1, "slice_gate": 0}),
                ("analyze CLI --shard --quantize", ["--shard", "--quantize"],
                 {"chip_pass_q": 1, "slice_gate": 0}),
                ("analyze CLI --stream (cycle 1)", ["--stream", state],
                 {"chip_pass_q": 1, "slice_gate": 1}),
                ("analyze CLI --stream (cycle 2)", ["--stream", state],
                 {"chip_pass_q": 1, "slice_gate": 1})]
        for cycle, (name, extra, launches) in enumerate(runs):
            with open(path, "w") as f:
                json.dump({**doc, "timestamp": 1000.0 + 180 * cycle}, f)
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = counted(by_path, name,
                             lambda: analyze.main([path, "--device", dev.type, *extra]))
            check(rc == 0, f"{name} returned {rc}: {err.getvalue()}")
            expect_launches(by_path, name, launches)
            result = json.loads(out.getvalue().strip().splitlines()[-1])
            check(result["reclaimable_slices"] == ["ml/idle"] and result["idle_chips"] == 2,
                  f"{name} gave {result}")
        check(result["window"]["filled"] == 2 and result["newly_reclaimable"] == [],
              f"analyze --stream second cycle gave {result}")


def write_dump(path: str, fleet_np, slice_names) -> None:
    """numpy (tc, hbm, valid, age, slice_id) -> a dump document in the dump
    format, each chip's series its valid samples (right-aligned, as dumps
    are), its id zero-padded so that load_fleet keeps the chips' order."""
    tc, hbm, valid, age, slice_id = fleet_np
    chips = []
    for i in range(tc.shape[0]):
        v = valid[i]
        chips.append({"slice": slice_names[slice_id[i]], "id": f"pod-{i:07d}/tpu",
                      "tc": tc[i, v].tolist(), "hbm": hbm[i, v].tolist(),
                      "pod_age_s": float(age[i])})
    with open(path, "w") as f:
        json.dump({"timestamp": 1000.0, "chips": chips}, f)


def analyze_dump_width_check(dev, by_path: dict) -> None:
    """The analyze CLI without --quantize on a dump of 131,072 chips x 8
    samples in 8,192 slices (make_example_fleet's, every seventh chip cut to
    1-7 samples): the f32 pass at the dump's width, once, in the design its
    plan promises; verdicts equal to evaluate_fleet on load_fleet's arrays
    and to the fleet's expected ones."""
    inputs, expected = make_example_fleet(CHIPS, DUMP_SAMPLES, SLICES, idle_fraction=0.5,
                                          seed=0, device="cpu")
    tc, hbm, valid, age, slice_id = (x.numpy() for x in inputs[:5])
    short = np.arange(CHIPS) % 7 == 3
    cut = np.arange(CHIPS)[short] // 7 % 7 + 1  # leading samples each short series lacks
    valid[short] = np.arange(DUMP_SAMPLES)[None, :] >= cut[:, None]
    names = [f"ml/slice-{s:05d}" for s in range(SLICES)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dump.json")
        t0 = time.perf_counter()
        write_dump(path, (tc, hbm, valid, age, slice_id), names)
        write_s = time.perf_counter() - t0
        out, err = io.StringIO(), io.StringIO()
        name = f"analyze CLI, {CHIPS}x{DUMP_SAMPLES} dump"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = counted(by_path, name, lambda: analyze.main([path, "--device", dev.type]))
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"{name} returned {rc}: {err.getvalue()[-2000:]}")
        expect_launches(by_path, name, {"chip_pass": 1, "slice_gate": 1})
        want_design = f32_expected_design(CHIPS, DUMP_SAMPLES)
        check(F32_DESIGNS_BY_PATH[name][want_design] == 1,
              f"{name} launched {F32_DESIGNS_BY_PATH[name]}, expected the {want_design} design")
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        t0 = time.perf_counter()
        with open(path) as f:
            fleet, loaded_names, _, _ = analyze.load_fleet(json.load(f))
        parse_s = time.perf_counter() - t0
    check(loaded_names == names and fleet[0].shape == (CHIPS, DUMP_SAMPLES)
          and np.array_equal(fleet[2], valid), "load_fleet did not rebuild the dump's arrays")
    single = evaluate_fleet(*fleet_from_numpy((*fleet, inputs[5].numpy()), dev),
                            num_slices=SLICES)
    idle = [names[i] for i in np.flatnonzero(single[0].cpu().numpy())]
    check(np.array_equal(single[0].cpu().numpy(), expected)
          and result["reclaimable_slices"] == idle
          and result["idle_chips"] == int(single[1].sum()) == CHIPS // 2,
          f"{name}: {len(result['reclaimable_slices'])} reclaimable slices and "
          f"{result['idle_chips']} idle chips, expected {len(idle)} and {CHIPS // 2}")
    log(f"phase 3: {name} in {SLICES} slices ({int(short.sum())} chips with 1-7 samples): "
        f"verdicts equal evaluate_fleet's and the expected ones; one launch of chip_pass, "
        f"{F32_DESIGNS_BY_PATH[name]}; host wall {cli_s:.3f} s for the CLI (JSON written in "
        f"{write_s:.3f} s, read and loaded again in {parse_s:.3f} s)")


def phase_main_path(dev, by_path: dict):
    t0 = time.perf_counter()
    inputs, expected = make_example_fleet(CHIPS, SAMPLES, SLICES, idle_fraction=0.5,
                                          seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tc, hbm, valid, age, slice_id, parr = inputs
    fleet_np = tuple(x.cpu().numpy() for x in inputs[:5])
    params = PolicyParams()

    bounds = slice_bounds(slice_id, SLICES, device=dev)
    q = quantize_fleet_inputs(inputs)

    def loaded(quantize):
        v, c = analyze.evaluate_loaded(fleet_np, SLICES, params, quantize=quantize,
                                       device=dev)
        check(int(c.sum()) == CHIPS // 2, f"analyze idle chips (quantize={quantize})")
        return v

    def uniform():
        check(assert_uniform_slices(slice_id, CPS) == SLICES, "uniform fleet")
        return evaluate_fleet_qu(q[0], q[1], q[2], q[4], CPS)[0]

    # Each path runs with the counts zeroed just before it and read just
    # after: it must launch its own pass exactly once and the other never,
    # the slice gate once on the contiguous paths and the scatter reduction
    # once on the scatter paths, and neither elsewhere.
    gate, scatter = {"slice_gate": 1}, {"slice_scatter": 1}
    paths = {
        "evaluate_fleet": ("chip_pass", scatter, lambda: evaluate_fleet(
            *inputs, num_slices=SLICES)[0]),
        "evaluate_fleet_cuda": ("chip_pass", scatter, lambda: evaluate_fleet_cuda(
            *inputs, num_slices=SLICES)[0]),
        "evaluate_fleet_q": ("chip_pass_q", scatter, lambda: evaluate_fleet_q(
            *q, num_slices=SLICES)[0]),
        "evaluate_fleet_cuda_q": ("chip_pass_q", scatter, lambda: evaluate_fleet_cuda_q(
            *q, num_slices=SLICES)[0]),
        "evaluate_fleet_c": ("chip_pass", gate, lambda: evaluate_fleet_c(
            tc, hbm, valid, age, bounds, parr)[0]),
        "evaluate_fleet_qc": ("chip_pass_q", gate, lambda: evaluate_fleet_qc(
            q[0], q[1], q[2], bounds, q[4])[0]),
        "evaluate_fleet_cuda_qc": ("chip_pass_q", gate, lambda: evaluate_fleet_cuda_qc(
            q[0], q[1], q[2], bounds, q[4])[0]),
        "evaluate_fleet_qu": ("chip_pass_q", {}, uniform),
        "analyze.evaluate_loaded": ("chip_pass", gate, lambda: loaded(False)),
        "analyze.evaluate_loaded --quantize": ("chip_pass_q", gate, lambda: loaded(True)),
    }
    t0 = time.perf_counter()
    for path, (kernel, reduction, run) in paths.items():
        v = counted(by_path, path, run)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        check(np.array_equal(v, expected), f"{path} verdicts")
        expect_launches(by_path, path, {kernel: 1, **reduction})
    main_s = time.perf_counter() - t0
    analyze_cli_check(dev, by_path)
    analyze_dump_width_check(dev, by_path)
    log(f"phase 3: main path {CHIPS}x{SAMPLES} in {SLICES} slices ok "
        f"(setup {setup_s:.3f} s, evaluations {main_s:.3f} s, launches "
        f"{ {p: c for p, c in by_path.items()} })")

    # each kernel against its plain version on the main path's own inputs
    candidate = chip_pass_q(q[0], q[1], q[2], q[4])
    err = {
        "chip_pass": mask_err(chip_pass(tc, hbm, valid, age, parr),
                              chip_pass_plain(tc, hbm, valid, age, parr)),
        "chip_pass_q": mask_err(candidate, chip_pass_q_plain(q[0], q[1], q[2], q[4])),
        "slice_gate": mask_err(slice_gate(candidate, bounds),
                               slice_gate_plain(candidate, bounds)),
        "slice_scatter": mask_err(slice_scatter(candidate, slice_id, SLICES),
                                  slice_scatter_plain(candidate, slice_id, SLICES)),
    }
    check(not any(err.values()), f"full-width kernel mismatch {err}")
    return inputs, expected, q, err


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


@contextlib.contextmanager
def forced_f32_plan(choose):
    """chip_pass launches choose(C, T)'s plan instead of its own while the
    block runs (timing only: the launches are not the main path's)."""
    own = kernels._choose_plan_f32
    kernels._choose_plan_f32 = choose
    try:
        yield
    finally:
        kernels._choose_plan_f32 = own


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
        log(f"phase 4: {name} device operations per call: not measured ({e})")
        return None
    ops, ms = {}, {}
    for event in prof.events():
        if (event.device_type == torch.autograd.DeviceType.CUDA
                and not any(w in event.name for w in ("spin_kernel", "sleep"))):
            key = event.name[:80]
            ops[key] = ops.get(key, 0) + 1
            ms[key] = ms.get(key, 0.0) + event.time_range.elapsed_us() / 1e3
    if not ops:
        log(f"phase 4: {name} device operations per call: not measured (no device event "
            "in the trace)")
        return None
    log(f"phase 4: {name} device operations per call: {sum(ops.values())} "
        f"{ {k: (n, round(ms[k], 5)) for k, n in ops.items()} } (count, traced ms); "
        f"{sum(ms.values()):.5f} ms traced in all")
    return {"total": sum(ops.values()), "by_name": ops, "ms_by_name": ms,
            "traced_ms": sum(ms.values())}


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


def phase_timing(inputs, q, err, num_slices: int, flush: torch.Tensor):
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
        bound_ms, bound_by = bound_ms_of(name, nbytes, C, T)
        ms = time_ms(kernel, 200)
        ms_cold = time_ms(kernel, 200, flush)
        plain_ms = time_ms(plain, 20)
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "max_abs_err": err[name], "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bytes": nbytes,
        }
        log(f"phase 4: {at} {name}: kernel {ms:.4f} ms warm, {ms_cold:.4f} ms cold, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes; "
            f"{bound_ms / ms:.3f} of the bound warm, {bound_ms / ms_cold:.3f} cold)")
    # the f32 pass in each design that takes these rows: the plan's, and the
    # warp design beside it as the control, in the same run
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
    rows["slice_gate"]["max_abs_err"] = err["slice_gate"]
    # the f32 paths again with the warp design forced, so that the record
    # shows whether end to end follows the pass
    with forced_f32_plan(lambda C, T: PlanWarps(-(-C // _F32_WARPS_PER_BLOCK))):
        for name in ("evaluate_fleet", "evaluate_fleet_c"):
            end_to_end[f"{name}, warp design forced"] = end_to_end_ms(
                f"{at} {name}, warp design forced", e2e[name], flush)
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


def seeded_fleet(dev, C: int, T: int, S: int, cut: bool = False):
    """make_example_fleet's layout (uniform slices, the first half idle,
    busy tc in [0.2, 1), hbm in [0.1, 0.9), pods 7200 s old, default params)
    at C chips x T samples in S slices, drawn on the card with a seeded
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


def xl_fleet(dev):
    """bench.py's XL fleet: seeded_fleet at 1,048,576 chips x 360 samples in
    65,536 slices."""
    return seeded_fleet(dev, XL_CHIPS, SAMPLES, XL_SLICES)


def bound_ms_of(name: str, nbytes: int, C: int, T: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the scalar operations over the f32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_SAMPLE[name] * C * T / SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def f32_design_times(args, flush: torch.Tensor, other_k: bool = False) -> dict:
    """Warm and cold times of each design of tp_chip_pass that takes args'
    rows (tc, hbm, valid, age, params: CUDA tensors), each first held
    against the plain version; with other_k, the long-row design also at
    the samples a lane that its plan does not take ("long, K=...")."""
    C, T = args[0].shape
    want = chip_pass_plain(*args)
    plans = _f32_plans(C, T)
    if other_k and "long" in plans:
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
    """Every design of tp_chip_pass at C chips for each T of
    f32_timing_t(C), warm and cold, on seeded_fleet's rows (the long-row
    design also at its other samples a lane); and the shapes where the
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
            "slices": S}


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
            "launch_floor_ms": floor_ms, "chips": C, "slices": S}


def scatter_rows(dev, flush: torch.Tensor) -> dict:
    """Phase 4's scatter reduction at each shape of scatter_fleets."""
    rows = {}
    for name, (cand, ids, S) in scatter_fleets(np.random.default_rng(8642)).items():
        rows[name] = scatter_timing(name, torch.from_numpy(cand).to(dev),
                                    torch.from_numpy(ids).to(dev), S, flush)
    return rows


def phase_dump_width(dev, flush: torch.Tensor) -> dict:
    """Phase 4 at an audit dump's width, 8 samples a chip: the f32 pass in
    each design at 32,768, 131,072 and 1,048,576 chips, warm and cold, beside
    its bound, the plain version and an empty kernel; evaluate_fleet_c end
    to end at 131,072 chips; then the f32 design sweep by T."""
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), 200)  # an empty kernel, timed alike
    rows = {}
    for C in (DRYRUN_CHIPS, CHIPS, XL_CHIPS):
        inputs, expected = seeded_fleet(dev, C, DUMP_SAMPLES, C // CPS, cut=True)
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
            check(np.array_equal(evaluate_fleet_c(*inputs[:4], bounds, inputs[5])[0].cpu().numpy(),
                                 expected), f"{at} evaluate_fleet_c verdicts")
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
    card, the main paths' verdicts against the expected ones, each kernel
    against its plain version, then phase_timing. Timing launches are not
    counted as the main path's."""
    t0 = time.perf_counter()
    inputs, expected = xl_fleet(dev)
    q = quantize_fleet_inputs(inputs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tc, hbm, valid, age, slice_id, parr = inputs
    check(assert_uniform_slices(slice_id, XL_CHIPS // XL_SLICES) == XL_SLICES, "XL layout")
    bounds = slice_bounds(slice_id, XL_SLICES, device=dev)
    verdicts = {
        "evaluate_fleet_c": evaluate_fleet_c(tc, hbm, valid, age, bounds, parr)[0],
        "evaluate_fleet_qc": evaluate_fleet_qc(q[0], q[1], q[2], bounds, q[4])[0],
        "evaluate_fleet_qu": evaluate_fleet_qu(q[0], q[1], q[2], q[4],
                                               XL_CHIPS // XL_SLICES)[0],
    }
    for path, v in verdicts.items():
        check(np.array_equal(v.cpu().numpy(), expected), f"XL {path} verdicts")
    candidate = chip_pass_q(q[0], q[1], q[2], q[4])
    err = {
        "chip_pass": mask_err(chip_pass(tc, hbm, valid, age, parr),
                              chip_pass_plain(tc, hbm, valid, age, parr)),
        "chip_pass_q": mask_err(candidate, chip_pass_q_plain(q[0], q[1], q[2], q[4])),
        "slice_gate": mask_err(slice_gate(candidate, bounds),
                               slice_gate_plain(candidate, bounds)),
    }
    check(not any(err.values()), f"XL kernel mismatch {err}")
    log(f"phase 4: {XL_CHIPS}x{SAMPLES} in {XL_SLICES} slices built on the card in "
        f"{setup_s:.3f} s; {', '.join(verdicts)} verdicts as expected; every kernel equals "
        f"its plain version; {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
    return phase_timing(inputs, q, err, XL_SLICES, flush)


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


def phase_streaming(dev, by_path: dict):
    """The streaming window over STREAM_CYCLES cycles at full width."""
    chunks, expected = stream_chunks(dev)
    check(not np.array_equal(expected[11], expected[12])
          and not np.array_equal(expected[12], expected[13])
          and not np.array_equal(expected[0], expected[1]),
          "the streaming run must turn slices idle by eviction")
    age = torch.full((CHIPS,), 7200.0, device=dev)
    params = PolicyParams(hbm_threshold=0.5)  # the hbm samples (<= 39%) rescue no chip
    pq = torch.from_numpy(quantize_params(
        np.array([params.lookback_s, params.hbm_cutoff()], np.float32))).to(dev)
    bounds = slice_bounds(np.repeat(np.arange(SLICES, dtype=np.int32), CPS), SLICES,
                          device=dev)
    state = init_window(CHIPS, WINDOW_CHUNKS, device=dev)
    fresh = init_window(CHIPS, WINDOW_CHUNKS, device=dev)
    totals = {path: dict.fromkeys(LAUNCHES, 0)
              for path in ("update_window_ + evaluate_window_qc", "evaluate_window_qu")}
    verdicts_qu = []
    for cycle, (tc_new, hbm_new) in enumerate(chunks):
        def qc_cycle():
            nonlocal state
            state = update_window_(state, tc_new, hbm_new)
            return evaluate_window_qc(state, age, bounds, pq)

        v, c = counted(by_path, "update_window_ + evaluate_window_qc", qc_cycle)
        expect_launches(by_path, "update_window_ + evaluate_window_qc",
                        {"chip_pass_q": 1, "slice_gate": 1})
        # the functional form follows on its own rings, never the ones it was given
        prev, fresh = fresh, update_window(fresh, tc_new, hbm_new)
        check(fresh[0].data_ptr() != prev[0].data_ptr()
              and all(torch.equal(a, b) for a, b in zip(fresh, state)),
              f"cycle {cycle}: update_window differs from update_window_")
        vu, cu = counted(by_path, "evaluate_window_qu",
                         lambda: evaluate_window_qu(state, age, pq, CPS))
        expect_launches(by_path, "evaluate_window_qu", {"chip_pass_q": 1, "slice_gate": 0})
        for path, total in totals.items():
            for name in total:
                total[name] += by_path[path][name]
        window = chunks[max(0, cycle - WINDOW_CHUNKS + 1):cycle + 1]
        full_v, full_c = evaluate_fleet_qc(torch.cat([w[0] for w in window], dim=1),
                                           torch.cat([w[1] for w in window], dim=1),
                                           age, bounds, pq)
        check(torch.equal(v, full_v) and torch.equal(c, full_c),
              f"cycle {cycle}: window_qc differs from the full re-evaluation")
        check(torch.equal(vu, v) and torch.equal(cu, c), f"cycle {cycle}: window_qu != qc")
        check(np.array_equal(v.cpu().numpy(), expected[cycle]), f"cycle {cycle}: verdicts")
        verdicts_qu.append(vu)
    by_path.update(totals)
    err = mask_err(chip_pass_q(state[0], state[1], age, pq),
                   chip_pass_q_plain(state[0], state[1], age, pq))
    check(err == 0, "chip_pass_q differs from its plain version on the window ring")
    log(f"phase 5: streaming window {CHIPS} chips, K={WINDOW_CHUNKS}, {CHUNK_SAMPLES} new "
        f"samples a cycle, {STREAM_CYCLES} cycles: window_qc and _qu equal the full "
        f"re-evaluation every cycle; idle slices by cycle "
        f"{[int(e.sum()) for e in expected]}")
    return {"chunks": chunks, "age": age, "pq": pq, "verdicts_qu": verdicts_qu}, err


def phase_sharded_one_rank(dev, by_path: dict, inputs, expected, q, stream) -> None:
    """Every sharded evaluator in a one-rank NCCL group equals the
    single-device results, launching its kernel once."""
    bounds = slice_bounds(inputs[4], SLICES, device=dev)
    ref = {"f32": evaluate_fleet(*inputs, num_slices=SLICES),
           "q": evaluate_fleet_q(*q, num_slices=SLICES)}
    runs = {
        "evaluate_fleet_sharded": ("chip_pass", "f32", lambda: evaluate_fleet_sharded(
            *inputs, num_slices=SLICES)),
        "evaluate_fleet_sharded_q": ("chip_pass_q", "q", lambda: evaluate_fleet_sharded_q(
            *q, num_slices=SLICES)),
        "evaluate_fleet_sharded_qc": ("chip_pass_q", "q", lambda: evaluate_fleet_sharded_qc(
            q[0], q[1], q[2], bounds, q[4])),
        "evaluate_fleet_sharded_qu": ("chip_pass_q", "q", lambda: evaluate_fleet_sharded_qu(
            q[0], q[1], q[2], q[4], CPS)),
        "make_sharded_evaluator": ("chip_pass", "f32", lambda: run_local(
            make_sharded_evaluator, SLICES, *inputs)),
        "make_sharded_evaluator_q": ("chip_pass_q", "q", lambda: run_local(
            make_sharded_evaluator_q, SLICES, *q)),
        "make_sharded_evaluator_qc": ("chip_pass_q", "q", lambda: run_local(
            make_sharded_evaluator_qc, SLICES, q[0], q[1], q[2],
            shard_bounds(bounds, 1, CHIPS, device=dev), q[4])),
        "make_sharded_evaluator_qu": ("chip_pass_q", "q", lambda: run_local(
            make_sharded_evaluator_qu, CPS, q[0], q[1], q[2], q[4])),
    }
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rdv"),
                                rank=0, world_size=1)
        try:
            for path, (kernel, kind, run) in runs.items():
                name = f"one-rank NCCL: {path}"
                v, c = counted(by_path, name, run)  # counts, not verdicts: no gate
                expect_launches(by_path, name, {kernel: 1, "slice_gate": 0})
                check(np.array_equal(v.cpu().numpy(), expected)
                      and torch.equal(v, ref[kind][0]) and torch.equal(c, ref[kind][1]),
                      f"{name} differs from the single-device evaluation")
            name = "one-rank NCCL: make_sharded_stream_step"
            cycles = counted(by_path, name, lambda: run_stream_local(
                CPS, WINDOW_CHUNKS, [ch[0] for ch in stream["chunks"]],
                [ch[1] for ch in stream["chunks"]], stream["age"], stream["pq"]))
            expect_launches(by_path, name, {"chip_pass_q": STREAM_CYCLES, "slice_gate": 0})
            for cycle, (v, *_) in enumerate(cycles):
                check(torch.equal(v, stream["verdicts_qu"][cycle]),
                      f"{name}: cycle {cycle} differs from update_window + evaluate_window_qu")
        finally:
            dist.destroy_process_group()
    log(f"phase 6: {len(runs) + 1} sharded paths in a one-rank NCCL group equal the "
        "single-device results")


def phase_dryrun(by_path: dict) -> None:
    """dryrun_multichip over DRYRUN_RANKS gloo ranks on the one card."""
    t0 = time.perf_counter()
    summaries = entry.dryrun_multichip(DRYRUN_RANKS, device="cuda", backend="gloo",
                                       chips_per_rank=CHIPS // DRYRUN_RANKS,
                                       num_samples=SAMPLES, timeout_s=600)
    want = {"make_sharded_evaluator": {"chip_pass": 1, "slice_gate": 0},
            "evaluate_fleet_sharded": {"chip_pass": 1, "slice_gate": 0},
            "evaluate_fleet_sharded_q": {"chip_pass_q": 1, "slice_gate": 0},
            "evaluate_fleet_sharded_qc": {"chip_pass_q": 1, "slice_gate": 0},
            "evaluate_fleet_sharded_qu": {"chip_pass_q": 1, "slice_gate": 0},
            "make_sharded_stream_step": {"chip_pass_q": entry.STREAM_CHUNKS + 2,
                                         "slice_gate": 0}}
    want = {path: {name: w.get(name, 0) for name in LAUNCHES} for path, w in want.items()}
    for rank, s in enumerate(summaries):
        check(s["launches"] == want, f"dryrun rank {rank} launched {s['launches']}, "
              f"expected {want}")
        check(s["num_chips"] == CHIPS and s["odd_chips"] % DRYRUN_RANKS,
              f"dryrun rank {rank} sizes {s}")
    for path in want:
        by_path[f"dryrun_multichip({DRYRUN_RANKS}, gloo): {path}"] = {
            name: sum(s["launches"][path][name] for s in summaries) for name in LAUNCHES}
    log(f"phase 7: dryrun_multichip({DRYRUN_RANKS}) with gloo on one card, "
        f"{CHIPS} chips: every rank verified every sharded path in "
        f"{time.perf_counter() - t0:.3f} s")


def phase_host_tooling(card: str) -> None:
    """Phase 8: the port's C++ core, unit runner, fuzz and replay smoke."""
    from tpu_pruner_torch import native
    from tpu_pruner_torch.testing import replay_smoke

    t0 = time.perf_counter()
    native.ensure_built()
    build_s = time.perf_counter() - t0
    units = subprocess.run([str(native.TESTS_PATH)], capture_output=True, text=True,
                           timeout=300)
    check(units.returncode == 0 and ", 0 failed" in units.stdout,
          f"the C++ unit runner failed:\n{units.stdout[-3000:]}{units.stderr[-3000:]}")
    fuzz = subprocess.run([str(native.BUILD_DIR / "tpupruner_fuzz"), "20000"],
                          capture_output=True, text=True, timeout=300)
    check(fuzz.returncode == 0 and "fuzz ok: 20000 iterations" in fuzz.stderr,
          f"the fuzz smoke failed:\n{fuzz.stderr[-3000:]}")
    t0 = time.perf_counter()
    rc = replay_smoke.main()
    smoke_s = time.perf_counter() - t0
    check(rc == 0, f"the replay smoke exited {rc}")
    loaded = sorted(name for name in sys.modules
                    if name.startswith("jax") or name.split(".")[0] == "tpu_pruner")
    check(not loaded, f"modules of jax or tpu_pruner were loaded: {loaded}")
    log(f"phase 8: g++ build of native/ (library, daemon, unit runner, fuzz) "
        f"{build_s:.3f} s; {units.stdout.strip().splitlines()[-1]}; "
        f"{fuzz.stderr.strip().splitlines()[-1]}; replay smoke {smoke_s:.3f} s; "
        f"no jax or tpu_pruner module loaded; {card}")


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
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    err = phase_adversarial(dev)
    err["chip_pass_q"] = max(err["chip_pass_q"], phase_int8_edges(dev))
    phase_int8_designs(dev)
    err["chip_pass"] = max(err["chip_pass"], phase_f32_designs(dev))
    err["slice_gate"] = phase_gate(dev)
    err["slice_scatter"] = phase_scatter(dev)
    input_err = phase_engine_inputs(dev)
    err = {name: max(e, input_err) for name, e in err.items()}
    by_path = {}
    inputs, expected, q, main_err = phase_main_path(dev, by_path)
    err = {name: max(err[name], main_err[name]) for name in err}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows, end_to_end = phase_timing(inputs, q, err, SLICES, flush)
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
    rows["slice_scatter"] = {**next(iter(scatter.values())), "fleets": scatter,
                             "max_abs_err": err["slice_scatter"]}
    stream, ring_err = phase_streaming(dev, by_path)
    phase_sharded_one_rank(dev, by_path, inputs, expected, q, stream)
    phase_dryrun(by_path)
    phase_host_tooling(card)
    for name, row in rows.items():
        row["max_abs_err"] = max(row["max_abs_err"], ring_err if name == "chip_pass_q" else 0)
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items() if c[name]}
        row["launches"] = sum(row["launches_by_path"].values())
        check(row["launches"] > 0, f"{name} was never launched on the main path")
    for name, by_design, counts, planned in (
            ("chip_pass_q", DESIGNS_BY_PATH, DESIGN_LAUNCHES, sorted(DESIGN_LAUNCHES)),
            ("chip_pass", F32_DESIGNS_BY_PATH, F32_DESIGN_LAUNCHES, F32_PLANNED)):
        designs = {d: sum(c[d] for c in by_design.values()) for d in counts}
        rows[name]["launches_by_design"] = designs
        check(all(designs[d] for d in planned), f"every design of {name} that its plan takes "
              f"({planned}) must run on the main path (phases 3, 5 and 6): {designs}")
        log(f"{name} launches by design in phases 3, 5 and 6: {designs} (by path: "
            f"{ {p: {d: n for d, n in c.items() if n} for p, c in by_design.items() if any(c.values())} })")
    print(json.dumps({"end_to_end": {f"{CHIPS} chips": end_to_end,
                                     f"{XL_CHIPS} chips": xl_end_to_end}}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
