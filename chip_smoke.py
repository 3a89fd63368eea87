#!/usr/bin/env python3
"""Smoke run of tpu_pruner_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each of which exits non-zero on failure:

1. build the CUDA kernels from tpu_pruner_torch/policy/csrc with nvcc
   (sm_90a), print each kernel's registers, shared memory and spills
   (a second nvcc with -Xptxas -v, started with the build), and print the
   card's name and power limit;
2. hold each kernel against its plain PyTorch version on an adversarial
   fleet (ragged chip counts, T in {1, 12, 31, 360, 361}, all-invalid rows,
   NaN, subnormals, -0.0, +-inf, finite/+inf/subnormal cutoffs, young
   pods): the masks must be equal, and so must the card's int8 quantizer
   and the numpy one. Then the int8 kernel alone on its edges: T in
   {1, 12, 31, 360, 361, 10080}, C in {1, 17, 1003}, contiguous tensors and
   views whose data pointers are off a 16-byte boundary (x[1:] of a
   [C+1, T] tensor, and arbitrary byte offsets), rows of all -1, -128 and
   127, and one full-width 131,072 x 360 view;
3. drive the main path at full width -- 131,072 chips x 360 samples in
   8,192 slices -- through evaluate_fleet, evaluate_fleet_c,
   quantize_fleet_inputs + evaluate_fleet_qc, the uniform path
   (assert_uniform_slices + evaluate_fleet_qu: the fleet is 16 chips a
   slice), the analyze evaluation, and the analyze CLI (batch, --shard in a
   one-rank group, --stream over two cycles); verdicts must equal the
   fleet's expected verdicts, each path (counts zeroed just before it, read
   just after) must launch its own kernel exactly once and the other kernel
   never, and each kernel must equal its plain version on the main path's
   inputs;
4. time each kernel with CUDA events (median over many launches) beside
   its plain version and its bound at the card's published rates: warm
   (back to back) and cold (a 256 MB scratch buffer zeroed before each
   launch, outside the events, so the 50 MB L2 holds none of the inputs);
   the int8 kernel also at T = 12, the streaming window's shape; and, end
   to end, evaluate_fleet_qc, evaluate_fleet_qu and one streaming cycle
   (update_window + evaluate_window_qc or _qu): device time, warm and
   cold, from replays of a CUDA graph of one call, and eager host wall time
   per call;
5. the streaming window at full width, K = 12 chunks of 6 new samples a
   cycle, 14 cycles (the ring wraps): each cycle's evaluate_window_qc and
   _qu must equal evaluate_fleet_qc over the last <= 12 chunks and the
   verdicts the chunks were built for; some slices turn idle exactly when
   their busy chunk is evicted; each window evaluation launches the int8
   kernel once;
6. every sharded evaluator and the stream step in a one-rank NCCL group
   (file:// rendezvous), at full width, against the single-device results;
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
per path of phases 3 and 5-7; the line before it is {"end_to_end": {...}},
phase 4's end-to-end times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
    chip_pass_q, chip_pass_q_plain, evaluate_fleet, evaluate_fleet_c, evaluate_fleet_q,
    evaluate_fleet_qc, evaluate_fleet_qu, evaluate_fleet_sharded, evaluate_fleet_sharded_q,
    evaluate_fleet_sharded_qc, evaluate_fleet_sharded_qu, evaluate_window_qc,
    evaluate_window_qu, init_window, make_example_fleet, make_sharded_evaluator,
    make_sharded_evaluator_q, make_sharded_evaluator_qc, make_sharded_evaluator_qu,
    quantize_fleet_inputs, quantize_params, quantize_samples, quantize_samples_device,
    reset_launches, shard_bounds, slice_bounds, update_window)
from tpu_pruner_torch.policy.kernels import _plan_q, _sm_count
from tpu_pruner_torch.policy.sharded import run_local, run_stream_local

CHIPS, SAMPLES, SLICES = 131072, 360, 8192
CPS = CHIPS // SLICES  # the example fleet is uniform: 16 chips a slice
WINDOW_CHUNKS, CHUNK_SAMPLES, STREAM_CYCLES = 12, 6, 14  # the daemon's window shape
DRYRUN_RANKS = 4
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
KERNEL_SYMBOLS = {"chip_pass": "chip_pass_kernel", "chip_pass_q": "chip_pass_q_kernel"}
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


def counted(by_path: dict, path: str, run):
    """run() with the kernel counts zeroed just before it and read just after;
    the counts are recorded under path."""
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    by_path[path] = dict(LAUNCHES)
    return out


def expect_launches(by_path: dict, path: str, want: dict) -> None:
    want = {name: want.get(name, 0) for name in LAUNCHES}
    check(by_path[path] == want, f"{path} launched {by_path[path]}, expected {want}")


def analyze_cli_check(dev, by_path: dict) -> None:
    """A small dump through the CLI: batch, --quantize, --shard [--quantize]
    (a one-rank group on the card) and two --stream cycles; each run must
    launch its kernel once."""
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
        runs = [("analyze CLI", [], "chip_pass"),
                ("analyze CLI --quantize", ["--quantize"], "chip_pass_q"),
                ("analyze CLI --shard", ["--shard"], "chip_pass"),
                ("analyze CLI --shard --quantize", ["--shard", "--quantize"], "chip_pass_q"),
                ("analyze CLI --stream (cycle 1)", ["--stream", state], "chip_pass_q"),
                ("analyze CLI --stream (cycle 2)", ["--stream", state], "chip_pass_q")]
        for cycle, (name, extra, kernel) in enumerate(runs):
            with open(path, "w") as f:
                json.dump({**doc, "timestamp": 1000.0 + 180 * cycle}, f)
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = counted(by_path, name,
                             lambda: analyze.main([path, "--device", dev.type, *extra]))
            check(rc == 0, f"{name} returned {rc}: {err.getvalue()}")
            expect_launches(by_path, name, {kernel: 1})
            result = json.loads(out.getvalue().strip().splitlines()[-1])
            check(result["reclaimable_slices"] == ["ml/idle"] and result["idle_chips"] == 2,
                  f"{name} gave {result}")
        check(result["window"]["filled"] == 2 and result["newly_reclaimable"] == [],
              f"analyze --stream second cycle gave {result}")


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
    # after: it must launch its own kernel exactly once and the other never.
    paths = {
        "evaluate_fleet": ("chip_pass", lambda: evaluate_fleet(*inputs, num_slices=SLICES)[0]),
        "evaluate_fleet_c": ("chip_pass", lambda: evaluate_fleet_c(
            tc, hbm, valid, age, bounds, parr)[0]),
        "evaluate_fleet_qc": ("chip_pass_q", lambda: evaluate_fleet_qc(
            q[0], q[1], q[2], bounds, q[4])[0]),
        "evaluate_fleet_qu": ("chip_pass_q", uniform),
        "analyze.evaluate_loaded": ("chip_pass", lambda: loaded(False)),
        "analyze.evaluate_loaded --quantize": ("chip_pass_q", lambda: loaded(True)),
    }
    t0 = time.perf_counter()
    for path, (kernel, run) in paths.items():
        v = counted(by_path, path, run)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        check(np.array_equal(v, expected), f"{path} verdicts")
        expect_launches(by_path, path, {kernel: 1})
    main_s = time.perf_counter() - t0
    analyze_cli_check(dev, by_path)
    log(f"phase 3: main path {CHIPS}x{SAMPLES} in {SLICES} slices ok "
        f"(setup {setup_s:.3f} s, evaluations {main_s:.3f} s, launches "
        f"{ {p: c for p, c in by_path.items()} })")

    # each kernel against its plain version on the main path's own inputs
    err = {
        "chip_pass": mask_err(chip_pass(tc, hbm, valid, age, parr),
                              chip_pass_plain(tc, hbm, valid, age, parr)),
        "chip_pass_q": mask_err(chip_pass_q(q[0], q[1], q[2], q[4]),
                                chip_pass_q_plain(q[0], q[1], q[2], q[4])),
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


def phase_timing(inputs, q, err):
    tc, hbm, valid, age, slice_id, parr = inputs
    tc_q, hbm_q = q[0], q[1]
    parr_q = q[4]
    C, T = tc.shape
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=tc.device)
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
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_SAMPLE[name] * C * T / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        ms = time_ms(kernel, 200)
        ms_cold = time_ms(kernel, 200, flush)
        plain_ms = time_ms(plain, 20)
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "max_abs_err": err[name], "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bytes": nbytes,
        }
        log(f"phase 4: {name}: kernel {ms:.4f} ms warm, {ms_cold:.4f} ms cold, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes; "
            f"{bound_ms / ms:.3f} of the bound warm, {bound_ms / ms_cold:.3f} cold)")

    # the streaming window's shape: a full ring of 12 chunk maxima per chip
    tc_new, hbm_new = tc_q[:, :CHUNK_SAMPLES].contiguous(), hbm_q[:, :CHUNK_SAMPLES].contiguous()
    state = init_window(C, WINDOW_CHUNKS, device=tc.device)
    for _ in range(WINDOW_CHUNKS):
        state = update_window(state, tc_new, hbm_new)
    ring_bytes = sum(x.nbytes for x in (state[0], state[1], age, parr_q)) + C
    ring_ms = time_ms(lambda: chip_pass_q(state[0], state[1], age, parr_q), 200)
    ring_bound = ring_bytes / HBM_BYTES_PER_S * 1e3
    plan = _plan_q(C, WINDOW_CHUNKS, _sm_count(tc.device))
    rows["chip_pass_q"]["window"] = {"T": WINDOW_CHUNKS, "ms": ring_ms, "bound_ms": ring_bound,
                                     "bytes": ring_bytes, "plan": plan._asdict()}
    log(f"phase 4: chip_pass_q at T={WINDOW_CHUNKS}: kernel {ring_ms:.4f} ms warm, bound "
        f"{ring_bound:.4f} ms ({ring_bytes} bytes; {ring_bound / ring_ms:.3f} of the bound; "
        f"plan {plan})")

    bounds = slice_bounds(slice_id, SLICES, device=tc.device)
    e2e = {
        "evaluate_fleet_qc": lambda: evaluate_fleet_qc(tc_q, hbm_q, age, bounds, parr_q),
        "evaluate_fleet_qu": lambda: evaluate_fleet_qu(tc_q, hbm_q, age, parr_q, CPS),
        # one cycle's work; the cursor does not advance between timed calls
        "streaming cycle, update_window + evaluate_window_qc": lambda: evaluate_window_qc(
            update_window(state, tc_new, hbm_new), age, bounds, parr_q),
        "streaming cycle, update_window + evaluate_window_qu": lambda: evaluate_window_qu(
            update_window(state, tc_new, hbm_new), age, parr_q, CPS),
    }
    end_to_end = {name: end_to_end_ms(name, fn, flush) for name, fn in e2e.items()}
    amax_ms = time_ms(lambda: torch.amax(tc, 1), 50)
    log(f"context (not a port of either kernel): torch.amax(tc, 1) {amax_ms:.4f} ms")
    return list(rows.values()), end_to_end


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
    totals = {"update_window + evaluate_window_qc": 0, "evaluate_window_qu": 0}
    verdicts_qu = []
    for cycle, (tc_new, hbm_new) in enumerate(chunks):
        def qc_cycle():
            nonlocal state
            state = update_window(state, tc_new, hbm_new)
            return evaluate_window_qc(state, age, bounds, pq)

        v, c = counted(by_path, "update_window + evaluate_window_qc", qc_cycle)
        expect_launches(by_path, "update_window + evaluate_window_qc", {"chip_pass_q": 1})
        vu, cu = counted(by_path, "evaluate_window_qu",
                         lambda: evaluate_window_qu(state, age, pq, CPS))
        expect_launches(by_path, "evaluate_window_qu", {"chip_pass_q": 1})
        for path in totals:
            totals[path] += by_path[path]["chip_pass_q"]
        window = chunks[max(0, cycle - WINDOW_CHUNKS + 1):cycle + 1]
        full_v, full_c = evaluate_fleet_qc(torch.cat([w[0] for w in window], dim=1),
                                           torch.cat([w[1] for w in window], dim=1),
                                           age, bounds, pq)
        check(torch.equal(v, full_v) and torch.equal(c, full_c),
              f"cycle {cycle}: window_qc differs from the full re-evaluation")
        check(torch.equal(vu, v) and torch.equal(cu, c), f"cycle {cycle}: window_qu != qc")
        check(np.array_equal(v.cpu().numpy(), expected[cycle]), f"cycle {cycle}: verdicts")
        verdicts_qu.append(vu)
    for path, n in totals.items():
        by_path[path] = {"chip_pass": 0, "chip_pass_q": n}
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
                v, c = counted(by_path, name, run)
                expect_launches(by_path, name, {kernel: 1})
                check(np.array_equal(v.cpu().numpy(), expected)
                      and torch.equal(v, ref[kind][0]) and torch.equal(c, ref[kind][1]),
                      f"{name} differs from the single-device evaluation")
            name = "one-rank NCCL: make_sharded_stream_step"
            cycles = counted(by_path, name, lambda: run_stream_local(
                CPS, WINDOW_CHUNKS, [ch[0] for ch in stream["chunks"]],
                [ch[1] for ch in stream["chunks"]], stream["age"], stream["pq"]))
            expect_launches(by_path, name, {"chip_pass_q": STREAM_CYCLES})
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
    want = {"make_sharded_evaluator": {"chip_pass": 1},
            "evaluate_fleet_sharded": {"chip_pass": 1},
            "evaluate_fleet_sharded_q": {"chip_pass_q": 1},
            "evaluate_fleet_sharded_qc": {"chip_pass_q": 1},
            "evaluate_fleet_sharded_qu": {"chip_pass_q": 1},
            "make_sharded_stream_step": {"chip_pass_q": entry.STREAM_CHUNKS + 2}}
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
    by_path = {}
    inputs, expected, q, main_err = phase_main_path(dev, by_path)
    err = {name: max(err[name], main_err[name]) for name in err}
    rows, end_to_end = phase_timing(inputs, q, err)
    stream, ring_err = phase_streaming(dev, by_path)
    phase_sharded_one_rank(dev, by_path, inputs, expected, q, stream)
    phase_dryrun(by_path)
    phase_host_tooling(card)
    for row in rows:
        name = row["name"]
        row["max_abs_err"] = max(row["max_abs_err"], ring_err if name == "chip_pass_q" else 0)
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items() if c[name]}
        row["launches"] = sum(row["launches_by_path"].values())
        check(row["launches"] > 0, f"{name} was never launched on the main path")
    print(json.dumps({"end_to_end": end_to_end}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
