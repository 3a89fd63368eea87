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
   quantize_fleet_inputs + evaluate_fleet_qc, the analyze evaluation and
   the analyze CLI; verdicts must equal the fleet's expected verdicts, each
   path (counts zeroed just before it, read just after) must launch its own
   kernel exactly once and the other kernel never, and each kernel must
   equal its plain version on the main path's inputs;
4. time each kernel with CUDA events (median over many launches) beside
   its plain version and its bound at the card's published rates: warm
   (back to back) and cold (a 256 MB scratch buffer zeroed before each
   launch, outside the events, so the 50 MB L2 holds none of the inputs);
   and evaluate_fleet_qc end to end (chip pass + cumsum + boundary
   gather): its device time, warm and cold, from replays of a CUDA graph
   of one evaluation, and its eager host wall time per call.

The line before the last is {"kernels": [...]}; the last line is
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

from tpu_pruner_torch import analyze
from tpu_pruner_torch.policy import (
    LAUNCHES, PolicyParams, _build, chip_pass, chip_pass_plain, chip_pass_q,
    chip_pass_q_plain, evaluate_fleet, evaluate_fleet_c, evaluate_fleet_qc,
    make_example_fleet, quantize_fleet_inputs, quantize_params,
    quantize_samples, quantize_samples_device, reset_launches, slice_bounds)

CHIPS, SAMPLES, SLICES = 131072, 360, 8192
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


def analyze_cli_check(dev) -> None:
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
        with open(path, "w") as f:
            json.dump(doc, f)
        for extra in ([], ["--quantize"]):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = analyze.main([path, "--device", dev.type, *extra])
            check(rc == 0, f"analyze CLI {extra} returned {rc}: {err.getvalue()}")
            result = json.loads(out.getvalue().strip().splitlines()[-1])
            check(result["reclaimable_slices"] == ["ml/idle"] and result["idle_chips"] == 2,
                  f"analyze CLI {extra} gave {result}")


def phase_main_path(dev):
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

    # Each path runs with the counts zeroed just before it and read just
    # after: it must launch its own kernel exactly once and the other never.
    paths = {
        "evaluate_fleet": ("chip_pass", lambda: evaluate_fleet(*inputs, num_slices=SLICES)[0]),
        "evaluate_fleet_c": ("chip_pass", lambda: evaluate_fleet_c(
            tc, hbm, valid, age, bounds, parr)[0]),
        "evaluate_fleet_qc": ("chip_pass_q", lambda: evaluate_fleet_qc(
            q[0], q[1], q[2], bounds, q[4])[0]),
        "analyze.evaluate_loaded": ("chip_pass", lambda: loaded(False)),
        "analyze.evaluate_loaded --quantize": ("chip_pass_q", lambda: loaded(True)),
    }
    by_path = {}
    t0 = time.perf_counter()
    for path, (kernel, run) in paths.items():
        reset_launches()
        v = run()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        check(np.array_equal(v, expected), f"{path} verdicts")
        want = {name: int(name == kernel) for name in counts}
        check(counts == want, f"{path} launched {counts}, expected {want}")
        by_path[path] = counts
    main_s = time.perf_counter() - t0
    launches = {name: {path: c[name] for path, c in by_path.items() if c[name]}
                for name in LAUNCHES}
    analyze_cli_check(dev)  # small dump through the CLI; its launches are not counted
    log(f"phase 3: main path {CHIPS}x{SAMPLES} in {SLICES} slices ok "
        f"(setup {setup_s:.3f} s, evaluations {main_s:.3f} s, launches {launches})")

    # each kernel against its plain version on the main path's own inputs
    err = {
        "chip_pass": mask_err(chip_pass(tc, hbm, valid, age, parr),
                              chip_pass_plain(tc, hbm, valid, age, parr)),
        "chip_pass_q": mask_err(chip_pass_q(q[0], q[1], q[2], q[4]),
                                chip_pass_q_plain(q[0], q[1], q[2], q[4])),
    }
    check(not any(err.values()), f"full-width kernel mismatch {err}")
    return launches, inputs, q, err


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


def phase_timing(launches, inputs, q, err):
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
    rows = []
    for name, (kernel, plain, nbytes) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_SAMPLE[name] * C * T / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        ms = time_ms(kernel, 200)
        ms_cold = time_ms(kernel, 200, flush)
        plain_ms = time_ms(plain, 20)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": err[name], "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "bytes": nbytes,
        })
        log(f"phase 4: {name}: kernel {ms:.4f} ms warm, {ms_cold:.4f} ms cold, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes; "
            f"{bound_ms / ms:.3f} of the bound warm, {bound_ms / ms_cold:.3f} cold)")
    bounds = slice_bounds(slice_id, SLICES, device=tc.device)
    qc = lambda: evaluate_fleet_qc(tc_q, hbm_q, age, bounds, parr_q)  # noqa: E731
    # An evaluation is a dozen small launches, so queued eager calls run at
    # the host's pace; its device time comes from replays of a CUDA graph.
    graph = graph_of(qc)
    qc_ms, qc_cold = time_ms(graph.replay, 200), time_ms(graph.replay, 200, flush)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        qc()
    torch.cuda.synchronize()
    qc_wall = (time.perf_counter() - t0) / 50 * 1e3
    log(f"phase 4: evaluate_fleet_qc end to end (chip pass + cumsum + gather): device "
        f"{qc_ms:.4f} ms warm, {qc_cold:.4f} ms cold (CUDA graph replay); eager host wall "
        f"{qc_wall:.4f} ms per call")
    amax_ms = time_ms(lambda: torch.amax(tc, 1), 50)
    log(f"context (not a port of either kernel): torch.amax(tc, 1) {amax_ms:.4f} ms")
    return rows


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
    log(smi.stdout.strip().splitlines()[0])

    err = phase_adversarial(dev)
    err["chip_pass_q"] = max(err["chip_pass_q"], phase_int8_edges(dev))
    launches, inputs, q, main_err = phase_main_path(dev)
    err = {name: max(err[name], main_err[name]) for name in err}
    rows = phase_timing(launches, inputs, q, err)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
