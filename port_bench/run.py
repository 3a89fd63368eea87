"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's driver (its inputs from the seed, the program's
kernels from their cache in the checkout), warms up the cell's own shapes
with ``warmup_ops`` operations, then measures a closed loop with one caller
for ``--seconds``: each operation starts when the previous one has returned
to the host, and the window ends with the operation that crosses its length.
``--trace 1`` traces up to ``trace_ops`` operations of the window with
``torch.profiler`` and reports the cell's per-layer metrics instead of its
end-to-end ones. A sample of the window's answers, drawn from the seed, is
then compared with the plain reference; the numbers compared and their
limits are the last lines on stderr and the last key of the result.

Without a CUDA device, or with fewer than the cell asks for, it exits with
code 2 and prints no result; it exits with code 3, and no result, if JAX or
the JAX package got loaded.
"""

import time

_PROCESS_T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench.cell import Ctx, load_cell, load_module  # noqa: E402
from port_bench.check import Compared, Reservoir  # noqa: E402
from port_bench.trace import Spans, Trace, breakdown, busy_s, trace_window  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pruner")
WORKDIR = Path("build") / "port_bench"  # the run's files and caches, in the checkout


@dataclass
class Run:
    """What a per-layer metric's reader reads."""

    cell: str
    trace: Trace | None
    ops: int
    spans: dict
    shape: dict


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every compile cache the card's stack may use, at fixed paths in the
    checkout (the program builds its own kernels into build/torch_kernels)."""
    cache = root / WORKDIR / "cache"
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def window(driver, start: int, seconds: float, max_ops: int, reservoir: Reservoir):
    """The closed loop: (per-operation seconds, failures, window seconds)."""
    times, failed, i = [], 0, start
    t_begin = time.perf_counter()
    t_end = t_begin
    while True:
        t = time.perf_counter()
        try:
            answer = driver.step(i)
        except Exception:  # a failed operation is counted and the loop goes on
            if not failed:
                traceback.print_exc()
            failed, answer = failed + 1, None
        t_end = time.perf_counter()
        times.append(t_end - t)
        reservoir.offer(i, answer)
        i += 1
        if t_end - t_begin >= seconds or len(times) >= max_ops:
            return times, failed, t_end - t_begin


def end_to_end(stat: str, times: list, elapsed: float) -> float:
    if stat == "mean_ms":
        return elapsed / len(times) * 1e3
    if stat == "mean_s":
        return elapsed / len(times)
    if stat == "p95_ms":
        return float(np.percentile(times, 95)) * 1e3
    raise ValueError(f"unknown statistic {stat!r}")


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        root: Path = ROOT, config: dict | None = None, t0: float | None = None):
    """One run of a cell: (result dict, numbers compared). ``config``
    replaces the cell's configuration (tests run tiny ones on the CPU)."""
    t0 = time.monotonic() if t0 is None else t0
    device = torch.device(device)
    cell = load_cell(root, workload)
    mix = cell.mix
    ctx = Ctx(workload, config or cell.config, mix, seed, device, root / WORKDIR, Spans())
    t_inputs = time.monotonic()
    driver = cell.driver(ctx)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.monotonic()
    warm = mix["warmup_ops"]
    for i in range(warm):
        driver.step(i)
    _sync(device)
    setup_s = time.monotonic() - t0
    print(f"set-up {setup_s:.3f} s: start and imports {t_inputs - t0:.3f}, inputs "
          f"{t_warm - t_inputs:.3f}, {warm} warm-up operations {t0 + setup_s - t_warm:.3f}",
          file=sys.stderr)

    reservoir = Reservoir(mix["check_samples"], seed)
    traced = None
    if trace:
        ctx.spans.on = True
        driver.trace(True)
        box = {}
        traced = trace_window(lambda: box.update(zip(
            ("times", "failed", "elapsed"),
            window(driver, warm, seconds, mix["trace_ops"], reservoir))), device)
        driver.trace(False)
        ctx.spans.on = False
        times, failed, elapsed = box["times"], box["failed"], box["elapsed"]
    else:
        times, failed, elapsed = window(driver, warm, seconds, sys.maxsize, reservoir)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    t_ref = time.monotonic()
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = driver.compare(reservoir.kept) + [Compared("failed", failed, 0)]
    print(f"reference and comparison {time.monotonic() - t_ref:.3f} s over "
          f"{len(reservoir.kept)} answers of {len(times)}", file=sys.stderr)

    if trace:
        view = Run(workload, traced, len(times), dict(ctx.spans.seconds), driver.shape())
        metrics = {}
        for entry in cell.per_layer:
            value = load_module(cell.reader_path(entry["name"]),
                                f"port_bench_metric_{entry['name']}").read(view)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        stats = mix["end_to_end"]
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for entry in cell.end_to_end:
            if entry["name"] != "setup_s":
                metrics[entry["name"]] = {"value": end_to_end(stats[entry["name"]], times,
                                                              elapsed),
                                          "unit": entry["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": len(times) > 0 and all(c.ok for c in compared),
              "attempted": len(times), "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = busy_s(traced)
        dev["window_s"] = traced.window_s
        result["breakdown"] = breakdown(traced)
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    return result, compared


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.run", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    chips = load_cell(ROOT, args.workload).entry["chips"]
    if torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, compared = run(args.workload, args.seed, args.seconds, bool(args.trace),
                           t0=_PROCESS_T0)
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for c in compared:
        print(f"compared {c.name} {c.value} limit {c.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
