"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 -m port_bench.control --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2]

For each seed it builds the cell as a run does, warms it up, runs a short
window of the program and compares a sample of its answers with the plain
reference: the lower readings. For each control seed it puts the
reference, computed in the precision below the configuration's (``bf16``
for an audit's f32, ``int4`` for the int8 window), in the program's place
at the same operations, and compares its answers alike: the upper
readings. One process reads every seed. A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from port_bench.cell import Ctx, load_cell
from port_bench.check import Reservoir
from port_bench.run import ROOT, WORKDIR, set_cache_dirs, window
from port_bench.trace import Spans


def readings(workload: str, seed: int, seconds: float, control: bool, device="cuda",
             config: dict | None = None) -> dict:
    cell = load_cell(ROOT, workload)
    ctx = Ctx(workload, config or cell.config, cell.mix, seed, torch.device(device),
              ROOT / WORKDIR, Spans())
    driver = cell.driver(ctx)
    warm = cell.mix["warmup_ops"]
    for i in range(warm):
        driver.step(i)
    reservoir = Reservoir(cell.mix["check_samples"], seed)
    times, failed, _ = window(driver, warm, seconds, sys.maxsize, reservoir)
    driver.release()
    out = {"seed": seed, "ops": len(times), "failed": failed,
           "program": {c.name: c.value for c in driver.compare(reservoir.kept)}}
    if control:
        answers = [(i, driver.control(i)) for i, _ in reservoir.kept]
        out["control"] = {c.name: c.value for c in driver.compare(answers)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.control",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control-seeds", default="", help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for seed in sorted(set(seeds) | controls):
        r = readings(args.workload, seed, args.seconds, seed in controls)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
        if seed in seeds:
            for k, v in r["program"].items():
                lower[k] = max(lower.get(k, 0), v)
        for k, v in r.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(),
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
