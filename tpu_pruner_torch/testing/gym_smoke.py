"""Policy-gym smoke: synthetic 200-cycle corpus → 3 policies scored in
one pass → winner flag line printed. `python -m
tpu_pruner_torch.testing.gym_smoke` runs this; exits non-zero when the
corpus, the gym run, or the scoring contract breaks.

Pipeline: trace_gen builds a seeded flapping scenario (the false-pause
trap), the REAL daemon records it back-to-back into a --flight-dir
corpus, and `tpu-pruner gym` replays the corpus against the default
3-policy panel (baseline, right-size, hysteresis).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CYCLES = 200


def main() -> int:
    from tpu_pruner_torch import native
    from tpu_pruner_torch.testing import trace_gen

    native.ensure_built()
    tmp = Path(tempfile.mkdtemp(prefix="tp-gym-smoke-"))
    spec = trace_gen.generate("flapping", CYCLES, workloads=3, seed=7)

    t0 = time.monotonic()
    capsules = trace_gen.record_corpus(spec, tmp / "flight")
    record_s = time.monotonic() - t0
    if len(capsules) != CYCLES:
        print(f"FAIL: expected {CYCLES} capsules, recorded {len(capsules)}")
        return 1
    print(f"recorded {len(capsules)}-cycle synthetic corpus in {record_s:.1f}s "
          f"({len(capsules) / record_s:.0f} cycles/s)")

    t0 = time.monotonic()
    # --assume-interval 180: the back-to-back recording compresses wall
    # time, so score cycles at the production cadence they model.
    proc = subprocess.run(
        [str(native.DAEMON_PATH), "gym", "--flight-dir", str(tmp / "flight"),
         "--assume-interval", "180"],
        capture_output=True, text=True, timeout=600)
    gym_s = time.monotonic() - t0
    if proc.returncode != 0:
        print(f"FAIL: gym exited {proc.returncode}:\n{proc.stderr[-2000:]}")
        return 1
    out = json.loads(proc.stdout)

    ok = True
    if out.get("cycles") != CYCLES:
        print(f"FAIL: gym scored {out.get('cycles')} cycles, wanted {CYCLES}")
        ok = False
    policies = out.get("policies", [])
    if len(policies) < 3:
        print(f"FAIL: {len(policies)} policies scored, wanted >= 3")
        ok = False
    winner = out.get("winner", {})
    if not winner.get("flag_line"):
        print("FAIL: winner carries no flag line")
        ok = False
    baseline = next((p for p in policies if p["kind"] == "baseline"), None)
    hysteresis = next((p for p in policies if p["kind"] == "hysteresis"), None)
    if baseline and baseline["false_pauses"] == 0:
        print("FAIL: a flapping corpus must cost the baseline false pauses")
        ok = False
    if baseline and hysteresis and hysteresis["false_pauses"] > baseline["false_pauses"]:
        print("FAIL: hysteresis produced MORE false pauses than baseline")
        ok = False

    print(f"gym: {out['cycles']} cycles x {len(policies)} policies in "
          f"{gym_s:.2f}s ({out['cycles'] / gym_s:.0f} cycles/s)")
    for p in policies:
        print(f"  {p['name']:36s} reclaimed {p['reclaimed_chip_hours']:8.3f} "
              f"chip-hrs, {p['false_pauses']} false pause(s), "
              f"churn {p['actuation_churn']}, score {p['score']}")
    print(f"winner: {winner.get('name')}")
    print(f"apply with: {winner.get('flag_line')}")
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
