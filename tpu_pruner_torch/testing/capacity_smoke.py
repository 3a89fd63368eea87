"""`python -m tpu_pruner_torch.testing.capacity_smoke`:
one member with slices → hub rollup → defrag
report.

The minimal end-to-end proof of the capacity observatory: a real member
daemon runs `--capacity on` over a sliced fixture (two single-tenant
idle slices plus one spare slice with no pods), and the smoke asserts
the three capacity surfaces agree — the member's own /debug/capacity
inventory (1 whole-free + 2 consolidatable slices, freed chips accrued
once the pauses land), the hub's /debug/fleet/capacity rollup (the
member's inventory verbatim + matching fleet totals), and `analyze
--capacity-report` over the member's flight capsules (bit-for-bit
replay, consolidation to 3 whole-free slices). Non-zero exit on any
miss.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _wait(predicate, timeout=45, interval=0.3, what="condition"):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            last = predicate()
        except OSError:
            last = None
        if last:
            return last
        time.sleep(interval)
    raise AssertionError(f"{what} never held (last={last!r})")


def main() -> int:
    from tpu_pruner_torch import native
    from tpu_pruner_torch.testing.fake_fleet import FakeFleet

    native.ensure_built()
    tmp = Path(tempfile.mkdtemp(prefix="tp-capacity-smoke-"))
    flight = tmp / "flight"
    with FakeFleet(tmp) as fleet:
        member = fleet.add_member(
            "cap-east", idle_pods=2, slice_topology="2x2",
            extra_args=("--capacity", "on",
                        "--flight-dir", str(flight), "--flight-keep", "64"))
        # A spare slice with no pods: the daemon LISTs nodes every
        # evaluation, so the next cycle's inventory must pick it up as
        # whole-free supply.
        member.k8s.add_node("cap-east-spare-0", pool="cap-east-spare",
                            topology="2x2", tpu_chips=4)
        fleet.start_hub(poll_interval=1, stale_after=5)

        # Member inventory: 3 slices — the spare whole-free, both tenant
        # slices consolidatable (their only tenant is idle), and freed
        # chips accounted once the pauses land.
        inv = _wait(
            lambda: (lambda doc:
                     doc if isinstance(doc, dict)
                     and doc.get("totals", {}).get("freed_chips", 0) > 0
                     and doc["totals"]["slices"] == 3 else None)(
                member.get_json("/debug/capacity")),
            what="member capacity inventory settled")
        totals = inv["totals"]
        if (totals["whole_free_slices"] != 1
                or totals["consolidatable_slices"] != 2
                or totals["consolidation_potential_chips"] != 8):
            print(f"member inventory off: {totals}", file=sys.stderr)
            return 1
        if inv.get("cluster") != "cap-east":
            print(f"inventory not stamped with the cluster: {inv.get('cluster')}",
                  file=sys.stderr)
            return 1

        # Hub rollup: the member's inventory verbatim + summed totals.
        rollup = _wait(
            lambda: (lambda doc:
                     doc if isinstance(doc, dict)
                     and any(c.get("cluster") == "cap-east"
                             and c.get("inventory", {}).get(
                                 "totals", {}).get("slices") == 3
                             for c in doc.get("clusters", []))
                     else None)(
                fleet.hub_get_json("/debug/fleet/capacity")),
            what="hub capacity rollup includes the member")
        hub_member = next(c for c in rollup["clusters"]
                          if c["cluster"] == "cap-east")
        hub_totals = hub_member.get("inventory", {}).get("totals", {})
        for key in ("slices", "whole_free_slices", "consolidatable_slices"):
            if (hub_totals.get(key) != totals[key]
                    or rollup["fleet_totals"][key] != totals[key]):
                print(f"hub rollup disagrees on {key}: member={totals[key]} "
                      f"hub={hub_totals.get(key)} "
                      f"fleet={rollup['fleet_totals'][key]}", file=sys.stderr)
                return 1

    # Fleet stopped; replay the defragmentation report from the capsules.
    report_proc = subprocess.run(
        [sys.executable, "-m", "tpu_pruner_torch.analyze",
         "--capacity-report", str(flight)],
        capture_output=True, text=True, timeout=120)
    if report_proc.returncode != 0:
        print(f"analyze --capacity-report failed:\n{report_proc.stderr}",
              file=sys.stderr)
        return 1
    report = json.loads(report_proc.stdout)
    if report["drift"]:
        print(f"capacity report drifted: {report['drifted_cycles']}",
              file=sys.stderr)
        return 1
    cons = report["consolidation"]
    if cons["whole_free_slices_after"] != 3:
        print(f"defrag report expected 3 whole-free slices after moves, "
              f"got {cons['whole_free_slices_after']}", file=sys.stderr)
        return 1
    print(f"capacity-smoke OK: 3-slice member inventory (1 whole-free, "
          f"2 consolidatable, {totals['freed_chips']} freed chips) matched "
          f"the hub rollup; defrag report replayed "
          f"{report['capsules']} capsules bit-for-bit — "
          f"{report['summary']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
