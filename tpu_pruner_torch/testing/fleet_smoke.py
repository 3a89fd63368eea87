"""`python -m tpu_pruner_torch.testing.fleet_smoke`:
N fake members → hub → assert the merged report.

The minimal end-to-end proof of the federation contract: three real
member daemons (distinct --cluster-name identities; one browned out by
stale evidence) run against hermetic fakes, the hub polls them, and the
merged surfaces must hold the fleet invariants — fleet workload totals
equal the sum of the members' own /debug/workloads totals, fleet
coverage is the per-cluster MINIMUM (the browned-out cluster's, not a
mean), a killed member becomes an explicit UNREACHABLE row, and
`analyze --fleet-report` over the three ledgers produces per-cluster
sections whose totals sum. Non-zero exit on any miss.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time


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
    tmp = tempfile.mkdtemp(prefix="tp-fleet-smoke-")
    try:
        with FakeFleet(tmp) as fleet:
            healthy = fleet.add_member("smoke-east", idle_pods=2)
            browned = fleet.add_member("smoke-west", idle_pods=1,
                                       stale_pods=3)
            doomed = fleet.add_member("smoke-null", idle_pods=1)
            fleet.start_hub(poll_interval=1, stale_after=3)

            # every member OK first: the browned-out member's 0.25
            # coverage must BE the fleet figure (the mean would be 0.75)
            _wait(lambda: all(
                m["status"] == "OK"
                for m in fleet.hub_get_json("/debug/fleet/clusters")["members"]),
                what="all members OK")
            signals = _wait(
                lambda: (lambda doc:
                         doc if "smoke-west" in doc["brownout_clusters"]
                         else None)(
                    fleet.hub_get_json("/debug/fleet/signals")),
                what="brownout named")
            if signals["coverage_min"] != 0.25:
                print(f"coverage_min {signals['coverage_min']} != 0.25 "
                      "(the browned-out member's minimum, not the mean)",
                      file=sys.stderr)
                return 1

            # kill one member: explicit UNREACHABLE row, minimum pinned to 0.
            # Its ledger checkpoint must exist first: the offline merge
            # below reads it, and a member killed before its first
            # checkpoint leaves none.
            _wait(lambda: os.path.exists(doomed.ledger_path),
                  what="the doomed member's ledger checkpoint")
            doomed.kill()
            _wait(lambda: [
                m for m in fleet.hub_get_json("/debug/fleet/clusters")["members"]
                if m["cluster"] == "smoke-null" and m["status"] == "UNREACHABLE"],
                what="killed member UNREACHABLE")
            signals = fleet.hub_get_json("/debug/fleet/signals")
            if signals["coverage_min"] != 0.0:
                print(f"coverage_min {signals['coverage_min']} != 0.0 "
                      "(a dark cluster must pin the minimum)", file=sys.stderr)
                return 1

            # the healthy member's pause must have accrued reclaimed
            # chip-seconds into the hub's merged view
            workloads = _wait(
                lambda: (lambda doc:
                         doc if any(c.get("totals", {}).get(
                             "reclaimed_chip_seconds", 0) > 0
                             for c in doc["clusters"]) else None)(
                    fleet.hub_get_json("/debug/fleet/workloads")),
                what="reclaimed chip-seconds in the hub view")
            fleet_reclaimed = workloads["fleet_totals"]["reclaimed_chip_seconds"]
            summed = sum(c.get("totals", {}).get("reclaimed_chip_seconds", 0.0)
                         for c in workloads["clusters"])
            if abs(summed - fleet_reclaimed) > 1e-9:
                print(f"fleet totals do not sum: {summed} != {fleet_reclaimed}",
                      file=sys.stderr)
                return 1

        # fleet stopped; merge the three checkpoints offline
        report = subprocess.run(
            [sys.executable, "-m", "tpu_pruner_torch.analyze", "--fleet-report",
             "--ledger-file", healthy.ledger_path,
             "--ledger-file", browned.ledger_path,
             "--ledger-file", doomed.ledger_path],
            capture_output=True, text=True, timeout=120)
        if report.returncode != 0:
            print(f"analyze --fleet-report failed:\n{report.stderr}",
                  file=sys.stderr)
            return 1
        doc = json.loads(report.stdout)
        cluster_names = {c["cluster"] for c in doc["clusters"]}
        if not {"smoke-east", "smoke-west", "smoke-null"} <= cluster_names:
            print(f"merged report missing clusters: {cluster_names}",
                  file=sys.stderr)
            return 1
        summed = sum(c["reclaimed_chip_seconds"] for c in doc["clusters"])
        if abs(summed - doc["fleet_totals"]["reclaimed_chip_seconds"]) > 1e-9:
            print("merged report totals do not sum", file=sys.stderr)
            return 1
        print(f"fleet-smoke OK: 3 members (1 browned out, 1 killed) merged — "
              f"coverage_min=0, UNREACHABLE row present, "
              f"{doc['fleet_totals']['reclaimed_chip_seconds']:.0f} "
              "reclaimed chip-seconds sum across clusters")
        return 0
    finally:
        pass


if __name__ == "__main__":
    sys.exit(main())
