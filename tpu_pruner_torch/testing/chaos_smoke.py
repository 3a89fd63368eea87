"""`python -m tpu_pruner_torch.testing.chaos_smoke`:
three seeded chaos scenarios against the real
daemon in under a minute — non-zero exit on any invariant miss.

The smoke is the minimal end-to-end proof of the chaos-tier contract
(tests/test_chaos.py is the exhaustive version):

1. convergence — a seeded multi-fault storm must land on EXACTLY the
   same canonical steady state (final-cycle decisions + cluster scale
   spec) as an undisturbed control run;
2. crash accounting — SIGKILL-restart cycles keep the reclaimed
   chip-seconds ledger monotonic and inside the physical chips x wall
   bound (no double-count across lives);
3. evidence gating — stale-but-plausible Prometheus bodies under
   --signal-guard on must veto every scale action until the evidence
   heals, then scaling resumes.

Every scenario is a pure function of its seed: re-run with the same
seed to reproduce a CI failure locally, byte for byte.
"""

from __future__ import annotations

import random
import sys
import tempfile
from pathlib import Path

SEED = 1107


def _idle_cluster(k8s, prom, chips: int = 4):
    _, _, pods = k8s.add_deployment_chain("ml", "trainer", num_pods=2,
                                          tpu_chips=chips)
    for pod in pods:
        prom.add_idle_pod_series(pod["metadata"]["name"], "ml", chips=chips)


def _fresh_pair():
    from tpu_pruner_torch.testing import FakeK8s, FakePrometheus

    prom, k8s = FakePrometheus(), FakeK8s()
    prom.start()
    k8s.start()
    _idle_cluster(k8s, prom)
    return prom, k8s


def scenario_convergence() -> str:
    """Seeded storm vs undisturbed control: byte-identical end state."""
    from tpu_pruner_torch.testing import chaos

    fingerprints = {}
    fired = 0
    for arm in ("chaos", "control"):
        prom, k8s = _fresh_pair()
        try:
            run = chaos.ChaosRun(prom, k8s,
                                 tempfile.mkdtemp(prefix=f"tp-smoke-{arm}-"))
            schedule = (chaos.build_schedule(SEED, rounds=3)
                        if arm == "chaos" else chaos.ChaosSchedule(SEED, []))
            for proc in chaos.run_chaos(schedule, run, cycles_per_round=4):
                if proc.returncode != 0:
                    raise AssertionError(
                        f"{arm} segment exited {proc.returncode}: "
                        f"{proc.stderr[-500:]}")
            if arm == "chaos":
                fired = len(k8s.faults_fired) + len(prom.faults_fired)
                if fired == 0:
                    raise AssertionError("storm never fired a fault")
            fingerprints[arm] = chaos.steady_state_fingerprint(
                run.audit_log, k8s)
        finally:
            prom.stop()
            k8s.stop()
    if fingerprints["chaos"] != fingerprints["control"]:
        raise AssertionError("chaos run diverged from control:\n"
                             f"  chaos:   {fingerprints['chaos'][:200]!r}\n"
                             f"  control: {fingerprints['control'][:200]!r}")
    return f"storm of {fired} fault(s) converged byte-identical to control"


def scenario_crash_accounting() -> str:
    """2x SIGKILL between clean segments: ledger monotonic + physically
    bounded (reclaimed <= chips x wall-time means no span was counted
    twice across process lives)."""
    import time

    from tpu_pruner_torch.testing import chaos

    prom, k8s = _fresh_pair()
    try:
        run = chaos.ChaosRun(prom, k8s,
                             tempfile.mkdtemp(prefix="tp-smoke-kill-"))
        rng = random.Random(SEED)
        t0 = time.monotonic()
        totals = [sum(run.ledger_totals().values())]
        run.run_segment(4)
        totals.append(sum(run.ledger_totals().values()))
        for _ in range(2):
            run.run_segment_sigkill(rng.uniform(0.6, 1.2))
            totals.append(sum(run.ledger_totals().values()))
        run.run_segment(4)
        totals.append(sum(run.ledger_totals().values()))
        wall = time.monotonic() - t0
        if totals != sorted(totals):
            raise AssertionError(f"ledger went backwards: {totals}")
        if totals[-1] <= 0:
            raise AssertionError("ledger never accrued chip-seconds")
        bound = 8 * wall + 8  # 2 pods x 4 chips, plus slack for cadence
        if totals[-1] > bound:
            raise AssertionError(
                f"reclaimed {totals[-1]:.1f} chip-s exceeds the physical "
                f"bound {bound:.1f} — double-count across restarts")
        return (f"ledger monotonic across 2 SIGKILLs: "
                f"{totals[-1]:.1f} chip-s <= {bound:.1f} bound")
    finally:
        prom.stop()
        k8s.stop()


def scenario_evidence_gating() -> str:
    """Stale evidence under --signal-guard on: zero scale actions while
    poisoned, scaling resumes once the fault clears."""
    from tpu_pruner_torch.testing import chaos

    prom, k8s = _fresh_pair()
    try:
        run = chaos.ChaosRun(prom, k8s,
                             tempfile.mkdtemp(prefix="tp-smoke-stale-"),
                             extra_args=("--signal-guard", "on"))
        prom.inject([{"fault": "stale_ts", "age_s": 7200.0,
                      "match": "signal_stat", "times": -1}])
        proc = run.run_segment(3)
        if proc.returncode != 0:
            raise AssertionError(f"poisoned segment exited {proc.returncode}")
        if k8s.scale_patches():
            raise AssertionError(
                f"scaled on stale evidence: {k8s.scale_patches()}")
        prom.clear_faults()
        proc = run.run_segment(2)
        if proc.returncode != 0:
            raise AssertionError(f"recovery segment exited {proc.returncode}")
        if not k8s.scale_patches():
            raise AssertionError("never recovered: no scale action after "
                                 "the stale fault cleared")
        reasons = {r["reason"] for r in
                   chaos.final_cycle_records(run.audit_log)}
        if reasons != {"SCALED"}:
            raise AssertionError(f"final cycle not clean: {reasons}")
        return ("stale evidence vetoed every action, then "
                f"{len(k8s.scale_patches())} scale patch(es) after recovery")
    finally:
        prom.stop()
        k8s.stop()


def main() -> int:
    from tpu_pruner_torch import native

    native.ensure_built()
    scenarios = [("convergence", scenario_convergence),
                 ("crash-accounting", scenario_crash_accounting),
                 ("evidence-gating", scenario_evidence_gating)]
    for name, fn in scenarios:
        try:
            detail = fn()
        except AssertionError as e:
            print(f"chaos-smoke FAILED [{name}]: {e}", file=sys.stderr)
            return 1
        print(f"{name}: {detail}")
    print(f"chaos-smoke OK: {len(scenarios)} seeded scenarios "
          f"(seed {SEED}) held every invariant")
    return 0


if __name__ == "__main__":
    sys.exit(main())
