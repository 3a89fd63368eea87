"""Synthetic trace corpus generator for the policy gym.

The gym (``tpu-pruner gym`` / ``analyze --gym``) scores policies over a
stream of flight-recorder capsules. Recorded production corpora are the
gold input, but policy tuning needs *scenarios* — shapes of idleness the
production window may not contain. This module scripts them against the
hermetic fakes: ``generate()`` builds a deterministic per-cycle idle/busy
script per workload, ``install()`` registers it as fake_prom scripted
series + a fake_k8s Deployment chain, and ``record_corpus()`` runs the
REAL daemon over the script (``--check-interval 0`` back-to-back cycles,
``--flight-dir`` capture) so the resulting capsules are genuine daemon
output, not synthesized JSON.

Scenarios:
  diurnal       phase-shifted day/night idleness per workload (half of
                each period idle) — the "pause at night" payoff case
  flapping      short random idle/busy streaks (seeded) — the false-pause
                trap hysteresis policies exist for
  resume-storm  a long all-idle stretch, then every workload goes busy at
                once — the regret-window stress case
  brownout      always idle, but the evidence's last-sample age spikes
                mid-corpus (record with --signal-guard on to exercise
                SIGNAL_* vetoes and the fleet brownout in the corpus)
  defrag        each workload pinned to its own slice (fake_k8s Nodes
                with GKE nodepool/tpu-topology labels, pods placed via
                spec.nodeName), draining one slice at a time — record
                with --capacity on to exercise the capacity observatory's
                partial-idle → whole-free inventory transitions

Scripted fake_prom series repeat their LAST value once exhausted, so a
script of ``cycles`` entries stays well-defined however many cycles the
daemon actually runs (tests/test_gym.py pins that contract).
"""

from __future__ import annotations

import random
import subprocess
from pathlib import Path

SCENARIOS = ("diurnal", "flapping", "resume-storm", "brownout", "defrag")

# Evidence age served while a brownout window is open: far beyond the
# default --signal-max-age of 300 s, so every pod reads STALE.
BROWNOUT_STALE_AGE = 4000.0


def generate(scenario: str, cycles: int, workloads: int = 3,
             pods_per_workload: int = 1, chips: int = 4,
             namespace: str = "gym", seed: int = 0) -> dict:
    """Build a deterministic trace spec: per-workload per-cycle scripts.

    Each workload's ``values[i]`` scripts cycle i: ``0.0`` = idle (the
    pod appears in the daemon's `== 0` idle query result), ``None`` =
    busy (no row — a real Prometheus returns nothing for a busy pod
    under the idle predicate). ``last_sample_age[i]`` scripts the signal
    watchdog's evidence freshness per cycle.
    """
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r} (expected one of {SCENARIOS})")
    if cycles < 1:
        raise ValueError("cycles must be >= 1")
    rng = random.Random(seed)

    spec = {"scenario": scenario, "cycles": cycles, "namespace": namespace,
            "chips": chips, "workloads": []}
    if scenario == "defrag":
        # One single-tenant slice (node pool) per workload: node w-j hosts
        # the workload's j-th pod, so slice `slice-w` is whole-free exactly
        # while workload w is idle.
        spec["slices"] = [
            {"pool": f"slice-{w}", "topology": "2x2",
             "nodes": [f"slice-{w}-node-{j}" for j in range(pods_per_workload)]}
            for w in range(workloads)
        ]
    for w in range(workloads):
        values: list[float | None] = []
        ages: list[float] = [0.0] * cycles
        if scenario == "diurnal":
            period = max(8, cycles // 4)
            offset = w * period // max(1, workloads)
            values = [0.0 if ((i + offset) % period) < period // 2 else None
                      for i in range(cycles)]
        elif scenario == "flapping":
            idle = bool(rng.getrandbits(1))
            while len(values) < cycles:
                streak = rng.randint(1, 3)
                values.extend([0.0 if idle else None] * streak)
                idle = not idle
            values = values[:cycles]
        elif scenario == "resume-storm":
            storm_at = max(1, int(cycles * 0.6))
            storm_len = max(2, cycles // 10)
            values = [None if storm_at <= i < storm_at + storm_len else 0.0
                      for i in range(cycles)]
        elif scenario == "brownout":
            values = [0.0] * cycles
            lo, hi = int(cycles * 0.4), int(cycles * 0.6)
            ages = [BROWNOUT_STALE_AGE if lo <= i < hi else 0.0
                    for i in range(cycles)]
        elif scenario == "defrag":
            # Staggered drain: workload w goes idle at cycle (w+1)*step and
            # stays idle, so mid-corpus the fleet is a mix of whole-free and
            # partial-idle slices (the defragmentation report's subject).
            step = max(1, cycles // (workloads + 1))
            values = [0.0 if i >= (w + 1) * step else None
                      for i in range(cycles)]
        spec["workloads"].append({
            "name": f"{scenario.replace('-', '')}-{w}",
            "pods": pods_per_workload,
            "values": values,
            "last_sample_age": ages,
        })
    return spec


def install(spec: dict, fake_prom, fake_k8s) -> None:
    """Register the spec's workloads: one Deployment chain per workload
    in fake_k8s (replicas = pod count) and one scripted duty-cycle series
    per pod in fake_prom, with the evidence-age script riding along."""
    ns = spec["namespace"]
    slices = spec.get("slices")
    if slices:
        # Every slice gets its nodes — entries beyond the workload list are
        # empty (whole-free) spare slices the capacity inventory should see.
        for sl in slices:
            for node_name in sl["nodes"]:
                fake_k8s.add_node(node_name, pool=sl["pool"],
                                  topology=sl["topology"],
                                  tpu_chips=spec["chips"])
    for w, wl in enumerate(spec["workloads"]):
        nodes = slices[w]["nodes"] if slices else None
        _, _, pods = fake_k8s.add_deployment_chain(
            ns, wl["name"], num_pods=wl["pods"], tpu_chips=spec["chips"],
            replicas=wl["pods"], nodes=nodes)
        for pod in pods:
            fake_prom.add_scripted_pod_series(
                pod["metadata"]["name"], ns, list(wl["values"]),
                last_sample_age=list(wl["last_sample_age"]))


def record_corpus(spec: dict, flight_dir, run_mode: str = "dry-run",
                  extra_args: tuple = (), timeout: int = 600,
                  check_interval: int = 0) -> list[Path]:
    """Run the REAL daemon over the spec's script — back-to-back cycles
    (--check-interval 0), one capsule per cycle — and return the sorted
    capsule paths. ``run_mode="dry-run"`` (default) records an evidence-
    complete corpus (nothing actually pauses, so every cycle carries the
    full counterfactual evidence the gym's false-pause detection needs);
    ``"scale-down"`` records live actuations (the ledger-parity input).
    """
    from tpu_pruner_torch.native import DAEMON_PATH
    from tpu_pruner_torch.testing import FakeK8s, FakePrometheus

    flight_dir = Path(flight_dir)
    prom, k8s = FakePrometheus(), FakeK8s()
    prom.start()
    k8s.start()
    try:
        install(spec, prom, k8s)
        # A static token skips the per-cycle bearer-auth chain (whose GCE
        # metadata probe costs ~0.4s/cycle in hermetic environments) —
        # the fakes ignore auth, and a 200-cycle corpus records in
        # seconds instead of minutes.
        cmd = [str(DAEMON_PATH), "--prometheus-url", prom.url,
               "--prometheus-token", "trace-gen",
               "--run-mode", run_mode, "--daemon-mode",
               "--check-interval", str(check_interval),
               "--max-cycles", str(spec["cycles"]),
               "--flight-dir", str(flight_dir),
               "--flight-keep", str(spec["cycles"]), *extra_args]
        proc = subprocess.run(cmd, env={"KUBE_API_URL": k8s.url},
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"corpus recording failed:\n{proc.stderr[-2000:]}")
    finally:
        prom.stop()
        k8s.stop()
    return sorted(flight_dir.glob("cycle-*.json"))
