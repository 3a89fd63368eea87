"""Seeded chaos orchestration for the daemon-vs-fakes pipeline.

The robustness tier's organizing idea: every failure the pruner will meet
in production — apiserver throttling storms, connections cut mid-body,
410 relist storms, wedged backends, stale-but-plausible metric bodies,
SIGKILL at arbitrary points — is reduced to a SEEDED, REPLAYABLE
schedule. One integer reproduces the whole pathology, so a chaos failure
in CI is a `ChaosSchedule(seed=...)` away from a local debugger, not a
flake.

Three layers:

- ``build_schedule(seed, rounds)``: a deterministic fault plan composing
  the full fault menu (k8s 429/5xx/disconnect/410/truncate, Prometheus
  5xx/truncate/stale/dup) from one ``random.Random(seed)`` stream.
- ``ChaosRun``: drives the REAL daemon binary in segments against the
  hermetic fakes with persistent state (--ledger-file, --flight-dir,
  --audit-log) carried across segments — including SIGKILL segments that
  murder the process at a seeded delay and restart it from its
  checkpoints.
- ``steady_state_fingerprint(...)``: the convergence oracle. After the
  storm passes, a chaos run must land on the SAME canonical bytes as an
  undisturbed control run — same final-cycle decisions, same cluster
  scale state. Volatile identity (cycle ids, timestamps, trace ids) is
  normalized out; everything else must match byte-for-byte.

Faults are injected BETWEEN daemon segments (the fakes consume them
per-request, first-match-wins), so a schedule's effect on the request
stream is a pure function of the seed — no sleeps, no races. Each round
bounds its burst well under the daemon's consecutive-failure budget
(kMaxConsecutiveFailures = 5) and is followed by clean cycles, so a
correct daemon always converges; a chaos run that exits non-zero IS the
regression.
"""

from __future__ import annotations

import json
import random
import signal
import subprocess
import time
from pathlib import Path

# Keys stripped (recursively) before byte-comparison: process/run identity
# and wall-clock, never decision substance. `cycle` is volatile because
# chaos runs burn failed cycles the control run never has; `detail` can
# embed retry counts/latencies.
VOLATILE_KEYS = frozenset({
    "cluster", "cycle", "ts", "time", "timestamp", "trace_id", "span_id",
    "latency_ms", "duration_ms", "wall_ms", "sealed_at", "detail",
    "resourceVersion", "creationTimestamp", "managedFields",
})

# ── seeded schedule ──────────────────────────────────────────────────────

# The composable fault menu: (name, target, builder). Builders take the
# schedule's Random and return one inject() entry; every numeric knob
# draws from the SAME stream, so the whole plan is a function of the seed.
FAULT_MENU = [
    ("k8s_429_storm", "k8s", lambda rng: {
        "fault": "status", "code": 429,
        "retry_after": str(rng.randint(1, 2)), "times": rng.randint(1, 2)}),
    ("k8s_5xx_burst", "k8s", lambda rng: {
        "fault": "status", "code": rng.choice([500, 502, 503]), "times": 1}),
    ("k8s_disconnect", "k8s", lambda rng: {
        "fault": "disconnect", "times": 1}),
    ("k8s_410_gone", "k8s", lambda rng: {
        # stale resourceVersion → consumers see 410 Gone / forced relist
        "fault": "wrong_rv", "rv": "1", "times": rng.randint(1, 2)}),
    ("k8s_truncate", "k8s", lambda rng: {
        "fault": "drop_after", "bytes": rng.randint(120, 400), "times": 1}),
    ("prom_5xx", "prom", lambda rng: {
        "fault": "status", "code": rng.choice([500, 503]), "times": 1}),
    ("prom_truncate", "prom", lambda rng: {
        "fault": "drop_after", "bytes": rng.randint(120, 400), "times": 1}),
    ("prom_stale", "prom", lambda rng: {
        "fault": "stale_ts", "age_s": float(rng.randint(3600, 7200)),
        "times": rng.randint(1, 2)}),
    ("prom_dup", "prom", lambda rng: {
        "fault": "dup_series", "times": rng.randint(1, 2)}),
]


class ChaosSchedule:
    """A seeded fault plan: one burst of inject() entries per round."""

    def __init__(self, seed: int, rounds: list[list[tuple[str, str, dict]]]):
        self.seed = seed
        # rounds[i] = [(fault_name, target, entry), ...]
        self.rounds = rounds

    @property
    def fault_types(self) -> set[str]:
        return {name for burst in self.rounds for name, _, _ in burst}

    def entries_for(self, round_idx: int, target: str) -> list[dict]:
        return [dict(e) for _, t, e in self.rounds[round_idx] if t == target]


def build_schedule(seed: int, rounds: int,
                   menu=None, faults_per_round: int = 2) -> ChaosSchedule:
    """Deterministic chaos plan: ``rounds`` bursts of ``faults_per_round``
    faults each, drawn from ``menu`` (default: the full FAULT_MENU) by a
    ``random.Random(seed)``. Same seed ⇒ same plan, byte for byte."""
    rng = random.Random(seed)
    menu = list(FAULT_MENU if menu is None else menu)
    plan = []
    for _ in range(rounds):
        burst = []
        for name, target, build in rng.sample(menu, k=min(faults_per_round,
                                                          len(menu))):
            burst.append((name, target, build(rng)))
        plan.append(burst)
    return ChaosSchedule(seed, plan)


# ── daemon segment driver ────────────────────────────────────────────────


class ChaosRun:
    """Drives the real daemon in segments with durable state carried
    across process lifetimes (and deaths).

    Every segment shares --ledger-file / --flight-dir / --audit-log under
    ``state_dir``, so a SIGKILL mid-segment followed by a fresh segment
    exercises exactly the production crash-restart path: reload the
    ledger checkpoint, resync the flight ring, never double-count."""

    def __init__(self, fake_prom, fake_k8s, state_dir, *,
                 extra_args: tuple = ()):
        from tpu_pruner_torch.native import DAEMON_PATH

        self.daemon = str(DAEMON_PATH)
        self.fake_prom = fake_prom
        self.fake_k8s = fake_k8s
        self.state_dir = Path(state_dir)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self.ledger_file = self.state_dir / "ledger.jsonl"
        self.flight_dir = self.state_dir / "flight"
        self.audit_log = self.state_dir / "audit.jsonl"
        self.extra_args = tuple(extra_args)
        self.segments: list[dict] = []

    def _cmd(self, cycles: int) -> list[str]:
        return [self.daemon,
                "--prometheus-url", self.fake_prom.url,
                "--run-mode", "scale-down",
                "--daemon-mode", "--check-interval", "0",
                "--max-cycles", str(cycles),
                "--ledger-file", str(self.ledger_file),
                "--flight-dir", str(self.flight_dir),
                "--audit-log", str(self.audit_log),
                *self.extra_args]

    def _env(self) -> dict:
        # Static tokens matter beyond realism: without them every cycle
        # re-probes the (absent) metadata server and eats its ~500 ms
        # timeout — 100x the whole cycle's cost under --check-interval 0.
        return {"KUBE_API_URL": self.fake_k8s.url,
                "KUBE_TOKEN": "chaos-token",
                "PROMETHEUS_TOKEN": "chaos-token",
                "PATH": "/usr/bin:/bin"}

    def run_segment(self, cycles: int, timeout: int = 120):
        """Run the daemon for `cycles` back-to-back cycles to clean exit.
        Returns the CompletedProcess; exit != 0 means the daemon did NOT
        absorb the injected faults (failure budget blown) — callers
        assert on it, because convergence is the contract under test."""
        proc = subprocess.run(self._cmd(cycles), env=self._env(),
                              capture_output=True, text=True,
                              timeout=timeout)
        self.segments.append({"kind": "run", "cycles": cycles,
                              "returncode": proc.returncode})
        return proc

    def run_segment_sigkill(self, kill_after_s: float, timeout: int = 120):
        """Launch the daemon, SIGKILL it after ``kill_after_s`` seconds
        (seeded by the caller), reap it. No graceful anything: the next
        segment must recover from whatever half-written instant this
        leaves behind. Returns the (negative-signal) exit code."""
        proc = subprocess.Popen(self._cmd(cycles=0),  # unlimited
                                env=self._env(),
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            time.sleep(kill_after_s)
        finally:
            proc.send_signal(signal.SIGKILL)
        rc = proc.wait(timeout=timeout)
        self.segments.append({"kind": "sigkill",
                              "kill_after_s": kill_after_s,
                              "returncode": rc})
        return rc

    def ledger_totals(self) -> dict[str, float]:
        """workload → reclaimed_chip_seconds from the ledger checkpoint
        (empty dict before the first checkpoint lands)."""
        if not self.ledger_file.exists():
            return {}
        totals = {}
        for line in self.ledger_file.read_text().splitlines():
            if not line.strip():
                continue
            row = json.loads(line)
            if "workload" in row:
                totals[row["workload"]] = row.get("reclaimed_chip_seconds",
                                                  0.0)
        return totals


def run_chaos(schedule: ChaosSchedule, run: ChaosRun, *,
              cycles_per_round: int = 5) -> list:
    """Execute a seeded plan: for each round, inject the burst, then run
    a daemon segment long enough to both hit the faults and converge
    past them. Returns the per-segment CompletedProcess list."""
    procs = []
    for i in range(len(schedule.rounds)):
        run.fake_k8s.inject(schedule.entries_for(i, "k8s"))
        run.fake_prom.inject(schedule.entries_for(i, "prom"))
        procs.append(run.run_segment(cycles_per_round))
    # the storm has passed: drop any un-consumed entries and run a final
    # clean segment — this is the state the fingerprint is taken from
    run.fake_k8s.clear_faults()
    run.fake_prom.clear_faults()
    procs.append(run.run_segment(cycles_per_round))
    return procs


# ── convergence oracle ───────────────────────────────────────────────────


def canonical(obj):
    """Recursively strip VOLATILE_KEYS; leave decision substance."""
    if isinstance(obj, dict):
        return {k: canonical(v) for k, v in sorted(obj.items())
                if k not in VOLATILE_KEYS}
    if isinstance(obj, list):
        return [canonical(v) for v in obj]
    return obj


def final_cycle_records(audit_path) -> list[dict]:
    """Canonicalized DecisionRecords of the LAST cycle in an --audit-log,
    sorted — the daemon's final verdict on every workload, with run
    identity stripped.

    The log is append-only across daemon restarts and each process
    numbers its cycles from 1, so "last cycle" means the trailing
    contiguous block of equal cycle ids at the END of the file — not a
    global max (which would collect one cycle from every segment)."""
    records = [json.loads(line)
               for line in Path(audit_path).read_text().splitlines()
               if line.strip()]
    if not records:
        return []
    last = records[-1]["cycle"]
    tail = []
    for r in reversed(records):
        if r["cycle"] != last:
            break
        tail.append(canonical(r))
    return sorted(tail, key=lambda r: json.dumps(r, sort_keys=True))


def cluster_scale_state(fake_k8s) -> dict:
    """The part of the fake cluster a pruner is FOR: every scalable
    object's replica/suspend spec, keyed by path."""
    state = {}
    for path, obj in sorted(fake_k8s.objects.items()):
        spec = obj.get("spec", {})
        row = {}
        if "replicas" in spec:
            row["replicas"] = spec["replicas"]
        if "suspend" in spec:
            row["suspend"] = spec["suspend"]
        if row:
            state[path] = row
    return state


def steady_state_fingerprint(audit_path, fake_k8s) -> bytes:
    """Canonical bytes of the converged end state: final-cycle decisions
    + cluster scale state. A chaos run and its undisturbed control MUST
    produce identical fingerprints — anything less means a fault leaked
    into a decision."""
    doc = {
        "decisions": final_cycle_records(audit_path),
        "cluster": cluster_scale_state(fake_k8s),
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
