"""`python -m tpu_pruner_torch.testing.event_smoke`:
three seeded event-dispatcher scenarios against
the real daemon in under a minute — non-zero exit on any invariant miss.

The smoke is the minimal end-to-end proof of the event-reconcile
contract (tests/test_event_reconcile.py is the exhaustive version):

1. detect latency — with a 60 s polling interval, a metric-plane flip
   must reach the scale patch in well under a second (the probe trigger
   decouples detect→action from --check-interval);
2. byte identity — the same quiesced cluster decided by the event
   dispatcher and by the polling loop produces byte-identical audit
   JSONL (volatile clock/trace fields normalized);
3. hysteresis — --pause-after 3 holds actuation through two
   HYSTERESIS_HOLD evaluations and pauses on the third consecutive
   idle one, exactly once.

Every scenario is a pure function of its inputs: re-run to reproduce a
CI failure locally, byte for byte.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The test suite's volatile set: clock/trace fields plus the capsule and
# audit provenance stamps that legitimately differ between modes.
VOLATILE_KEYS = {"ts", "ts_unix", "ts_ms", "now_unix", "trace_id", "id",
                 "incremental", "reconcile"}


def _normalize(obj):
    if isinstance(obj, dict):
        return {k: _normalize(v) for k, v in obj.items()
                if k not in VOLATILE_KEYS}
    if isinstance(obj, list):
        return [_normalize(v) for v in obj]
    return obj


def _fresh_pair():
    from tpu_pruner_torch.testing import FakeK8s, FakePrometheus

    prom, k8s = FakePrometheus(), FakeK8s()
    prom.start()
    k8s.start()
    return prom, k8s


def _daemon_cmd(prom, *extra, reconcile="event", interval=1, cycles=2,
                run_mode="scale-down"):
    from tpu_pruner_torch.native import DAEMON_PATH

    return [str(DAEMON_PATH), "--prometheus-url", prom.url,
            "--prometheus-token", "ev-smoke", "--run-mode", run_mode,
            "--watch-cache", "on", "--reconcile", reconcile,
            "--daemon-mode", "--check-interval", str(interval),
            "--max-cycles", str(cycles), *extra]


def scenario_detect_latency() -> str:
    """Metric flip → scale patch in <1 s against a 60 s interval."""
    prom, k8s = _fresh_pair()
    proc = None
    try:
        _, _, pods = k8s.add_deployment_chain("ml", "trainer")
        cmd = _daemon_cmd(prom, "--sample-interval-ms", "100",
                          interval=60, cycles=3)
        proc = subprocess.Popen(cmd, env={"KUBE_API_URL": k8s.url},
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        time.sleep(1.5)  # startup anti-entropy done, probe baseline set
        if k8s.scale_patches():
            raise AssertionError("scaled before any idle evidence existed")
        t0 = time.time()
        prom.add_idle_pod_series(pods[0]["metadata"]["name"], "ml")
        while time.time() - t0 < 10 and not k8s.scale_patches():
            time.sleep(0.02)
        latency = time.time() - t0
        if not k8s.scale_patches():
            raise AssertionError("metric flip never actuated")
        if latency >= 1.0:
            raise AssertionError(
                f"detect→action took {latency:.2f}s against a 60 s "
                "interval — the probe trigger is not decoupling latency")
        return f"idle flip patched in {latency * 1000:.0f} ms (interval 60 s)"
    finally:
        if proc is not None and proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=20)
        prom.stop()
        k8s.stop()


def scenario_byte_identity() -> str:
    """Quiesced dry-run: event vs cycle audit JSONL byte-identical."""
    prom, k8s = _fresh_pair()
    try:
        for i in range(3):
            _, _, pods = k8s.add_deployment_chain("ml", f"dep-{i}",
                                                  num_pods=2)
            for pod in pods:
                prom.add_idle_pod_series(pod["metadata"]["name"], "ml")
        streams = {}
        for mode in ("cycle", "event"):
            audit = Path(tempfile.mkdtemp(
                prefix=f"tp-smoke-ident-{mode}-")) / "audit.jsonl"
            cmd = _daemon_cmd(prom, "--audit-log", str(audit),
                              reconcile=mode, cycles=3, run_mode="dry-run")
            proc = subprocess.run(cmd, env={"KUBE_API_URL": k8s.url},
                                  capture_output=True, text=True,
                                  timeout=120)
            if proc.returncode != 0:
                raise AssertionError(
                    f"{mode} run exited {proc.returncode}: "
                    f"{proc.stderr[-500:]}")
            records = [_normalize(json.loads(line))
                       for line in audit.read_text().splitlines()]
            if not records:
                raise AssertionError(f"{mode} run produced no audit records")
            streams[mode] = json.dumps(records, sort_keys=True)
        if streams["event"] != streams["cycle"]:
            raise AssertionError(
                "event-mode audit diverged from cycle mode:\n"
                f"  event: {streams['event'][:200]!r}\n"
                f"  cycle: {streams['cycle'][:200]!r}")
        n = streams["event"].count('"reason"')
        return f"{n} audit records byte-identical across both engines"
    finally:
        prom.stop()
        k8s.stop()


def scenario_hysteresis() -> str:
    """--pause-after 3: two holds, then exactly one pause."""
    prom, k8s = _fresh_pair()
    try:
        _, _, pods = k8s.add_deployment_chain("ml", "trainer")
        prom.add_idle_pod_series(pods[0]["metadata"]["name"], "ml")
        audit = Path(tempfile.mkdtemp(prefix="tp-smoke-hyst-")) / "a.jsonl"
        cmd = _daemon_cmd(prom, "--pause-after", "3",
                          "--audit-log", str(audit), cycles=4)
        proc = subprocess.run(cmd, env={"KUBE_API_URL": k8s.url},
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise AssertionError(
                f"daemon exited {proc.returncode}: {proc.stderr[-500:]}")
        seq = [(r["cycle"], r["reason"]) for r in
               map(json.loads, audit.read_text().splitlines())]
        if seq[:3] != [(1, "HYSTERESIS_HOLD"), (2, "HYSTERESIS_HOLD"),
                       (3, "SCALED")]:
            raise AssertionError(f"streak sequence wrong: {seq}")
        if len(k8s.scale_patches()) != 1:
            raise AssertionError(
                f"expected exactly one pause, saw {k8s.scale_patches()}")
        return "held 2 evaluations, paused on streak 3, exactly one patch"
    finally:
        prom.stop()
        k8s.stop()


def main() -> int:
    from tpu_pruner_torch import native

    native.ensure_built()
    scenarios = [("detect-latency", scenario_detect_latency),
                 ("byte-identity", scenario_byte_identity),
                 ("hysteresis", scenario_hysteresis)]
    for name, fn in scenarios:
        try:
            detail = fn()
        except AssertionError as e:
            print(f"event-smoke FAILED [{name}]: {e}", file=sys.stderr)
            return 1
        print(f"{name}: {detail}")
    print(f"event-smoke OK: {len(scenarios)} scenarios held every invariant")
    return 0


if __name__ == "__main__":
    sys.exit(main())
