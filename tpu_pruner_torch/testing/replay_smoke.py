"""`python -m tpu_pruner_torch.testing.replay_smoke`:
record two daemon cycles against the hermetic
fakes, then replay every capsule offline — non-zero exit on decision
drift.

The smoke is the minimal end-to-end proof of the flight-recorder
contract: the daemon runs real scale-down cycles (fake Prometheus + fake
K8s API), seals one capsule per cycle into a temp --flight-dir, the fakes
are torn down, and `python -m tpu_pruner_torch.analyze --replay` must then
reproduce every cycle's DecisionRecords bit-for-bit with zero network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path


def main() -> int:
    from tpu_pruner_torch import native
    from tpu_pruner_torch.testing import FakeK8s, FakePrometheus

    native.ensure_built()

    prom = FakePrometheus()
    k8s = FakeK8s()
    prom.start()
    k8s.start()
    tmp = tempfile.mkdtemp(prefix="tp-replay-smoke-")
    flight_dir = Path(tmp) / "flight"
    try:
        _, _, pods = k8s.add_deployment_chain("ml", "trainer", num_pods=2,
                                              tpu_chips=4)
        for pod in pods:
            prom.add_idle_pod_series(pod["metadata"]["name"], "ml", chips=4)

        cmd = [str(native.DAEMON_PATH), "--prometheus-url", prom.url,
               "--run-mode", "scale-down", "--daemon-mode",
               "--check-interval", "1", "--max-cycles", "2",
               "--flight-dir", str(flight_dir)]
        proc = subprocess.run(cmd, env={"KUBE_API_URL": k8s.url},
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            print(f"daemon exited {proc.returncode}:\n{proc.stderr}",
                  file=sys.stderr)
            return 1
    finally:
        # fakes down BEFORE replay: a capsule replay that needed the
        # network would fail right here
        prom.stop()
        k8s.stop()

    capsules = sorted(flight_dir.glob("cycle-*.json"))
    if len(capsules) != 2:
        print(f"expected 2 capsules in {flight_dir}, found "
              f"{[c.name for c in capsules]}", file=sys.stderr)
        return 1

    for capsule in capsules:
        replay = subprocess.run(
            [sys.executable, "-m", "tpu_pruner_torch.analyze", "--replay",
             str(capsule)], capture_output=True, text=True, timeout=120)
        if replay.returncode != 0:
            print(f"REPLAY DRIFT in {capsule.name}:\n{replay.stderr}",
                  file=sys.stderr)
            return replay.returncode
        summary = json.loads(replay.stdout)
        print(f"{capsule.name}: cycle {summary['cycle']} replayed, "
              f"{len(summary['recorded'])} decision(s) reproduced, "
              f"{summary['actions']['recorded_scale_downs']} scale-down(s)")
    print("replay-smoke OK: 2 cycles recorded and replayed with zero drift")
    return 0


if __name__ == "__main__":
    sys.exit(main())
