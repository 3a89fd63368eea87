"""`python -m tpu_pruner_torch.testing.trace_smoke`:
record a traced action → breach the SLO → fetch
the pinned trace → render the waterfall.

The minimal end-to-end proof of action provenance traces: a real member
daemon runs `--trace on --slo-detect-to-action-ms 1` over one idle pod,
so the first actuated evaluation both completes a causal span tree
(evaluate → query/decode/signal/resolve/merge/gates → actuate) and
breaches the 1 ms detect→action SLO, pinning the trace past normal ring
eviction. The smoke asserts the pinned trace is fetchable by id at
/debug/traces/<id> with an `actuate` span, that `analyze --trace <id>
--traces-url` renders the same trace as a waterfall, that `analyze
--slow` reports the breach, and that the flight capsule's offline
`trace` stamp renders without the daemon. Non-zero exit on any miss.
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


def _analyze(*argv):
    return subprocess.run(
        [sys.executable, "-m", "tpu_pruner_torch.analyze", *argv],
        capture_output=True, text=True, timeout=120)


def main() -> int:
    from tpu_pruner_torch import native
    from tpu_pruner_torch.testing.fake_fleet import FakeFleet

    native.ensure_built()
    tmp = Path(tempfile.mkdtemp(prefix="tp-trace-smoke-"))
    flight = tmp / "flight"
    with FakeFleet(tmp) as fleet:
        member = fleet.add_member(
            "trace-east", idle_pods=1,
            extra_args=("--trace", "on", "--slo-detect-to-action-ms", "1",
                        "--flight-dir", str(flight), "--flight-keep", "64"))

        # One actuated evaluation: completes a trace AND breaches the
        # 1 ms SLO (a real pause takes longer than that), so it pins.
        index = _wait(
            lambda: (lambda doc:
                     doc if isinstance(doc, dict)
                     and doc.get("pinned", 0) > 0
                     and doc.get("slo", {}).get("breaches", 0) > 0
                     else None)(member.get_json("/debug/traces")),
            what="SLO breach pinned a trace")
        breached = [t for t in index["traces"] if t.get("breached")]
        if not breached:
            print(f"index reports breaches but lists none: {index}",
                  file=sys.stderr)
            return 1
        trace_id = breached[0]["trace_id"]

        # The pinned trace resolves by id with a complete span tree.
        trace = member.get_json(f"/debug/traces/{trace_id}")
        names = [s.get("name") for s in trace.get("span_tree", [])]
        if "actuate" not in names:
            print(f"pinned trace {trace_id} has no actuate span: {names}",
                  file=sys.stderr)
            return 1
        if not trace.get("breached") or not trace.get("pinned"):
            print(f"trace {trace_id} not marked breached+pinned: {trace}",
                  file=sys.stderr)
            return 1

        # Waterfall render by id against the live ring.
        proc = _analyze("--trace", trace_id, "--traces-url", member.url)
        if proc.returncode != 0:
            print(f"analyze --trace failed:\n{proc.stderr}", file=sys.stderr)
            return 1
        rendered = json.loads(proc.stdout)
        if rendered.get("trace_id") != trace_id:
            print(f"waterfall rendered the wrong trace: "
                  f"{rendered.get('trace_id')} != {trace_id}",
                  file=sys.stderr)
            return 1
        if "actuate" not in proc.stderr or "#" not in proc.stderr:
            print(f"waterfall table missing spans:\n{proc.stderr}",
                  file=sys.stderr)
            return 1

        # Slow-trace report sees the breach and the burn.
        proc = _analyze("--slow", member.url)
        if proc.returncode != 0:
            print(f"analyze --slow failed:\n{proc.stderr}", file=sys.stderr)
            return 1
        slow = json.loads(proc.stdout)
        if slow.get("slo", {}).get("breaches", 0) < 1:
            print(f"--slow reports no breaches: {slow.get('slo')}",
                  file=sys.stderr)
            return 1

    # Fleet stopped; the capsule's trace stamp still renders offline.
    proc = _analyze("--trace", str(flight))
    if proc.returncode != 0:
        print(f"offline capsule waterfall failed:\n{proc.stderr}",
              file=sys.stderr)
        return 1
    offline = json.loads(proc.stdout)
    if len(offline.get("trace_id") or "") != 32:
        print(f"offline render carries no trace id: {offline}",
              file=sys.stderr)
        return 1
    print(f"trace-smoke OK: SLO breach pinned trace {trace_id} "
          f"({len(names)} spans, root "
          f"{trace.get('root', {}).get('duration_ms', 0):.1f}ms); waterfall "
          f"+ --slow + offline capsule render all agree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
