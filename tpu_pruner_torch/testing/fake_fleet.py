"""Fake fleet: N member daemons plus the federation hub, in one process
tree.

The fleet tests, the fleet smoke, and the reference bench's
federation sections all need the same scaffolding: spin members with
distinct cluster identities and scripted evidence health, point a
`tpu-pruner hub` at their metrics ports, and read the merged view back.

Two member flavors:
  - FleetMember: a REAL daemon binary against its own hermetic fakes —
    the fleet surface asserted end to end (the 3-member smoke keeps
    using these);
  - LightMember: a scripted lightweight member serving canned
    /debug/{workloads,signals,decisions} documents from plain dicts PLUS
    the /debug/delta change-journal protocol (epochs, generation,
    bounded log, long-poll) — so 100+-member federations and the
    bench's planet tier fit in a 1-core container where 100 real
    daemon+fake trees never could.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


def _popen_with_port(cmd, env):
    """Start a metrics-serving process and parse its ephemeral port from
    stderr, then keep draining stderr on a thread (a --check-interval 1
    daemon logs enough to fill an undrained pipe mid-test). Set
    TP_FLEET_TEE=<path> to also append every member's stderr there —
    interleaved member logs are the only way to debug a fleet fixture."""
    import os
    import subprocess

    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    tee_path = os.environ.get("TP_FLEET_TEE")

    def _sink(line):
        if tee_path:
            with open(tee_path, "a") as f:
                f.write(line)

    port = None
    for line in proc.stderr:
        _sink(line)
        m = re.search(r"serving /metrics on port (\d+)", line)
        if m:
            port = int(m.group(1))
            break
    assert port, f"{cmd[0]} never reported its metrics port"

    def _drain():
        for line in proc.stderr:
            _sink(line)

    drainer = threading.Thread(target=_drain, daemon=True)
    drainer.start()
    return proc, port


def _http_get(port: int, path: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.read().decode()


class FleetMember:
    """One member daemon with its own fakes, cluster identity and ledger."""

    def __init__(self, cluster: str, tmp_dir: Path, *, idle_pods: int = 1,
                 stale_pods: int = 0, tpu_chips: int = 4,
                 signal_guard: str = "on", run_mode: str = "scale-down",
                 slice_topology: str | None = None, extra_args: tuple = ()):
        from tpu_pruner_torch.native import DAEMON_PATH
        from tpu_pruner_torch.testing import FakeK8s, FakePrometheus

        self.cluster = cluster
        self.prom = FakePrometheus()
        self.k8s = FakeK8s()
        self.prom.start()
        self.k8s.start()
        self.ledger_path = str(Path(tmp_dir) / f"ledger-{cluster}.jsonl")
        # idle_pods have healthy evidence; stale_pods' newest sample is
        # hours old, so the signal guard reads them STALE — enough of them
        # drops coverage below --signal-min-coverage and browns the member
        # out (healthy siblings then defer with SIGNAL_BROWNOUT but still
        # resolve, so the member's ledger tracks their roots).
        for i in range(idle_pods + stale_pods):
            nodes = None
            if slice_topology:
                # One single-tenant slice per deployment: node i in pool
                # "<cluster>-slice-i" with the GKE topology label, pod i
                # placed on it — the capacity observatory's unit fixture.
                node = f"{cluster}-node-{i}"
                self.k8s.add_node(node, pool=f"{cluster}-slice-{i}",
                                  topology=slice_topology,
                                  tpu_chips=tpu_chips)
                nodes = [node]
            _, _, pods = self.k8s.add_deployment_chain(
                "ml", f"{cluster}-dep-{i}", num_pods=1, tpu_chips=tpu_chips,
                nodes=nodes)
            knobs = {"chips": tpu_chips}
            if i >= idle_pods:
                knobs["last_sample_age"] = 4000.0
            self.prom.add_idle_pod_series(
                pods[0]["metadata"]["name"], "ml", **knobs)
        cmd = [str(DAEMON_PATH), "--prometheus-url", self.prom.url,
               "--run-mode", run_mode, "--daemon-mode",
               "--check-interval", "1", "--metrics-port", "auto",
               "--cluster-name", cluster,
               "--signal-guard", signal_guard,
               "--ledger-file", self.ledger_path, *extra_args]
        self.proc, self.port = _popen_with_port(
            cmd, {"KUBE_API_URL": self.k8s.url})

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def get(self, path: str) -> str:
        return _http_get(self.port, path)

    def get_json(self, path: str) -> dict:
        return json.loads(self.get(path))

    def kill(self):
        """Hard-stop the daemon (fakes stay up): the member goes dark the
        way a crashed pod does, for UNREACHABLE-row tests."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=10)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
        self.proc.wait(timeout=10)
        self.prom.stop()
        self.k8s.stop()


def _workload_row(cluster, key, *, chips=4, reclaimed=0.0, idle=0.0,
                  active=0.0, state="idle"):
    kind, ns, name = key.split("/", 2)
    return {"schema": 2, "cluster": cluster, "epoch": 0, "workload": key,
            "kind": kind, "namespace": ns, "name": name, "chips": chips,
            "state": state, "idle_seconds": idle, "active_seconds": active,
            "reclaimed_chip_seconds": reclaimed, "idle_streak_cycles": 1,
            "pauses": 0, "resumes": 0, "first_seen_cycle": 1,
            "last_seen_cycle": 1, "events": []}


def _sorted_rows(rows_by_key, sort="reclaimed"):
    """The member-side array order the hub's delta applier replicates:
    ascending key, then a STABLE sort by the sort field, descending
    (ledger::workloads_json's exact comparator)."""
    field = {"idle": "idle_seconds", "chips": "chips"}.get(
        sort, "reclaimed_chip_seconds")
    ordered = [rows_by_key[k] for k in sorted(rows_by_key)]
    return sorted(ordered, key=lambda r: -float(r.get(field, 0.0)))


class LightMember:
    """Scripted lightweight fleet member: serves the member debug surfaces
    (and the /debug/delta journal protocol) straight from dicts — no
    daemon, no fake apiserver/Prometheus. Mutate the surfaces through
    set_workloads/set_signals/append_decision and every change lands in
    the journal under a fresh epoch; restart() simulates a member restart
    (new generation, epoch reset — a polling hub must resync)."""

    def __init__(self, cluster, *, tracked=2, chips=4, journal_cap=4096,
                 signal_guard=True):
        self.cluster = cluster
        self.journal_cap = journal_cap
        self._cv = threading.Condition()
        self._gen_seq = 0
        # Counters tests read: per-path request counts + body bytes served.
        self.requests = {}
        self.bytes_served = 0
        rows = {}
        for i in range(tracked):
            key = f"Deployment/ml/{cluster}-dep-{i}"
            rows[key] = _workload_row(cluster, key, chips=chips,
                                      reclaimed=float(100 + i), idle=10.0,
                                      state="paused")
        self._rows = rows
        self._signals = {"cluster": cluster, "enabled": bool(signal_guard),
                         "coverage_ratio": 1.0, "brownout": False}
        self._dec_capacity = 512
        self._dec_dropped = 0
        self._decisions = []
        self._reset_journal()
        self._httpd = None
        self._thread = None

    # ── journal (mirrors native/src/delta.cpp) ──

    def _reset_journal(self):
        self._gen_seq += 1
        self.gen = f"light-{id(self) & 0xFFFF}-{self._gen_seq}"
        self.epoch = 0
        self._min_since = 0
        self._log = []
        # key → epoch last changed / removed; "" = workloads meta
        self._wl_epoch = {}
        self._wl_removed = {}
        self._sig_epoch = 0
        self._dec_meta_epoch = 0
        self._dec_ring = []  # (epoch, record)
        # Prime: everything current is epoch-0 state; the first delta poll
        # answers with a full snapshot anyway (since=-1).
        for key in self._rows:
            self._wl_epoch[key] = 0
        self._dec_ring = [(0, r) for r in self._decisions]

    def _note(self, epoch, n=1):
        for _ in range(n):
            self._log.append(epoch)
        while len(self._log) > self.journal_cap:
            self._min_since = max(self._min_since, self._log.pop(0))

    def _bump(self):
        self.epoch += 1
        return self.epoch

    # ── scripted mutations (each journals + wakes long-pollers) ──

    def set_workload(self, key, **fields):
        with self._cv:
            e = self._bump()
            row = self._rows.get(key) or _workload_row(self.cluster, key)
            row = dict(row)
            row.update(fields)
            self._rows[key] = row
            self._wl_epoch[key] = e
            self._wl_removed.pop(key, None)
            self._note(e)
            self._cv.notify_all()

    def remove_workload(self, key):
        with self._cv:
            if key not in self._rows:
                return
            e = self._bump()
            del self._rows[key]
            self._wl_epoch.pop(key, None)
            self._wl_removed[key] = e
            self._note(e)
            self._cv.notify_all()

    def set_signals(self, **fields):
        with self._cv:
            e = self._bump()
            self._signals.update(fields)
            self._sig_epoch = e
            self._note(e)
            self._cv.notify_all()

    def append_decision(self, record):
        with self._cv:
            e = self._bump()
            self._dec_ring.append((e, record))
            self._decisions.append(record)
            while len(self._dec_ring) > self._dec_capacity:
                self._dec_ring.pop(0)
                self._decisions.pop(0)
                self._dec_dropped += 1
            self._dec_meta_epoch = e  # dropped may have advanced
            self._note(e)
            self._cv.notify_all()

    def restart(self):
        """Member restart: the journal (and its epoch space) is gone; the
        surfaces survive (a real daemon reloads its ledger checkpoint)."""
        with self._cv:
            self._reset_journal()
            self._cv.notify_all()

    # ── documents ──

    def workloads_doc(self):
        totals = {
            "idle_seconds": round(sum(r["idle_seconds"] for r in self._rows.values()), 3),
            "active_seconds": round(sum(r["active_seconds"] for r in self._rows.values()), 3),
            "reclaimed_chip_seconds": round(
                sum(r["reclaimed_chip_seconds"] for r in self._rows.values()), 3),
        }
        return {"schema": 2, "cluster": self.cluster, "epoch": 0,
                "workloads": _sorted_rows(self._rows), "tracked": len(self._rows),
                "totals": totals, "sort": "reclaimed"}

    def signals_doc(self):
        return dict(self._signals)

    def decisions_doc(self):
        return {"cluster": self.cluster, "capacity": self._dec_capacity,
                "dropped": self._dec_dropped,
                "decisions": [r for _, r in self._dec_ring]}

    def _wl_meta(self):
        doc = self.workloads_doc()
        doc.pop("workloads")
        return doc

    def _dec_meta(self):
        doc = self.decisions_doc()
        doc.pop("decisions")
        return doc

    def _delta_response(self, since, gen, wait_ms, deadline):
        with self._cv:
            first = since < 0
            resync = (not first) and (gen != self.gen or since > self.epoch or
                                      since < self._min_since)
            if not first and not resync and since == self.epoch and wait_ms > 0:
                self._cv.wait_for(lambda: self.epoch != since,
                                  timeout=wait_ms / 1000.0)
            resp = {"cluster": self.cluster, "gen": self.gen, "epoch": self.epoch}
            if first or resync:
                if resync:
                    resp["resync"] = True
                resp["full"] = {"workloads": self.workloads_doc(),
                                "signals": self.signals_doc(),
                                "decisions": self.decisions_doc()}
                return resp
            resp["since"] = since
            surfaces = {}
            upserts = [self._rows[k]
                       for k in sorted(self._wl_epoch)
                       if self._wl_epoch[k] > since]
            removes = sorted(k for k, e in self._wl_removed.items() if e > since)
            if upserts or removes:
                surfaces["workloads"] = {"meta": self._wl_meta(),
                                         "upserts": upserts, "removes": removes}
            if self._sig_epoch > since:
                surfaces["signals"] = {"doc": self.signals_doc()}
            fresh = [r for e, r in self._dec_ring if e > since]
            if fresh or self._dec_meta_epoch > since:
                surfaces["decisions"] = {"meta": self._dec_meta(),
                                         "appends": fresh,
                                         "replace": len(fresh) == len(self._dec_ring)}
            if surfaces:
                resp["surfaces"] = surfaces
            return resp

    # ── HTTP ──

    def start(self):
        member = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # silence
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                member.requests[path] = member.requests.get(path, 0) + 1
                if path == "/debug/workloads":
                    body = json.dumps(member.workloads_doc())
                elif path == "/debug/signals":
                    body = json.dumps(member.signals_doc())
                elif path == "/debug/decisions":
                    body = json.dumps(member.decisions_doc())
                elif path == "/debug/delta":
                    params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
                    since = int(params.get("since", -1))
                    wait_ms = min(int(params.get("wait_ms", 0)), 55000)
                    body = json.dumps(member._delta_response(
                        since, params.get("gen", ""), wait_ms, None))
                elif path == "/metrics":
                    body = "# lightweight fleet member\n"
                elif path == "/readyz" or path == "/healthz":
                    body = "ok\n"
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                data = body.encode()
                member.bytes_served += len(data)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def get_json(self, path):
        return json.loads(_http_get(self.port, path))

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class FakeFleet:
    """N members + one hub. Use as a context manager, or call stop()."""

    def __init__(self, tmp_dir):
        self.tmp_dir = Path(tmp_dir)
        self.members: list[FleetMember] = []
        self.light_members: list[LightMember] = []
        self.child_hubs: list = []  # (proc, port) of region hubs
        self.hub_proc = None
        self.hub_port = None

    def add_member(self, cluster: str, **kwargs) -> FleetMember:
        member = FleetMember(cluster, self.tmp_dir, **kwargs)
        self.members.append(member)
        return member

    def add_light_member(self, cluster: str, **kwargs) -> LightMember:
        """A scripted lightweight member (no daemon — see LightMember):
        the building block for 100+-member federations."""
        member = LightMember(cluster, **kwargs).start()
        self.light_members.append(member)
        return member

    def start_child_hub(self, member_urls, *, cluster: str,
                        poll_interval: int = 1, stale_after: int | None = None,
                        extra_args: tuple = ()):
        """A region hub (hub-of-hubs): point the top hub at its port via
        member_urls=[f"http://127.0.0.1:{port}"]. Returns (proc, port)."""
        from tpu_pruner_torch.native import DAEMON_PATH

        cmd = [str(DAEMON_PATH), "hub", "--metrics-port", "auto",
               "--poll-interval", str(poll_interval),
               "--cluster-name", cluster]
        if stale_after is not None:
            cmd += ["--stale-after", str(stale_after)]
        for url in member_urls:
            cmd += ["--member", url]
        cmd += list(extra_args)
        proc, port = _popen_with_port(cmd, {})
        self.child_hubs.append((proc, port))
        return proc, port

    def start_hub(self, *, poll_interval: int = 1, stale_after: int | None = None,
                  member_urls: list[str] | None = None, extra_args: tuple = ()):
        from tpu_pruner_torch.native import DAEMON_PATH

        urls = member_urls if member_urls is not None else [
            m.url for m in self.members]
        cmd = [str(DAEMON_PATH), "hub", "--metrics-port", "auto",
               "--poll-interval", str(poll_interval),
               "--cluster-name", "hub"]
        if stale_after is not None:
            cmd += ["--stale-after", str(stale_after)]
        for url in urls:
            cmd += ["--member", url]
        cmd += list(extra_args)
        self.hub_proc, self.hub_port = _popen_with_port(cmd, {})
        return self.hub_port

    def hub_get(self, path: str) -> str:
        assert self.hub_port, "hub not started"
        return _http_get(self.hub_port, path)

    def hub_get_json(self, path: str) -> dict:
        return json.loads(self.hub_get(path))

    def stop(self):
        if self.hub_proc is not None and self.hub_proc.poll() is None:
            self.hub_proc.terminate()
        if self.hub_proc is not None:
            self.hub_proc.wait(timeout=10)
        for proc, _ in self.child_hubs:
            if proc.poll() is None:
                proc.terminate()
        for proc, _ in self.child_hubs:
            proc.wait(timeout=10)
        for m in self.members:
            m.stop()
        for m in self.light_members:
            m.stop()

    def __enter__(self) -> "FakeFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
