"""In-process fake Kubernetes API server.

Generic path-keyed object store with real RFC 7386 merge-patch semantics,
labelSelector pod LISTs, the /scale subresource, and an Events sink — the
exact surface the pruner's watch-free client uses (GET/LIST/PATCH/POST) —
plus the watch surface its informer mode uses: every store write stamps a
global monotonic resourceVersion and lands in a watch log; `?watch=true`
GETs (namespaced or cluster-scoped collections) hold a chunked streaming
connection delivering newline-delimited ADDED/MODIFIED/DELETED events past
the client's resourceVersion, BOOKMARK events while idle
(allowWatchBookmarks), HTTP 410 Gone for versions older than the
compaction floor (`expire_watches()`), and injectable connection drops
(`kill_watches()`).

Fault injection is a first-class API (the chaos tier): beyond the
targeted `fail_next()` / `outage` / `kill_watches()` knobs, `inject()`
takes a declarative schedule of per-request fault points — `status`
(respond N, optional Retry-After), `delay` (stall the request, modeling a
wedged apiserver: the fixture's request lock is held, so everything
queues behind it), `disconnect` (close before any response byte),
`drop_after` (truncate the response after N bytes — headers included —
then abruptly close: mid-LIST-page and mid-watch-frame cuts), and
`wrong_rv` (serve a LIST whose metadata.resourceVersion is a lie, the
stale-but-plausible shape). Entries match on a path regex + method and
decrement a `times` budget, so a schedule is consumed deterministically
in request-arrival order: the same seed-generated schedule against the
same request sequence replays the same faults (the chaos harness's
replayability contract). Single-process mode only, like the watch
surface. See `inject()` for the schema.

Watch caveats: assigning `fake.objects[path] = obj` emits the event —
mutating an already-stored dict in place does NOT (reassign to emit
MODIFIED). In multi-process mode (`start(workers=N)`) each forked worker
has its own store snapshot, so watch events do not propagate across
workers — exercise watches with the default single-process server.

Scenario helpers build the reference's ownership chains (Pod→RS→Deployment,
Pod→SS→Notebook, kserve-labelled pods) plus the TPU-native one
(Pod→Job→JobSet multi-host slices with google.com/tpu requests).
"""

from __future__ import annotations

import base64
import copy
import json
import re
import socket
import threading
import time
import uuid
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import multiprocessing

from tpu_pruner_torch.testing import h2_server, wire_proto


def _mp_worker_main(fake: "FakeK8s", sock, conn) -> None:
    """Entry point of one forked API-server worker (start(workers=N)).

    The worker inherits a copy-on-write snapshot of the fully-built fake
    (fork start method — nothing is pickled) plus the already-listening
    socket; all workers accept() from that one socket, the kernel handing
    each new connection to whichever worker is free — the classic pre-fork
    server shape. Recording attributes (patches/requests/...) are the
    worker's own copies; the parent merges them on demand over the control
    pipe. Must be module-level so the fork context can invoke it directly.
    """
    # The fork may have captured control pipes of earlier-started siblings;
    # drop them so this process serves its OWN state (plain-attribute mode).
    fake._mp_conns = []
    fake._mp_procs = []
    # Fresh locks: the parent's may have been held mid-fork in a scenario
    # helper thread, which would deadlock every request here.
    fake._lock = threading.Lock()
    fake._watch_cond = threading.Condition()
    server = ThreadingHTTPServer(sock.getsockname(), fake._make_handler(),
                                 bind_and_activate=False)
    server.socket.close()  # replace the unused socket with the shared one
    server.socket = sock
    threading.Thread(target=server.serve_forever, daemon=True).start()
    while True:
        try:
            msg = conn.recv()
        except (EOFError, KeyboardInterrupt):
            break
        if msg == "stats":
            conn.send({
                "patches": fake.patches,
                "patch_times": fake.patch_times,
                "rejected_patches": fake.rejected_patches,
                "requests": fake.requests,
                "events": fake.events,
            })
        elif msg == "stop":
            conn.send("ok")
            break
    server.shutdown()


def merge_patch(target, patch):
    """RFC 7386 JSON merge patch."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out


def parse_label_selector(selector: str) -> list[tuple[str, set]]:
    """Parse `k=v` and set-based `k in (v1,v2)` requirements.

    Top-level commas separate requirements; commas inside parentheses
    belong to the value set.
    """
    reqs: list[tuple[str, set]] = []
    clauses, depth, cur = [], 0, ""
    for ch in selector:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            clauses.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        clauses.append(cur)
    for clause in map(str.strip, clauses):
        if not clause:
            continue
        if " in " in clause:
            key, _, vals = clause.partition(" in ")
            vals = vals.strip().lstrip("(").rstrip(")")
            reqs.append((key.strip(), {v.strip() for v in vals.split(",")}))
        elif "=" in clause:
            k, v = clause.split("=", 1)
            reqs.append((k.strip(), {v.strip()}))
    return reqs


# ── server-side structural-schema validation ────────────────────────────
#
# A real API server rejects patches that violate the target's schema:
# built-in types via field validation, CRs via the CRD's structural schema
# (the validation gpu-pruner's kind tier hits in tests/e2e.rs:256-333).
# The merge-patch store alone would absorb a typo'd patch path
# (spec.suspended, minReplica) that only a live cluster would catch —
# these validators close that gap for the five patch shapes the daemon
# emits. Unknown fields → 400 (fieldValidation=Strict / structural-schema
# pruning); wrong types or out-of-range values → 422 reason=Invalid.


class PatchInvalid(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _check_allowed(obj: dict, allowed: set, where: str) -> None:
    unknown = set(obj) - allowed
    if unknown:
        raise PatchInvalid(400, f"unknown field(s) in {where}: {sorted(unknown)}")


def _check_metadata(meta) -> None:
    if meta is None:
        return
    if not isinstance(meta, dict):
        raise PatchInvalid(422, "metadata must be an object")
    ann = meta.get("annotations")
    if ann is not None:
        if not isinstance(ann, dict):
            raise PatchInvalid(422, "metadata.annotations must be an object")
        for k, v in ann.items():
            # deletion via merge-patch null is legal; values must be strings
            if v is not None and not isinstance(v, str):
                raise PatchInvalid(422, f"annotation {k!r} value must be a string")


def _non_negative_int(value, where: str) -> None:
    if not isinstance(value, int) or isinstance(value, bool) or value < 0:
        raise PatchInvalid(422, f"{where} must be a non-negative integer")


def validate_patch(path: str, body) -> None:
    """Raise PatchInvalid if `body` violates the target's schema."""
    if not isinstance(body, dict):
        raise PatchInvalid(400, "patch body must be a JSON object")
    if path.endswith("/scale"):
        # autoscaling/v1 Scale: only spec.replicas is patchable
        _check_allowed(body, {"apiVersion", "kind", "metadata", "spec"}, "Scale")
        _check_metadata(body.get("metadata"))
        spec = body.get("spec")
        if spec is not None:
            if not isinstance(spec, dict):
                raise PatchInvalid(422, "Scale.spec must be an object")
            _check_allowed(spec, {"replicas"}, "Scale.spec")
            if "replicas" in spec:
                _non_negative_int(spec["replicas"], "Scale.spec.replicas")
        return
    _check_allowed(body, {"apiVersion", "kind", "metadata", "spec", "status"}, "patch")
    _check_metadata(body.get("metadata"))
    spec = body.get("spec")
    if spec is None:
        return
    if not isinstance(spec, dict):
        raise PatchInvalid(422, "spec must be an object")
    if "/jobsets/" in path:
        _check_allowed(
            spec, {"suspend", "replicatedJobs", "network", "successPolicy",
                   "failurePolicy", "startupPolicy", "ttlSecondsAfterFinished"},
            "JobSet.spec")
        if "suspend" in spec and not isinstance(spec["suspend"], bool):
            raise PatchInvalid(422, "JobSet.spec.suspend must be a boolean")
    elif "/inferenceservices/" in path:
        _check_allowed(spec, {"predictor", "transformer", "explainer"},
                       "InferenceService.spec")
        predictor = spec.get("predictor")
        if predictor is not None:
            if not isinstance(predictor, dict):
                raise PatchInvalid(422, "spec.predictor must be an object")
            _check_allowed(predictor, {"minReplicas", "maxReplicas", "scaleTarget",
                                       "scaleMetric", "model", "containers"},
                           "InferenceService.spec.predictor")
            if "minReplicas" in predictor:
                _non_negative_int(predictor["minReplicas"],
                                  "spec.predictor.minReplicas")
    elif "/notebooks/" in path:
        # the pause shape is metadata-only (kubeflow-resource-stopped
        # annotation); spec.template is the only structural spec field
        _check_allowed(spec, {"template"}, "Notebook.spec")
    elif "/leaderworkersets/" in path:
        _check_allowed(spec, {"replicas", "leaderWorkerTemplate", "startupPolicy",
                              "rolloutStrategy"}, "LeaderWorkerSet.spec")
        if "replicas" in spec:
            _non_negative_int(spec["replicas"], "LeaderWorkerSet.spec.replicas")


class _ObjectStore(dict):
    """Path-keyed object dict that journals writes for the watch surface.

    Every insert/replace/delete stamps the object with the next global
    resourceVersion and appends an ADDED/MODIFIED/DELETED event (deep-copy
    snapshot) to the fake's watch log under `_watch_cond`, waking any
    streaming watch handlers. Never takes the fake's request `_lock` —
    handlers call in while already holding it.
    """

    def __init__(self, fake: "FakeK8s"):
        super().__init__()
        self._fake = fake

    def __setitem__(self, path: str, obj: dict) -> None:
        fake = self._fake
        event_type = "MODIFIED" if path in self else "ADDED"
        with fake._watch_cond:
            fake._rv += 1
            obj.setdefault("metadata", {})["resourceVersion"] = str(fake._rv)
            super().__setitem__(path, obj)
            fake._watch_log.append(
                {"rv": fake._rv, "type": event_type, "path": path,
                 "object": copy.deepcopy(obj)})
            fake._watch_cond.notify_all()

    def __delitem__(self, path: str) -> None:
        fake = self._fake
        with fake._watch_cond:
            obj = super().pop(path)
            fake._rv += 1
            snapshot = copy.deepcopy(obj)
            snapshot.setdefault("metadata", {})["resourceVersion"] = str(fake._rv)
            fake._watch_log.append(
                {"rv": fake._rv, "type": "DELETED", "path": path,
                 "object": snapshot})
            fake._watch_cond.notify_all()

    def pop(self, path, *default):
        if path not in self:
            if default:
                return default[0]
            raise KeyError(path)
        obj = self[path]
        del self[path]
        return obj


def rfc3339(dt: datetime) -> str:
    return dt.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def age(seconds: int) -> str:
    """creationTimestamp `seconds` ago."""
    return rfc3339(datetime.now(timezone.utc) - timedelta(seconds=seconds))


class _TruncatingFile:
    """Write-side wfile wrapper implementing the `drop_after` fault: pass
    through `budget` response bytes (status line and headers included),
    then shut the socket down abruptly and raise BrokenPipeError — the
    client observes a response (or watch frame) cut mid-byte-stream, not
    a clean close. The handler's BrokenPipeError guard swallows the
    raise, so the thread unwinds quietly like a real client disconnect."""

    def __init__(self, raw, sock, budget: int):
        self._raw = raw
        self._sock = sock
        self._budget = budget

    def write(self, data):
        if self._budget <= 0:
            self._die()
        chunk = data[:self._budget]
        self._raw.write(chunk)
        self._budget -= len(chunk)
        if len(chunk) < len(data):
            try:
                self._raw.flush()
            except OSError:
                pass
            self._die()
        return len(data)

    def _die(self):
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise BrokenPipeError("drop_after budget exhausted (injected fault)")

    def flush(self):
        try:
            self._raw.flush()
        except OSError:
            pass

    def close(self):
        self._raw.close()

    @property
    def closed(self):
        return self._raw.closed


class FakeK8s:
    # fault kinds inject() accepts; see the method docstring
    FAULT_KINDS = frozenset(
        {"status", "delay", "disconnect", "drop_after", "wrong_rv"})

    def __init__(self):
        # ── watch surface state (before `objects`: the store journals
        # into these) ──
        self._rv = 0                 # global monotonic resourceVersion
        self._watch_log: list[dict] = []   # {rv, type, path, object}
        self._watch_floor = 0        # rv below which watches 410 (compaction)
        self._watch_generation = 0   # bumped by kill_watches(): drop streams
        self._watch_stop = False     # set by stop(): end all streams
        self._watch_cond = threading.Condition()
        self.bookmark_interval_s = 0.5  # idle-stream BOOKMARK cadence
        # path (e.g. "/api/v1/namespaces/ns/pods/p") → object dict
        self.objects: dict[str, dict] = _ObjectStore(self)
        # Recording state lives in underscored attributes; the public names
        # are properties so that in multi-process mode (start(workers=N))
        # the parent transparently serves the MERGED view across workers
        # while handlers keep appending to their process-local lists.
        self._events: list[dict] = []
        self._patches: list[tuple[str, dict]] = []  # LANDED (path, body) in arrival order
        self._patch_times: list[float] = []  # time.monotonic() per landed patch
        # (path, body, status) for patches the server refused (400/404/409/422)
        self._rejected_patches: list[tuple[str, dict, int]] = []
        self._requests: list[tuple[str, str]] = []  # (method, path)
        # W3C traceparent header per recorded request (None when absent),
        # aligned with _requests. Single-process mode only: the traceparent
        # tests drive the default in-process server.
        self._traceparents: list[str | None] = []
        self.outage = False  # True → every request 503s (apiserver outage)
        # Server-side structural-schema validation (see validate_patch).
        # ON by default so every hermetic test proves the daemon's patches
        # survive a validating API server; tests may disable it to model
        # a permissive aggregated apiserver.
        self.strict_validation = True
        # Binary wire path (--wire proto): serve
        # application/vnd.kubernetes.protobuf for collection LISTs and
        # watch streams whose request Accept asks for it AND whose
        # objects fit the encoder's Pod-subset schema (wire_proto.py);
        # anything else falls back to JSON — the negotiation-fallback
        # path the native client counts. False models a JSON-only
        # apiserver. Counters below record what actually went out;
        # response recording (requests/patches/...) is wire-independent.
        self.serve_protobuf = True
        self.proto_lists = 0         # LIST responses served as protobuf
        self.proto_watch_frames = 0  # watch frames served as protobuf
        # >0 → chunk every collection LIST into pages of this size with
        # metadata.continue tokens even when the client sends no `limit`
        # (what an intermediary cache does); clients that ignore the token
        # silently see only the first page. Independently of this switch,
        # a client-sent `limit=N` query param always paginates at N, with
        # OPAQUE continue tokens that 410 once the compaction floor moves
        # past their snapshot (expire_watches) — the real apiserver's
        # limit/continue contract, which the informer's initial LIST uses.
        self.paginate_lists = 0
        # LIST encode cache: per-(path, selector) scan results and
        # per-pod JSON/protobuf encodings computed ONCE per snapshot rv
        # instead of once per page request. A 1M-pod paginated cold LIST
        # is thousands of page GETs; without this the fake rescans — and
        # re-encodes — the whole store per page, and the FIXTURE, not the
        # daemon, dominates the bench wall. Per-pod encodings only engage
        # at >= ENCODE_CACHE_MIN items (big bench fixtures); small tests
        # keep the uncached path so in-place object mutation (see module
        # docstring caveat) stays visible. Stats ride the bench detail
        # (list_encode_cache_stats) and are never asserted on.
        self.ENCODE_CACHE_MIN = 512
        self._list_cache: dict[tuple[str, str], dict] = {}
        self.list_encode_stats = {"scans": 0, "scan_hits": 0,
                                  "encodes": 0, "encode_seconds": 0.0}
        # targeted fault injection: (method or "*", exact path) → [code, n]
        # where n is the remaining failure count (-1 = fail forever)
        self.fail_rules: dict[tuple[str, str], list] = {}
        # declarative fault schedule (the chaos tier): inject() appends
        # entries, every request consumes them first-match-wins under
        # _lock — see inject() for the schema and fault kinds
        self.fault_schedule: list[dict] = []
        self.faults_fired: list[tuple[str, str, str]] = []  # (kind, method, path)
        # shared-transport accounting: accepted connections + h2 streams,
        # so tests can assert multiplexing actually happened (e.g. a warm
        # cycle opens <= 1 connection to this endpoint)
        self.transport = h2_server.TransportStats()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # multi-process mode (start(workers=N)): control pipes + processes
        self._mp_conns: list = []
        self._mp_procs: list = []
        self._mp_socket = None
        self._mp_port: int | None = None

    # ── recording views (merged across workers in multi-process mode) ──
    def _mp_stats(self) -> dict:
        """Pull and merge every worker's recordings. Patches and their
        times are re-interleaved globally by timestamp (CLOCK_MONOTONIC is
        system-wide on Linux, so cross-process times are comparable) —
        sequential bench runs window them by start index, which stays
        correct because later runs' patches all carry later times."""
        for conn in self._mp_conns:
            conn.send("stats")
        per = [conn.recv() for conn in self._mp_conns]
        merged = {"rejected_patches": [], "requests": [], "events": []}
        timed = []
        for d in per:
            timed.extend(zip(d["patch_times"], d["patches"]))
            merged["rejected_patches"].extend(d["rejected_patches"])
            merged["requests"].extend(d["requests"])
            merged["events"].extend(d["events"])
        timed.sort(key=lambda tp: tp[0])
        merged["patches"] = [tuple(p) for _, p in timed]
        merged["patch_times"] = [t for t, _ in timed]
        merged["rejected_patches"] = [tuple(r) for r in merged["rejected_patches"]]
        merged["requests"] = [tuple(r) for r in merged["requests"]]
        return merged

    @property
    def patches(self):
        return self._mp_stats()["patches"] if self._mp_conns else self._patches

    @property
    def patch_times(self):
        return self._mp_stats()["patch_times"] if self._mp_conns else self._patch_times

    @property
    def rejected_patches(self):
        return (self._mp_stats()["rejected_patches"] if self._mp_conns
                else self._rejected_patches)

    @property
    def requests(self):
        return self._mp_stats()["requests"] if self._mp_conns else self._requests

    @property
    def events(self):
        return self._mp_stats()["events"] if self._mp_conns else self._events

    @property
    def traceparents(self):
        """traceparent header per request, aligned with `requests`
        (single-process mode; workers don't forward it)."""
        return self._traceparents

    # ── object builders ────────────────────────────────────────────────
    @staticmethod
    def _meta(name, ns, uid=None, owners=None, labels=None, created_age=7200):
        meta = {
            "name": name,
            "namespace": ns,
            "uid": uid or str(uuid.uuid4()),
            "resourceVersion": "1",
            "creationTimestamp": age(created_age),
        }
        if owners:
            meta["ownerReferences"] = owners
        if labels:
            meta["labels"] = labels
        return meta

    @staticmethod
    def owner(kind, name, uid="owner-uid"):
        return {"apiVersion": "v1", "kind": kind, "name": name, "uid": uid, "controller": True}

    def add_pod(self, ns, name, owners=None, labels=None, phase="Running",
                created_age=7200, tpu_chips=4, no_creation_ts=False, node=None):
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": self._meta(name, ns, owners=owners, labels=labels,
                                   created_age=created_age),
            "spec": {
                "containers": [
                    {
                        "name": "main",
                        "resources": (
                            {"requests": {"google.com/tpu": str(tpu_chips)},
                             "limits": {"google.com/tpu": str(tpu_chips)}}
                            if tpu_chips
                            else {}
                        ),
                    }
                ]
            },
            "status": {"phase": phase},
        }
        if node:
            pod["spec"]["nodeName"] = node
        if no_creation_ts:
            del pod["metadata"]["creationTimestamp"]
        self.objects[f"/api/v1/namespaces/{ns}/pods/{name}"] = pod
        return pod

    def add_node(self, name, pool=None, topology=None, tpu_chips=4,
                 device="google.com/tpu"):
        """Cluster-scoped Node carrying the GKE slice-topology labels the
        capacity observatory reads (nodepool = slice id, tpu-topology =
        slice shape) plus an allocatable accelerator quantity."""
        labels = {}
        if pool:
            labels["cloud.google.com/gke-nodepool"] = pool
        if topology:
            labels["cloud.google.com/gke-tpu-topology"] = topology
        meta = {
            "name": name,
            "uid": str(uuid.uuid4()),
            "resourceVersion": "1",
            "creationTimestamp": age(7200),
        }
        if labels:
            meta["labels"] = labels
        node = {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": meta,
            "status": {"allocatable": {device: str(tpu_chips)}},
        }
        self.objects[f"/api/v1/nodes/{name}"] = node
        return node

    def _add_apps(self, plural, kind, ns, name, uid=None, owners=None, replicas=2):
        obj = {
            "apiVersion": "apps/v1",
            "kind": kind,
            "metadata": self._meta(name, ns, uid=uid, owners=owners),
            "spec": {"replicas": replicas},
        }
        self.objects[f"/apis/apps/v1/namespaces/{ns}/{plural}/{name}"] = obj
        return obj

    def add_deployment(self, ns, name, uid=None, replicas=2):
        return self._add_apps("deployments", "Deployment", ns, name, uid, replicas=replicas)

    def add_replicaset(self, ns, name, uid=None, owners=None, replicas=2):
        return self._add_apps("replicasets", "ReplicaSet", ns, name, uid, owners, replicas)

    def add_statefulset(self, ns, name, uid=None, owners=None, replicas=1):
        return self._add_apps("statefulsets", "StatefulSet", ns, name, uid, owners, replicas)

    def add_notebook(self, ns, name, uid=None):
        obj = {
            "apiVersion": "kubeflow.org/v1",
            "kind": "Notebook",
            "metadata": self._meta(name, ns, uid=uid),
            "spec": {"template": {}},
        }
        self.objects[f"/apis/kubeflow.org/v1/namespaces/{ns}/notebooks/{name}"] = obj
        return obj

    def add_inference_service(self, ns, name, uid=None, min_replicas=1):
        obj = {
            "apiVersion": "serving.kserve.io/v1beta1",
            "kind": "InferenceService",
            "metadata": self._meta(name, ns, uid=uid),
            "spec": {"predictor": {"minReplicas": min_replicas}},
        }
        self.objects[
            f"/apis/serving.kserve.io/v1beta1/namespaces/{ns}/inferenceservices/{name}"
        ] = obj
        return obj

    def add_job(self, ns, name, uid=None, owners=None):
        obj = {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": self._meta(name, ns, uid=uid, owners=owners),
            "spec": {},
        }
        self.objects[f"/apis/batch/v1/namespaces/{ns}/jobs/{name}"] = obj
        return obj

    def add_jobset(self, ns, name, uid=None):
        obj = {
            "apiVersion": "jobset.x-k8s.io/v1alpha2",
            "kind": "JobSet",
            "metadata": self._meta(name, ns, uid=uid),
            "spec": {"suspend": False, "replicatedJobs": []},
        }
        self.objects[f"/apis/jobset.x-k8s.io/v1alpha2/namespaces/{ns}/jobsets/{name}"] = obj
        return obj

    def add_jobset_slice(self, ns, jobset_name, num_hosts=4, tpu_chips=4, uid=None,
                         pod_age=7200, num_jobs=1):
        """A multi-host TPU slice: JobSet → Job → worker pods (one per host).
        num_jobs > 1 models a MULTI-SLICE JobSet (DCN-connected slices as
        replicated jobs under one owner, SURVEY.md §5): workers-0..N-1."""
        js = self.add_jobset(ns, jobset_name, uid=uid)
        pods = []
        for j in range(num_jobs):
            job_name = f"{jobset_name}-workers-{j}"
            self.add_job(ns, job_name,
                         owners=[self.owner("JobSet", jobset_name, js["metadata"]["uid"])])
            for host in range(num_hosts):
                pods.append(
                    self.add_pod(
                        ns,
                        f"{job_name}-{host}",
                        owners=[self.owner("Job", job_name)],
                        labels={
                            "jobset.sigs.k8s.io/jobset-name": jobset_name,
                            "batch.kubernetes.io/job-name": job_name,
                        },
                        tpu_chips=tpu_chips,
                        created_age=pod_age,
                    )
                )
        return js, pods

    def add_leaderworkerset(self, ns, name, uid=None, replicas=1):
        obj = {
            "apiVersion": "leaderworkerset.x-k8s.io/v1",
            "kind": "LeaderWorkerSet",
            "metadata": self._meta(name, ns, uid=uid),
            "spec": {"replicas": replicas, "leaderWorkerTemplate": {}},
        }
        self.objects[
            f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{ns}/leaderworkersets/{name}"
        ] = obj
        return obj

    def add_lws_group(self, ns, lws_name, num_hosts=2, tpu_chips=4, uid=None,
                      pod_age=7200):
        """A multi-host serving group with realistic LWS topology: the
        leader StatefulSet is owned by the LWS, but the worker StatefulSet
        is owned by the *leader Pod* (upstream controller semantics) — so
        only the leaderworkerset.sigs.k8s.io/name pod label reaches the
        root uniformly."""
        lws = self.add_leaderworkerset(ns, lws_name, uid=uid)
        leader_ss = self.add_statefulset(
            ns, lws_name,
            owners=[self.owner("LeaderWorkerSet", lws_name, lws["metadata"]["uid"])])
        labels = {"leaderworkerset.sigs.k8s.io/name": lws_name}
        pods = [self.add_pod(
            ns, f"{lws_name}-0",
            owners=[self.owner("StatefulSet", leader_ss["metadata"]["name"],
                               leader_ss["metadata"]["uid"])],
            labels=labels, tpu_chips=tpu_chips, created_age=pod_age)]
        worker_ss = self.add_statefulset(
            ns, f"{lws_name}-0-workers",
            owners=[self.owner("Pod", f"{lws_name}-0", pods[0]["metadata"]["uid"])])
        for host in range(1, num_hosts):
            pods.append(self.add_pod(
                ns, f"{lws_name}-0-{host}",
                owners=[self.owner("StatefulSet", worker_ss["metadata"]["name"],
                                   worker_ss["metadata"]["uid"])],
                labels=labels, tpu_chips=tpu_chips, created_age=pod_age))
        return lws, pods

    # ── deployment chain helper (Pod→RS→Deployment) ──
    def add_deployment_chain(self, ns, name, num_pods=1, tpu_chips=4, pod_age=7200,
                             pod_labels=None, annotations=None, replicas=None,
                             nodes=None):
        dep = self.add_deployment(
            ns, name, replicas=replicas if replicas is not None else 2)
        if annotations:
            dep["metadata"]["annotations"] = dict(annotations)
        rs = self.add_replicaset(
            ns, f"{name}-abc123",
            owners=[self.owner("Deployment", name, dep["metadata"]["uid"])])
        pods = [
            self.add_pod(
                ns, f"{name}-abc123-{i}",
                owners=[self.owner("ReplicaSet", rs["metadata"]["name"], rs["metadata"]["uid"])],
                labels=dict(pod_labels) if pod_labels else None,
                tpu_chips=tpu_chips, created_age=pod_age,
                node=nodes[i % len(nodes)] if nodes else None)
            for i in range(num_pods)
        ]
        return dep, rs, pods

    # ── introspection ──
    def fail_next(self, method: str, path: str, code: int = 503, times: int = -1,
                  retry_after: int | str | None = None):
        """Make `method` (or "*" for any) requests to the exact `path` fail
        with `code`, `times` times (-1 = until cleared). retry_after adds
        a Retry-After header (API Priority & Fairness 429 shape):
        delta-seconds as int, or an HTTP-date string (RFC 7231 form)."""
        self.fail_rules[(method, path)] = [code, times, retry_after]

    def _injected_failure(self, method: str, path: str):
        """Returns (code, retry_after|None) to fail with, or None.
        Caller holds _lock."""
        for key in ((method, path), ("*", path)):
            rule = self.fail_rules.get(key)
            if rule and rule[1] != 0:
                if rule[1] > 0:
                    rule[1] -= 1
                return rule[0], (rule[2] if len(rule) > 2 else None)
        return None

    def inject(self, schedule: list[dict]):
        """Append a declarative fault schedule (the chaos tier).

        Each entry is a dict::

            {"fault": <kind>, "match": <path regex, default ".*">,
             "method": <"GET"|"PATCH"|"POST"|"*", default "*">,
             "times": <budget, default 1; -1 = unlimited>, ...params}

        Kinds and their params:

        - ``status``: respond ``code`` (default 503) with a Status body;
          ``retry_after`` adds a Retry-After header (int delta-seconds or
          an HTTP-date string) — the 429/5xx-burst shape.
        - ``delay``: sleep ``seconds`` (default 1.0) before serving
          normally. Served under the fixture's request lock, so this
          models a WEDGED apiserver: everything queues behind it.
        - ``disconnect``: close the connection before any response byte.
        - ``drop_after``: serve normally but cut the connection after
          ``bytes`` response bytes (status line + headers included) —
          mid-LIST-page / mid-watch-frame truncation.
        - ``wrong_rv``: serve the LIST normally but lie in
          ``metadata.resourceVersion`` (value ``rv``, default "1") — the
          stale-but-plausible response a broken cache produces.

        Entries are consumed FIRST-MATCH-WINS in schedule order, each
        decrementing its ``times`` budget, requests arriving in order —
        so a seed-generated schedule replays deterministically against
        the same request sequence. Every fired fault is recorded in
        ``faults_fired`` as (kind, method, path). Single-process servers
        only (``start()`` without workers), like the watch surface.
        """
        compiled = []
        for entry in schedule:
            kind = entry.get("fault")
            if kind not in self.FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(one of {sorted(self.FAULT_KINDS)})")
            e = dict(entry)
            e.setdefault("method", "*")
            e.setdefault("times", 1)
            e["_re"] = re.compile(e.get("match", ".*"))
            compiled.append(e)
        with self._lock:
            self.fault_schedule.extend(compiled)

    def clear_faults(self):
        """Drop every un-consumed inject() entry."""
        with self._lock:
            self.fault_schedule.clear()

    def _take_fault(self, method: str, path: str):
        """First schedule entry matching (method, path) with budget left,
        or None; decrements the budget and records the firing. Caller
        holds _lock."""
        for e in self.fault_schedule:
            if e["times"] == 0:
                continue
            if e["method"] not in ("*", method):
                continue
            if not e["_re"].search(path):
                continue
            if e["times"] > 0:
                e["times"] -= 1
            self.faults_fired.append((e["fault"], method, path))
            return e
        return None

    def kill_watches(self):
        """Abruptly drop every active watch stream (mid-stream connection
        loss). New watch requests are served normally — the client's
        reconnect-and-resume path is what this exercises."""
        with self._watch_cond:
            self._watch_generation += 1
            self._watch_cond.notify_all()

    def expire_watches(self):
        """Simulate apiserver history compaction: any watch resuming from
        a resourceVersion older than *now* gets HTTP 410 Gone and must
        relist; active streams are dropped. The floor is set to a fresh
        version (not current+1) so the relist's LIST version is always
        acceptable — clients can recover, exactly once through a relist."""
        with self._watch_cond:
            self._rv += 1  # synthetic compaction marker: floor > all prior rvs
            self._watch_floor = self._rv
            self._watch_generation += 1
            self._watch_cond.notify_all()

    def _encode_continue(self, start: int) -> str:
        """Opaque continue token, shaped like a real apiserver's: carries
        the cursor AND the resourceVersion of the snapshot it belongs to,
        base64'd so clients cannot (and must not) interpret it — they pass
        it back verbatim."""
        raw = f"v1:{start}:{self._rv}"
        return base64.urlsafe_b64encode(raw.encode()).decode().rstrip("=")

    def _decode_continue(self, token: str):
        """Returns (start_index, None) or (0, 410): malformed tokens and
        tokens whose snapshot rv predates the compaction floor
        (expire_watches) get HTTP 410 Expired, exactly the real
        apiserver's answer to a stale continue — the client must restart
        the LIST from the beginning."""
        if not token:
            return 0, None
        try:
            pad = "=" * (-len(token) % 4)
            raw = base64.urlsafe_b64decode((token + pad).encode()).decode()
            version, start, rv = raw.split(":")
            if version != "v1":
                return 0, 410
            start, rv = int(start), int(rv)
        except Exception:
            return 0, 410
        if rv < self._watch_floor:
            return 0, 410
        return start, None

    def scale_patches(self):
        return [(p, b) for p, b in self.patches if p.endswith("/scale")]

    def patches_for(self, path_suffix):
        return [b for p, b in self.patches if p.endswith(path_suffix)]

    def resume_patches(self):
        """Landed patches that bring a root BACK UP (replicas>0,
        suspend=false, minReplicas>0, or removal of the Kubeflow stop
        annotation) — operator/test resume actions. The daemon only ever
        scales down, so anything here came from outside it; ledger tests
        assert resume detection against this record."""
        out = []
        for p, b in self.patches:
            spec = b.get("spec") or {}
            replicas = spec.get("replicas")
            min_replicas = (spec.get("predictor") or {}).get("minReplicas")
            annotations = (b.get("metadata") or {}).get("annotations") or {}
            if ((isinstance(replicas, int) and replicas > 0)
                    or spec.get("suspend") is False
                    or (isinstance(min_replicas, int) and min_replicas > 0)
                    or ("kubeflow-resource-stopped" in annotations
                        and annotations["kubeflow-resource-stopped"] is None)):
                out.append((p, b))
        return out

    def resume_root(self, path, replicas=2):
        """Re-scale a paused root back up — what an operator's `kubectl
        scale` / unsuspend does. Flips the kind's paused state on the
        stored object and journals the MODIFIED watch event, so an
        informer-backed daemon observes the resume without polling.
        Returns the updated object."""
        obj = copy.deepcopy(self.objects[path])
        if "/jobsets/" in path:
            obj.setdefault("spec", {})["suspend"] = False
        elif "/notebooks/" in path:
            (obj.get("metadata", {}).get("annotations") or {}).pop(
                "kubeflow-resource-stopped", None)
        elif "/inferenceservices/" in path:
            obj.setdefault("spec", {}).setdefault("predictor", {})[
                "minReplicas"] = replicas
        else:
            obj.setdefault("spec", {})["replicas"] = replicas
        self.objects[path] = obj  # reassign: stamps rv + emits MODIFIED
        return obj

    # ── lifecycle ──────────────────────────────────────────────────────
    def _make_handler(self):
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # real API servers (Go net/http) set TCP_NODELAY; without it the
            # keep-alive body write stalls behind the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def handle_one_request(self):
                # The drop_after fault raises BrokenPipeError from inside
                # the handler (as would a real client disconnect mid-
                # response); unwind quietly instead of a stderr traceback.
                try:
                    super().handle_one_request()
                except BrokenPipeError:
                    self.close_connection = True

            def _apply_fault(self, fault):
                """Apply a consumed inject() fault. Returns False when the
                request was already answered (or the connection killed);
                True to continue serving normally (delay slept / wfile
                wrapped for drop_after / wrong_rv armed)."""
                kind = fault["fault"]
                if kind == "status":
                    self._respond(fault.get("code", 503),
                                  {"kind": "Status", "status": "Failure",
                                   "message": "injected fault (test)"},
                                  retry_after=fault.get("retry_after"))
                    return False
                if kind == "disconnect":
                    self.close_connection = True
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return False
                if kind == "delay":
                    time.sleep(fault.get("seconds", 1.0))
                    return True
                if kind == "drop_after":
                    self.wfile = _TruncatingFile(self.wfile, self.connection,
                                                 int(fault.get("bytes", 0)))
                    self.close_connection = True
                    return True
                if kind == "wrong_rv":
                    self._wrong_rv = str(fault.get("rv", "1"))
                    return True
                return True

            def _respond(self, code, payload, retry_after=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.end_headers()
                self.wfile.write(body)

            def _not_found(self):
                self._respond(404, {"kind": "Status", "status": "Failure",
                                    "reason": "NotFound", "code": 404,
                                    "message": f"{self.path} not found"})

            def _respond_raw(self, code, body, content_type):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _respond_collection(self, items, meta, cached=None, start=0):
                """LIST response with content negotiation: protobuf when
                the client asked for it and every item fits the encoder's
                schema, JSON otherwise (the fallback a JSON-only
                apiserver exercises). ``cached``/``start`` identify this
                page's slice of a snapshot-rv scan entry: big fixtures
                serve pages assembled from per-pod encodings computed
                once per snapshot (byte-identical to the direct encode)."""
                accept = self.headers.get("Accept", "")
                use_cache = (cached is not None
                             and len(cached["items"]) >= fake.ENCODE_CACHE_MIN)
                if use_cache and cached["pod_json"] is None:
                    t0 = time.perf_counter()
                    cached["pod_json"] = [json.dumps(o) for o in cached["items"]]
                    if fake.serve_protobuf:
                        cached["pod_pb"] = [wire_proto.encode_pod_chunk(o)
                                            for o in cached["items"]]
                    fake.list_encode_stats["encodes"] += 1
                    fake.list_encode_stats["encode_seconds"] += (
                        time.perf_counter() - t0)
                if fake.serve_protobuf and wire_proto.K8S_PROTO in accept:
                    if use_cache and cached["pod_pb"] is not None:
                        pb = wire_proto.assemble_pod_list(
                            cached["pod_pb"][start:start + len(items)], meta)
                    else:
                        pb = wire_proto.encode_pod_list(items, meta)
                    if pb is not None:
                        fake.proto_lists += 1
                        self._respond_raw(200, pb, wire_proto.K8S_PROTO)
                        return
                if use_cache:
                    # assembled to be byte-identical to json.dumps of the
                    # full payload (default separators)
                    body = ('{"kind": "List", "apiVersion": "v1", '
                            '"metadata": ' + json.dumps(meta) + ', "items": ['
                            + ", ".join(
                                cached["pod_json"][start:start + len(items)])
                            + ']}').encode()
                    self._respond_raw(200, body, "application/json")
                    return
                self._respond(200, {"kind": "List", "apiVersion": "v1",
                                    "metadata": meta, "items": items})

            def setup(self):
                super().setup()
                fake.transport.connection_opened()

            def handle_one_request(self):
                # Shared-transport clients may speak h2 (connection preface
                # instead of a request line): hand the socket to the h2
                # shim, which replays each stream through this same handler
                # class — one request implementation, both protocols.
                if h2_server.maybe_serve_h2(self, fake.transport):
                    self.close_connection = True
                    return
                # Outage simulation: stop() alone can't take the server
                # dark — handler threads keep serving pooled keep-alive
                # connections — so every verb checks the switch first.
                if fake.outage:
                    try:
                        self.raw_requestline = self.rfile.readline(65537)
                        if not self.raw_requestline or not self.parse_request():
                            self.close_connection = True
                            return
                        self._respond(503, {"kind": "Status", "status": "Failure",
                                            "reason": "ServiceUnavailable",
                                            "message": "apiserver outage (test)"})
                        self.close_connection = True
                    except Exception:
                        self.close_connection = True
                    return
                super().handle_one_request()

            # collection resources the real API server LISTs/WATCHes —
            # namespaced (/…/namespaces/<ns>/<plural>) and cluster-scoped
            # (/api/v1/<plural>, /apis/<group>/<version>/<plural>; the
            # informer's all-namespace list+watch shape)
            COLLECTIONS = {
                "pods", "replicasets", "deployments", "statefulsets", "jobs",
                "jobsets", "leaderworkersets", "notebooks", "inferenceservices",
                "nodes",
            }

            def _collection_object_re(self, path):
                """Regex matching object paths of the collection at `path`
                (namespaced or cluster-scoped), or None when `path` is not
                a collection."""
                if path.rsplit("/", 1)[-1] not in self.COLLECTIONS:
                    return None
                if "/namespaces/" in path:
                    return re.compile(re.escape(path) + r"/[^/]+$")
                # Nodes are cluster-scoped OBJECTS, not just a cluster-scoped
                # LIST view over namespaced objects: they live directly at
                # /api/v1/nodes/<name>, so they must not take the namespaced
                # mapping below.
                if path == "/api/v1/nodes":
                    return re.compile(r"/api/v1/nodes/[^/]+$")
                if m := re.fullmatch(r"/api/v1/([a-z]+)", path):
                    return re.compile(r"/api/v1/namespaces/[^/]+/%s/[^/]+$" % m.group(1))
                if m := re.fullmatch(r"/apis/([^/]+)/([^/]+)/([a-z]+)", path):
                    return re.compile(r"/apis/%s/%s/namespaces/[^/]+/%s/[^/]+$"
                                      % (re.escape(m.group(1)), re.escape(m.group(2)),
                                         m.group(3)))
                return None

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path
                query = parse_qs(parsed.query)
                if query.get("watch", ["false"])[0] == "true":
                    self._do_watch(path, query)
                    return
                with fake._lock:
                    fake.requests.append(("GET", self.path))
                    fake._traceparents.append(self.headers.get("traceparent"))
                    if (inj := fake._injected_failure("GET", path)) is not None:
                        code, retry_after = inj
                        self._respond(code, {"kind": "Status", "status": "Failure",
                                             "message": "injected failure (test)"},
                                      retry_after=retry_after)
                        return
                    self._wrong_rv = None
                    if (flt := fake._take_fault("GET", path)) is not None:
                        if not self._apply_fault(flt):
                            return
                    # collection LIST (optional labelSelector), incl. empty lists
                    if (rx := self._collection_object_re(path)) is not None:
                        selector = query.get("labelSelector", [""])[0]
                        # snapshot-rv scan cache: page N+1 of the same
                        # LIST reuses page N's scan instead of re-walking
                        # the whole store (items are refs, so the
                        # in-place-mutation caveat still holds)
                        cache_key = (path, selector)
                        cached = fake._list_cache.get(cache_key)
                        if cached is not None and cached["rv"] == fake._rv:
                            items = cached["items"]
                            fake.list_encode_stats["scan_hits"] += 1
                        else:
                            reqs = parse_label_selector(selector)
                            items = [
                                obj for p, obj in fake.objects.items()
                                if rx.fullmatch(p)
                                and all(
                                    obj["metadata"].get("labels", {}).get(k)
                                    in vals
                                    for k, vals in reqs
                                )
                            ]
                            cached = {"rv": fake._rv, "items": items,
                                      "pod_json": None, "pod_pb": None}
                            fake._list_cache[cache_key] = cached
                            fake.list_encode_stats["scans"] += 1
                        # a real LIST carries the store's resourceVersion —
                        # the version a subsequent watch resumes from
                        # (unless a wrong_rv fault armed a lie)
                        meta = {"resourceVersion": self._wrong_rv or str(fake._rv)}
                        try:
                            limit = int(query.get("limit", ["0"])[0] or "0")
                        except ValueError:
                            limit = 0
                        page = limit if limit > 0 else fake.paginate_lists
                        if page > 0:
                            token = query.get("continue", [""])[0]
                            start, expired = fake._decode_continue(token)
                            if expired is not None:
                                self._respond(410, {
                                    "kind": "Status", "status": "Failure",
                                    "reason": "Expired", "code": 410,
                                    "message": "The provided continue parameter "
                                               "is too old to display a "
                                               "consistent list result."})
                                return
                            chunk = items[start:start + page]
                            if start + page < len(items):
                                meta["continue"] = fake._encode_continue(
                                    start + page)
                            self._respond_collection(chunk, meta,
                                                     cached=cached,
                                                     start=start)
                            return
                        self._respond_collection(items, meta, cached=cached)
                        return
                    obj = fake.objects.get(path)
                if obj is None:
                    self._not_found()
                    return
                self._respond(200, obj)

            def _do_watch(self, path, query):
                """Streaming `?watch=true` on a collection: chunked
                newline-delimited events past the client's resourceVersion,
                BOOKMARKs while idle, 410 below the compaction floor,
                abrupt drop on kill_watches()/stop()."""
                with fake._lock:
                    fake.requests.append(("GET", self.path))
                    fake._traceparents.append(self.headers.get("traceparent"))
                    inj = fake._injected_failure("GET", path)
                    flt = None if inj is not None else fake._take_fault("GET", path)
                if inj is not None:
                    code, retry_after = inj
                    self._respond(code, {"kind": "Status", "status": "Failure",
                                         "message": "injected failure (test)"},
                                  retry_after=retry_after)
                    return
                if flt is not None and not self._apply_fault(flt):
                    return
                rx = self._collection_object_re(path)
                if rx is None:
                    self._not_found()
                    return
                try:
                    cursor = int(query.get("resourceVersion", ["0"])[0] or "0")
                except ValueError:
                    cursor = 0
                bookmarks = query.get("allowWatchBookmarks", ["false"])[0] == "true"
                with fake._watch_cond:
                    expired = cursor < fake._watch_floor
                    gen = fake._watch_generation
                    # log is append-only with increasing rv: start past the
                    # client's version, then advance an index (no rescans)
                    idx = 0
                    while idx < len(fake._watch_log) and fake._watch_log[idx]["rv"] <= cursor:
                        idx += 1
                if expired:
                    self._respond(410, {"kind": "Status", "status": "Failure",
                                        "reason": "Expired", "code": 410,
                                        "message": f"too old resource version: {cursor}"})
                    self.close_connection = True
                    return

                # Binary wire path: a proto-accepting watch streams
                # 4-byte big-endian length-delimited Unknown(WatchEvent)
                # frames instead of newline-delimited JSON. An object the
                # encoder can't represent tears the stream down (the
                # client re-watches; its relist LIST falls back to JSON).
                accept = self.headers.get("Accept", "")
                proto_watch = fake.serve_protobuf and wire_proto.K8S_PROTO in accept
                self.send_response(200)
                self.send_header("Content-Type",
                                 wire_proto.K8S_PROTO_WATCH if proto_watch
                                 else "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_event(payload):
                    if proto_watch:
                        data = wire_proto.encode_watch_frame(
                            payload["type"], payload["object"])
                        if data is None:
                            raise BrokenPipeError(
                                "watch object outside the proto schema")
                        fake.proto_watch_frames += 1
                    else:
                        data = (json.dumps(payload) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()

                try:
                    while True:
                        batch, bookmark_rv, dropped = [], None, False
                        with fake._watch_cond:
                            for _scan in range(2):  # events now, or after one wait
                                if fake._watch_stop or fake._watch_generation != gen:
                                    dropped = True
                                    break
                                while idx < len(fake._watch_log):
                                    ev = fake._watch_log[idx]
                                    idx += 1
                                    if rx.fullmatch(ev["path"]):
                                        batch.append(ev)
                                if batch or _scan == 1:
                                    break
                                fake._watch_cond.wait(timeout=fake.bookmark_interval_s)
                            if not dropped and not batch:
                                bookmark_rv = fake._rv
                        if dropped:
                            # abrupt close (no terminating chunk): clients
                            # observe a dropped connection, as intended
                            self.close_connection = True
                            return
                        for ev in batch:
                            write_event({"type": ev["type"], "object": ev["object"]})
                        if bookmark_rv is not None and bookmarks:
                            write_event({"type": "BOOKMARK", "object": {
                                "kind": "Bookmark",
                                "metadata": {"resourceVersion": str(bookmark_rv)}}})
                except (BrokenPipeError, ConnectionResetError, OSError):
                    self.close_connection = True

            def do_PATCH(self):
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                path = urlparse(self.path).path
                with fake._lock:
                    fake.requests.append(("PATCH", self.path))
                    fake._traceparents.append(self.headers.get("traceparent"))
                    if (inj := fake._injected_failure("PATCH", path)) is not None:
                        code, retry_after = inj
                        self._respond(code, {"kind": "Status", "status": "Failure",
                                             "message": "injected failure (test)"},
                                      retry_after=retry_after)
                        return
                    if (flt := fake._take_fault("PATCH", path)) is not None:
                        if not self._apply_fault(flt):
                            return
                    target_path = path.removesuffix("/scale")
                    obj = fake.objects.get(target_path)
                    if obj is None:
                        fake.rejected_patches.append((path, body, 404))
                        self._not_found()
                        return
                    if fake.strict_validation:
                        try:
                            validate_patch(path, body)
                        except PatchInvalid as e:
                            fake.rejected_patches.append((path, body, e.code))
                            self._respond(e.code, {
                                "kind": "Status", "status": "Failure",
                                "reason": "Invalid" if e.code == 422 else "BadRequest",
                                "code": e.code, "message": str(e)})
                            return
                    # resourceVersion precondition (optimistic concurrency,
                    # as the real API server: mismatch → 409 Conflict)
                    want_rv = (body.get("metadata") or {}).get("resourceVersion")
                    have_rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if want_rv is not None and want_rv != have_rv:
                        fake.rejected_patches.append((path, body, 409))
                        self._respond(409, {"kind": "Status", "status": "Failure",
                                            "reason": "Conflict",
                                            "message": "resourceVersion mismatch"})
                        return
                    # recorded only once validation + existence + precondition
                    # passed: a test asserting via patches/patch_times must
                    # never count a rejected patch as landed
                    fake.patches.append((path, body))
                    fake.patch_times.append(time.monotonic())
                    merged = merge_patch(obj, body)
                    # the store stamps the next global resourceVersion and
                    # journals the MODIFIED watch event
                    fake.objects[target_path] = merged
                    self._respond(200, merged)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                path = urlparse(self.path).path
                with fake._lock:
                    fake.requests.append(("POST", self.path))
                    fake._traceparents.append(self.headers.get("traceparent"))
                    if (inj := fake._injected_failure("POST", path)) is not None:
                        code, retry_after = inj
                        self._respond(code, {"kind": "Status", "status": "Failure",
                                             "message": "injected failure (test)"},
                                      retry_after=retry_after)
                        return
                    if (flt := fake._take_fault("POST", path)) is not None:
                        if not self._apply_fault(flt):
                            return
                    if path.endswith("/events"):
                        fake.events.append(body)
                        self._respond(201, body)
                        return
                    # Lease create (leader election). Deliberately NOT a
                    # generic create: unknown collection paths must keep
                    # 404ing so client-side path-construction bugs fail
                    # here the way they would on a real API server.
                    name = (body.get("metadata") or {}).get("name")
                    is_lease = re.fullmatch(
                        r"/apis/coordination\.k8s\.io/v1/namespaces/[^/]+/leases", path)
                    if name and is_lease:
                        key = path.rstrip("/") + "/" + name
                        if key in fake.objects:
                            self._respond(409, {"kind": "Status", "status": "Failure",
                                                "reason": "AlreadyExists",
                                                "message": f"{name} already exists"})
                            return
                        meta = body.setdefault("metadata", {})
                        meta.setdefault("uid", str(uuid.uuid4()))
                        meta.setdefault("resourceVersion", "1")
                        meta.setdefault("creationTimestamp", age(0))
                        fake.objects[key] = body
                        self._respond(201, body)
                        return
                self._not_found()

        return Handler

    def start(self, workers: int | None = None) -> int:
        """Serve the fake API. workers<=1 (default): one in-process
        threading server — the hermetic-test mode, where recording
        attributes are plain in-memory lists and fault switches
        (outage/fail_next/paginate) can be flipped live.

        workers=N>1: N forked processes all accept()ing from one shared
        listening socket (pre-fork shape), so request handling stops
        contending on a single interpreter's GIL — the bench mode
        (single-process wall-clock measured the fixture, not the
        pipeline). State is a fork-time snapshot per worker;
        recordings are merged on access. Flip fault switches BEFORE
        start; per-worker fail_next counts apply per process.
        """
        # default backlog of 5 drops SYNs under the concurrent resolve fan-out
        ThreadingHTTPServer.request_queue_size = 128
        if workers is None or workers <= 1:
            self._server = ThreadingHTTPServer(("127.0.0.1", 0), self._make_handler())
            self._thread = threading.Thread(target=self._server.serve_forever,
                                            daemon=True)
            self._thread.start()
            return self._server.server_address[1]

        import socket as socket_mod

        sock = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_STREAM)
        sock.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        sock.listen(128)
        self._mp_socket = sock
        self._mp_port = sock.getsockname()[1]
        ctx = multiprocessing.get_context("fork")  # COW state, no pickling
        # Python 3.12 warns that fork() in a multi-threaded process can
        # deadlock the child on inherited locks. Accounted for here:
        # _mp_worker_main replaces the fake's lock first thing, the child
        # touches no other inherited synchronization, and the harness's
        # other threads simply don't run in the child. Suppress ONLY the
        # fork message (not all DeprecationWarnings) for the spawn loop.
        import warnings

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*fork.*",
                                    category=DeprecationWarning)
            for _ in range(workers):
                parent_conn, child_conn = ctx.Pipe()
                proc = ctx.Process(target=_mp_worker_main,
                                   args=(self, sock, child_conn), daemon=True)
                proc.start()
                child_conn.close()
                self._mp_conns.append(parent_conn)
                self._mp_procs.append(proc)
        return self._mp_port

    @property
    def url(self) -> str:
        if self._mp_port is not None:
            return f"http://127.0.0.1:{self._mp_port}"
        assert self._server is not None
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def stop(self) -> None:
        with self._watch_cond:  # end streaming watch handlers first
            self._watch_stop = True
            self._watch_cond.notify_all()
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._mp_conns:
            for conn in self._mp_conns:
                try:
                    conn.send("stop")
                    conn.recv()
                    conn.close()
                except (BrokenPipeError, EOFError, OSError):
                    pass
            for proc in self._mp_procs:
                proc.join(timeout=5)
                if proc.is_alive():
                    proc.terminate()
            self._mp_conns, self._mp_procs = [], []
        if self._mp_socket:
            self._mp_socket.close()
            self._mp_socket = None
            self._mp_port = None


def main() -> None:  # standalone: python -m tpu_pruner_torch.testing.fake_k8s
    fake = FakeK8s()
    fake.add_deployment_chain("default", "demo")
    port = fake.start()
    print(f"fake k8s api listening on http://127.0.0.1:{port}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        fake.stop()


if __name__ == "__main__":
    main()
