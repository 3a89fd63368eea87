"""In-process fake Prometheus serving /api/v1/query.

Returns canned instant-vector series, records every query (and auth
header) it receives, and can be told to fail N requests — which is how the
daemon's consecutive-failure budget is exercised hermetically.

Fault injection is a first-class API (the chaos tier): `inject()` takes
a declarative schedule of per-query fault points — `status` (respond N),
`delay` (stall the query under the fixture lock: a wedged backend),
`drop_after` (truncate the response after N bytes, headers included, then
abruptly close), `stale_ts` (serve the normal body with every sample
timestamp shifted `age_s` into the past — stale-but-plausible evidence),
and `dup_series` (serve every result row twice — the duplicate-series
shape a misconfigured federation produces). Entries match on a query
regex and decrement a `times` budget, consumed first-match-wins in
query-arrival order, so a seed-generated schedule replays
deterministically. Fired faults are recorded in `faults_fired`. See
`inject()` for the schema.
"""

from __future__ import annotations

import copy
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tpu_pruner_torch.testing import h2_server, wire_proto
from tpu_pruner_torch.testing.fake_k8s import _TruncatingFile


def promql_structure_error(query: str) -> str | None:
    """Structural lint of a received PromQL string: balanced (), {}, []
    outside string literals, terminated strings, non-empty. No promtool
    exists in this image (conftest gotcha), so this is the hermetic
    guard against escaping/rendering bugs in the native query builders —
    a query with an unbalanced brace would otherwise sail through every
    e2e and fail only on a real Prometheus."""
    if not query.strip():
        return "empty query"
    stack = []
    pairs = {")": "(", "}": "{", "]": "["}
    i, n = 0, len(query)
    while i < n:
        ch = query[i]
        if ch in "\"'`":  # PromQL strings: double-, single-, or backtick-quoted
            quote = ch
            i += 1
            while i < n and query[i] != quote:
                # backslash escapes exist in " and ' strings, not backticks
                i += 2 if (query[i] == "\\" and quote != "`") else 1
            if i >= n:
                return "unterminated string literal"
        elif ch in "({[":
            stack.append(ch)
        elif ch in ")}]":
            if not stack or stack.pop() != pairs[ch]:
                return f"unbalanced '{ch}' at offset {i}"
        i += 1
    if stack:
        return f"unclosed '{stack[-1]}'"
    return None


class FakePrometheus:
    def __init__(self):
        self.series: list[dict] = []
        # time-advancing per-pod series: [{"labels": {...}, "values": [...]}]
        # where values[i] scripts the i-th instant query served (see
        # add_scripted_pod_series)
        self.scripted_series: list[dict] = []
        self.instant_queries_served = 0  # advances the scripts, one per query
        # signal-watchdog evidence: per-pod sample coverage / last-sample
        # age served to the daemon's evidence query (detected by its
        # synthetic signal_stat label). Keyed (namespace, pod); the knobs
        # ride add_idle_pod_series / add_scripted_pod_series. Evidence
        # queries have their own script index so a guard-on daemon's two
        # queries per cycle don't double-advance the duty-cycle scripts.
        self.evidence_series: dict[tuple, dict] = {}
        self.evidence_queries_served = 0
        self.evidence_bodies: list[str] = []  # verbatim evidence responses
        self.queries: list[str] = []
        # VERBATIM response body per successfully served instant query —
        # flight-recorder tests assert a capsule's recorded raw body is
        # byte-identical to what this fake actually sent (round-trip
        # fidelity, scripted per-pod series included)
        self.response_bodies: list[str] = []
        self.query_paths: list[str] = []  # full request paths (Cloud Monitoring prefix checks)
        self.query_times: list[float] = []  # time.monotonic() per query (cycle windowing)
        self.auth_headers: list[str | None] = []
        self.traceparents: list[str | None] = []  # W3C traceparent per query
        self.fail_requests_remaining = 0
        self.fail_status = 500
        self.hang_seconds = 0.0  # >0 → every query stalls (wedged-backend sim)
        # Pin the `now` used for evidence rows and scripted-series sample
        # timestamps (float unix). The byte-identity tests (wire modes,
        # incremental on/off) compare recorded response bodies across
        # daemon RUNS against one fixture; the per-query wall clock is
        # the only nondeterminism in those bodies. None = real time.
        self.freeze_time: float | None = None
        self._cached = None
        self._cached_payload = None
        self._cached_version = -1
        self._version = 0
        # Binary wire path (--wire proto): serve the protobuf
        # instant-vector exposition when the request Accept asks for it
        # (wire_proto.encode_prom_vector — it carries the EXACT decimal
        # text of the JSON form, so the native side reconstructs a
        # canonical body byte-identical to the JSON one). response_bodies
        # / evidence_bodies always record the JSON rendering regardless
        # of what went on the wire: they are the byte-identity reference
        # the flight-recorder tests compare capsules against. False
        # models a JSON-only Prometheus (negotiation fallback).
        self.serve_protobuf = True
        self.proto_queries = 0  # instant queries answered as protobuf
        # shared-transport accounting (see fake_k8s): connections accepted,
        # h2 streams, peak concurrency — the concurrent idleness+evidence
        # query pair shows up here as max_concurrent_streams >= 2.
        self.transport = h2_server.TransportStats()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # declarative fault schedule (the chaos tier): inject() appends
        # entries, instant queries consume them first-match-wins under
        # _lock — see inject() for the schema and fault kinds
        self.fault_schedule: list[dict] = []
        self.faults_fired: list[tuple[str, str]] = []  # (kind, query)

    # fault kinds inject() accepts; see the method docstring
    FAULT_KINDS = frozenset(
        {"status", "delay", "drop_after", "stale_ts", "dup_series"})

    def inject(self, schedule: list[dict]):
        """Append a declarative fault schedule (the chaos tier).

        Each entry is a dict::

            {"fault": <kind>, "match": <query regex, default ".*">,
             "times": <budget, default 1; -1 = unlimited>, ...params}

        Kinds and their params:

        - ``status``: answer with HTTP ``code`` (default 503) and a
          Prometheus error body — the 5xx-burst shape.
        - ``delay``: sleep ``seconds`` (default 1.0) before serving,
          holding the fixture's query lock (a wedged backend: queries
          pile up behind it).
        - ``drop_after``: serve the normal response but cut the
          connection after ``bytes`` response bytes (headers included) —
          a truncated body mid-transfer.
        - ``stale_ts``: serve the normal body claiming to be ``age_s``
          seconds (default 3600) older than it is — sample timestamps
          shift into the past, and evidence ``signal_stat="age"`` rows
          report ``age_s`` more. Valid JSON, plausible values,
          untrustworthy evidence: a ``--signal-guard on`` daemon must
          veto rather than scale on it.
        - ``dup_series``: serve every result row twice — duplicate
          series, the shape a misconfigured federation/HA pair produces.

        Entries are consumed FIRST-MATCH-WINS in schedule order against
        each instant query (``/api/v1/query``), each decrementing its
        ``times`` budget — a seed-generated schedule replays
        deterministically against the same query sequence. Fired faults
        are recorded in ``faults_fired`` as (kind, query).
        """
        compiled = []
        for entry in schedule:
            kind = entry.get("fault")
            if kind not in self.FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(one of {sorted(self.FAULT_KINDS)})")
            e = dict(entry)
            e.setdefault("times", 1)
            e["_re"] = re.compile(e.get("match", ".*"))
            compiled.append(e)
        with self._lock:
            self.fault_schedule.extend(compiled)

    def clear_faults(self):
        """Drop every un-consumed inject() entry."""
        with self._lock:
            self.fault_schedule.clear()

    def _take_fault(self, query: str):
        """First schedule entry matching `query` with budget left, or
        None; decrements the budget and records the firing. Caller holds
        _lock."""
        for e in self.fault_schedule:
            if e["times"] == 0:
                continue
            if not e["_re"].search(query):
                continue
            if e["times"] > 0:
                e["times"] -= 1
            self.faults_fired.append((e["fault"], query))
            return e
        return None

    # ── scenario helpers ──
    def add_idle_pod_series(
        self,
        pod: str,
        namespace: str,
        container: str = "main",
        value: float = 0.0,
        accelerator_type: str = "tpu-v5-lite-podslice",
        chips: int = 1,
        exported: bool = True,
        extra_labels: dict | None = None,
        sample_count=1200.0,
        last_sample_age=0.0,
    ) -> None:
        """One series per chip, like real per-chip TPU metrics.

        ``sample_count`` / ``last_sample_age`` script the pod's rows in
        the signal watchdog's evidence query (see _register_evidence):
        scalars repeat every cycle, lists advance one entry per evidence
        query (last repeats), ``None`` omits that statistic's row, and
        ``None`` for both models an ABSENT metric family."""
        prefix = "exported_" if exported else ""
        for chip in range(chips):
            labels = {
                f"{prefix}pod": pod,
                f"{prefix}namespace": namespace,
                f"{prefix}container": container,
                "accelerator_id": str(chip),
                "accelerator_type": accelerator_type,
                "node_type": accelerator_type,
            }
            labels.update(extra_labels or {})
            self.series.append({"metric": labels, "value": [time.time(), str(value)]})
        self._register_evidence(pod, namespace, exported, sample_count, last_sample_age)
        self._version += 1

    def _register_evidence(self, pod, namespace, exported, sample_count,
                           last_sample_age) -> None:
        """Evidence-query rows for one pod: what the real query's
        `sum by (pod, ns) (count_over_time(...))` / `time() - timestamp(...)`
        would return, pre-aggregated (one "samples" + one "age" row)."""
        prefix = "exported_" if exported else ""
        self.evidence_series[(namespace, pod)] = {
            "labels": {f"{prefix}pod": pod, f"{prefix}namespace": namespace},
            "sample_count": sample_count,
            "last_sample_age": last_sample_age,
        }

    def _evidence_result(self, idx: int) -> list[dict]:
        def pick(v):
            if isinstance(v, (list, tuple)):
                return v[idx] if idx < len(v) else v[-1]
            return v

        now = self.freeze_time if self.freeze_time is not None else time.time()
        result = []
        for ev in self.evidence_series.values():
            count = pick(ev["sample_count"])
            age = pick(ev["last_sample_age"])
            if count is not None:
                result.append({"metric": {**ev["labels"], "signal_stat": "samples"},
                               "value": [now, str(count)]})
            if age is not None:
                result.append({"metric": {**ev["labels"], "signal_stat": "age"},
                               "value": [now, str(age)]})
        return result

    def add_idle_node_series(
        self,
        pod: str,
        namespace: str,
        node: str,
        container: str = "main",
        value: float = 0.0,
        model: str = "tpu-v5-lite-podslice",
        chips: int = 1,
        honor_labels: bool = False,
    ) -> None:
        """gke-system shaped rows: what the Cloud Monitoring PromQL API
        returns for the kubernetes_io:node_accelerator_* query after the
        on(node_name) KSM join — pod-keyed rows (pods are the many side)
        carrying the node's node_name/model via group_left (namespace
        surfaces as exported_namespace under stock GMP-managed KSM).
        Several pods may share one node: call once per pod with the same
        `node`. chips>1 emits per-chip rows, which real evaluation no
        longer produces (node idleness aggregates chips first) but the
        decoder must keep tolerating."""
        ns_label = "namespace" if honor_labels else "exported_namespace"
        for chip in range(chips):
            self.series.append({
                "metric": {
                    "node_name": node,
                    "accelerator_id": str(chip),
                    "model": model,
                    "pod": pod,
                    ns_label: namespace,
                    "container": container,
                },
                "value": [time.time(), str(value)],
            })
        self._version += 1

    def add_scripted_pod_series(
        self,
        pod: str,
        namespace: str,
        values: list,
        container: str = "main",
        accelerator_type: str = "tpu-v5-lite-podslice",
        chips: int = 1,
        exported: bool = True,
        extra_labels: dict | None = None,
        sample_count=1200.0,
        last_sample_age=0.0,
    ) -> None:
        """Time-advancing duty-cycle series: `values[i]` scripts the i-th
        instant query this fake serves (i.e. the daemon's i-th cycle).

        A float means the pod's series is present with that value — the
        daemon's `== 0` idle query only ever returns idle rows, so 0.0
        models an idle cycle. ``None`` means the series is ABSENT from
        that response: the pod was busy that cycle (a real Prometheus
        returns no row for it). The last entry repeats once the script is
        exhausted, so tests don't have to predict exact cycle counts.
        Ledger integration tests drive idle→active→idle transitions with
        e.g. ``values=[0.0, None, 0.0]``.

        ``sample_count`` / ``last_sample_age`` script the pod's evidence
        rows (signal watchdog): scalars repeat, lists advance one entry
        per EVIDENCE query (its own index — a guard-on daemon issues two
        queries per cycle and the duty-cycle script must not
        double-advance), ``None`` omits the row; both ``None`` models an
        ABSENT metric family. Staleness/gap scenarios script e.g.
        ``last_sample_age=[0.0, 4000.0]`` (healthy, then a dead scrape).
        """
        if not values:
            raise ValueError("scripted series needs at least one entry")
        prefix = "exported_" if exported else ""
        for chip in range(chips):
            labels = {
                f"{prefix}pod": pod,
                f"{prefix}namespace": namespace,
                f"{prefix}container": container,
                "accelerator_id": str(chip),
                "accelerator_type": accelerator_type,
                "node_type": accelerator_type,
            }
            labels.update(extra_labels or {})
            self.scripted_series.append({"labels": labels, "values": list(values)})
        self._register_evidence(pod, namespace, exported, sample_count, last_sample_age)
        self._version += 1

    def add_range_pod_series(
        self,
        pod: str,
        namespace: str,
        values: list[float],
        metric_name: str = "tensorcore_utilization",
        container: str = "main",
        chips: int = 1,
        step_s: float = 300.0,
        exported: bool = True,
        extra_labels: dict | None = None,
    ) -> None:
        """Range-query series (one per chip): `values` are the window's
        samples, newest last, timestamped `step_s` apart ending now —
        what /api/v1/query_range returns and tpu_pruner_torch.dump consumes.
        `metric_name` becomes __name__ and query_range filters on it, so
        a test's tc and hbm registrations stay distinguishable."""
        prefix = "exported_" if exported else ""
        now = time.time()
        for chip in range(chips):
            labels = {
                "__name__": metric_name,
                f"{prefix}pod": pod,
                f"{prefix}namespace": namespace,
                f"{prefix}container": container,
                "accelerator_id": str(chip),
            }
            labels.update(extra_labels or {})
            self.series.append({
                "metric": labels,
                "values": [[now - (len(values) - 1 - i) * step_s, str(v)]
                           for i, v in enumerate(values)],
            })
        self._version += 1

    # ── lifecycle ──
    def start(self, certfile: str | None = None, keyfile: str | None = None) -> int:
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # real API servers (Go net/http) set TCP_NODELAY; without it the
            # keep-alive body write stalls behind the client's delayed ACK
            disable_nagle_algorithm = True  # keep-alive

            def log_message(self, *args):  # silence
                pass

            def setup(self):
                super().setup()
                fake.transport.connection_opened()

            def handle_one_request(self):
                # h2 preface → the shared h2 shim (streams replay through
                # this handler class); anything else is normal HTTP/1.1.
                if h2_server.maybe_serve_h2(self, fake.transport):
                    self.close_connection = True
                    return
                # drop_after faults raise BrokenPipeError from inside the
                # handler (like a real mid-response disconnect); unwind
                # quietly instead of a stderr traceback
                try:
                    super().handle_one_request()
                except BrokenPipeError:
                    self.close_connection = True

            def _respond(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_query_body(self, payload: dict, body: bytes):
                """Send a successful instant-query response in whichever
                wire format the client negotiated. `body` is the JSON
                rendering (already recorded as the byte-identity
                reference); `payload` is the same data as objects, which
                the protobuf encoder consumes."""
                accept = self.headers.get("Accept", "")
                if fake.serve_protobuf and wire_proto.PROM_PROTO in accept:
                    pb = wire_proto.encode_prom_vector(payload)
                    if pb is not None:
                        fake.proto_queries += 1
                        self.send_response(200)
                        self.send_header("Content-Type", wire_proto.PROM_PROTO)
                        self.send_header("Content-Length", str(len(pb)))
                        self.end_headers()
                        self.wfile.write(pb)
                        return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _fault_payload(self, flt, payload):
                """stale_ts / dup_series response-shape faults: a
                well-formed body whose DATA is untrustworthy."""
                payload = copy.deepcopy(payload)
                result = payload["data"]["result"]
                if flt["fault"] == "stale_ts":
                    # one semantic, two encodings: the data claims to be
                    # `age_s` older than it is. Plain samples shift their
                    # timestamp back; evidence "age" rows (whose VALUE is
                    # the age) report age_s more — either way a
                    # --signal-guard daemon must refuse to act on it.
                    age = float(flt.get("age_s", 3600.0))
                    for srs in result:
                        if "value" not in srs:
                            continue
                        if srs.get("metric", {}).get("signal_stat") == "age":
                            srs["value"] = [srs["value"][0],
                                            str(float(srs["value"][1]) + age)]
                        else:
                            srs["value"] = [float(srs["value"][0]) - age,
                                            srs["value"][1]]
                elif flt["fault"] == "dup_series":
                    payload["data"]["result"] = result + copy.deepcopy(result)
                return payload

            def _handle_query(self, query: str):
                if fake.hang_seconds:  # before the lock: other verbs stay live
                    time.sleep(fake.hang_seconds)
                with fake._lock:
                    fake.queries.append(query)
                    fake.auth_headers.append(self.headers.get("Authorization"))
                    fake.traceparents.append(self.headers.get("traceparent"))
                    # injected fault schedule (inject()): transport-level
                    # kinds apply immediately; the data-shape kinds
                    # (stale_ts/dup_series) arm and rewrite the payload
                    # just before it is recorded + sent below
                    flt = fake._take_fault(query)
                    if flt is not None:
                        kind = flt["fault"]
                        if kind == "status":
                            self._respond(int(flt.get("code", 503)),
                                          {"status": "error",
                                           "errorType": "internal",
                                           "error": "injected fault (test)"})
                            return
                        if kind == "delay":
                            time.sleep(float(flt.get("seconds", 1.0)))
                        elif kind == "drop_after":
                            self.wfile = _TruncatingFile(
                                self.wfile, self.connection,
                                int(flt.get("bytes", 0)))
                            self.close_connection = True
                    if err := promql_structure_error(query):
                        # 400 like a real Prometheus parse error — feeds the
                        # daemon's failure budget instead of fake success
                        self._respond(400, {"status": "error",
                                            "errorType": "bad_data",
                                            "error": f"parse error: {err}"})
                        return
                    if fake.fail_requests_remaining > 0:
                        fake.fail_requests_remaining -= 1
                        self._respond(
                            fake.fail_status,
                            {"status": "error", "errorType": "internal", "error": "injected"},
                        )
                        return
                    if "signal_stat" in query:
                        # the signal watchdog's evidence query (its
                        # synthetic label is the marker): serve the
                        # per-pod coverage/age rows on the evidence
                        # script's OWN index so duty-cycle scripts stay
                        # cycle-aligned
                        idx = fake.evidence_queries_served
                        fake.evidence_queries_served += 1
                        payload = {
                            "status": "success",
                            "data": {"resultType": "vector",
                                     "result": fake._evidence_result(idx)},
                        }
                        if flt is not None and flt["fault"] in ("stale_ts",
                                                                "dup_series"):
                            payload = self._fault_payload(flt, payload)
                        body = json.dumps(payload).encode()
                        fake.evidence_bodies.append(body.decode())
                        self._send_query_body(payload, body)
                        return
                    # serialize once per series-list version (large fleets);
                    # instant vectors exclude range-only series (no "value")
                    if fake._cached_version != fake._version or fake._cached is None:
                        fake._cached_payload = {
                            "status": "success",
                            "data": {"resultType": "vector",
                                     "result": [s for s in fake.series
                                                if "value" in s]},
                        }
                        fake._cached = json.dumps(fake._cached_payload).encode()
                        fake._cached_version = fake._version
                    payload = fake._cached_payload
                    body = fake._cached
                    if fake.scripted_series:
                        # time-advancing scripts make the response a
                        # function of the query index — rebuild per query
                        # (the scripted path is a correctness fixture, not
                        # the fleet-scale one)
                        idx = fake.instant_queries_served
                        result = [s for s in fake.series if "value" in s]
                        now = (fake.freeze_time if fake.freeze_time is not None
                               else time.time())
                        for s in fake.scripted_series:
                            vals = s["values"]
                            v = vals[idx] if idx < len(vals) else vals[-1]
                            if v is None:  # busy this cycle: no row
                                continue
                            result.append({"metric": s["labels"],
                                           "value": [now, str(v)]})
                        payload = {
                            "status": "success",
                            "data": {"resultType": "vector", "result": result},
                        }
                        body = json.dumps(payload).encode()
                    if flt is not None and flt["fault"] in ("stale_ts",
                                                            "dup_series"):
                        payload = self._fault_payload(flt, payload)
                        body = json.dumps(payload).encode()
                    fake.instant_queries_served += 1
                    fake.response_bodies.append(body.decode())
                self._send_query_body(payload, body)

            def _handle_query_range(self, query: str):
                """Matrix response filtered by the queried metric name (a
                real Prometheus never mixes metrics in one response — an
                unfiltered fake would mask tc/hbm join bugs): series whose
                __name__ equals the query's leading identifier; series
                without __name__ match any query (legacy instant helpers).
                Range-only series return their stored values; instant
                series synthesize a one-sample matrix. Honors the same
                hang/failure-injection knobs as the instant path."""
                if fake.hang_seconds:
                    time.sleep(fake.hang_seconds)
                with fake._lock:
                    fake.queries.append(query)
                    fake.auth_headers.append(self.headers.get("Authorization"))
                    fake.traceparents.append(self.headers.get("traceparent"))
                    if err := promql_structure_error(query):
                        self._respond(400, {"status": "error",
                                            "errorType": "bad_data",
                                            "error": f"parse error: {err}"})
                        return
                    if fake.fail_requests_remaining > 0:
                        fake.fail_requests_remaining -= 1
                        self._respond(
                            fake.fail_status,
                            {"status": "error", "errorType": "internal",
                             "error": "injected"})
                        return
                    name = re.match(r"[A-Za-z_:][A-Za-z0-9_:]*",
                                    query.strip())
                    name = name.group(0) if name else ""
                    result = [
                        {"metric": s["metric"],
                         "values": (s["values"] if "values" in s
                                    else [s["value"]])}
                        for s in fake.series
                        if s["metric"].get("__name__", name) == name
                    ]
                self._respond(200, {
                    "status": "success",
                    "data": {"resultType": "matrix", "result": result},
                })

            def do_POST(self):
                # Accept both the vanilla path and the Cloud Monitoring
                # PromQL API shape (/v1/projects/<p>/location/global/
                # prometheus/api/v1/query) — same wire protocol.
                parsed = urlparse(self.path)
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length).decode()
                query = parse_qs(body).get("query", [""])[0]
                if parsed.path.endswith("/api/v1/query_range"):
                    fake.query_paths.append(parsed.path)
                    fake.query_times.append(time.monotonic())
                    self._handle_query_range(query)
                    return
                if not parsed.path.endswith("/api/v1/query"):
                    self._respond(404, {"status": "error", "error": "not found"})
                    return
                fake.query_paths.append(parsed.path)
                fake.query_times.append(time.monotonic())
                self._handle_query(query)

            def do_GET(self):
                parsed = urlparse(self.path)
                query = parse_qs(parsed.query).get("query", [""])[0]
                if parsed.path.endswith("/api/v1/query_range"):
                    fake.query_paths.append(parsed.path)
                    fake.query_times.append(time.monotonic())
                    self._handle_query_range(query)
                    return
                if not parsed.path.endswith("/api/v1/query"):
                    self._respond(404, {"status": "error", "error": "not found"})
                    return
                fake.query_paths.append(parsed.path)
                fake.query_times.append(time.monotonic())
                self._handle_query(query)

        # default backlog of 5 drops SYNs under concurrent load
        ThreadingHTTPServer.request_queue_size = 128
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._tls = certfile is not None
        if certfile:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._server.socket = ctx.wrap_socket(self._server.socket, server_side=True)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        assert self._server is not None
        scheme = "https" if getattr(self, "_tls", False) else "http"
        host = "localhost" if getattr(self, "_tls", False) else "127.0.0.1"
        return f"{scheme}://{host}:{self._server.server_address[1]}"

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def main() -> None:  # standalone: python -m tpu_pruner_torch.testing.fake_prom
    fake = FakePrometheus()
    fake.add_idle_pod_series("demo-pod", "default", chips=4)
    port = fake.start()
    print(f"fake prometheus listening on http://127.0.0.1:{port}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        fake.stop()


if __name__ == "__main__":
    main()
