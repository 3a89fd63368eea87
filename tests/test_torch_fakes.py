"""The port's hermetic fixtures (tpu_pruner_torch.testing) against the
reference's (tpu_pruner.testing), byte for byte.

The same scripted setup calls build a fake of each package; the same
requests then go to both over raw sockets, and the raw responses must be
equal: status line, every header but Date, and the body bytes. The covered
surface is the fake apiserver's LIST (JSON, protobuf, label selector,
pages), GET, merge-patch, the scale subresource, a resourceVersion
conflict, Events, Lease create, watch frames (JSON and protobuf), an
injected 410 and 429, a stale-continue 410, a truncated body
(drop_after), the multi-process server, an h2 request, a CONNECT and an
absolute-form request through FakeProxy, and the fake Prometheus's instant
(JSON and protobuf), evidence and range queries, a lint 400 and its
injected faults.

The fakes mint uids with uuid.uuid4() and stamp timestamps from the
clock. Both are fixed for both packages alike (a uuid4 that counts from 0
for each fake, and one frozen instant for fake_k8s's creationTimestamps
and fake_prom's sample times), and the HTTP Date header is masked; nothing
else is. The pure helpers (wire_proto's encoders, promql_structure_error
over the reference's lint corpus, huffman_encode, pb_fields, the HPACK
helpers) must give equal outputs on equal inputs.
"""

import contextlib
import itertools
import re
import socket
import time
import uuid
from datetime import datetime
from urllib.parse import quote

import pytest

import test_query_lint
from tpu_pruner.testing import fake_k8s as ref_k8s
from tpu_pruner.testing import fake_otlp_grpc as ref_otlp
from tpu_pruner.testing import fake_prom as ref_prom
from tpu_pruner.testing import fake_proxy as ref_proxy
from tpu_pruner.testing import h2_server as ref_h2
from tpu_pruner.testing import wire_proto as ref_wire
from tpu_pruner_torch import native
from tpu_pruner_torch.testing import fake_k8s, fake_otlp_grpc, fake_prom, fake_proxy, h2_server
from tpu_pruner_torch.testing import wire_proto

SIDES = {"reference": (ref_k8s, ref_prom, ref_proxy), "port": (fake_k8s, fake_prom, fake_proxy)}
FROZEN_UNIX = 1785312000.0  # 2026-07-29T08:00:00Z


class FrozenDatetime(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.fromtimestamp(FROZEN_UNIX, tz)


class FrozenTime:
    """The time module with time() pinned; everything else passes through."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return FROZEN_UNIX


@contextlib.contextmanager
def frozen_fakes():
    """Fixed uids and a frozen clock for both packages' fakes; call the
    yielded function before building each fake to restart the uids."""
    counter = [itertools.count()]

    def restart():
        counter[0] = itertools.count()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter[0])))
        for k8s_mod, prom_mod, _ in SIDES.values():
            mp.setattr(k8s_mod, "datetime", FrozenDatetime)
            mp.setattr(prom_mod, "time", FrozenTime())
        yield restart


@pytest.fixture()
def frozen():
    with frozen_fakes() as restart:
        yield restart


DATE_SHRINK = len("Thu, 29 Jul 2026 08:00:00 GMT") - len("<masked>")


def mask_date(raw: bytes) -> bytes:
    return re.sub(rb"\r\nDate: [^\r]*", b"\r\nDate: <masked>", raw)


def request_bytes(method, path, headers=(), body=b""):
    lines = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1", *headers]
    if body:
        lines.append(f"Content-Length: {len(body)}")
    lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def exchange(port, raw_request, timeout=20.0) -> bytes:
    """Send one request, read to EOF; the response with Date masked."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(raw_request)
        out = bytearray()
        while chunk := sock.recv(65536):
            out += chunk
    return mask_date(bytes(out))


def read_chunks(port, raw_request, count, timeout=20.0) -> bytes:
    """Send a watch request and read its head and `count` whole chunks."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(raw_request)
        buf = bytearray()

        def need(n):
            while len(buf) < n:
                chunk = sock.recv(65536)
                if not chunk:
                    raise AssertionError(f"stream closed after {bytes(buf)!r}")
                buf.extend(chunk)

        while b"\r\n\r\n" not in buf:
            need(len(buf) + 1)
        pos = buf.index(b"\r\n\r\n") + 4
        for _ in range(count):
            while b"\r\n" not in buf[pos:]:
                need(len(buf) + 1)
            eol = buf.index(b"\r\n", pos)
            size = int(buf[pos:eol], 16)
            need(eol + 2 + size + 2)
            pos = eol + 2 + size + 2
    return mask_date(bytes(buf[:pos]))


def h2_get(port, path, accept=None, timeout=20.0):
    """One prior-knowledge h2 GET: (decoded response headers, Date masked;
    the DATA bytes)."""
    block = b"".join(ref_h2.hpack_literal(k, v) for k, v in (
        (":method", "GET"), (":scheme", "http"), (":path", path),
        (":authority", "127.0.0.1"), *((("accept", accept),) if accept else ())))
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(ref_h2.PREFACE + ref_h2.frame_header(0, ref_h2.FRAME_SETTINGS, 0, 0)
                     + ref_h2.frame_header(len(block), ref_h2.FRAME_HEADERS,
                                           ref_h2.FLAG_END_HEADERS | ref_h2.FLAG_END_STREAM, 1)
                     + block)
        reader = sock.makefile("rb")
        headers, data = [], bytearray()
        while True:
            head = reader.read(9)
            assert len(head) == 9, f"h2 connection closed early: {headers} {bytes(data)!r}"
            length = int.from_bytes(head[:3], "big")
            ftype, flags, stream = head[3], head[4], int.from_bytes(head[5:9], "big")
            payload = reader.read(length)
            if stream != 1:
                continue
            if ftype == ref_h2.FRAME_HEADERS:
                headers += [(k, "<masked>" if k == "date" else v)
                            for k, v in ref_h2.hpack_decode(payload)]
            elif ftype == ref_h2.FRAME_DATA:
                data += payload
            if ftype in (ref_h2.FRAME_HEADERS, ref_h2.FRAME_DATA) and flags & ref_h2.FLAG_END_STREAM:
                return headers, bytes(data)


# -- the fake apiserver -------------------------------------------------------------------

PODS = "/api/v1/pods"
DEPLOY = "/apis/apps/v1/namespaces/ml/deployments/trainer"
POD0 = "/api/v1/namespaces/ml/pods/trainer-abc123-0"
PROTO = f"Accept: {wire_proto.K8S_PROTO}"
MERGE = "Content-Type: application/merge-patch+json"


def build_k8s(mod):
    fake = mod.FakeK8s()
    fake.add_deployment_chain("ml", "trainer", num_pods=3, pod_labels={"app": "t"},
                              annotations={"owner": "team"})
    fake.add_jobset_slice("tpu", "slice", num_hosts=2)
    fake.add_node("n0", pool="p", topology="2x2")
    fake.add_notebook("ml", "nb", uid="nb-uid")
    fake.add_lws_group("ml", "lws", num_hosts=2)
    fake.add_inference_service("ml", "isvc")
    fake.add_pod("ml", "pending", phase="Pending", no_creation_ts=True, tpu_chips=0)
    return fake


def pod_events(fake):
    return sum(1 for ev in fake._watch_log if "/pods/" in ev["path"])


def k8s_session(mod):
    """Every request of the apiserver script, in order; the responses."""
    fake = build_k8s(mod)
    port = fake.start()
    out = {}
    try:
        out["watch_json"] = read_chunks(
            port, request_bytes("GET", PODS + "?watch=true&resourceVersion=0"), pod_events(fake))
        # resourceVersion 3 is the first pod's: the stream resumes after it
        out["watch_proto"] = read_chunks(
            port, request_bytes("GET", PODS + "?watch=true&resourceVersion=3", [PROTO]),
            pod_events(fake) - 1)
        for name, path, headers in (
                ("list_json", PODS, []), ("list_proto", PODS, [PROTO]),
                ("list_selector", "/api/v1/namespaces/ml/pods?labelSelector=" + quote("app=t"), []),
                ("list_selector_set", "/api/v1/pods?labelSelector=" + quote(
                    "batch.kubernetes.io/job-name in (slice-workers-0,x)"), [PROTO]),
                ("list_nodes", "/api/v1/nodes", []), ("list_jobsets", "/apis/jobset.x-k8s.io/"
                                                      "v1alpha2/jobsets", []),
                ("page_1", PODS + "?limit=2", []), ("get", DEPLOY, []),
                ("get_scale", DEPLOY + "/scale", []), ("missing", "/api/v1/namespaces/x/pods/y", []),
                ("not_a_collection", "/api/v1/widgets", [])):
            out[name] = exchange(port, request_bytes("GET", path, headers))
        token = re.search(rb'"continue": "([^"]+)"', out["page_1"]).group(1).decode()
        out["page_2"] = exchange(port, request_bytes("GET", f"{PODS}?limit=2&continue={token}"))
        for name, path, body in (
                ("merge_patch", DEPLOY, b'{"metadata": {"annotations": {"a": "b", "owner": null}}}'),
                ("scale_patch", DEPLOY + "/scale", b'{"spec": {"replicas": 0}}'),
                ("conflict", DEPLOY, b'{"metadata": {"resourceVersion": "999"}}'),
                ("patch_missing", DEPLOY + "x", b'{"spec": {}}')):
            out[name] = exchange(port, request_bytes("PATCH", path, [MERGE], body))
        fake.strict_validation = True
        out["invalid_patch"] = exchange(port, request_bytes(
            "PATCH", DEPLOY + "/scale", [MERGE], b'{"spec": {"replicas": -1}}'))
        out["after_patches"] = exchange(port, request_bytes("GET", DEPLOY))
        out["event"] = exchange(port, request_bytes(
            "POST", "/api/v1/namespaces/ml/events", ["Content-Type: application/json"],
            b'{"reason": "idle", "metadata": {"name": "e1"}}'))
        lease = b'{"metadata": {"name": "leader"}, "spec": {"holderIdentity": "a"}}'
        for name in ("lease", "lease_again"):
            out[name] = exchange(port, request_bytes(
                "POST", "/apis/coordination.k8s.io/v1/namespaces/ml/leases", [], lease))
        fake.fail_next("GET", POD0, 410, times=1)
        out["injected_410"] = exchange(port, request_bytes("GET", POD0))
        out["after_410"] = exchange(port, request_bytes("GET", POD0))
        fake.fail_next("*", POD0, 429, times=1, retry_after=3)
        out["injected_429"] = exchange(port, request_bytes("GET", POD0))
        fake.inject([{"fault": "drop_after", "match": "^/api/v1/pods$", "bytes": 300},
                     {"fault": "wrong_rv", "match": "^/api/v1/pods$", "rv": "7"},
                     {"fault": "status", "code": 503, "retry_after": 2, "method": "PATCH"}])
        out["truncated"] = exchange(port, request_bytes("GET", PODS))
        out["wrong_rv"] = exchange(port, request_bytes("GET", PODS, [PROTO]))
        out["status_503"] = exchange(port, request_bytes("PATCH", DEPLOY, [MERGE], b"{}"))
        fake.expire_watches()
        out["stale_continue"] = exchange(port, request_bytes(
            "GET", f"{PODS}?limit=2&continue={token}"))
        out["watch_gone"] = exchange(port, request_bytes("GET", PODS + "?watch=true&resourceVersion=1"))
        out["h2_list"] = h2_get(port, PODS)
        out["h2_proto"] = h2_get(port, "/api/v1/namespaces/ml/pods", accept=wire_proto.K8S_PROTO)
        out["h2_get"] = h2_get(port, DEPLOY)
        out["recorded"] = (fake.requests, fake.patches, fake.rejected_patches, fake.events,
                           fake.faults_fired, fake.proto_lists, fake.proto_watch_frames)
    finally:
        fake.stop()
    return out


@pytest.fixture(scope="module")
def k8s_sessions():
    sessions = {}
    with frozen_fakes() as restart:
        for side, (k8s_mod, _, _) in SIDES.items():
            restart()
            sessions[side] = k8s_session(k8s_mod)
    return sessions


K8S_CASES = ["watch_json", "watch_proto", "list_json", "list_proto", "list_selector",
             "list_selector_set", "list_nodes", "list_jobsets", "page_1", "page_2", "get",
             "get_scale", "missing", "not_a_collection", "merge_patch", "scale_patch",
             "conflict", "patch_missing", "invalid_patch", "after_patches", "event", "lease",
             "lease_again", "injected_410", "after_410", "injected_429", "truncated", "wrong_rv",
             "status_503", "stale_continue", "watch_gone", "h2_list", "h2_proto", "h2_get",
             "recorded"]


def test_k8s_script_covers_every_case(k8s_sessions):
    assert sorted(k8s_sessions["port"]) == sorted(K8S_CASES)
    port = k8s_sessions["port"]
    assert port["list_proto"].split(b"\r\n")[0] == b"HTTP/1.1 200 OK"
    assert wire_proto.K8S_PROTO.encode() in port["list_proto"]
    assert wire_proto.K8S_PROTO_WATCH.encode() in port["watch_proto"]
    assert port["truncated"].startswith(b"HTTP/1.1 200") and len(port["truncated"]) == 300 - DATE_SHRINK
    assert port["injected_410"].startswith(b"HTTP/1.1 410")
    assert b"Retry-After: 3" in port["injected_429"]
    assert port["stale_continue"].startswith(b"HTTP/1.1 410")
    assert port["watch_gone"].startswith(b"HTTP/1.1 410")
    assert port["conflict"].startswith(b"HTTP/1.1 409")
    assert port["lease_again"].startswith(b"HTTP/1.1 409")
    assert port["invalid_patch"].startswith(b"HTTP/1.1 422")
    assert b'"replicas": 0' in port["after_patches"] and b'"owner"' not in port["after_patches"]
    assert dict(port["h2_list"][0])[":status"] == "200"


@pytest.mark.parametrize("case", K8S_CASES)
def test_fake_k8s_matches_reference(k8s_sessions, case):
    assert k8s_sessions["port"][case] == k8s_sessions["reference"][case]


def test_fake_k8s_workers_match_reference(frozen):
    """The pre-fork server (start(workers=2)): each fake on its own
    ephemeral port, the same LIST bytes, merged recordings, a clean stop."""
    seen = {}
    for side, (k8s_mod, _, _) in SIDES.items():
        frozen()
        fake = build_k8s(k8s_mod)
        port = fake.start(workers=2)
        try:
            seen[side] = ([exchange(port, request_bytes("GET", PODS, headers))
                           for headers in ([], [PROTO], [])], sorted(fake.requests), port)
        finally:
            fake.stop()
        assert fake._mp_procs == [] and fake._mp_port is None
    assert seen["port"][:2] == seen["reference"][:2]
    assert seen["port"][2] != seen["reference"][2]


# -- the fake Prometheus -----------------------------------------------------------------

IDLE_QUERY = 'max_over_time(tensorcore_utilization{pod != ""}[30m]) == 0'
EVIDENCE_QUERY = 'count_over_time(tensorcore_utilization{signal_stat="x"}[30m])'


def build_prom(mod):
    fake = mod.FakePrometheus()
    fake.add_idle_pod_series("p0", "ml", chips=2, sample_count=[900.0, 3.0],
                             last_sample_age=[0.0, 4000.0])
    fake.add_idle_pod_series("p1", "ml", exported=False, extra_labels={"zone": "a"})
    fake.add_idle_node_series("p2", "ml", "node-0", chips=2)
    fake.add_scripted_pod_series("p3", "ml", [0.0, None, 0.5], chips=2)
    fake.add_range_pod_series("p4", "ml", [0.0, 0.25, 1.0])
    fake.add_range_pod_series("p4", "ml", [0.5], metric_name="hbm_utilization")
    return fake


def query_get(path, query, headers=()):
    return request_bytes("GET", f"{path}?query={quote(query)}", headers)


def prom_session(mod):
    fake = build_prom(mod)
    port = fake.start()
    out = {}
    proto = f"Accept: {wire_proto.PROM_PROTO}"
    try:
        for name, raw in (
                ("instant_json", query_get("/api/v1/query", IDLE_QUERY)),
                ("instant_proto", query_get("/api/v1/query", IDLE_QUERY, [proto])),
                ("evidence", query_get("/api/v1/query", EVIDENCE_QUERY)),
                ("evidence_proto", query_get("/api/v1/query", EVIDENCE_QUERY, [proto])),
                ("instant_post", request_bytes(
                    "POST", "/v1/projects/p/location/global/prometheus/api/v1/query",
                    ["Content-Type: application/x-www-form-urlencoded"],
                    ("query=" + quote(IDLE_QUERY)).encode())),
                ("range_tc", query_get("/api/v1/query_range", "tensorcore_utilization{}")),
                ("range_hbm", query_get("/api/v1/query_range", "hbm_utilization")),
                ("lint_400", query_get("/api/v1/query", "max_over_time(m[30m]")),
                ("not_found", query_get("/api/v2/query", IDLE_QUERY))):
            out[name] = exchange(port, raw)
        fake.inject([{"fault": "status", "code": 503},
                     {"fault": "stale_ts", "age_s": 60},
                     {"fault": "dup_series", "match": "signal_stat"},
                     {"fault": "drop_after", "bytes": 150}])
        for name in ("fault_503", "fault_stale", "fault_dup_evidence", "fault_truncated"):
            query = EVIDENCE_QUERY if name == "fault_dup_evidence" else IDLE_QUERY
            out[name] = exchange(port, query_get("/api/v1/query", query))
        fake.fail_requests_remaining = 1
        out["fail_requests"] = exchange(port, query_get("/api/v1/query", IDLE_QUERY))
        out["h2_query"] = h2_get(port, "/api/v1/query?query=" + quote(IDLE_QUERY))
        out["recorded"] = (fake.queries, fake.response_bodies, fake.evidence_bodies,
                           fake.query_paths, fake.faults_fired, fake.proto_queries)
    finally:
        fake.stop()
    return out


@pytest.fixture(scope="module")
def prom_sessions():
    sessions = {}
    with frozen_fakes() as restart:
        for side, (_, prom_mod, _) in SIDES.items():
            restart()
            sessions[side] = prom_session(prom_mod)
    return sessions


PROM_CASES = ["instant_json", "instant_proto", "evidence", "evidence_proto", "instant_post",
              "range_tc", "range_hbm", "lint_400", "not_found", "fault_503", "fault_stale",
              "fault_dup_evidence", "fault_truncated", "fail_requests", "h2_query", "recorded"]


def test_prom_script_covers_every_case(prom_sessions):
    port = prom_sessions["port"]
    assert sorted(port) == sorted(PROM_CASES)
    assert wire_proto.PROM_PROTO.encode() in port["instant_proto"]
    assert port["lint_400"].startswith(b"HTTP/1.1 400")
    assert len(port["fault_truncated"]) == 150 - DATE_SHRINK
    assert str(FROZEN_UNIX).encode() in port["instant_json"]


@pytest.mark.parametrize("case", PROM_CASES)
def test_fake_prom_matches_reference(prom_sessions, case):
    assert prom_sessions["port"][case] == prom_sessions["reference"][case]


def test_fake_prom_protobuf_decodes_to_its_json(prom_sessions):
    """The port's protobuf instant vector carries the data of the JSON body
    the fake recorded for that query: the wire decoder's canonical body
    equals it."""
    proto_body = prom_sessions["port"]["instant_proto"].split(b"\r\n\r\n", 1)[1]
    response_bodies = prom_sessions["port"]["recorded"][1]
    decoded = native.wire_decode_prom(proto_body)
    assert decoded["canonical_body"] == response_bodies[1]


# -- FakeProxy ------------------------------------------------------------------------------


def proxy_session(k8s_mod, proxy_mod):
    fake, proxy = build_k8s(k8s_mod), proxy_mod.FakeProxy()
    k8s_port, proxy_port = fake.start(), proxy.start()
    out = {}
    try:
        out["connect"] = exchange(proxy_port, (
            f"CONNECT 127.0.0.1:{k8s_port} HTTP/1.1\r\nHost: 127.0.0.1:{k8s_port}\r\n\r\n"
        ).encode() + request_bytes("GET", PODS, [PROTO]))
        out["absolute_form"] = exchange(proxy_port, request_bytes(
            "GET", f"http://127.0.0.1:{k8s_port}{DEPLOY}", ["Proxy-Authorization: Basic eA=="]))
        out["bad_gateway"] = exchange(proxy_port, b"CONNECT 127.0.0.1:1 HTTP/1.1\r\n\r\n")
        proxy.require_auth = "Basic dXNlcjpwdw=="
        out["auth_required"] = exchange(proxy_port, b"CONNECT 127.0.0.1:1 HTTP/1.1\r\n\r\n")
        out["recorded"] = ([c.replace(str(k8s_port), "<port>") for c in proxy.connects],
                           [r.replace(str(k8s_port), "<port>") for r in proxy.requests],
                           [{k: v.replace(str(k8s_port), "<port>") for k, v in h.items()}
                            for h in proxy.headers], fake.requests)
    finally:
        proxy.stop()
        fake.stop()
    return out


def test_fake_proxy_matches_reference(frozen):
    sessions = {}
    for side, (k8s_mod, _, proxy_mod) in SIDES.items():
        frozen()
        sessions[side] = proxy_session(k8s_mod, proxy_mod)
    port = sessions["port"]
    assert port["connect"].startswith(b"HTTP/1.1 200 Connection Established\r\n\r\nHTTP/1.1 200")
    assert port["absolute_form"].startswith(b"HTTP/1.1 200")
    assert port["bad_gateway"].startswith(b"HTTP/1.1 502")
    assert port["auth_required"].startswith(b"HTTP/1.1 407")
    assert port == sessions["reference"]


# -- the pure helpers -------------------------------------------------------------------------


def encoder_inputs(k8s_mod):
    fake = build_k8s(k8s_mod)
    pods = [obj for path, obj in fake.objects.items() if "/pods/" in path]
    other = [obj for path, obj in fake.objects.items() if "/pods/" not in path]
    return pods, other


def encode_all(wire):
    def attempt(fn, *args):
        try:
            return fn(*args)
        except wire.Unencodable as exc:
            return ("Unencodable", str(exc))

    pods, other = encoder_inputs(ref_k8s)
    weird = dict(pods[0], spec=dict(pods[0]["spec"], tolerations=[{"key": "x"}]))
    meta = {"resourceVersion": "42", "continue": "abc"}
    prom = {"status": "success", "data": {"resultType": "vector", "result": [
        {"metric": {"pod": "p", "a": "é"}, "value": [FROZEN_UNIX, "0.125"]},
        {"metric": {}, "value": [1.5, "NaN"]}]}}
    return [
        [attempt(wire.encode_object_body, obj) for obj in pods + other + [weird]],
        wire.encode_unknown("v1", "Pod", b"\x00\x01raw"),
        wire.encode_pod_list(pods, meta), wire.encode_pod_list(pods + [weird], meta),
        [wire.encode_pod_chunk(p) for p in pods + [weird]],
        wire.assemble_pod_list([wire.encode_pod_chunk(p) for p in pods], meta),
        [wire.encode_watch_frame(t, p) for t in ("ADDED", "DELETED") for p in pods],
        wire.encode_watch_frame("BOOKMARK", {"kind": "Bookmark",
                                             "metadata": {"resourceVersion": "9"}}),
        wire.encode_watch_frame("ADDED", weird),
        wire.encode_prom_vector(prom),
        wire.encode_prom_vector({"status": "success", "data": {"resultType": "matrix",
                                                              "result": []}}),
    ]


def test_wire_proto_encoders_match_reference(frozen):
    frozen()
    want = encode_all(ref_wire)
    frozen()
    got = encode_all(wire_proto)
    assert got == want
    assert got[2] is not None and got[3] is None  # an out-of-schema pod refuses the list


LINT_CORPUS = [q for q, _ in test_query_lint.test_linter_verdicts.pytestmark[0].args[1]]


def test_promql_structure_error_matches_reference():
    queries = LINT_CORPUS + [native.build_query(kw) for kw in test_query_lint.builder_arg_matrix()]
    queries += [q[:cut] for q in queries[-4:] for cut in (1, 17, 40)]
    assert len(LINT_CORPUS) == 15 and len(queries) > 40
    verdicts = [fake_prom.promql_structure_error(q) for q in queries]
    assert verdicts == [ref_prom.promql_structure_error(q) for q in queries]
    assert any(v is None for v in verdicts) and any(v is not None for v in verdicts)


HUFFMAN_INPUTS = [b"", b"grpc-status", b"grpc-message", b"0", b"quota exceeded",
                  bytes(range(256)), "ünïcode".encode()]


def test_otlp_helpers_match_reference():
    for data in HUFFMAN_INPUTS:
        assert fake_otlp_grpc.huffman_encode(data) == ref_otlp.huffman_encode(data)
    messages = [b"", b"\x08\x96\x01", b"\x12\x07testing\x1a\x03\x08\x96\x01",
                b"\x0a\x02hi\x11" + bytes(8) + b"\x18\x01"]
    for msg in messages:
        fields = fake_otlp_grpc.pb_fields(msg)
        assert fields == ref_otlp.pb_fields(msg)
        for number in (1, 2, 3):
            assert fake_otlp_grpc.pb_find(fields, number) == ref_otlp.pb_find(fields, number)


def test_hpack_helpers_match_reference():
    pairs = [(":status", "200"), ("content-type", "application/json"), ("x-long", "v" * 300)]
    for name, value in pairs:
        assert h2_server.hpack_literal(name, value) == ref_h2.hpack_literal(name, value)
    block = b"".join(ref_h2.hpack_literal(k, v) for k, v in pairs) + b"\x88\x82"
    assert h2_server.hpack_decode(block) == ref_h2.hpack_decode(block)
    for args in ((0, 4, 0, 0), (16384, 0, 1, 3), (70000, 1, 5, 2**31 - 1)):
        assert h2_server.frame_header(*args) == ref_h2.frame_header(*args)


def test_merge_patch_and_selectors_match_reference():
    target = {"a": {"b": 1, "c": [1, 2]}, "d": "x"}
    for patch in ({"a": {"b": None}}, {"a": None, "e": {"f": 1}}, {"d": [3]}, [1], "s", {}):
        assert fake_k8s.merge_patch(target, patch) == ref_k8s.merge_patch(target, patch)
    for selector in ("", "app=t", "a=b,c in (x, y)", "k in (v1,v2),z=1"):
        assert fake_k8s.parse_label_selector(selector) == ref_k8s.parse_label_selector(selector)
    for path, body in (("/x/scale", {"spec": {"replicas": -1}}), ("/x/scale", {"spec": {}}),
                       ("/x", {"spec": {"replicas": "2"}}), ("/x", {"metadata": {"labels": 1}})):
        outcome = []
        for mod in (ref_k8s, fake_k8s):
            try:
                outcome.append(("ok", mod.validate_patch(path, body)))
            except mod.PatchInvalid as exc:
                outcome.append((exc.code, str(exc)))
        assert outcome[0] == outcome[1]
