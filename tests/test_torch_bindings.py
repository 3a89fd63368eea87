"""The port's C API bindings (tpu_pruner_torch.native) against the
reference's (tpu_pruner.native), and the port's public surface against the
reference's.

The guard: every public function and class of tpu_pruner/native.py and of
every module of tpu_pruner/testing/ has a counterpart of the same name
under tpu_pruner_torch, with an equal inspect.signature (for a class, also
every public method's).

The parity: each binding is called through both modules with the same
arguments, taken from the reference's own tests. Both call the same library
-- the reference's _lib is pointed at the port's build for the duration of
the module -- so what is compared is each wrapper's payload, defaults and
result handling. Results must be equal, and so must the ValueError text on
the error cases; tolerance: exact. Fields that are random or read a clock
(an Event's generated name, a decode timing, an informer's sync time) are
masked, and nothing else.
"""

import importlib
import inspect
import json
import pkgutil

import pytest

import tpu_pruner.native
import tpu_pruner.testing
from tpu_pruner_torch import native
from tpu_pruner_torch.testing import FakeK8s, trace_gen, wire_proto
from tpu_pruner_torch.testing.fake_otlp_grpc import FakeGrpcCollector

REFERENCE_MODULES = ["tpu_pruner.native", "tpu_pruner.testing"] + [
    f"tpu_pruner.testing.{m.name}" for m in pkgutil.iter_modules(tpu_pruner.testing.__path__)]


def public_names(module_name):
    module = importlib.import_module(module_name)
    if module_name == "tpu_pruner.testing":
        return list(module.__all__)
    return [name for name, obj in vars(module).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module_name]


SURFACE = [(m, name) for m in REFERENCE_MODULES for name in public_names(m)]


def signature(obj):
    """inspect.signature, or for a class without one of its own (an
    exception), the names of its bases."""
    try:
        return inspect.signature(obj)
    except ValueError:
        return [base.__name__ for base in obj.__mro__[1:]]


def method_signatures(cls):
    return {name: (type(attr).__name__, signature(attr) if callable(attr) else None)
            for name, attr in vars(cls).items()
            if not name.startswith("_") or name in ("__init__", "__enter__", "__exit__")}


@pytest.mark.parametrize("module_name,name", SURFACE, ids=[f"{m}.{n}" for m, n in SURFACE])
def test_public_surface_matches_reference(module_name, name):
    port_name = module_name.replace("tpu_pruner", "tpu_pruner_torch", 1)
    ref = getattr(importlib.import_module(module_name), name)
    port = getattr(importlib.import_module(port_name), name)
    assert port is not ref
    assert port.__module__.startswith("tpu_pruner_torch.")
    assert signature(port) == signature(ref)
    if inspect.isclass(ref):
        assert method_signatures(port) == method_signatures(ref)


def test_surface_covers_every_reference_module():
    assert len(REFERENCE_MODULES) == 18
    assert len(SURFACE) >= 100
    ref_source = inspect.getsource(tpu_pruner.native.load)
    assert sorted(native._FUNCTIONS) == sorted(
        line.strip().strip('",') for line in ref_source.splitlines()
        if line.strip().startswith('"tp_'))


# -- binding parity ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """The reference's bindings on the port's library, plus shared inputs: a
    small capsule corpus recorded by the port's daemon and wire bodies
    encoded by the port's wire_proto."""
    lib = native.load()
    root = tmp_path_factory.mktemp("bindings")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_pruner.native, "_lib", lib)
        capsules = trace_gen.record_corpus(
            trace_gen.generate("defrag", 4, workloads=2), root / "corpus",
            extra_args=("--capacity", "on", "--trace", "on"))
        k8s = FakeK8s()
        k8s.add_deployment_chain("ml", "trainer", num_pods=3)
        k8s.add_pod("ml", "edge-pod", labels={"app\ttab": 'quo"te', "ünïcode": "значение"})
        pods = [obj for path, obj in sorted(k8s.objects.items()) if "/pods/" in path]
        list_body = wire_proto.encode_pod_list(pods, {"resourceVersion": "42"})
        list_path = root / "list.pb"
        list_path.write_bytes(list_body)
        json_path = root / "list.json"
        json_path.write_text(json.dumps({"metadata": {"resourceVersion": "42"},
                                         "items": pods}))
        yield {"capsules": [json.loads(p.read_text()) for p in capsules], "pods": pods,
               "list_body": list_body, "list_path": str(list_path),
               "json_path": str(json_path), "missing": str(root / "absent.pb")}


def vector(series):
    return {"status": "success", "data": {"resultType": "vector", "result": series}}


NOW = 1785312000  # 2026-07-29T08:00:00Z
SAMPLE_LABELS = {"exported_pod": "p1", "exported_namespace": "ns", "exported_container": "c",
                 "accelerator_type": "tpu-v5-lite-podslice", "node_type": "ct5lp-hightpu-4t"}
PROM = vector([{"metric": {**SAMPLE_LABELS, "accelerator_id": str(i)}, "value": [NOW, "0"]}
               for i in range(4)]
              + [{"metric": {"pod": "p", "namespace": "n", "container": "c"}, "value": [NOW, "0"]},
                 {"metric": {"exported_namespace": "n"}, "value": [NOW, "0"]}])
EVIDENCE = vector([
    {"metric": {"pod": "p", "namespace": "n", "signal_stat": "samples"}, "value": [1, "30"]},
    {"metric": {"pod": "p", "namespace": "n", "signal_stat": "age"}, "value": [1, "12"]},
    {"metric": {"pod": "g", "namespace": "n", "signal_stat": "samples"}, "value": [1, "3"]},
    {"metric": {"pod": "g", "namespace": "n", "signal_stat": "age"}, "value": [1, "9"]},
    {"metric": {"pod": "s", "namespace": "n", "signal_stat": "age"}, "value": [1, "4000"]}])
CANDIDATES = [{"namespace": "n", "pod": p} for p in ("p", "g", "s", "q")]


def target(kind, name, ns, uid=None, rv=None):
    meta = {"name": name, "namespace": ns}
    if uid is not None:
        meta["uid"] = uid
    if rv is not None:
        meta["resourceVersion"] = rv
    return {"kind": kind, "object": {"metadata": meta}}


def pod(created=None, phase="Running", annotations=None):
    p = {"metadata": {}, "status": {"phase": phase}}
    if created:
        p["metadata"]["creationTimestamp"] = created
    if annotations:
        p["metadata"]["annotations"] = annotations
    return p


def ledger_row(key, rec):
    return {"workload": key, "kind": "Deployment", "namespace": "ml", "name": key, "chips": 4,
            "idle_seconds": 1.0, "reclaimed_chip_seconds": rec}


def workloads_doc(rows, reclaimed):
    return {"cluster": "c1", "sort": "reclaimed", "tracked": len(rows),
            "totals": {"idle_seconds": 1.0, "active_seconds": 0.0,
                       "reclaimed_chip_seconds": reclaimed},
            "workloads": rows}


SIGNALS = {"cluster": "c1", "enabled": True, "coverage_ratio": 1.0}
DECISIONS = {"cluster": "c1", "capacity": 8, "dropped": 0, "decisions": []}
IDLE = [{"kind": "Deployment", "namespace": f"ns{i % 3}", "name": f"w{i}", "chips": i + 1}
        for i in range(7)]
TIMER_STEPS = [
    {"op": "schedule", "key": "b", "due_ms": 200}, {"op": "schedule", "key": "a", "due_ms": 100},
    {"op": "schedule", "key": "deep", "due_ms": 50000}, {"op": "cancel", "key": "zz"},
    {"op": "next_due"}, {"op": "advance", "now_ms": 300}, {"op": "advance", "now_ms": 60000},
    {"op": "acquire", "now_ms": 0}, {"op": "acquire", "now_ms": 10},
    {"op": "acquire", "now_ms": 999}, {"op": "acquire", "now_ms": 1000},
    {"op": "available", "now_ms": 1005}]
CAPACITY_INPUTS = {
    "nodes": [{"name": n, "pool": p, "topology": "2x2", "chips": 4}
              for n, p in (("a0", "sA"), ("b0", "sB"), ("spare0", "spare"))],
    "placements": [{"pod": "ml/a-0", "node": "a0", "chips": 4, "idle": True,
                    "root": "Deployment/ml/a"},
                   {"pod": "ml/r-0", "node": "b0", "chips": 4, "idle": True,
                    "root": "Deployment/ml/r"}],
    "freed": [{"kind": "Deployment", "ns": "ml", "name": "old", "chips": 8, "state": "paused"}]}
FAMILIES = ["signal", "transport", "backoff", "incremental", "wire", "store", "trace", "fleet",
            "capacity", "ledger"]


def call(*args, **kwargs):
    return args, kwargs


# binding -> ctx -> [(args, kwargs), ...]
CALLS = {
    "build_query": lambda c: [call(args) for args in (
        {"device": "gpu", "duration": 30}, {"device": "gpu", "duration": 30, "power_threshold": 150.0},
        {"device": "gpu", "duration": 15, "namespace": "ml-team", "power_threshold": 100.0},
        {"device": "gpu", "duration": 15, "namespace_exclude": "kube-.*"},
        {"device": "gpu", "duration": 30, "model_name": "NVIDIA A100", "honor_labels": True},
        {"device": "tpu", "duration": 30}, {"device": "tpu", "duration": 30, "hbm_threshold": 0.05},
        {"device": "tpu", "duration": 30, "accelerator_type": 'a"b', "namespace": r"ml-\d+"},
        {"device": "tpu", "metric_schema": "gke-system", "duration": 30}, {"duration": 30},
        {"device": "cuda", "duration": 30}, {"device": "tpu", "metric_schema": "stackdriver",
                                            "duration": 30},
        {"device": "gpu", "metric_schema": "gke-system", "duration": 30})],
    "build_evidence_query": lambda c: [call(args) for args in (
        {"device": "tpu"}, {"device": "tpu", "metric_schema": "gke-system", "namespace": "ml.*",
                            "accelerator_type": "tpu-v5p-slice"},
        {"device": "gpu", "model_name": "NVIDIA A10G"}, {"device": "cuda"})],
    "signal_assess": lambda c: [
        call(EVIDENCE, CANDIDATES), call(EVIDENCE, CANDIDATES, {"min_coverage": 0.9}),
        call(EVIDENCE, CANDIDATES, {"scrape_interval_s": 60, "max_age_s": 10, "window_s": 600}),
        call(EVIDENCE, []), call({"status": "error", "error": "boom"}, CANDIDATES),
        call({"status": "success", "data": {}}, CANDIDATES)],
    **{f"{family}_metric_families": (lambda c: [call()]) for family in FAMILIES},
    "audit_reason_codes": lambda c: [call()],
    "enabled_resources": lambda c: [call(f) for f in ("drsin", "drsinj", "l", "drsinjl", "n", "di",
                                                      "", "xdqz", "dddd")],
    "compact_roundtrip": lambda c: [
        *(call(json.dumps(p)) for p in c["pods"]),
        *(call(proto_body=wire_proto.encode_object_body(p)) for p in c["pods"]),
        call(json.dumps({"apiVersion": "v1", "kind": "Pod", "metadata": {
            "name": "x", "namespace": "ns", "finalizers": ["keep"]}, "spec": {"containers": []}})),
        call(proto_body=b"\x00garbage"), call(), call("{not json")],
    "store_stats": lambda c: [call()],
    "wire_decode_k8s": lambda c: [
        call(c["list_body"]), call(c["list_body"], "list"),
        *(call(wire_proto.encode_watch_frame(t, p)[4:], "watch")
          for t in ("ADDED", "MODIFIED", "DELETED") for p in c["pods"][:2]),
        call(wire_proto.encode_watch_frame(
            "BOOKMARK", {"kind": "Bookmark", "metadata": {"resourceVersion": "123"}})[4:], "watch"),
        call(c["list_body"][:len(c["list_body"]) // 2]), call(b"\xff\x00junk", "watch"),
        call(c["list_body"], "tree")],
    "wire_decode_prom": lambda c: [
        call(wire_proto.encode_prom_vector(PROM)),
        call(wire_proto.encode_prom_vector(PROM), schema="gke-system"),
        call(wire_proto.encode_prom_vector(PROM), device="gpu"),
        call(wire_proto.encode_prom_vector(PROM)[:20]), call(b"\x07")],
    "wire_bench_decode": lambda c: [
        call(c["list_path"], "protobuf"), call(c["list_path"], "protobuf", iters=3),
        call(c["json_path"], "json", 2), call(c["missing"], "protobuf")],
    "json_parse": lambda c: [call(body, zero_copy=z) for z in (False, True) for body in (
        '{"a": [1, 2.5, "x\\u00e9"], "b": null}', json.dumps(PROM), "[]", '{"a": 1', "",
        '{"a": 1} trailing', '"\\ud800"')],
    "decode_samples": lambda c: [
        call(PROM), call(PROM, device="gpu"), call(PROM, schema="gke-system"),
        call(None, response_raw=json.dumps(PROM)),
        call(None, response_raw=json.dumps(PROM), zero_copy=True, schema="gke-system"),
        call(vector([]), schema="gke_system"), call({"status": "error", "error": "boom"}),
        call({"status": "success", "data": {"resultType": "matrix", "result": []}}),
        call(None, response_raw="{truncated", zero_copy=True)],
    "generate_event": lambda c: [
        call(target("Notebook", "tpu-test", "ml-ns", "nb-uid-1"), now=NOW),
        call(target("Deployment", "my-dep", "prod", "dep-uid"), device="gpu", now=NOW),
        call(target("ReplicaSet", "my-rs", "staging"), "tpu", NOW),
        call({"kind": "Deployment", "object": {"metadata": {"name": "orphan"}}}, now=NOW),
        call(target("JobSet", "slice-a", "tpu-jobs", "js-uid"), now=NOW),
        call(target("CronJob", "c", "ns"), now=NOW)],
    "check_eligibility": lambda c: [call(p, NOW, 30 * 60 + 300) for p in (
        pod("2026-07-01T00:00:00Z", phase="Pending"), pod(), pod("2026-07-29T07:45:00Z"),
        pod("2026-07-29T07:25:00Z"), pod("2026-07-29T07:24:59Z"), pod("not-a-time"),
        pod("2026-07-29T07:24:59Z", annotations={"tpu-pruner.dev/skip": "true"}),
        pod("2026-07-29T07:24:59Z", annotations={"tpu-pruner.dev/skip": "True"}))],
    "dedup_targets": lambda c: [
        call([target("Deployment", "d", "ns", "uid-1"), target("Deployment", "d", "ns", "uid-1")]),
        call([target("Deployment", "x", "ns", "uid-1"), target("ReplicaSet", "x", "ns", "uid-1")]),
        call([target("Notebook", "nb-a", "ns", "u"), target("Notebook", "nb-b", "ns", "u")]),
        call([target("Deployment", "d", "ns"), target("Deployment", "d2", "ns"),
              target("Deployment", "d", "ns")]),
        call([target("CronJob", "c", "ns")])],
    "target_meta": lambda c: [
        *(call(target(kind, "obj", "ns", "the-uid", rv="42")) for kind in (
            "Deployment", "ReplicaSet", "StatefulSet", "Notebook", "InferenceService", "JobSet",
            "LeaderWorkerSet")),
        call({"kind": "Deployment", "object": {"metadata": {"name": "x"}}}),
        call(target("CronJob", "c", "ns"))],
    "shard_of": lambda c: [call(key, n) for key in ("", "Deployment/ml/a", "JobSet/tpu/slice-7")
                           for n in (0, 1, 8, 100000)],
    "fleet_aggregate": lambda c: [
        call([{"url": "http://a", "cluster": "a", "reachable": True,
               "signals": {"enabled": True, "coverage_ratio": 0.95, "brownout": False},
               "workloads": workloads_doc([ledger_row("w", 5.0)], 5.0)},
              {"url": "http://b", "cluster": "b", "reachable": False, "ever_reached": True,
               "staleness_s": 999, "failures": 5, "last_error": "timed out"}], stale_after_s=30),
        call([{"url": "http://a", "cluster": "a", "reachable": True,
               "signals": {"enabled": False}},
              {"url": "http://b", "cluster": "b", "reachable": True,
               "signals": {"enabled": True, "coverage_ratio": 0.4, "brownout": True}}],
             10, decisions_per_member=2, hub_cluster="hub")],
    "stamp_exposition": lambda c: [call(body, cluster) for cluster in ("c1", "") for body in (
        '# HELP x y\nplain_total 3\nhist_bucket{phase="q",le="+Inf"} 1 # {trace_id="ab"} 0.1 9\n'
        'prelabeled{cluster="other"} 5\n# EOF\n', "")],
    "capacity_build": lambda c: [call(CAPACITY_INPUTS), call({"nodes": [{"name": 1}]})],
    "capacity_report": lambda c: [
        call([cap["capacity"] | {"cycle": cap["cycle"], "now_unix": cap["now_unix"]}
              for cap in c["capsules"]]), call([])],
    "delta_sim": lambda c: [
        call([{"op": "publish", "workloads": workloads_doc(
                   [ledger_row("a", 5.0), ledger_row("b", 9.0)], 14.0),
               "signals": SIGNALS, "decisions": DECISIONS},
              {"op": "poll"}, {"op": "poll"},
              {"op": "publish", "workloads": workloads_doc(
                  [ledger_row("a", 50.0), ledger_row("b", 9.0)], 59.0),
               "signals": SIGNALS, "decisions": DECISIONS},
              {"op": "poll"}, {"op": "restart"}, {"op": "poll", "since": 1, "gen": "x"}]),
        call([{"op": "publish", "workloads": workloads_doc(
                  [ledger_row(f"w{i}", float(i))], float(i)), "signals": SIGNALS,
               "decisions": DECISIONS} for i in range(6)] + [{"op": "poll"}], log_cap=2),
        call([{"op": "bogus"}])],
    "timerwheel_sim": lambda c: [
        call(TIMER_STEPS, bucket={"capacity": 2, "window_ms": 1000}),
        call(TIMER_STEPS[:7], origin_ms=50), call([{"op": "acquire", "now_ms": 1}])],
    "replay_cycle": lambda c: [
        call(c["capsules"][-1]),
        call(c["capsules"][-1], {"lookback": "10m", "run_mode": "scale-down"}),
        call(c["capsules"][1], {"duration": 45, "hbm_threshold": 0.05}), call({})],
    "gym_simulate": lambda c: [
        call(c["capsules"]), call(c["capsules"], ["baseline", "sweep:lookback=10m,grace=60"]),
        call(c["capsules"], None, 60, False, 180),
        call(c["capsules"], ["hysteresis:pause_after=2", "right-size:threshold=0.5"],
             assume_interval_s=180, false_pause_penalty_chip_hours=2.5,
             churn_penalty_chip_hours=0.0),
        call(c["capsules"], ["nonsense:policy"])],
    "right_size_plan": lambda c: [
        call("Deployment", {"spec": {"replicas": 4}}, 2, 8),
        call("StatefulSet", {"spec": {"replicas": 3}}, 3, 12, threshold=0.5),
        call("Notebook", {"spec": {}}, 1, 4), call("Deployment", {"spec": {"replicas": 1}}, 0, 0),
        call("CronJob", {}, 1, 1)],
    "ledger_sim": lambda c: [
        call(3, [{"now": 1000, "idle": IDLE, "pauses": [
                     {"kind": "Deployment", "namespace": "ns0", "name": "w6", "reason": "SCALED"}]},
                 {"now": 1010, "idle": IDLE},
                 {"now": 1030, "idle": IDLE, "resumes": [
                     {"kind": "Deployment", "namespace": "ns0", "name": "w6"}]}]),
        call(7, [{"now": 1000, "idle": IDLE}], query="sort=chips&limit=2"), call(1, [])],
}
# fields that are random or read a clock: {binding: paths}
VOLATILE = {"generate_event": [("metadata", "name")], "wire_bench_decode": [("seconds",)]}


def masked(name, result):
    if name == "delta_sim":
        # a journal generation is "<unix time>-<pid>-<process counter>"; a
        # poll's wire size counts it once
        for step in result:
            gen = step.get("response", {}).get("gen")
            if gen is not None:
                step["response"]["gen"] = "<masked>"
                step["bytes"] -= len(gen)
    for path in VOLATILE.get(name, []):
        node = result
        for key in path[:-1]:
            node = node.get(key, {}) if isinstance(node, dict) else {}
        if isinstance(node, dict) and path[-1] in node:
            node[path[-1]] = "<masked>"
    return result


def outcome(module, name, args, kwargs):
    try:
        return "ok", masked(name, getattr(module, name)(*args, **kwargs))
    except ValueError as exc:
        return "ValueError", str(exc)


def test_calls_cover_every_binding():
    bound = {n for n in public_names("tpu_pruner.native") if n not in ("load", "ensure_built")}
    assert set(CALLS) | {"InformerSession", "otlp_grpc_call"} == bound


@pytest.mark.parametrize("name", sorted(CALLS))
def test_binding_matches_reference(ctx, name):
    outcomes = []
    for args, kwargs in CALLS[name](ctx):
        want = outcome(tpu_pruner.native, name, args, kwargs)
        got = outcome(native, name, args, kwargs)
        assert got == want, (name, args, kwargs)
        outcomes.append(got[0])
    assert "ok" in outcomes


def test_binding_error_texts_are_the_librarys(ctx):
    """The error cases above raise the C side's message, unchanged."""
    with pytest.raises(ValueError, match="unknown metric schema"):
        native.decode_samples(vector([]), schema="gke_system")
    with pytest.raises(ValueError, match="unknown kind"):
        native.dedup_targets([target("CronJob", "c", "ns")])
    with pytest.raises(ValueError, match="pass obj_json or proto_body"):
        native.compact_roundtrip()


@pytest.mark.parametrize("variant", ["plain", "shrunk_window", "early_reject", "edge_frames"])
def test_otlp_grpc_call_matches_reference(variant):
    """otlp_grpc_call through both modules against the port's collector."""
    options, size = {
        "plain": ({}, 512 * 1024),
        "shrunk_window": ({"initial_window_size": 1000, "bogus_stream_window_update": True},
                          256 * 1024),
        "early_reject": ({"grpc_status": 8, "grpc_message": "quota", "initial_window_size": 0,
                          "reject_before_body": True}, 256 * 1024),
        "edge_frames": ({"pad_headers": True, "ping_before_response": True,
                         "huffman_trailers": True, "split_trailers": True}, 64),
    }[variant]
    results = []
    for module in (tpu_pruner.native, native):
        grpc = FakeGrpcCollector(**options)
        port = grpc.start()
        try:
            results.append(module.otlp_grpc_call("127.0.0.1", port, "/test.Service/Big", size,
                                                 timeout_ms=5000))
            if results[-1]["ok"]:
                assert len(grpc.requests[0][1]) == size
        finally:
            grpc.stop()
    assert results[0] == results[1]


@pytest.fixture()
def ref_on_port_lib(monkeypatch):
    monkeypatch.setattr(tpu_pruner.native, "_lib", native.load())


def informer_run(module, k8s):
    """Sync, read, follow a live ADDED and a relist; the informer's own view."""
    seen = []
    pod_path = "/api/v1/namespaces/ml/pods/trainer-abc123-0"
    with module.InformerSession(k8s.url, resources=["pods", "replicasets", "deployments"]) as s:
        seen.append(s.synced)
        seen.append(s.get(pod_path))
        seen.append(s.get("/apis/apps/v1/namespaces/ml/deployments/trainer"))
        seen.append(s.get("/api/v1/namespaces/ml/pods/absent"))
        stats = s.stats()
        for res in stats["resources"].values():
            res.pop("cold_sync_seconds")
            res.pop("resource_version")
        seen.append(stats)
    with pytest.raises(ValueError) as exc:
        module.InformerSession("http://127.0.0.1:1", resources=["nonsense"], wait_ms=100)
    seen.append(str(exc.value))
    return seen


def test_informer_session_matches_reference(ref_on_port_lib):
    """Both InformerSession classes over one FakeK8s of the port's."""
    k8s = FakeK8s()
    k8s.add_deployment_chain("ml", "trainer", num_pods=2)
    k8s.start()
    try:
        want = informer_run(tpu_pruner.native, k8s)
        got = informer_run(native, k8s)
    finally:
        k8s.stop()
    assert got == want
    assert got[0] is True and got[1]["metadata"]["name"] == "trainer-abc123-0"
    assert got[3] is None


def test_informer_session_follows_the_port_fake():
    """The port's session syncs from the port's FakeK8s and follows ADDED,
    MODIFIED and a 410 relist, as tests/test_informer.py checks the
    reference's."""
    import time

    def wait_for(predicate, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(0.05)
        return False

    k8s = FakeK8s()
    k8s.add_deployment_chain("ml", "trainer", num_pods=2)
    k8s.start()
    pod_path = "/api/v1/namespaces/ml/pods/trainer-abc123-0"
    try:
        with native.InformerSession(k8s.url, resources=["pods"]) as s:
            assert s.synced
            k8s.add_pod("ml", "newpod")
            assert wait_for(lambda: s.get("/api/v1/namespaces/ml/pods/newpod"))
            pod_obj = dict(k8s.objects[pod_path])
            pod_obj["status"] = {"phase": "Succeeded"}
            k8s.objects[pod_path] = pod_obj
            assert wait_for(lambda: s.get(pod_path)["status"]["phase"] == "Succeeded")
            relists = s.stats()["resources"]["/api/v1/pods"]["relists"]
            k8s.expire_watches()
            k8s.add_pod("ml", "after-410")
            assert wait_for(lambda: s.get("/api/v1/namespaces/ml/pods/after-410"))
            assert s.stats()["resources"]["/api/v1/pods"]["relists"] > relists
    finally:
        k8s.stop()
