"""ctypes bindings over the tpu-pruner C++ core, built by the port itself.

The C++ core (``native/src``) exposes a narrow C API (``capi.cpp``) over
its pure domain functions: query building, sample decoding, eligibility,
event generation, the fleet and ledger math, the replay, gym and capacity
engines, and the informer. This module builds that core with ``g++`` into
``build/torch_native/`` at first use and binds every one of those
functions under ``tpu_pruner/native.py``'s names, signatures and payload
shapes. It is the port's own copy and imports nothing of ``tpu_pruner``.

All C API functions exchange JSON strings; results are heap-allocated by
the library and released with ``tp_free``. Importing this module builds
nothing; ``load()``, ``build()`` and ``ensure_built()`` do.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import json
import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "torch_native"
LIB_PATH = BUILD_DIR / "libtpupruner.so"
# TP_DAEMON_PATH points the hermetic tiers at an alternate daemon binary,
# e.g. a sanitizer build; the build below still links its own.
DAEMON_PATH = Path(os.environ.get("TP_DAEMON_PATH", BUILD_DIR / "tpu-pruner"))
TESTS_PATH = BUILD_DIR / "tpupruner_tests"

# The C API functions bound here (native/src/capi.cpp); each takes a JSON
# string and returns a heap string released with tp_free.
_FUNCTIONS = (
    "tp_build_query",
    "tp_build_evidence_query",
    "tp_signal_assess",
    "tp_signal_metric_families",
    "tp_transport_metric_families",
    "tp_backoff_metric_families",
    "tp_incremental_metric_families",
    "tp_wire_metric_families",
    "tp_store_metric_families",
    "tp_trace_metric_families",
    "tp_compact_roundtrip",
    "tp_store_stats",
    "tp_wire_decode_k8s",
    "tp_wire_decode_prom",
    "tp_wire_bench_decode",
    "tp_json_parse",
    "tp_enabled_resources",
    "tp_decode_samples",
    "tp_generate_event",
    "tp_check_eligibility",
    "tp_dedup_targets",
    "tp_target_meta",
    "tp_otlp_grpc_call",
    "tp_audit_reason_codes",
    "tp_shard_of",
    "tp_fleet_metric_families",
    "tp_fleet_aggregate",
    "tp_capacity_metric_families",
    "tp_capacity_build",
    "tp_capacity_report",
    "tp_stamp_exposition",
    "tp_delta_sim",
    "tp_timerwheel_sim",
    "tp_replay_cycle",
    "tp_gym_simulate",
    "tp_right_size_plan",
    "tp_ledger_sim",
    "tp_ledger_metric_families",
    "tp_informer_start",
    "tp_informer_stats",
    "tp_informer_get",
    "tp_informer_stop",
    "tp_version",
)

# The direct-build flags of the reference's g++ build, plus
# `-include optional`: native/include/tpupruner/json.hpp:216-217 uses
# std::optional without including <optional>, which compiles only where
# another standard header happens to pull it in (g++ 12's do not). The fix
# belongs in json.hpp, which predates the port and is not edited by it.
CXXFLAGS = ("-std=c++20", "-O2", "-g", "-fPIC", "-Wall", "-Wextra",
            '-DTP_VERSION="0.1.0"', '-DTP_GIT_REV="nocmake"',
            "-include", "optional", "-I", str(NATIVE_DIR / "include"))

_lib = None


def _newest_mtime(tree: Path, suffixes: tuple[str, ...] = (".cpp", ".hpp", ".txt")) -> float:
    newest = 0.0
    for root, _dirs, files in os.walk(tree):
        for f in files:
            if f.endswith(suffixes):
                newest = max(newest, os.path.getmtime(os.path.join(root, f)))
    return newest


def _outputs(units: bool) -> list[Path]:
    """What a build links: the library and the daemon and, with units, the
    unit-test runner and the fuzz binary."""
    outputs = [LIB_PATH, BUILD_DIR / "tpu-pruner"]
    if units:
        outputs += [TESTS_PATH, BUILD_DIR / "tpupruner_fuzz"]
    return outputs


def _stale(units: bool = False) -> bool:
    outputs = _outputs(units)
    if not all(p.exists() for p in outputs):
        return True
    built = min(os.path.getmtime(p) for p in outputs)
    return built < _newest_mtime(NATIVE_DIR)


def _run(step: str, cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native {step} failed:\n{proc.stdout}\n{proc.stderr}")


def _locked_build(units: bool, force: bool = False) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:  # closing it unlocks
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or _stale(units):
            _compile_and_link(units, force)
    return LIB_PATH


def build() -> Path:
    """Build the library and the daemon into ``build/torch_native/`` if any
    file under ``native/`` is newer than either; returns ``LIB_PATH``.

    Links ``libtpupruner.so`` from the objects of ``native/src/*.cpp`` but
    ``main.o``, and the ``tpu-pruner`` daemon from ``main.o`` and the same
    objects. Compiles run in parallel, under an exclusive lock on
    ``build/torch_native/.lock`` held for the whole build, so concurrent
    processes build once. A failed compile or link raises ``RuntimeError``
    with the compiler's output.
    """
    return _locked_build(units=False)


def ensure_built(force: bool = False) -> Path:
    """``build()``, plus the C++ unit-test runner (``TESTS_PATH``, from
    ``native/tests/test_*.cpp``) and ``tpupruner_fuzz`` (from
    ``fuzz_main.cpp``), both linked against the library's objects; with
    ``force``, every object is compiled again. Returns ``LIB_PATH``."""
    return _locked_build(units=True, force=force)


def _compile_and_link(units: bool = False, force: bool = False) -> None:
    """Compile each source whose object is missing, older than it or older
    than the newest header (every one with force), then link."""
    cxx = os.environ.get("CXX", "g++")
    obj_dir = BUILD_DIR / "obj"
    obj_dir.mkdir(exist_ok=True)
    tests = NATIVE_DIR / "tests"
    sources = sorted((NATIVE_DIR / "src").glob("*.cpp"))
    jobs = [(src, obj_dir / (src.stem + ".o"), []) for src in sources]
    if units:
        jobs += [(src, obj_dir / ("tests_" + src.stem + ".o"), ["-I", str(tests)])
                 for src in sorted(tests.glob("test_*.cpp"))]
        jobs.append((tests / "fuzz_main.cpp", obj_dir / "fuzz_main.o", ["-I", str(tests)]))
    newest_hdr = _newest_mtime(NATIVE_DIR, (".hpp",))

    def stale(src: Path, obj: Path) -> bool:
        return force or not obj.exists() or os.path.getmtime(obj) < max(
            os.path.getmtime(src), newest_hdr)

    def compile_one(src: Path, obj: Path, extra: list[str]) -> None:
        # to a temporary name, so an interrupted compile leaves no object
        tmp = obj.with_name(obj.name + ".tmp")
        _run(f"compile {src.name}", [cxx, *CXXFLAGS, *extra, "-c", str(src), "-o", str(tmp)])
        os.replace(tmp, obj)

    with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as ex:
        futures = [ex.submit(compile_one, *job) for job in jobs if stale(job[0], job[1])]
        for future in futures:
            future.result()
    lib_objs = [str(obj_dir / (src.stem + ".o")) for src in sources if src.stem != "main"]
    links = [("libtpupruner.so", LIB_PATH, lib_objs, ["-shared"]),
             ("tpu-pruner", BUILD_DIR / "tpu-pruner", [str(obj_dir / "main.o"), *lib_objs], [])]
    if units:
        test_objs = [str(obj) for _src, obj, _extra in jobs if obj.stem.startswith("tests_")]
        links += [("tpupruner_tests", TESTS_PATH, [*test_objs, *lib_objs], []),
                  ("tpupruner_fuzz", BUILD_DIR / "tpupruner_fuzz",
                   [str(obj_dir / "fuzz_main.o"), *lib_objs], [])]
    # Link to temporary names and rename, so a reader never sees half a file.
    for name, target, objs, extra in links:
        tmp = target.with_name(target.name + ".tmp")
        _run(f"link {name}", [cxx, *extra, *objs, "-o", str(tmp), "-ldl", "-lpthread"])
        os.replace(tmp, target)


def load() -> ctypes.CDLL:
    """Build if needed, then load ``LIB_PATH`` once per process."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.tp_free.argtypes = [ctypes.c_void_p]
    lib.tp_free.restype = None
    for fn in _FUNCTIONS:
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_char_p]
        f.restype = ctypes.c_void_p
    _lib = lib
    return lib


def _call(name: str, payload) -> dict | list | str | int | float | None:
    """Call a JSON-in/JSON-out C API function.

    Errors are surfaced as ``{"error": "..."}`` payloads and re-raised.
    """
    lib = load()
    raw = json.dumps(payload).encode()
    ptr = getattr(lib, name)(raw)
    if not ptr:
        raise RuntimeError(f"{name}: null result")
    try:
        out = ctypes.string_at(ptr).decode()
    finally:
        lib.tp_free(ptr)
    result = json.loads(out)
    if isinstance(result, dict) and "error" in result:
        raise ValueError(result["error"])
    return result


def build_query(args: dict) -> str:
    """Render the idle-workload PromQL for the given CLI-style args."""
    return _call("tp_build_query", args)["query"]


def build_evidence_query(args: dict) -> str:
    """Render the signal watchdog's companion evidence PromQL (per-pod
    sample coverage + last-sample age over the lookback window) for the
    same CLI-style args ``build_query`` takes."""
    return _call("tp_build_evidence_query", args)["query"]


def signal_assess(response: dict, candidates: list[dict],
                  config: dict | None = None) -> dict:
    """Run the REAL signal-watchdog assessment (native/src/signal.cpp)
    over a synthetic evidence response and candidate set. ``candidates``
    is [{"namespace", "pod"}...]; ``config`` overrides
    scrape_interval_s / max_age_s / min_coverage / window_s. Returns the
    assessment JSON: coverage_ratio, brownout, per-verdict pod counts and
    per-pod details."""
    payload: dict = {"response": response, "candidates": candidates}
    if config:
        payload["config"] = config
    return _call("tp_signal_assess", payload)


def signal_metric_families() -> list[str]:
    """Canonical signal-watchdog metric family names served on /metrics —
    the docs drift-guard test joins this list against docs/OPERATIONS.md."""
    return _call("tp_signal_metric_families", {})["families"]


def enabled_resources(flags: str) -> list[str]:
    """Parse a 'drsinj' flag string into the enabled resource kinds."""
    return _call("tp_enabled_resources", flags)["kinds"]


def transport_metric_families() -> list[str]:
    """Canonical shared-transport metric family names served on /metrics —
    the docs drift-guard test joins this list against docs/OPERATIONS.md."""
    return _call("tp_transport_metric_families", {})["families"]


def backoff_metric_families() -> list[str]:
    """Canonical unified retry/backoff metric family names served on
    /metrics (backoff.cpp) — the docs drift-guard test joins this list
    against docs/OPERATIONS.md."""
    return _call("tp_backoff_metric_families", {})["families"]


def incremental_metric_families() -> list[str]:
    """Canonical differential-reconcile metric family names served on
    /metrics — the docs drift-guard test joins this list against
    docs/OPERATIONS.md."""
    return _call("tp_incremental_metric_families", {})["families"]


def wire_metric_families() -> list[str]:
    """Canonical binary-wire (tpu_pruner_wire_*) metric family names
    served on /metrics — the docs drift-guard test joins this list
    against docs/OPERATIONS.md."""
    return _call("tp_wire_metric_families", {})["families"]


def store_metric_families() -> list[str]:
    """Canonical compact-store (tpu_pruner_store_* / cold_sync) metric
    family names served on /metrics — the docs drift-guard test joins
    this list against docs/OPERATIONS.md."""
    return _call("tp_store_metric_families", {})["families"]


def trace_metric_families() -> list[str]:
    """Canonical action-provenance trace/SLO (tpu_pruner_trace_* /
    tpu_pruner_slo_*) metric family names served on /metrics with --trace
    on — the docs drift-guard test joins this list against
    docs/OPERATIONS.md."""
    return _call("tp_trace_metric_families", {})["families"]


def compact_roundtrip(obj_json: str | None = None, *, proto_body: bytes | None = None,
                      api_version: str = "v1", kind: str = "Pod") -> dict:
    """Decode one object through the REAL compact PodRecord path
    (native/src/compact.cpp) and return its materialized form.

    Pass ``obj_json`` (object text → record_from_value; ``compact`` is
    False when the strict-subset builder refused and kept the exact
    Value) or ``proto_body`` (an ObjectMeta-bearing protobuf object body
    → record_from_proto). ``dump`` must be byte-identical to the
    non-compact decode of the same data — the parity corpus asserts it."""
    if proto_body is not None:
        import base64

        return _call("tp_compact_roundtrip",
                     {"body_b64": base64.b64encode(proto_body).decode(),
                      "api_version": api_version, "kind": kind})
    if obj_json is None:
        raise ValueError("pass obj_json or proto_body")
    return _call("tp_compact_roundtrip", {"json": obj_json})


def store_stats() -> dict:
    """Process-wide compact-store gauges (store_bytes/store_pods), intern
    table size, and recycled Doc-arena counters (reuses/returns/drops/
    pooled_bytes) — the bench's bytes-per-pod bar and the page-pinning
    regression test read these."""
    return _call("tp_store_stats", {})


def wire_decode_k8s(body: bytes, shape: str = "list") -> dict:
    """Decode a Kubernetes protobuf body through the REAL wire decoder
    (native/src/proto.cpp). ``shape`` is "list" (an
    application/vnd.kubernetes.protobuf LIST response) or "watch" (one
    length-delimited frame WITHOUT its 4-byte length prefix). Returns the
    materialized items/object plus the fused-path key fields and
    fingerprints — the wire parity corpus compares these against
    json.loads of the JSON form of the same data."""
    import base64

    return _call("tp_wire_decode_k8s",
                 {"body_b64": base64.b64encode(body).decode(), "shape": shape})


def wire_decode_prom(body: bytes, device: str = "tpu", schema: str = "gmp") -> dict:
    """Decode a Prometheus protobuf exposition body through the fused
    wire decoder: returns {"samples", "num_series", "errors",
    "canonical_body"} where canonical_body must be byte-identical to the
    JSON body the fake recorded for the same data."""
    import base64

    return _call("tp_wire_decode_prom",
                 {"body_b64": base64.b64encode(body).decode(),
                  "device": device, "schema": schema})


def wire_bench_decode(path: str, content_type: str, iters: int = 1) -> dict:
    """Time `iters` informer-shaped decodes of the response body stored
    at ``path`` ("protobuf" → proto::parse_list; "json" → Doc::parse +
    items walk). The bench's cold-LIST decode-wall probe."""
    return _call("tp_wire_bench_decode",
                 {"path": path, "content_type": content_type, "iters": iters})


def json_parse(body: str, zero_copy: bool = False) -> dict:
    """Parse a JSON body through the Value parser or (zero_copy=True) the
    arena/zero-copy Doc parser, returning canonical {"dump","pretty"} text.
    The decode-parity tests assert both paths agree byte-for-byte (and
    raise identical errors) on recorded transport bodies."""
    return _call("tp_json_parse", {"body": body, "zero_copy": zero_copy})


def decode_samples(
    prom_response: dict | None,
    device: str = "tpu",
    schema: str = "gmp",
    response_raw: str | None = None,
    zero_copy: bool = False,
) -> dict:
    """Decode a Prometheus instant-query response into pod metric samples.

    Pass `response_raw` (verbatim body text) to drive the decoder from raw
    bytes; with zero_copy=True it runs the arena/Doc-walking decoder — the
    parity tests compare both against identical input."""
    payload: dict = {"device": device, "schema": schema}
    if response_raw is not None:
        payload["response_raw"] = response_raw
        payload["zero_copy"] = zero_copy
    else:
        payload["response"] = prom_response
    return _call("tp_decode_samples", payload)


def generate_event(target: dict, device: str = "tpu", now: int | None = None) -> dict:
    """Build the K8s Event emitted before a scale-down action."""
    payload = {"target": target, "device": device}
    if now is not None:
        payload["now"] = int(now)
    return _call("tp_generate_event", payload)


def check_eligibility(pod: dict, now_unix: int, lookback_secs: int) -> dict:
    """Apply the reference's eligibility gates to a Pod object."""
    return _call(
        "tp_check_eligibility",
        {"pod": pod, "now_unix": now_unix, "lookback_secs": lookback_secs},
    )


def dedup_targets(targets: list[dict]) -> list[dict]:
    """uid+kind dedup of scale targets (reference HashSet<ScaleKind>)."""
    return _call("tp_dedup_targets", targets)


def target_meta(target: dict) -> dict:
    """Meta accessors (name/namespace/kind/uid/apiVersion) for a target."""
    return _call("tp_target_meta", target)


def shard_of(key: str, shards: int) -> dict:
    """Shard placement for a resolved-root key (native/src/shard.cpp):
    ``{"shard": i, "hash": fnv1a64, "resolved_count": n}``. The shard
    index is a pure function of (key, shards) — the reconcile engine's
    same-root-same-shard guarantee the determinism tests pin."""
    return _call("tp_shard_of", {"key": key, "shards": shards})


def audit_reason_codes() -> list[str]:
    """Canonical DecisionRecord reason codes (SCALED, DRY_RUN, ...) —
    every code the daemon can emit, in enum order. The docs drift-guard
    test joins this list against docs/OPERATIONS.md."""
    return _call("tp_audit_reason_codes", {})["codes"]


def fleet_metric_families() -> list[str]:
    """Canonical tpu_pruner_fleet_* family names the federation hub serves
    on /metrics — the docs drift-guard test joins this list against
    docs/OPERATIONS.md."""
    return _call("tp_fleet_metric_families", {})["families"]


def fleet_aggregate(members: list[dict], stale_after_s: int = 30,
                    decisions_per_member: int | None = None,
                    hub_cluster: str | None = None) -> dict:
    """Run the REAL hub merge math (native/src/fleet.cpp) over synthetic
    member snapshots. Each member: {"url", "cluster", "reachable",
    "ever_reached"?, "staleness_s"?, "polls"?, "failures"?, "last_error"?,
    "workloads"?, "signals"?, "decisions"?} where workloads/signals/
    decisions are the member's /debug documents (plus "capacity"? — a
    member's /debug/capacity inventory). Returns the five /debug/fleet
    documents, "metrics"/"metrics_openmetrics" exposition text, and
    "capacity_rollup" — the hub's own /debug/capacity body."""
    payload: dict = {"members": members, "stale_after_s": stale_after_s}
    if decisions_per_member is not None:
        payload["decisions_per_member"] = decisions_per_member
    if hub_cluster is not None:
        payload["hub_cluster"] = hub_cluster
    return _call("tp_fleet_aggregate", payload)


def stamp_exposition(body: str, cluster: str) -> str:
    """Insert cluster="..." into every sample line of a Prometheus text
    exposition (the fleet identity choke point; idempotent)."""
    return _call("tp_stamp_exposition", {"body": body, "cluster": cluster})["body"]


def capacity_metric_families() -> list[str]:
    """Canonical tpu_pruner_capacity_* family names served on /metrics with
    --capacity on — the docs drift-guard test joins this list against
    docs/OPERATIONS.md."""
    return _call("tp_capacity_metric_families", {})["families"]


def capacity_build(inputs: dict) -> dict:
    """Run the REAL capacity-inventory math (native/src/capacity.cpp) over
    a canonical inputs record {"nodes": [...], "placements": [...],
    "freed": [...]}. Returns {"doc" (the inventory), "inputs_canonical"
    (order-normalized round-trip), "shared_busy_roots" (the slice gate's
    held roots), "metrics", "metrics_openmetrics"}."""
    return _call("tp_capacity_build", {"inputs": inputs})


def capacity_report(stamps: list[dict]) -> dict:
    """The replayable defragmentation report (capacity::report) — the
    `analyze --capacity-report` backend. ``stamps`` is a list of capsule
    capacity stamps [{"cycle", "now_unix", "inputs", "doc"}...]; every
    inventory is recomputed from its inputs (byte drift reported per
    cycle) and consolidation potential is dt-integrated across the
    window with the ledger's math."""
    return _call("tp_capacity_report", {"stamps": stamps})


def delta_sim(steps: list[dict], log_cap: int | None = None) -> list[dict]:
    """Drive the REAL delta-federation protocol (native/src/delta.cpp):
    the member-side change journal AND the hub-side cursor/apply state
    machine, through a scripted sequence of steps:
      {"op": "publish", "workloads": {...}, "signals": {...},
       "decisions": {...}}      journal a new surface snapshot
      {"op": "poll"}            poll with the applier's own cursor
      {"op": "poll", "since": N, "gen": "..."}   poll an explicit cursor
      {"op": "restart"}         member restart (new generation, epoch 0)
    Returns one result per step — polls carry the raw wire "response",
    the "applied" verdict and the hub's reconstructed "docs"."""
    payload: dict = {"steps": steps}
    if log_cap is not None:
        payload["log_cap"] = log_cap
    return _call("tp_delta_sim", payload)["results"]


def timerwheel_sim(steps: list[dict], bucket: dict | None = None,
                   origin_ms: int = 0) -> dict:
    """Drive the event engine's REAL time plane (native/src/timerwheel.cpp)
    — the hierarchical timer wheel and the sliding-window token bucket —
    through a scripted sequence under an injected clock. Steps:
      {"op": "schedule", "key": k, "due_ms": N}
      {"op": "cancel", "key": k}
      {"op": "advance", "now_ms": N}    -> {"fired": [keys...]}
      {"op": "next_due"}                -> {"next_due": N | -1}
      {"op": "acquire", "now_ms": N}    -> {"granted": bool}
      {"op": "available", "now_ms": N}  -> {"available": N}
    ``bucket`` is {"capacity": N, "window_ms": N} (required for acquire/
    available steps). Returns {"results": [...], "wheel": stats,
    "bucket": stats?} — deterministic byte-for-byte, no sleeps."""
    payload: dict = {"steps": steps, "origin_ms": origin_ms}
    if bucket is not None:
        payload["bucket"] = bucket
    return _call("tp_timerwheel_sim", payload)


def replay_cycle(capsule: dict, what_if: dict | None = None) -> dict:
    """Deterministically replay a flight-recorder CycleCapsule through the
    REAL decision pipeline (recorder.cpp): decode the recorded Prometheus
    body, re-run eligibility and the owner walk over the capsule's object
    snapshot, re-apply the target gates — zero network. Returns {match,
    replayed, recorded, drift, flips?, query_changed, actions}.

    ``what_if`` re-decides under altered config (keys: lookback, duration,
    grace, run_mode, enabled_resources, max_scale_per_cycle,
    hbm_threshold) and adds the ``flips`` list — exactly which decisions
    change. This is `analyze --replay` / `--what-if`'s backend."""
    payload: dict = {"capsule": capsule}
    if what_if:
        payload["what_if"] = what_if
    return _call("tp_replay_cycle", payload)


def gym_simulate(capsules: list[dict], policies: list | None = None,
                 regret_window_s: int = 600, assume_scale_down: bool = True,
                 assume_interval_s: int = 0,
                 false_pause_penalty_chip_hours: float | None = None,
                 churn_penalty_chip_hours: float | None = None) -> dict:
    """Run the policy gym (native/src/gym.cpp) over a flight-recorder
    capsule corpus: one pass, N policies scored side by side with the
    ledger's own integration math (reclaimed chip-hours vs false pauses
    vs actuation churn). ``policies`` entries are spec strings
    ("baseline", "sweep:lookback=10m", "right-size:threshold=0.8",
    "hysteresis:pause_after=3") or structured objects; None scores the
    default 3-policy panel. ``assume_scale_down`` scores dry-run corpora
    as if run_mode=scale-down (False = strict as-recorded mode, the
    ledger-parity contract). This is `analyze --gym`'s backend."""
    payload: dict = {"capsules": capsules, "regret_window_s": regret_window_s,
                     "assume_scale_down": assume_scale_down}
    if assume_interval_s:
        payload["assume_interval_s"] = assume_interval_s
    if policies:
        payload["policies"] = policies
    if false_pause_penalty_chip_hours is not None:
        payload["false_pause_penalty_chip_hours"] = false_pause_penalty_chip_hours
    if churn_penalty_chip_hours is not None:
        payload["churn_penalty_chip_hours"] = churn_penalty_chip_hours
    return _call("tp_gym_simulate", payload)


def right_size_plan(kind: str, obj: dict, idle_pods: int, idle_chips: int,
                    threshold: float = 0.8) -> dict:
    """The replica right-sizing math (gym::right_size_plan) — the ONE
    implementation shared by the daemon's --right-size split, the replay
    engine and the gym. Returns {applicable, current_replicas,
    busy_replicas, target_replicas, freed_chips, held, detail}."""
    return _call("tp_right_size_plan",
                 {"kind": kind, "object": obj, "idle_pods": idle_pods,
                  "idle_chips": idle_chips, "threshold": threshold})


def ledger_sim(top_k: int, cycles: list[dict], query: str = "") -> dict:
    """Replay scripted cycles through the REAL workload-ledger accounting
    (native/src/ledger.cpp) with injected timestamps — the deterministic
    test seam for integration math and /metrics cardinality bounding.

    Each cycle: {"now": unix_ts, "idle": [{kind, namespace, name, chips}],
    "pauses": [...], "resumes": [...]}. Returns {"workloads": <the
    /debug/workloads body for `query`>, "metrics": <classic exposition
    text>, "metrics_openmetrics": <OpenMetrics form>}."""
    return _call("tp_ledger_sim",
                 {"top_k": top_k, "cycles": cycles, "query": query})


def ledger_metric_families() -> list[str]:
    """Canonical workload-ledger metric family names served on /metrics —
    the docs drift-guard test joins this list against docs/OPERATIONS.md."""
    return _call("tp_ledger_metric_families", {})["families"]


class InformerSession:
    """In-process informer (list+watch cluster cache) session over the C
    core — the test seam for the reflector/store machinery: point it at a
    fake apiserver, mutate objects, poll `get`/`stats` for convergence,
    inject 410s/connection drops and assert the relist behavior.

    The reflector threads run inside libtpupruner.so; always `stop()` (or
    use as a context manager) so they join before the fixture goes away.
    """

    def __init__(self, api_url: str, token: str = "",
                 resources: list[str] | None = None, wait_ms: int = 5000):
        payload = {"api_url": api_url, "token": token, "wait_ms": wait_ms}
        if resources is not None:
            payload["resources"] = resources
        out = _call("tp_informer_start", payload)
        self.handle = out["handle"]
        self.synced = out["synced"]

    def stats(self) -> dict:
        return _call("tp_informer_stats", {"handle": self.handle})

    def get(self, path: str) -> dict | None:
        """Cached object for a namespaced object path, or None when the
        cache can't answer (unsynced/unwatched/absent — callers GET)."""
        out = _call("tp_informer_get", {"handle": self.handle, "path": path})
        return out["object"] if out["found"] else None

    def stop(self) -> None:
        _call("tp_informer_stop", {"handle": self.handle})

    def __enter__(self) -> "InformerSession":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def otlp_grpc_call(host: str, port: int, path: str, message_size: int,
                   timeout_ms: int = 5000, tls_ca: str | None = None) -> dict:
    """Test hook: drive the OTLP/gRPC unary client with an arbitrary-size
    zero-filled payload (otlp_grpc.cpp flow-control coverage). tls_ca
    selects gRPC-over-TLS (ALPN h2) verified against that CA bundle."""
    payload = {"host": host, "port": port, "path": path,
               "message_size": message_size, "timeout_ms": timeout_ms}
    if tls_ca is not None:
        payload["tls_ca"] = tls_ca
    return _call("tp_otlp_grpc_call", payload)
