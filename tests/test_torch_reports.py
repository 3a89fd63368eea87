"""The host-only report modes of tpu_pruner_torch.analyze against
tpu_pruner.analyze, on the CPU.

Both CLIs run in this process on the same argv and the same documents,
written by the test or served from a local HTTP server. Their exit codes
must be equal, their stdout byte-equal, and their stderr equal once the
port's module name is read as the reference's. An argparse error also
prints the usage block, which lists every option: there the port's own
``--device``, ``--profile``, ``--follow-fleet``, ``--sweep`` and ``--step-s``
options are taken out and whitespace (line
wrapping, which depends on the length of the program name) collapsed
before comparing; the error line itself is compared byte for byte.
"""

import contextlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tpu_pruner import analyze as jax_analyze
from tpu_pruner_torch import analyze as torch_analyze

REF_PROG = "python -m tpu_pruner.analyze"


def run_cli(main, argv):
    """(exit code, stdout, stderr) of one in-process CLI run, as the
    interpreter would end it: SystemExit(str) prints and exits 1."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code
            if rc is None:
                rc = 0
            elif not isinstance(rc, int):
                print(rc, file=err)
                rc = 1
    return rc, out.getvalue(), err.getvalue()


def normalize_stderr(err, module="analyze"):
    err = err.replace(f"tpu_pruner_torch.{module}", f"tpu_pruner.{module}")
    if not err.startswith("usage: "):
        return err
    marker = f"\npython -m tpu_pruner.{module}: error: "
    usage, sep, message = err.partition(marker)
    for own in ("[--device {cuda,cpu}]", "[--profile PATH]", "[--follow-fleet]",
                "[--sweep KEY=VALUE [KEY=VALUE ...]]", "[--step-s STEP_S]"):
        usage = usage.replace(own, "")
    usage = " ".join(usage.split())
    return usage + sep + message


def assert_cli_parity(argv):
    """Run both CLIs on ``argv``; returns the reference's result."""
    ref = run_cli(jax_analyze.main, list(argv))
    got = run_cli(torch_analyze.main, list(argv))
    assert got[0] == ref[0], (got[2], ref[2])
    assert got[1] == ref[1]
    assert normalize_stderr(got[2]) == normalize_stderr(ref[2])
    return ref


class DebugServer:
    """A daemon's metrics port stand-in: serves ``routes`` (path -> JSON
    document) on 127.0.0.1 and answers 404 for any other path."""

    def __init__(self, routes):
        routes = dict(routes)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                doc = routes.get(self.path)
                body = json.dumps(doc if doc is not None else {"error": "not found"}).encode()
                self.send_response(200 if doc is not None else 404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


# -- documents ---------------------------------------------------------------

def decision(cycle, ts, pod="p0", ns="ml", **extra):
    return {"cycle": cycle, "ts": ts, "namespace": ns, "pod": pod, **extra}


DECISIONS = [
    decision(3, "2026-01-01T00:06:00Z", reason="SCALED", action="scale_down",
             signal={"metric": "tensorcore_utilization", "value": 0.0},
             lookback_s=2100, owner_chain=["Pod/ml/p0", "ReplicaSet/ml/w-1",
                                           "Deployment/ml/w"],
             root={"kind": "Deployment", "namespace": "ml", "name": "w"},
             trace_id="0123456789abcdef0123456789abcdef"),
    decision(1, "2026-01-01T00:00:00Z", reason="BELOW_MIN_AGE", action="none",
             detail="pod age 60s < lookback 2100s"),
    decision(1, "2026-01-01T00:00:00Z", pod="p1", reason="DRY_RUN"),
    decision(2, "2026-01-01T00:03:00Z", reason="DRY_RUN",
             signal={"metric": "tensorcore_utilization", "value": 0.0},
             owner_chain=[], root=None),
]

CAPSULE_DECISIONS = [
    {"namespace": "gym", "pod": "w-0-abc", "reason": "DRY_RUN", "action": "none"},
    {"namespace": "gym", "pod": "w-1-def", "reason": "SIGNAL_STALE"},
]

SPANS = [
    {"name": "evaluate", "start_us": 0, "end_us": 5400},
    {"name": "query", "start_us": 120, "end_us": 2210,
     "attrs": {"series": 6, "bytes": 2048}},
    {"name": "resolve", "start_us": 2300, "end_us": 4100,
     "events": [{"name": f"walk-{i}"} for i in range(6)]},
    {"name": "actuate", "start_us": 4100, "end_us": 4100, "error": True,
     "error_message": "patch refused"},
    {"name": "signal", "start_us": 2210, "end_us": 2290, "error": True},
]

SIGNAL = {
    "cycle": 7, "coverage_ratio": 0.5, "brownout": True,
    "pods": {"healthy": 2, "stale": 1, "gappy": 1},
    "details": [
        {"namespace": "gym", "pod": "w-0-abc", "verdict": "healthy",
         "sample_count": 70, "last_age_s": 12.0},
        {"namespace": "gym", "pod": "w-1-def", "verdict": "stale",
         "sample_count": 70, "last_age_s": 4000.0},
        {"namespace": "gym", "pod": "w-2-ghi", "verdict": "gappy",
         "sample_count": 9.0, "last_age_s": 30.4},
        {"namespace": "other", "pod": "lost", "verdict": "absent"},
    ],
}


def capsule(cycle, signal=None, trace=None, decisions=CAPSULE_DECISIONS):
    c = {"id": f"cycle-{cycle:06d}", "cycle": cycle, "now_unix": 1000 + 60 * cycle,
         "prom": {"query": "up"}, "decisions": decisions,
         "config": {"signal_scrape_interval_s": 30, "signal_max_age_s": 300,
                    "signal_min_coverage": 0.9}}
    if signal is not None:
        c["signal"] = signal
    if trace is not None:
        c["trace"] = trace
    return c


TRACE_ID = "a1b2c3d4e5f60718293a4b5c6d7e8f90"
TRACE_DOC = {"trace_id": TRACE_ID, "cycle": 7, "trigger": "dirty", "root_ms": 5.4,
             "root": {"name": "evaluate", "duration_ms": 5.4, "ingress_lag_ms": 81},
             "breached": True, "span_tree": SPANS}
OTHER_TRACE = {"trace_id": "f" * 32, "cycle": 99, "trigger": "timer",
               "root": {"name": "evaluate", "duration_ms": 0.25},
               "span_tree": [{"name": "evaluate", "start_us": 0, "end_us": 250}]}
TRACES_INDEX = {
    "enabled": True, "retained": 2, "pinned": 1, "completed_total": 40,
    "evicted_total": 38,
    "slo": {"enabled": True, "slo_ms": 5, "breaches": 1, "burn_ratio": 0.025,
            "bad": 1, "good": 39,
            "worst": [{"trace_id": TRACE_ID, "cycle": 7, "trigger": "dirty",
                       "root_ms": 5.4, "breached": True}]},
    "traces": [{"trace_id": TRACE_ID, "cycle": 7, "trigger": "dirty", "root_ms": 5.4},
               {"trace_id": "f" * 32, "cycle": 99, "trigger": "timer",
                "root_ms": 0.25}],
}
TRACES_NO_SLO = {"enabled": True, "retained": 3, "completed_total": 3,
                 "traces": [{"trace_id": "1" * 32, "cycle": 1, "trigger": "cycle",
                             "root_ms": 0.5},
                            {"trace_id": "2" * 32, "cycle": 2, "trigger": "cycle",
                             "root_ms": 7.25, "breached": True},
                            {"trace_id": "3" * 32, "cycle": 3, "trigger": "probe",
                             "root_ms": 1.0}]}


def account(cluster, epoch, name, ns, chips, reclaimed, idle, active=0.0,
            pauses=0, resumes=0, state="paused", kind="Deployment"):
    r = {"kind": kind, "namespace": ns, "name": name, "chips": chips,
         "state": state, "idle_seconds": idle, "active_seconds": active,
         "reclaimed_chip_seconds": reclaimed, "pauses": pauses, "resumes": resumes}
    if cluster is not None:
        r.update(cluster=cluster, epoch=epoch, schema=2,
                 workload=f"{kind}/{ns}/{name}")
    return r


CLUSTER_A = [account("us-east", 5, "train", "ml", 16, 123456.789, 7716.04, 10.5, 2, 1),
             account("us-east", 5, "serve", "inference", 4, 0.0, 0.0, 3600.0,
                     state="active"),
             account("us-east", 4, "nb", "ml", 8, 3601.3333333, 450.166666, 1.0, 1)]
CLUSTER_B = [account("eu-west", 3, "train", "ml", 32, 99999.5, 3124.984375, 0.0, 1),
             account("eu-west", 3, "sweep", "research", 64, 2.0e6, 31250.0, 0.0, 3, 2,
                     kind="JobSet")]
LEDGERS = {
    "schema1": [account(None, 0, "train", "ml", 16, 7200.25, 450.015625, 0.0, 1),
                account(None, 0, "serve", "inference", 4, 0.0, 0.0, 60.0,
                        state="active")],
    "cluster_a": CLUSTER_A,
    "cluster_b": CLUSTER_B,
    "stale_a": [account("us-east", 4, "train", "ml", 16, 1.0, 1.0)],
    "diverge_a": [dict(CLUSTER_A[0], pauses=9), *CLUSTER_A[1:]],
    "mixed": [CLUSTER_A[0], account(None, 0, "x", "ml", 4, 1.0, 1.0)],
    "empty": [],
}
WORKLOADS = {"cluster": "stub", "schema": 2, "epoch": 1, "workloads": [
    account("stub", 1, "w", "ml", 4, 240.0, 60.0, state="idle")]}


@pytest.fixture(scope="module")
def server():
    routes = {
        "/debug/decisions": {"decisions": DECISIONS},
        "/debug/workloads": WORKLOADS,
        "/debug/signals": SIGNAL,
        "/debug/signals-off": {"enabled": False},
        "/debug/signals-healthy": {"cycle": 3, "coverage_ratio": 1.0,
                                   "pods": {"healthy": 2}, "details": []},
        "/debug/cycles/7": capsule(7, signal=dict(SIGNAL, brownout=False)),
        "/debug/traces": TRACES_INDEX,
        "/debug/traces-no-slo": TRACES_NO_SLO,
        "/debug/traces-off": {"enabled": False},
        "/debug/traces-empty": {"enabled": False, "traces": []},
        "/debug/traces-none": {"retained": 0, "slo": {"enabled": False}},
        f"/debug/traces/{TRACE_ID}": TRACE_DOC,
        f"/debug/traces/{'f' * 32}": OTHER_TRACE,
    }
    srv = DebugServer(routes)
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Path of every document the host-only cases read, by name."""
    root = tmp_path_factory.mktemp("reports")
    paths = {}

    audit = root / "audit.jsonl"
    lines = [json.dumps(r) for r in DECISIONS]
    lines.insert(2, "")
    audit.write_text("\n".join(lines) + '\n{"cycle": 4, "namespace": "ml", "po')
    paths["audit"] = audit

    for name, records in LEDGERS.items():
        path = root / f"{name}.jsonl"
        text = "".join(json.dumps(r) + "\n" for r in records)
        if name == "cluster_b":
            text += '{"cluster": "eu-west", "epo\n'  # torn tail line
        path.write_text(text)
        paths[name] = path

    for name, doc in {
        "capsule_signal": capsule(7, signal=json.loads(json.dumps(SIGNAL))),
        "capsule_healthy": capsule(8, signal={"cycle": 8, "coverage_ratio": 1.0,
                                              "pods": {"healthy": 1},
                                              "details": [SIGNAL["details"][0]],
                                              "thresholds": {"max_age_s": 60}}),
        "capsule_plain": capsule(9),
        "capsule_trace": capsule(7, trace={"trace_id": TRACE_ID, "trigger": "cycle",
                                           "spans": SPANS}),
        "capsule_trace_empty": capsule(5, trace={"trace_id": "e" * 32, "spans": []},
                                       decisions=[]),
    }.items():
        path = root / f"{name}.json"
        path.write_text(json.dumps(doc))
        paths[name] = path

    flight = root / "flight"
    flight.mkdir()
    (flight / "cycle-000001.json").write_text(json.dumps(
        capsule(1, trace={"trace_id": "d" * 32, "trigger": "cycle",
                          "spans": SPANS[:2]})))
    (flight / "cycle-000002.json").write_text(json.dumps(
        capsule(2, trace={"trace_id": "c" * 32, "trigger": "anti_entropy",
                          "spans": SPANS[1:]})))
    (flight / "cycle-000003.json").write_text(json.dumps(capsule(3)))
    (flight / "notes.json").write_text("{}")
    paths["flight"] = flight
    empty = root / "empty-flight"
    empty.mkdir()
    paths["empty_flight"] = empty
    paths["dump"] = root / "dump.json"
    paths["dump"].write_text(json.dumps({"chips": [
        {"slice": "ml/a", "id": "c0", "tc": [0.0] * 4, "pod_age_s": 7200}]}))
    return paths


def expand(argv, files, url):
    """argv with "@name" replaced by the path of that document and
    "URL" by the server's base URL."""
    out = []
    for a in argv:
        if a.startswith("@"):
            a = str(files[a[1:]])
        out.append(a.replace("URL", url))
    return out


# -- --explain -----------------------------------------------------------------

EXPLAIN = {
    "audit_log_with_torn_line": ["--explain", "ml/p0", "--audit-log", "@audit"],
    "other_pod": ["--explain", "ml/p1", "--audit-log", "@audit"],
    "no_records": ["--explain", "ml/gone", "--audit-log", "@audit"],
    "no_slash": ["--explain", "p0", "--audit-log", "@audit"],
    "bare_url": ["--explain", "ml/p0", "--decisions-url", "URL"],
    "bare_url_slash": ["--explain", "ml/p0", "--decisions-url", "URL/"],
    "full_url": ["--explain", "ml/p0", "--decisions-url", "URL/debug/decisions"],
}


@pytest.mark.parametrize("case", sorted(EXPLAIN))
def test_explain_matches_reference(files, server, case):
    rc, out, err = assert_cli_parity(expand(EXPLAIN[case], files, server.url))
    if case == "audit_log_with_torn_line":
        assert rc == 0 and "WARNING: skipping unparseable audit line 6" in err
        cycles = [d["cycle"] for d in json.loads(out)["decisions"]]
        assert cycles == [1, 2, 3]
    if case == "no_slash":
        assert rc == 2 and out == ""


# -- --fleet-report ------------------------------------------------------------

FLEET = {
    "schema1_alone": ["@schema1"],
    "two_clusters": ["@cluster_a", "@cluster_b"],
    "stale_duplicate_loses_by_epoch": ["@stale_a", "@cluster_a", "@cluster_b"],
    "same_file_twice": ["@cluster_a", "@cluster_a"],
    "equal_epoch_divergence": ["@cluster_a", "@diverge_a"],
    "schema1_in_merge": ["@schema1", "@cluster_a"],
    "mixed_schema": ["@mixed"],
    "empty": ["@empty"],
    "empty_merges": ["@empty", "@cluster_b"],
    "workloads_url": ["@cluster_a", "URL"],
    "workloads_url_alone": ["URL/debug/workloads"],
}


def fleet_argv(sources):
    argv = ["--fleet-report"]
    for s in sources:
        argv += ["--workloads-url" if s.startswith("URL") else "--ledger-file", s]
    return argv


@pytest.mark.parametrize("case", sorted(FLEET))
def test_fleet_report_matches_reference(files, server, case):
    rc, out, err = assert_cli_parity(expand(fleet_argv(FLEET[case]), files, server.url))
    if case in ("equal_epoch_divergence", "schema1_in_merge", "mixed_schema"):
        assert rc == 1 and out == ""
    if case == "stale_duplicate_loses_by_epoch":
        doc = json.loads(out)
        assert [c["epoch"] for c in doc["clusters"]] == [3, 5]
        assert doc["tracked_workloads"] == 5
        # raw seconds are sums of the inputs, never rounded
        assert doc["fleet_totals"]["reclaimed_chip_seconds"] == (
            99999.5 + 2.0e6 + 123456.789 + 0.0 + 3601.3333333)


def test_merged_ledger_out_round_trips(files, tmp_path):
    """--merged-ledger-out writes the same checkpoint from both CLIs, and
    that checkpoint read back alone gives the merge's report again."""
    merged = tmp_path / "merged.jsonl"
    argv = fleet_argv(["@stale_a", "@cluster_a", "@cluster_b"]) + [
        "--merged-ledger-out", str(merged)]
    argv = expand(argv, files, "")
    ref = run_cli(jax_analyze.main, argv)
    ref_merged = merged.read_text()
    merged.unlink()
    got = run_cli(torch_analyze.main, argv)
    assert got[0] == ref[0] == 0 and got[1] == ref[1]
    assert normalize_stderr(got[2]) == normalize_stderr(ref[2])
    assert merged.read_text() == ref_merged
    assert "wrote merged checkpoint (5 account(s), 2 cluster(s))" in got[2]
    again = assert_cli_parity(["--fleet-report", "--ledger-file", str(merged)])
    assert again[1] == got[1]


# -- --signal-report -------------------------------------------------------------

SIGNAL_CASES = {
    "capsule_with_signal": ["@capsule_signal"],
    "capsule_own_thresholds": ["@capsule_healthy"],
    "capsule_without_signal": ["@capsule_plain"],
    "capsule_url": ["URL/debug/cycles/7"],
    "live_brownout_bare_url": ["URL"],
    "live_healthy": ["URL/debug/signals-healthy"],
    "live_disabled": ["URL/debug/signals-off"],
}


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_signal_report_matches_reference(files, server, case):
    argv = ["--signal-report", *SIGNAL_CASES[case]]
    rc, out, err = assert_cli_parity(expand(argv, files, server.url))
    if case in ("capsule_without_signal", "live_disabled"):
        assert rc == 1 and out == ""
    if case == "live_brownout_bare_url":
        assert "BROWNOUT" in err and json.loads(out)["brownout"] is True


# -- --trace and --slow ----------------------------------------------------------

TRACE_CASES = {
    "capsule_file": ["--trace", "@capsule_trace"],
    "capsule_empty_spans": ["--trace", "@capsule_trace_empty"],
    "flight_dir_newest_stamp": ["--trace", "@flight"],
    "capsule_without_stamp": ["--trace", "@capsule_plain"],
    "empty_flight_dir": ["--trace", "@empty_flight"],
    "id_with_traces_url": ["--trace", TRACE_ID, "--traces-url", "URL"],
    "id_with_full_traces_url": ["--trace", "f" * 32, "--traces-url",
                                "URL/debug/traces"],
    "id_without_traces_url": ["--trace", TRACE_ID],
    "bare_url_newest": ["--trace", "URL/"],
    "per_trace_url_joins_capsule": ["--trace", f"URL/debug/traces/{TRACE_ID}"],
    "per_trace_url_no_capsule": ["--trace", f"URL/debug/traces/{'f' * 32}"],
    "no_retained_traces": ["--trace", "URL/debug/traces-empty"],
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_matches_reference(files, server, case):
    rc, out, err = assert_cli_parity(expand(TRACE_CASES[case], files, server.url))
    if case in ("capsule_without_stamp", "empty_flight_dir", "id_without_traces_url",
                "no_retained_traces"):
        assert rc == 1 and out == ""
    if case == "bare_url_newest":
        doc = json.loads(out)
        assert doc["trace_id"] == TRACE_ID and len(doc["decisions"]) == 2
        assert "SLO BREACH" in err and "|" in err
    if case == "flight_dir_newest_stamp":
        assert json.loads(out)["trace_id"] == "c" * 32


SLOW_CASES = {
    "slo_enabled_bare_url": "URL",
    "slo_disabled": "URL/debug/traces-no-slo",
    "tracing_disabled": "URL/debug/traces-off",
    "nothing_retained": "URL/debug/traces-none",
}


@pytest.mark.parametrize("case", sorted(SLOW_CASES))
def test_slow_matches_reference(server, case):
    """The hint line names each package's own module; the comparison reads
    the port's name as the reference's."""
    argv = ["--slow", SLOW_CASES[case].replace("URL", server.url)]
    rc, out, err = assert_cli_parity(argv)
    got = run_cli(torch_analyze.main, argv)
    if case == "tracing_disabled":
        assert rc == 1 and out == ""
    if case in ("slo_enabled_bare_url", "slo_disabled"):
        assert "python -m tpu_pruner_torch.analyze --trace <id>" in got[2]
    if case == "slo_disabled":
        ids = [line.split()[0] for line in err.splitlines() if line[:1].isdigit()]
        assert ids == ["2" * 32, "3" * 32, "1" * 32]


# -- argument errors and dispatch order (tpu_pruner/analyze.py main) ----------------

ERRORS = {
    "trace_with_gym": ["--trace", "x", "--gym", "g"],
    "trace_with_slow": ["--trace", "x", "--slow", "URL"],
    "traces_url_alone": ["--traces-url", "URL"],
    "traces_url_with_gym": ["--traces-url", "URL", "--gym", "g"],
    "slow_with_replay": ["--slow", "URL", "--replay", "r"],
    "slow_with_signal_report": ["--slow", "URL", "--signal-report", "s"],
    "gym_with_replay": ["--gym", "g", "--replay", "r"],
    "gym_with_capacity_report": ["--gym", "g", "--capacity-report", "c"],
    "gym_policy_alone": ["--gym-policy", "baseline", "--gym-policy", "hysteresis"],
    "as_recorded_alone": ["--as-recorded"],
    "gym_policy_with_capacity": ["--gym-policy", "baseline", "--capacity-report", "c"],
    "capacity_with_replay": ["--capacity-report", "c", "--replay", "r"],
    "capacity_with_explain": ["--capacity-report", "c", "--explain", "ml/p"],
    "signal_with_fleet": ["--signal-report", "s", "--fleet-report"],
    "replay_with_explain": ["--replay", "r", "--explain", "ml/p"],
    "replay_with_fleet": ["--replay", "r", "--fleet-report"],
    "what_if_alone": ["--what-if", "a=1", "b=2", "--what-if", "c=3"],
    "what_if_with_fleet": ["--what-if", "a=1", "--fleet-report"],
    "fleet_with_explain": ["--fleet-report", "--explain", "ml/p"],
    "fleet_without_sources": ["--fleet-report"],
    "ledger_file_alone": ["--ledger-file", "@cluster_a"],
    "workloads_url_alone": ["--workloads-url", "URL"],
    "merged_out_alone": ["--merged-ledger-out", "m.jsonl"],
    "merged_out_with_explain": ["--merged-ledger-out", "m.jsonl", "--explain", "ml/p"],
    "explain_without_source": ["--explain", "ml/p"],
    "explain_with_both_sources": ["--explain", "ml/p", "--audit-log", "@audit",
                                  "--decisions-url", "URL"],
    "audit_log_alone": ["--audit-log", "@audit"],
    "decisions_url_alone": ["@dump", "--decisions-url", "URL"],
    "no_dump": [],
    "no_dump_with_quantize": ["--quantize"],
    "window_chunks_zero": ["@dump", "--window-chunks", "0"],
    "stream_with_shard": ["@dump", "--stream", "s.npz", "--shard"],
    "missing_argument": ["--explain"],
    "bad_int": ["--gym", "g", "--regret-window", "ten"],
    "unknown_option": ["@dump", "--frobnicate"],
    "two_dumps": ["@dump", "@dump"],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_argument_errors_match_reference(files, server, case):
    """Every parser.error branch of the dispatch, in the reference's order
    (the order decides which error a user sees), plus argparse's own."""
    rc, out, err = assert_cli_parity(expand(ERRORS[case], files, server.url))
    assert rc == 2 and out == ""
    assert f"{REF_PROG}: error: " in err


def test_what_if_without_equals_is_refused(files):
    """A --what-if pair without '=' is refused before the C core is asked."""
    rc, out, err = assert_cli_parity(
        ["--replay", str(files["capsule_plain"]), "--what-if", "lookback=10m", "bogus"])
    assert rc == 2 and "--what-if expects key=value, got 'bogus'" in err


def test_empty_corpus_is_refused(files):
    """--gym and --capacity-report over a directory with no capsule exit 1
    before the C core is asked; --capacity-report over capsules without a
    capacity stamp too."""
    for argv in (["--gym", str(files["empty_flight"])],
                 ["--capacity-report", str(files["empty_flight"])],
                 ["--capacity-report", str(files["flight"])]):
        rc, out, err = assert_cli_parity(argv)
        assert rc == 1 and out == "" and err
