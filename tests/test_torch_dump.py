"""tpu_pruner_torch.dump against tpu_pruner.dump, on the CPU.

``build_dump`` of both packages gets the same range series; ``main()`` of
both runs against one local ``/api/v1/query_range`` server. The dumps must
be equal apart from ``timestamp`` (the export's wall clock) and the port's
two additions, ``step_s`` (the samples' spacing, which the reference does
not stamp) and the nulls that place its ``main()``'s series in time, and
exit codes and stderr equal once the port's module name is read as the
reference's.
"""

import copy
import json
import re
import subprocess
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from test_torch_reports import normalize_stderr, run_cli
from tpu_pruner import dump as ref_dump
from tpu_pruner.native import REPO_ROOT
from tpu_pruner_torch import analyze as torch_analyze
from tpu_pruner_torch import dump as port_dump


def series(values, **labels):
    return {"metric": labels, "values": [[1000.0 + 60 * i, str(v)]
                                          for i, v in enumerate(values)]}


JOBSET = "label_jobset_sigs_k8s_io_jobset_name"
TC = [
    series([0.0, 0.0, 0.0], namespace="ml", pod="trainer-0", accelerator_id="0",
           **{JOBSET: "llm"}),
    series([0.0, 0.25, 0.0], namespace="ml", pod="trainer-0", accelerator_id="1",
           **{JOBSET: "llm"}),
    # honor_labels scrape: every identity label arrives exported_
    series([0.0, 0.0], exported_namespace="ml", exported_pod="trainer-1",
           exported_accelerator_id="3", **{"exported_" + JOBSET: "llm"}),
    series([0.0, 0.0], exported_namespace="ml", exported_pod="trainer-1",
           exported_accelerator_id="2", **{"exported_" + JOBSET: "llm"}),
    series([0.5], namespace="web", pod="solo"),  # no slice label: own slice
    series([0.0, "NaN"], namespace="web", pod="odd", accelerator_id="0", custom="s1"),
    series([0.0], namespace="ml"),  # aggregate row: no pod identity, skipped
]
HBM = [
    series([0.01, 0.0, 0.0], namespace="ml", pod="trainer-0", accelerator_id="1"),
    series([0.2, 0.3], exported_namespace="ml", exported_pod="trainer-1",
           exported_accelerator_id="3"),
    series([0.0], namespace="web", pod="nobody", accelerator_id="0"),
]

BUILD_CASES = {
    "tc_and_hbm": (TC, HBM, JOBSET, 7200, 2100),
    "tc_only": (TC, [], JOBSET, 60, 180),
    "hbm_none": (TC, None, "custom", 7200.5, 2100.0),
    "empty": ([], HBM, JOBSET, 7200, 2100),
}


def without_timestamp(doc):
    doc = dict(doc)
    assert isinstance(doc.pop("timestamp"), float)
    return doc


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_dump_matches_reference(case):
    args = BUILD_CASES[case]
    got = port_dump.build_dump(*args)
    ref = ref_dump.build_dump(*args)
    # as JSON text: key order counts, and a NaN sample equals itself
    assert json.dumps(without_timestamp(got)) == json.dumps(without_timestamp(ref))
    stamped = port_dump.build_dump(*args, step_s=60.0)
    assert list(stamped)[:2] == ["lookback_s", "step_s"] and stamped["step_s"] == 60.0
    assert json.dumps(without_timestamp(stamped)) == json.dumps(
        {"lookback_s": got["lookback_s"], "step_s": 60.0, **without_timestamp(got)})
    if case == "tc_and_hbm":
        ids = [c["id"] for c in got["chips"]]
        assert "ml/trainer-1/3" in ids and "ml/trainer-1/2" in ids
        assert next(c for c in got["chips"] if c["id"] == "ml/trainer-1/3")["hbm"] == [0.2, 0.3]
        assert [c["slice"] for c in got["chips"]][-2:] == ["web/solo", "web/odd"]


def test_build_dump_places_each_sample_at_its_step():
    """With the window's start and steps, a sample lands at its step and a
    step with none is null, in tc and hbm apart: a gap, a series that
    stopped, one that started late, timestamps a few ms off the step, and
    one off the window."""
    start, step = 1_000_000.5, 60.0

    def at(*pairs, **labels):
        return {"metric": {"namespace": "ml", "accelerator_id": "0", **labels},
                "values": [[start + step * k + jitter, str(v)] for k, v, jitter in pairs]}

    tc = [at((0, 0.0, 0), (1, 0.5, 0.001), (3, 0.0, -0.002), (5, 0.25, 0), pod="gap"),
          at((0, 0.0, 0), (1, 0.0, 0), pod="stopped"),
          at((4, 0.0, 0), (5, 0.0, 0), (6, 1.0, 0), pod="late")]
    hbm = [at((1, 0.1, 0), (2, 0.2, 0), (5, 0.5, 0), pod="gap"),
           at((-1, 0.9, 0), (0, 0.3, 0), pod="stopped")]
    doc = port_dump.build_dump(tc, hbm, JOBSET, 7200, 360, step, start, 6)
    got = {c["id"]: (c["tc"], c.get("hbm")) for c in doc["chips"]}
    assert got == {
        "ml/gap/0": ([0.0, 0.5, None, 0.0, None, 0.25], [None, 0.1, 0.2, None, None, 0.5]),
        "ml/stopped/0": ([0.0, 0.0, None, None, None, None], [0.3, None, None, None, None, None]),
        "ml/late/0": ([None, None, None, None, 0.0, 0.0], None)}
    assert doc["step_s"] == step
    # without the window, as the reference lists them
    assert port_dump.build_dump(tc, hbm, JOBSET, 7200, 360, step)["chips"][0]["tc"] == [
        0.0, 0.5, 0.0, 0.25]


def test_label_matches_reference():
    for metric in ({"pod": "a"}, {"exported_pod": "b"}, {"pod": "", "exported_pod": "c"},
                   {}):
        assert port_dump._label(metric, "pod") == ref_dump._label(metric, "pod")


def steps_of(start: float, end: float, step: float) -> int:
    """The evaluation times of query_range: start, start + step, ... <= end."""
    return (round(end * 1000) - round(start * 1000)) // round(step * 1000) + 1


def rebased(answer, params):
    """``answer`` with each series' timestamps moved onto the request's steps,
    its last value at the newest step, as Prometheus answers for a series
    scraped up to now."""
    result = (answer.get("data") or {}).get("result")
    if not isinstance(result, list) or "start" not in params:
        return answer
    start, end = float(params["start"][0]), float(params["end"][0])
    step = float(params["step"][0])
    steps = steps_of(start, end, step)
    answer = copy.deepcopy(answer)
    for series in answer["data"]["result"]:
        values = series.get("values", [])
        series["values"] = [[start + step * (steps - len(values) + i), v]
                            for i, (_, v) in enumerate(values)]
    return answer


class QueryRange:
    """A Prometheus stand-in answering /api/v1/query_range by query text,
    each series' samples at the request's newest steps; records each
    request's query and Authorization header."""

    def __init__(self, answers):
        self.requests = []
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                params = urllib.parse.parse_qs(url.query)
                query = params.get("query", [""])[0]
                srv.requests.append((url.path, query, self.headers.get("Authorization"),
                                     params.get("step", [""])[0]))
                answer = answers.get(query, {"status": "error", "error": f"unknown {query}"})
                body = json.dumps(rebased(answer, params)).encode()
                self.send_response(200)
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


def matrix(result):
    return {"status": "success", "data": {"resultType": "matrix", "result": result}}


PERCENT_TC = [series([0.0, 50.0, 0.0], namespace="ml", pod="p", accelerator_id="0")]
PERCENT_HBM = [series([12.5, 0.0], namespace="ml", pod="p", accelerator_id="0")]


@pytest.fixture(scope="module")
def prom():
    srv = QueryRange({
        "tensorcore_utilization": matrix(TC),
        "hbm_memory_bandwidth_utilization": matrix(HBM),
        "duty_cycle_percent": matrix(PERCENT_TC),
        "hbm_percent": matrix(PERCENT_HBM),
        "nothing": matrix([]),
        "instant": {"status": "success", "data": {"resultType": "vector", "result": []}},
    })
    yield srv
    srv.stop()


MAIN_CASES = {
    "defaults": [],
    "percent": ["--tc-metric", "duty_cycle_percent", "--hbm-metric", "hbm_percent",
                "--percent"],
    "no_hbm_series": ["--hbm-metric", ""],
    "stream_export": ["--window-s", "180", "--lookback-s", "2100", "--step-s", "60",
                      "--slice-label", "custom", "--pod-age-s", "60"],
    "empty_result_warns": ["--tc-metric", "nothing"],
    "prometheus_error": ["--tc-metric", "rate(broken"],
    "not_a_matrix": ["--hbm-metric", "instant"],
    "missing_url": None,
}

TIMESTAMP = re.compile(r'"timestamp": [0-9.e+-]+')
STEP = re.compile(r'"step_s": ([0-9.e+-]+), ')


def without_nulls(text: str) -> str:
    """A dump's text with its nulls (steps with no sample) taken out of each
    series and ``step_s`` out of the document."""
    doc = json.loads(text)
    doc.pop("step_s", None)
    for chip in doc["chips"]:
        for key in ("tc", "hbm"):
            if key in chip:
                chip[key] = [v for v in chip[key] if v is not None]
    return json.dumps(doc)


@pytest.mark.parametrize("case", sorted(MAIN_CASES))
def test_main_matches_reference(prom, monkeypatch, case):
    monkeypatch.setenv("PROMETHEUS_TOKEN", "s3cret")
    extra = MAIN_CASES[case]
    argv = [] if extra is None else ["--prometheus-url", prom.url + "/", *extra]
    first = len(prom.requests)
    ref = run_cli(ref_dump.main, argv)
    middle = len(prom.requests)
    got = run_cli(port_dump.main, argv)
    assert got[0] == ref[0]
    assert bool(got[1]) == bool(ref[1])
    if got[1]:
        # the port stamps --step-s on its document, after lookback_s, and
        # places each sample at its step: every series spans the window, the
        # steps before a series' first sample null
        assert (TIMESTAMP.sub("T", without_nulls(got[1]))
                == TIMESTAMP.sub("T", without_nulls(ref[1])))
        step = argv[argv.index("--step-s") + 1] if "--step-s" in argv else "300"
        window = argv[argv.index("--window-s") + 1] if "--window-s" in argv else "2100"
        assert STEP.findall(got[1]) == [str(float(step))]
        doc = json.loads(got[1])
        assert list(doc)[:2] == ["lookback_s", "step_s"]
        steps = int(float(window) // float(step)) + 1
        if doc["chips"]:  # placed in time, as analyze --sweep takes them
            assert torch_analyze.ragged_chips(doc) == 0
        for chip, want in zip(doc["chips"], json.loads(ref[1])["chips"], strict=True):
            for key in ("tc", "hbm"):
                if key in want:
                    n = len(want[key])
                    assert chip[key][:steps - n] == [None] * (steps - n)
                    assert json.dumps(chip[key][steps - n:]) == json.dumps(want[key])
                    assert len(chip[key]) == steps
    assert normalize_stderr(got[2], "dump") == normalize_stderr(ref[2], "dump")
    # both sent the same queries, with the bearer token, to query_range
    asked = prom.requests[middle:]
    assert asked == prom.requests[first:middle]
    assert all(r[0] == "/api/v1/query_range" and r[2] == "Bearer s3cret" for r in asked)
    if case == "percent":
        doc = json.loads(got[1])
        assert doc["chips"][0]["tc"] == [None] * 5 + [0.0, 0.5, 0.0]
        assert doc["chips"][0]["hbm"] == [None] * 6 + [0.125, 0.0]
    if case == "empty_result_warns":
        assert "returned no pod-keyed series" in got[2] and json.loads(got[1])["chips"] == []
    if case in ("prometheus_error", "not_a_matrix"):
        assert got[0] == 1 and got[1] == ""
    if case == "missing_url":
        assert got[0] == 2
    if case == "stream_export":
        doc = json.loads(got[1])
        assert doc["lookback_s"] == 2100.0 and asked[0][3] == "60"


def test_module_entry_point_feeds_analyze(prom, tmp_path):
    """python -m tpu_pruner_torch.dump writes a dump that
    python -m tpu_pruner_torch.analyze reads, as the reference's pair does."""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "JAX_PLATFORMS": "cpu"}
    outs = []
    for dump_module, analyze_module, extra in (
            ("tpu_pruner.dump", "tpu_pruner.analyze", []),
            ("tpu_pruner_torch.dump", "tpu_pruner_torch.analyze", ["--device", "cpu"])):
        proc = subprocess.run([sys.executable, "-m", dump_module, "--prometheus-url", prom.url],
                              capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
                              env=env)
        assert proc.returncode == 0, proc.stderr
        path = tmp_path / f"{dump_module}.json"
        path.write_text(proc.stdout)
        proc = subprocess.run([sys.executable, "-m", analyze_module, str(path), *extra],
                              capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
                              env=env)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1]
    assert json.loads(outs[1])["num_chips"] == 6
