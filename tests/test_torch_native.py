"""The port's build of the C++ core (tpu_pruner_torch.native) and the
report modes that run it: analyze --replay/--what-if, --gym and
--capacity-report, plus --trace and --signal-report over recorded capsules.

A module fixture builds the core through tpu_pruner_torch.native.build()
into build/torch_native/, then records capsule corpora with that build's
daemon (the port's own tpu_pruner_torch.testing.trace_gen drives it over
the port's hermetic fakes).
Both CLIs then run in this process on the same capsules and call the same
library: the reference's bindings are pointed at the port's loaded
library for the duration of the module. Exit codes, stdout bytes and
stderr (the port's module name read as the reference's) must be equal.
"""

import json
import os
import threading
import time

import pytest

import tpu_pruner.native
from test_torch_reports import DebugServer, assert_cli_parity
from tpu_pruner_torch import native
from tpu_pruner_torch.testing import trace_gen

STAMPS = ("--capacity", "on", "--trace", "on", "--signal-guard", "on")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{scenario: sorted capsule paths}, recorded by the port-built daemon;
    the reference's bindings use the port's library meanwhile."""
    lib_path = native.build()
    root = tmp_path_factory.mktemp("corpora")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_pruner.native, "_lib", native.load())
        out = {"lib_path": lib_path}
        for scenario, cycles, kwargs in (("defrag", 12, {"pods_per_workload": 2}),
                                         ("flapping", 12, {"seed": 2}),
                                         ("brownout", 10, {})):
            out[scenario] = trace_gen.record_corpus(
                trace_gen.generate(scenario, cycles, workloads=3, **kwargs),
                root / scenario, extra_args=STAMPS)
            assert len(out[scenario]) == cycles
        yield out


# -- the build ----------------------------------------------------------------------


def test_build_is_the_ports_own(corpora):
    build_dir = native.REPO_ROOT / "build" / "torch_native"
    assert corpora["lib_path"] == native.LIB_PATH == build_dir / "libtpupruner.so"
    assert native.DAEMON_PATH == build_dir / "tpu-pruner"
    assert os.access(native.DAEMON_PATH, os.X_OK)
    lib = native.load()
    assert lib._name == str(native.LIB_PATH) and native.load() is lib
    assert native.build() == native.LIB_PATH  # fresh: no rebuild


def fake_native_tree(root):
    (root / "include").mkdir(parents=True)
    (root / "src").mkdir()
    (root / "src" / "core.cpp").write_text(
        '#include <optional>\nextern "C" int tp_answer() { return 42; }\n')
    (root / "src" / "main.cpp").write_text("int main() { return 0; }\n")
    return root


@pytest.fixture()
def scratch_build(tmp_path, monkeypatch):
    """Point build() at a tiny source tree and a build dir of the test's own."""
    src = fake_native_tree(tmp_path / "native")
    out = tmp_path / "build"
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setattr(native, "LIB_PATH", out / "libtpupruner.so")
    monkeypatch.setattr(native, "DAEMON_PATH", out / "tpu-pruner")
    return src, out


def test_build_rebuilds_only_when_native_is_newer(scratch_build):
    src, out = scratch_build
    assert native.build() == out / "libtpupruner.so"
    assert (out / "tpu-pruner").exists() and (out / ".lock").exists()
    assert sorted(p.name for p in (out / "obj").iterdir()) == ["core.o", "main.o"]
    built = os.path.getmtime(out / "libtpupruner.so")
    native.build()
    assert os.path.getmtime(out / "libtpupruner.so") == built
    later = built + 10
    os.utime(src / "src" / "core.cpp", (later, later))
    native.build()
    assert os.path.getmtime(out / "libtpupruner.so") > built


def test_build_raises_with_the_compilers_stderr(scratch_build):
    src, out = scratch_build
    (src / "src" / "broken.cpp").write_text("int broken( { return; }\n")
    with pytest.raises(RuntimeError, match=r"native compile broken\.cpp failed") as exc:
        native.build()
    assert "broken.cpp" in str(exc.value) and "error" in str(exc.value)
    assert not (out / "libtpupruner.so").exists()


def test_concurrent_builds_run_once(scratch_build, monkeypatch):
    """The file lock serializes concurrent builds: the later ones find it fresh."""
    runs = []
    compile_and_link = native._compile_and_link

    def slow_build(*args):
        runs.append(threading.get_ident())
        time.sleep(0.5)
        compile_and_link(*args)

    monkeypatch.setattr(native, "_compile_and_link", slow_build)
    errors = []

    def build():
        try:
            native.build()
        except Exception as exc:  # reported by the assertion below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(runs) == 1


# -- --replay / --what-if -------------------------------------------------------------


def capsule_path(corpora, scenario, index):
    return str(corpora[scenario][index])


REPLAY = {
    "defrag_newest": ("defrag", -1, []),
    "brownout_stale_cycle": ("brownout", 5, []),
    "lookback_10m": ("flapping", -1, ["--what-if", "lookback=10m"]),
    "query_changing": ("flapping", -1, ["--what-if", "duration=45", "hbm_threshold=0.05"]),
    "two_groups": ("flapping", 6, ["--what-if", "run_mode=scale-down", "max_scale_per_cycle=1",
                                   "--what-if", "signal_min_coverage=0"]),
    "three_pairs_two_groups": ("brownout", -1, ["--what-if", "run_mode=scale-down",
                                                "grace=60", "--what-if", "lookback=10m"]),
    "brownout_guard_off": ("brownout", 5, ["--what-if", "signal_guard=off"]),
}


@pytest.mark.parametrize("case", sorted(REPLAY))
def test_replay_matches_reference(corpora, case):
    scenario, index, extra = REPLAY[case]
    rc, out, err = assert_cli_parity(
        ["--replay", capsule_path(corpora, scenario, index), *extra])
    assert rc == 0
    result = json.loads(out)
    if not extra:
        assert result["match"] is True and "bit-for-bit" in err
    if case == "query_changing":
        assert result["query_changed"] is True and "NOTE: this what-if" in err
    if case == "two_groups":
        assert "'signal_min_coverage': '0'" in err and len(result["flips"]) == 1
    if case == "three_pairs_two_groups":
        assert "[predicted]" in err and len(result["flips"]) == 3


def test_replay_drift_exits_1(corpora, tmp_path):
    """A capsule whose recorded decision was altered replays as drift."""
    doc = json.loads(corpora["flapping"][0].read_text())
    doc["decisions"][0]["reason"] = "SCALED"
    doc["decisions"][0]["action"] = "scale_down"
    path = tmp_path / "drifted.json"
    path.write_text(json.dumps(doc))
    rc, out, err = assert_cli_parity(["--replay", str(path)])
    assert rc == 1 and "REPLAY DRIFT" in err and "recorded:" in err
    assert json.loads(out)["match"] is False


def test_replay_from_url(corpora):
    doc = json.loads(corpora["defrag"][3].read_text())
    server = DebugServer({"/debug/cycles/4": doc})
    try:
        rc, out, _ = assert_cli_parity(["--replay", server.url + "/debug/cycles/4"])
    finally:
        server.stop()
    assert rc == 0 and json.loads(out)["match"] is True


# -- --gym --------------------------------------------------------------------------------

GYM = {
    "default_panel": ("flapping", []),
    "two_policies": ("flapping", ["--gym-policy", "baseline",
                                  "--gym-policy", "sweep:lookback=10m,grace=60"]),
    "as_recorded": ("flapping", ["--as-recorded"]),
    "assume_interval": ("brownout", ["--assume-interval", "180"]),
    "regret_window": ("flapping", ["--assume-interval", "180", "--regret-window", "60",
                                   "--gym-policy", "hysteresis:pause_after=2",
                                   "--gym-policy", "right-size:threshold=0.5"]),
    "single_capsule": ("defrag", ["--assume-interval", "180"]),
}


@pytest.mark.parametrize("case", sorted(GYM))
def test_gym_matches_reference(corpora, case):
    scenario, extra = GYM[case]
    source = (capsule_path(corpora, scenario, -1) if case == "single_capsule"
              else str(corpora[scenario][0].parent))
    rc, out, err = assert_cli_parity(["--gym", source, *extra])
    assert rc == 0 and "winner:" in err
    result = json.loads(out)
    assert result["cycles"] == (1 if case == "single_capsule" else len(corpora[scenario]))
    if case == "two_policies":
        assert len(result["policies"]) == 2
    if case == "as_recorded":
        assert "(as recorded)" in err


def test_gym_from_cycles_index_url(corpora):
    """A daemon URL: the /debug/cycles index, then each listed capsule."""
    routes = {}
    for path in corpora["flapping"]:
        doc = json.loads(path.read_text())
        routes[f"/debug/cycles/{doc['id']}"] = doc
    routes["/debug/cycles"] = {"capsules": [{"id": k.rsplit("/", 1)[1]} for k in routes]}
    server = DebugServer(routes)
    try:
        rc, out, _ = assert_cli_parity(["--gym", server.url, "--assume-interval", "180"])
        from_dir = assert_cli_parity(["--gym", str(corpora["flapping"][0].parent),
                                      "--assume-interval", "180"])
    finally:
        server.stop()
    assert rc == 0 and out == from_dir[1]


# -- --capacity-report ------------------------------------------------------------------------


def test_capacity_report_over_recorded_corpus(corpora):
    rc, out, err = assert_cli_parity(
        ["--capacity-report", str(corpora["defrag"][0].parent)])
    assert rc == 0 and "reproduced bit-for-bit" in err
    report = json.loads(out)
    assert report["capsules"] == len(corpora["defrag"]) and report["drift"] is False


def node(name, pool, chips=4):
    return {"name": name, "pool": pool, "topology": "2x2", "chips": chips}


def place(pod, on, idle, root):
    return {"pod": pod, "node": on, "chips": 4, "idle": idle, "root": root}


def synthetic_inputs(idle):
    return {"nodes": [node("a0", "sA"), node("b0", "sB"), node("spare0", "spare")],
            "placements": [place("ml/a-0", "a0", idle, "Deployment/ml/a"),
                           place("ml/r-0", "b0", True, "Deployment/ml/r"),
                           place("ml/r-1", "a0", False, "Deployment/ml/r")],
            "freed": [{"kind": "Deployment", "ns": "ml", "name": "old", "chips": 8,
                       "state": "paused"}]}


@pytest.mark.parametrize("tamper", [False, True], ids=["clean", "tampered_doc"])
def test_capacity_report_over_synthetic_stamps(tmp_path, corpora, tamper):
    """Stamps built with capacity_build (one capsule recorded without
    --capacity on among them is skipped); a tampered recorded inventory is
    drift and exits 1."""
    for cycle, (now, idle) in enumerate([(1000, False), (1060, True), (1120, True)], 1):
        inputs = synthetic_inputs(idle)
        doc = native.capacity_build(inputs)["doc"]
        if tamper and cycle == 2:
            doc["totals"]["free_chips"] += 1
        (tmp_path / f"cycle-{cycle:06d}.json").write_text(json.dumps(
            {"cycle": cycle, "now_unix": now, "capacity": {"inputs": inputs, "doc": doc}}))
    (tmp_path / "cycle-000004.json").write_text(json.dumps({"cycle": 4, "now_unix": 1180}))
    rc, out, err = assert_cli_parity(["--capacity-report", str(tmp_path)])
    report = json.loads(out)
    assert report["capsules"] == 3 and report["window_s"] == 120
    if tamper:
        assert rc == 1 and report["drifted_cycles"] == [2] and "REPLAY DRIFT" in err
    else:
        assert rc == 0 and report["drift"] is False and report["moves"]


# -- --trace and --signal-report over recorded capsules -----------------------------------------


@pytest.mark.parametrize("scenario", ["defrag", "brownout"])
def test_trace_over_recorded_capsules(corpora, scenario):
    for source in (str(corpora[scenario][0].parent), capsule_path(corpora, scenario, 2)):
        rc, out, err = assert_cli_parity(["--trace", source])
        assert rc == 0 and "timeline" in err
        assert len(json.loads(out)["trace_id"]) == 32


@pytest.mark.parametrize("index", [0, 4, 5, -1])
def test_signal_report_over_recorded_capsules(corpora, index):
    """Brownout corpus: cycles 5-6 (indices 4-5) read stale evidence."""
    rc, out, err = assert_cli_parity(
        ["--signal-report", capsule_path(corpora, "brownout", index)])
    assert rc == 0
    assert json.loads(out)["brownout"] is (index in (4, 5))

