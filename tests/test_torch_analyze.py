"""tpu_pruner_torch.analyze against tpu_pruner.analyze, on the CPU.

Both CLIs read the same dumps; their stdout JSON lines must be equal. The
port runs with ``--device cpu`` (the plain versions of its kernels).
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from tpu_pruner import analyze as jax_analyze
from tpu_pruner.native import REPO_ROOT
from tpu_pruner_torch import analyze as torch_analyze
from tpu_pruner_torch import obs


def chip(slice_name, tc, hbm=None, age=7200, chip_id=None):
    c = {"slice": slice_name, "tc": tc, "pod_age_s": age}
    if hbm is not None:
        c["hbm"] = hbm
    if chip_id is not None:
        c["id"] = chip_id
    return c


# The dumps of tests/test_analyze.py's batch-mode cases, plus edge rows.
DUMPS = {
    "reclaimable": {"chips": [
        chip("ml/idle-a", [0.0] * 8),
        chip("ml/idle-a", [0.0] * 8),
        chip("ml/busy-b", [0.0, 0.5, 0.0, 0.0]),
        chip("ml/busy-b", [0.0] * 4),
    ]},
    "hbm_rescue": {"hbm_threshold": 0.05, "chips": [
        chip("ml/streaming", [0.0] * 4, hbm=[0.2] * 4),
        chip("ml/truly-idle", [0.0] * 4, hbm=[0.0] * 4),
    ]},
    "age_gate": {"chips": [
        chip("ml/young", [0.0] * 4, age=60),
        chip("ml/old", [0.0] * 4, age=9999),
    ]},
    "hbm_longer_than_tc": {"hbm_threshold": 0.05, "chips": [
        chip("ml/s", [0.0], hbm=[0.2, 0.2, 0.2]),
        chip("ml/t", [0.0], hbm=[0.0]),
    ]},
    "ragged": {"chips": [
        chip("ml/ragged", [0.0] * 3),
        chip("ml/ragged", [0.0] * 9),
    ]},
    "uneven_11_chips": {"hbm_threshold": 0.05, "chips": [
        *[chip("ml/idle", [0.0] * 6, hbm=[0.0] * 6) for _ in range(4)],
        *[chip("ml/busy", [0.0, 0.7, 0.0], hbm=[0.1] * 3) for _ in range(3)],
        *[chip("ml/hbm-active", [0.0] * 6, hbm=[0.2] * 6) for _ in range(4)],
    ]},
    "interleaved": {"hbm_threshold": 0.05, "chips": [
        chip("ml/idle", [0.0] * 6, hbm=[0.0] * 6, chip_id="c"),
        chip("ml/busy", [0.0, 0.7, 0.0], hbm=[0.1] * 3),
        chip("ml/idle", [0.0] * 6, hbm=[0.0] * 6, chip_id="a"),
        chip("ml/hbm-active", [0.0] * 6, hbm=[0.2] * 6),
        chip("ml/busy", [0.0] * 3, hbm=[0.1] * 3),
        chip("ml/idle", [0.0] * 6, hbm=[0.0] * 6, chip_id="b"),
    ]},
    "empty_series_and_subnormal": {"chips": [
        chip("ml/gap", []),
        chip("ml/gap", [0.0, 0.0]),
        chip("ml/tiny", [1e-40, 0.0]),
        chip("ml/unaligned", [0.0043, 0.0], hbm=[0.0437]),
    ]},
}
ARGS = {
    "default": [],
    "quantize": ["--quantize"],
    "lookback_override": ["--lookback-s", "30"],
    "threshold_override": ["--hbm-threshold", "0.1", "--quantize"],
}


def run_in_process(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue().strip().splitlines()[-1], err.getvalue()


@pytest.mark.parametrize("args", sorted(ARGS))
@pytest.mark.parametrize("dump", sorted(DUMPS))
def test_analyze_json_matches_reference(tmp_path, dump, args):
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(DUMPS[dump]))
    ref, ref_table = run_in_process(jax_analyze.main, [str(path), *ARGS[args]])
    got, got_table = run_in_process(torch_analyze.main,
                                    [str(path), "--device", "cpu", *ARGS[args]])
    assert json.loads(got) == json.loads(ref)
    assert got == ref
    assert got_table == ref_table


def test_load_fleet_matches_reference():
    doc = DUMPS["interleaved"]
    ref = jax_analyze.load_fleet(doc)
    got = torch_analyze.load_fleet(doc)
    for r, g in zip(ref[0], got[0]):
        assert r.dtype == g.dtype and r.tobytes() == g.tobytes()
    assert got[1] == ref[1] and list(got[2]) == list(ref[2]) and got[3] == ref[3]


def test_module_entry_point_matches_reference(tmp_path):
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(DUMPS["uneven_11_chips"]))
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)}
    outs = []
    for module, extra in (("tpu_pruner.analyze", []),
                          ("tpu_pruner_torch.analyze", ["--device", "cpu"])):
        proc = subprocess.run([sys.executable, "-m", module, str(path), *extra],
                              capture_output=True, text=True, timeout=300,
                              cwd=REPO_ROOT, env=env)
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout.strip()))
    assert outs[0] == outs[1]
    assert outs[1]["reclaimable_slices"] == ["ml/idle"]


# option -> (argv, what stderr says): combinations refused with exit code 2
REFUSED = {
    "--shard": (["--shard", "--stream", "state.npz"], "--shard does not apply to --stream"),
    "--stream=state.npz": (["--stream=state.npz", "--window-chunks", "0"],
                           "--window-chunks must be >= 1"),
    "--explain": (["--explain", "ml/p0"],
                  "--explain needs exactly one of --audit-log or --decisions-url"),
}


@pytest.mark.parametrize("option", sorted(REFUSED))
def test_unported_modes_are_refused(tmp_path, option):
    """Combinations the CLI does not run are refused before any file is
    read, as the reference refuses them: --stream with --shard, an empty
    window, and --explain without a decision source. (Every mode is
    ported; tests/test_torch_reports.py holds each refusal against the
    reference's.)"""
    argv, message = REFUSED[option]
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        torch_analyze.main(["dump.json", *argv])
    assert exc.value.code == 2
    assert message in err.getvalue()


# -- --stream against tpu_pruner.analyze --stream (tests/test_analyze.py:229-338)


def stream_dump(ts, idle, busy=(), gap=False, ids=True):
    chips = []
    for name in list(idle) + list(busy):
        for j in range(2):
            tc = [] if gap else ([0.0] * 3 if name in idle else [0.0, 0.7, 0.0])
            c = chip(name, tc, hbm=[0.0] * len(tc) if tc else None)
            if ids:
                c["id"] = f"{name}/{j}"
            chips.append(c)
    return {"chips": chips, "timestamp": ts}


# each step: (dump, extra arguments); the window holds 3 chunks
STREAMS = {
    "deltas_and_partial_window": [
        (stream_dump(1000.0, idle=["ml/a", "ml/b"]), []),
        (stream_dump(1180.0, idle=["ml/a"], busy=["ml/b"]), []),
    ],
    "scrape_gap": [
        (stream_dump(1000.0, idle=["ml/a"], busy=["ml/b"]), []),
        (stream_dump(1180.0, idle=["ml/a"], busy=["ml/b"], gap=True), []),
        (stream_dump(1360.0, idle=["ml/a", "ml/b"]), []),
    ],
    "eviction": [
        (stream_dump(1000.0 + 180 * i, idle=["ml/b"] if i else [],
                     busy=[] if i else ["ml/b"]), [])
        for i in range(5)
    ],
    "mismatch_then_reset": [
        (stream_dump(1000.0, idle=["ml/a"], busy=["ml/b"]), []),
        (stream_dump(1180.0, idle=["ml/other"]), []),
        (stream_dump(1180.0, idle=["ml/other"]), ["--reset"]),
        (stream_dump(1360.0, idle=["ml/other"]), ["--window-chunks", "4"]),
    ],
    "positional_ids": [
        (stream_dump(1000.0, idle=["ml/a"], ids=False), ["--hbm-threshold", "0.05"]),
        (stream_dump(1180.0, idle=["ml/a"], busy=["ml/c"], ids=False), ["--reset"]),
    ],
}


def run_cli(main, argv):
    """(exit code, last stdout line, stderr) of one in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc, message = exc.code, exc.code
            if not isinstance(message, int):
                print(message, file=err)
                rc = 1
    lines = out.getvalue().strip().splitlines()
    return rc, lines[-1] if lines else "", err.getvalue()


def stream_step(main, tmp_path, state, doc, extra, device_args=()):
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(doc))
    return run_cli(main, [str(path), "--stream", str(state), "--window-chunks", "3",
                          *extra, *device_args])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_reference(tmp_path, name):
    """Cycle by cycle, the port's --stream prints the reference's JSON line
    and its stderr (deltas, staleness, warnings, errors that point at
    --reset), each package on its own state file."""
    outs = []
    for step, (doc, extra) in enumerate(STREAMS[name]):
        ref = stream_step(jax_analyze.main, tmp_path, tmp_path / "jax.npz", doc, extra)
        got = stream_step(torch_analyze.main, tmp_path, tmp_path / "torch.npz", doc, extra,
                          ["--device", "cpu"])
        assert got[0] == ref[0], (step, got[2], ref[2])
        assert got[1] == ref[1], step
        assert got[2].replace("torch.npz", "STATE") == ref[2].replace("jax.npz", "STATE")
        outs.append(got)
    if name == "eviction":  # busy only in cycle 0; evicted by cycle 3 with K=3
        lines = [json.loads(o[1]) for o in outs]
        assert [x["reclaimable_slices"] for x in lines] == [[], [], [], ["ml/b"], ["ml/b"]]
        assert lines[3]["newly_reclaimable"] == ["ml/b"] and not lines[3]["window"]["partial"]
    if name == "mismatch_then_reset":
        assert outs[1][0] == 1 and "--reset" in outs[1][2]
        assert outs[3][0] == 1 and "window chunks" in outs[3][2]
    if name == "positional_ids":
        assert "positional identity" in outs[0][2]


def test_stream_state_round_trips_between_packages(tmp_path):
    """One state file, cycles alternating between the packages, gives the
    same JSON lines as the reference alone; the file keeps the reference's
    keys and dtypes whichever package wrote it."""
    cycles = [stream_dump(1000.0 + 180 * i,
                          idle=["ml/a", "ml/b"] if i % 3 else ["ml/a"],
                          busy=[] if i % 3 else ["ml/b"]) for i in range(6)]
    mains = [jax_analyze.main, torch_analyze.main]
    for i, doc in enumerate(cycles):
        ref = stream_step(jax_analyze.main, tmp_path, tmp_path / "alone.npz", doc, [])
        which = i % 2
        got = stream_step(mains[which], tmp_path, tmp_path / "shared.npz", doc, [],
                          ["--device", "cpu"] if which else [])
        assert got[:2] == ref[:2], i
        with np.load(tmp_path / "shared.npz", allow_pickle=False) as a, \
                np.load(tmp_path / "alone.npz", allow_pickle=False) as b:
            assert sorted(a.files) == sorted(b.files) == sorted(
                ["tc_ring", "hbm_ring", "cursor", "chunk_times", "chip_ids",
                 "slice_names", "prev_verdicts"])
            for key in b.files:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
                np.testing.assert_array_equal(a[key], b[key])


# -- --shard under torchrun against tpu_pruner.analyze --shard ---------------


def run_in_session(cmd, timeout, **kwargs):
    """subprocess.run in a session of its own; on timeout the whole session
    (the launcher and every rank it started) is killed before the test fails."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kwargs)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)



@pytest.mark.parametrize("extra", [[], ["--quantize"]])
def test_shard_under_torchrun_matches_reference(tmp_path, extra):
    """Four gloo ranks launched by torchrun print, on rank 0 alone, the JSON
    line of the reference's --shard over its 8-device CPU mesh (11 chips:
    padding)."""
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(DUMPS["uneven_11_chips"]))
    ref, _ = run_in_process(jax_analyze.main, [str(path), "--shard", *extra])
    proc = run_in_session(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "tpu_pruner_torch.analyze", str(path),
         "--shard", "--device", "cpu", *extra],
        timeout=240, cwd=REPO_ROOT,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1  # only rank 0 prints
    assert lines[0] == ref
    assert json.loads(lines[0])["reclaimable_slices"] == ["ml/idle"]


@pytest.mark.parametrize("extra", [[], ["--quantize"]])
def test_shard_without_torchrun_runs_one_rank(tmp_path, extra):
    """Without torchrun, --shard runs in a one-rank group and equals the
    reference, table included."""
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(DUMPS["interleaved"]))
    ref, ref_table = run_in_process(jax_analyze.main, [str(path), "--shard", *extra])
    got, got_table = run_in_process(torch_analyze.main,
                                    [str(path), "--shard", "--device", "cpu", *extra])
    assert got == ref and got_table == ref_table


def test_port_imports_neither_jax_nor_reference(tmp_path):
    """The port, chip_smoke.py and the kernel cases it shares with the tests
    (tests/torch_kernel_cases.py) load no JAX and nothing of tpu_pruner,
    and neither does a report mode run through the port's CLI; importing
    the CLI builds no native code."""
    ledger = tmp_path / "ledger.jsonl"
    ledger.write_text(json.dumps(
        {"cluster": "c1", "epoch": 2, "schema": 2, "workload": "Deployment/ml/w",
         "kind": "Deployment", "namespace": "ml", "name": "w", "chips": 4,
         "state": "paused", "idle_seconds": 600.0, "active_seconds": 0.0,
         "reclaimed_chip_seconds": 2400.0, "pauses": 1, "resumes": 0}) + "\n")
    probe = (
        "import runpy, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import chip_smoke, torch_kernel_cases, tpu_pruner_torch, tpu_pruner_torch.analyze\n"
        "import tpu_pruner_torch.policy, tpu_pruner_torch.policy.cuda_engine\n"
        "import tpu_pruner_torch.entry, tpu_pruner_torch.policy.sharded\n"
        "import tpu_pruner_torch.native, tpu_pruner_torch.dump\n"
        "sys.argv = ['analyze', '--fleet-report', '--ledger-file', sys.argv[1]]\n"
        "try:\n"
        "    runpy.run_module('tpu_pruner_torch.analyze', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code in (0, None), exc.code\n"
        "assert tpu_pruner_torch.native._lib is None\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'tpu_pruner'\n"
        "             or m.startswith('tpu_pruner.'))\n"
        "print('BAD=' + ','.join(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe, str(ledger)], capture_output=True,
                          text=True, timeout=300, cwd=REPO_ROOT,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    report, bad = proc.stdout.strip().splitlines()
    assert json.loads(report)["reclaimed_chip_hours"] == round(2400.0 / 3600, 3)
    assert "across 1 tracked workload(s)" in proc.stderr
    assert bad == "BAD="


# -- the native dump reader and its fallback, against the reference's json.load

def reader_dump(escaped: bool) -> str:
    """A dump in the shapes dump.py writes, with unknown keys, positional
    ids, NaN and ragged series; ``escaped`` writes one slice name with an
    escape, which the native reader leaves to json.load."""
    busy = "ml\\/busy" if escaped else "ml/busy"
    return (
        '{"timestamp": 1180.5, "lookback_s": 2100, "hbm_threshold": 0.05, "source": {"v": 2},\n'
        ' "chips": [\n'
        '  {"slice": "ml/idle", "id": "ml/idle-0/1", "pod_age_s": 7200.0,'
        ' "tc": [0.0, 0.0, 0.0], "hbm": [0.01, 0.0, 0.02]},\n'
        '  {"slice": "' + busy + '", "id": "ml/busy-0/0", "pod_age_s": 7200,'
        ' "tc": [0.0, 0.25, NaN], "hbm": [0.1]},\n'
        '  {"slice": "ml/idle", "id": "ml/idle-0/0", "pod_age_s": 9000.25, "tc": [0.0, 0.0],'
        ' "labels": {"zone": "a"}},\n'
        '  {"slice": "ml/young", "pod_age_s": 60, "tc": [0.0, 0.0, 0.0], "hbm": null},\n'
        '  {"slice": "ml/busy", "id": "ml/busy-0/1", "pod_age_s": 7200, "tc": [1e-40, 0.0]}\n'
        ' ]}\n')


READER_MODES = {"batch": [], "quantize": ["--quantize"], "stream": ["--stream"]}


def cli_bytes(main, argv):
    """(exit code, stdout, stderr) of one in-process run, whole."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("mode", sorted(READER_MODES))
@pytest.mark.parametrize("escaped", [False, True], ids=["native", "fallback"])
def test_reader_paths_print_the_reference_bytes(tmp_path, escaped, mode):
    """A dump the native reader takes and one it leaves to json.load: the
    port prints the reference's stdout and stderr byte for byte, in the
    batch path, --quantize and two --stream cycles (whose window ages come
    from the dumps' timestamps), and counts the path it took."""
    path = tmp_path / "dump.json"
    stream = mode == "stream"
    for cycle in range(2 if stream else 1):
        path.write_text(reader_dump(escaped).replace("1180.5", str(1180.5 + 180 * cycle)))
        extra = [*READER_MODES[mode]]
        ref = cli_bytes(jax_analyze.main,
                        [str(path), *extra, *[str(tmp_path / "ref.npz")] * stream])
        before = dict(obs.counts)
        got = cli_bytes(torch_analyze.main, [str(path), "--device", "cpu", *extra,
                                             *[str(tmp_path / "got.npz")] * stream])
        assert obs.counts["ingest_native"] - before["ingest_native"] == int(not escaped)
        assert obs.counts["ingest_fallback"] - before["ingest_fallback"] == int(escaped)
        assert got == ref
    line = json.loads(got[1])
    if stream:
        assert line["window"]["oldest_chunk_age_s"] == 180.0
    else:
        assert line["reclaimable_slices"] == ["ml/idle"]


@pytest.mark.parametrize("escaped", [False, True], ids=["native", "fallback"])
def test_reader_reads_stdin_as_the_reference_does(tmp_path, escaped):
    """``-`` reads the dump from stdin, on either path: the port's process
    prints the reference's stdout and stderr byte for byte."""
    path = tmp_path / "dump.json"
    path.write_text(reader_dump(escaped))
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)}
    outs = []
    for module, extra in (("tpu_pruner.analyze", []),
                          ("tpu_pruner_torch.analyze", ["--device", "cpu"])):
        with open(path, "rb") as stdin:
            proc = subprocess.run([sys.executable, "-m", module, "-", *extra], stdin=stdin,
                                  capture_output=True, timeout=300, cwd=REPO_ROOT, env=env)
        assert proc.returncode == 0, proc.stderr
        outs.append((proc.stdout, proc.stderr))
    assert outs[0] == outs[1]
    assert json.loads(outs[1][0])["reclaimable_slices"] == ["ml/idle"]


# -- --sweep: a grid of policies over a dump of raw samples ---------------------


def sweep_case(seed=3, slices=24, step_s=60.0):
    """A dump of 4-chip groups whose series are placed in time, as
    tpu_pruner_torch.dump writes them: 60 steps a chip, the last the newest,
    null at a step with no sample; and the samples as they lie in time,
    (tc, hbm, valid, age, slice_id) in the dump's order. Groups are idle
    since a random step, some with one busy sample, each chip with one HBM
    sample of 0, 0.01 or 0.03, ages around the grid's gates; and where
    reading a series as right-aligned, or a null as a sample, would turn a
    verdict: every 7th group is idle throughout but one chip stopped
    reporting 7 steps ago (no data in the 5-minute window); of every 5th,
    idle for 16 steps, one chip missed the 3 scrapes around the 15-minute
    window's edge; of every 3rd, one chip has 4 steps with no hbm sample,
    newer than its HBM sample, which lies just outside the 15-minute window.
    ``step_s`` is stamped unless None."""
    rng = np.random.default_rng(seed)
    C, T = 4 * slices, 60
    tc = np.zeros((C, T), np.float32)
    hbm = np.zeros((C, T), np.float32)
    valid = np.ones((C, T), bool)
    hbm_given = np.ones((C, T), bool)
    age = np.zeros(C, np.float32)
    for s in range(slices):
        stopped, gapped = s % 7 == 0, s % 5 == 1 and s % 7
        since = 70 if stopped else 16 if gapped else int(rng.integers(1, 70))
        for c in range(4):
            i = 4 * s + c
            tc[i, :max(0, T - since)] = 0.4
            if s % 5 == 0 and c == 1 and not stopped:
                tc[i, int(rng.integers(0, T))] = 0.3
            hbm[i, int(rng.integers(0, T))] = [0.0, 0.01, 0.03][s % 3]
            age[i] = 9999.0 if stopped or gapped else rng.choice([600.0, 1500.0, 3900.0, 9999.0])
            if stopped and c == 3:
                valid[i, T - 7:] = hbm_given[i, T - 7:] = False
            if gapped and c == 2:
                valid[i, 44:47] = hbm_given[i, 44:47] = False
            if s % 3 == 2 and c == 0:
                hbm[i] = 0.0
                hbm[i, 43] = 0.03
                hbm_given[i, 50:54] = False
    tc[~valid] = 0.0
    hbm[~hbm_given] = 0.0
    chips = [chip(f"ml/js-{i // 4}",
                  [float(v) if ok else None for v, ok in zip(tc[i], valid[i])],
                  hbm=[float(v) if ok else None for v, ok in zip(hbm[i], hbm_given[i])],
                  age=float(age[i]), chip_id=f"c{i % 4}") for i in range(C)]
    doc = {"lookback_s": 2100, "chips": chips}
    if step_s is not None:
        doc["step_s"] = step_s
    return doc, (tc, hbm, valid, age, np.arange(C, dtype=np.int32) // 4)


def sweep_dump(**kwargs):
    return sweep_case(**kwargs)[0]


SWEEP_KEYS = ["duration=5m,15,3600s", "hbm_threshold=0,0.02,0.05", "grace=10m"]


def test_sweep_table_and_json_match_the_reference(tmp_path):
    from port_bench.reference import sweep as ref

    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(sweep_dump()))
    line, err = run_in_process(torch_analyze.main,
                               [str(path), "--device", "cpu", "--sweep", *SWEEP_KEYS])
    got = json.loads(line)
    # the reference on the samples at their true steps
    tc, hbm, valid, age, slice_id = sweep_case()[1]
    slices, chips, counts = ref.sweep([(tc, hbm, valid)], age, slice_id, 24,
                                      [300.0, 900.0, 3600.0], [0.0, 0.02, 0.05], 600.0, 60.0)
    assert got["num_chips"] == 96 and got["num_slices"] == 24 and got["window_samples"] == 60
    assert got["step_s"] == 60.0 and got["grace_s"] == 600.0
    assert [(p["duration_s"], p["hbm_threshold"], p["lookback_s"]) for p in got["policies"]] == [
        (d, t, d + 600.0) for d in (300.0, 900.0, 3600.0) for t in (0.0, 0.02, 0.05)]
    assert [[p["reclaimable_slices"], p["reclaimable_chips"]] for p in got["policies"]] == \
        counts.tolist()
    assert [p["idle_chips"] for p in got["policies"]] == [
        int(((chips >> p) & 1).sum()) for p in range(9)]
    assert len(set(counts[:, 0].tolist())) > 2  # the policies disagree
    rows = err.strip().splitlines()
    assert rows[0].split() == ["duration", "grace", "hbm_threshold", "slices", "chips", "idle",
                               "chips"]
    assert [r.split()[:5] for r in rows[1:]] == [
        [f"{d}m", "600s", t, str(n[0]), str(n[1])]
        for (d, t), n in zip([(d, t) for d in (5, 15, 60) for t in ("0", "0.02", "0.05")],
                             counts.tolist())]


def test_sweep_needs_the_dumps_step(tmp_path):
    path = tmp_path / "nostep.json"
    path.write_text(json.dumps(sweep_dump(step_s=None)))
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        torch_analyze.main([str(path), "--device", "cpu", "--sweep", *SWEEP_KEYS])
    assert "carries no step_s" in str(exc.value.code) and "--step-s" in str(exc.value.code)
    given, _ = run_in_process(torch_analyze.main, [str(path), "--device", "cpu", "--step-s",
                                                   "60", "--sweep", *SWEEP_KEYS])
    stamped = tmp_path / "step.json"
    stamped.write_text(json.dumps(sweep_dump()))
    assert given == run_in_process(torch_analyze.main, [str(stamped), "--device", "cpu",
                                                        "--sweep", *SWEEP_KEYS])[0]
    with pytest.raises(SystemExit, match="window holds 1 to 60"):
        torch_analyze.main([str(stamped), "--device", "cpu", "--sweep", "duration=61"])


def test_sweep_refuses_series_not_placed_in_time(tmp_path):
    """A dump whose series are listed as they came, shorter where a chip
    missed scrapes, cannot say when each sample was taken: --sweep refuses
    it, where the one-policy audit right-aligns it as before."""
    doc = sweep_dump()
    for c in doc["chips"]:
        for key in ("tc", "hbm"):
            c[key] = [v for v in c[key] if v is not None]
    path = tmp_path / "listed.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(SystemExit) as exc:
        torch_analyze.main([str(path), "--device", "cpu", "--sweep", *SWEEP_KEYS])
    assert "placed in time, 60 samples each" in str(exc.value.code)
    assert "16 of 96 chips" in str(exc.value.code)  # 4 stopped, 4 with gaps, 8 without hbm
    run_in_process(torch_analyze.main, [str(path), "--device", "cpu"])


def test_sweep_warns_where_no_pod_passes_a_policys_age_gate(tmp_path):
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(sweep_dump()))
    line, err = run_in_process(torch_analyze.main, [
        str(path), "--device", "cpu", "--sweep", "duration=15m,1h", "grace=6340"])
    # the oldest pod is 9,999 s old: 3,600 + 6,340 = 9,940 passes, 9,999 + 1 would not
    assert "WARNING" not in err
    line, err = run_in_process(torch_analyze.main, [
        str(path), "--device", "cpu", "--sweep", "duration=15m,1h", "grace=6400"])
    assert "no pod is old enough for duration 3600 s + grace 6400 s" in err
    assert "oldest is 9999 s" in err
    assert [p["reclaimable_chips"] for p in json.loads(line)["policies"]][1] == 0


@pytest.mark.parametrize("argv, message", [
    (["--sweep", "duration=" + ",".join(str(m) for m in range(1, 14)),
      "hbm_threshold=0,0.01,0.02,0.03,0.05"], "at most 64 policies"),
    (["--sweep", "hbm_threshold=0.05"], "needs duration="),
    (["--sweep", "duration=5", "lookback=10m"], "--sweep takes duration="),
    (["--sweep", "duration=5", "grace=300,600"], "one grace"),
    (["--sweep", "duration=5", "--stream", "state.npz"], "does not apply with --stream"),
    (["--step-s", "60"], "--step-s only applies with --sweep"),
], ids=["65-policies", "no-duration", "unknown-key", "two-graces", "with-stream", "step-alone"])
def test_sweep_refusals(argv, message):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        torch_analyze.main(["dump.json", *argv])
    assert exc.value.code == 2 and message in err.getvalue()


def test_sweep_under_profile_shows_its_span_and_counters(tmp_path):
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(sweep_dump()))
    plain, _ = run_in_process(torch_analyze.main,
                              [str(path), "--device", "cpu", "--sweep", *SWEEP_KEYS])
    line, err = run_in_process(torch_analyze.main, [
        str(path), "--device", "cpu", "--profile", str(tmp_path / "trace.json"),
        "--sweep", *SWEEP_KEYS])
    assert line == plain  # stdout as without the flag
    spans = {row.split()[0]: int(row.split()[1]) for row in err.splitlines()
             if row.split() and row.split()[0].startswith(("analyze.", "engine."))}
    assert spans["engine.sweep"] == 1 and spans["analyze.evaluate"] == 1
    counters = err.split("counters: ", 1)[1].splitlines()[0]
    assert "sweep_policies 9" in counters and "sweep_window_passes 1" in counters
