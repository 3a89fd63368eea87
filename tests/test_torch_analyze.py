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


# option -> (argv, what stderr says): modes the port refuses, with exit code 2
REFUSED = {
    "--shard": (["--shard", "--stream", "state.npz"], "--shard does not apply to --stream"),
    "--stream=state.npz": (["--stream=state.npz", "--window-chunks", "0"],
                           "--window-chunks must be >= 1"),
    "--explain": (["--explain"], "not ported"),
}


@pytest.mark.parametrize("option", sorted(REFUSED))
def test_unported_modes_are_refused(tmp_path, option):
    """Modes the port does not run are refused before any dump is read:
    report modes that are not ported, --stream with --shard (as the
    reference refuses it), and an empty window."""
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
    """The port and chip_smoke.py load no JAX and nothing of tpu_pruner."""
    probe = (
        "import sys\n"
        "import chip_smoke, tpu_pruner_torch, tpu_pruner_torch.analyze\n"
        "import tpu_pruner_torch.policy, tpu_pruner_torch.policy.cuda_engine\n"
        "import tpu_pruner_torch.entry, tpu_pruner_torch.policy.sharded\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'tpu_pruner'\n"
        "             or m.startswith('tpu_pruner.'))\n"
        "print(','.join(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=300, cwd=REPO_ROOT,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""
