"""tpu_pruner_torch.entry against __graft_entry__, on the CPU, and the port's
coverage of the JAX engine's public names."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import __graft_entry__ as jax_entry
import tpu_pruner.policy as jax_policy
from tpu_pruner.native import REPO_ROOT
from tpu_pruner.policy import engine as jeng
from tpu_pruner_torch import entry as torch_entry
from tpu_pruner_torch import policy as tp


def test_entry_matches_reference():
    """The same example fleet and step; verdicts and masks bit for bit."""
    jfn, jargs = jax_entry.entry()
    tfn, targs = torch_entry.entry(device="cpu")
    for j, t in zip(jargs, targs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ref, got = jfn(*jargs), tfn(*targs)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[0].sum()) == torch_entry.NUM_SLICES // 2


@pytest.mark.parametrize("ranks", [8, 5])
def test_dryrun_multichip_on_cpu(tmp_path, ranks):
    """Every rank checks every sharded path against the single-device port
    and the expected verdicts. On the CPU the chip pass runs its plain
    version, so no path counts a kernel launch."""
    summaries = torch_entry.dryrun_multichip(ranks, device="cpu", timeout_s=120,
                                             workdir=tmp_path)
    assert len(summaries) == ranks
    paths = {"make_sharded_evaluator", "evaluate_fleet_sharded", "evaluate_fleet_sharded_q",
             "evaluate_fleet_sharded_qc", "evaluate_fleet_sharded_qu",
             "make_sharded_stream_step"}
    for s in summaries:
        assert s["world_size"] == ranks and set(s["launches"]) == paths
        assert all(c == {"chip_pass": 0, "chip_pass_q": 0, "slice_gate": 0,
                         "slice_scatter": 0, "window_gather": 0, "window_join": 0,
                         "sweep_pass": 0, "sweep_scatter": 0}
                   for c in s["launches"].values())
        assert s["num_chips"] == 8 * ranks and s["odd_chips"] % ranks != 0
        assert s["idle_slices"] == s["num_slices"] // 2


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


def test_entry_module_runs(tmp_path):
    """`python -m tpu_pruner_torch.entry 2 --device cpu`, as a user runs it."""
    proc = run_in_session([sys.executable, "-m", "tpu_pruner_torch.entry", "2",
                           "--device", "cpu"], timeout=240, cwd=REPO_ROOT,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                               "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert "entry() ok: [(256,), (2048,)]" in proc.stdout
    assert "dryrun_multichip: 2 ranks" in proc.stdout


def test_port_covers_every_engine_name():
    """Every engine function the JAX package exports has a same-named
    counterpart in tpu_pruner_torch.policy."""
    engine_names = [name for name in jax_policy.__all__
                    if getattr(getattr(jax_policy, name), "__module__", "") == jeng.__name__]
    assert len(engine_names) >= 29
    missing = [name for name in engine_names if not hasattr(tp, name)]
    assert missing == []
    assert all(name in tp.__all__ for name in engine_names)
    assert callable(torch_entry.entry) and callable(torch_entry.dryrun_multichip)
