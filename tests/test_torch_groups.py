"""``evaluate_fleet`` over JobSet groups of mixed sizes, chips in host order.

The port against ``port_bench/reference/groups.py`` on fleets drawn by
``port_bench/groups.py`` at the group sizes of the ``gke-65k-nodes-mixed``
deployment (counts cut) and on hand-made edge cases; the benchmark cell
``eval-260k-t360-f32-groups`` at a tiny size, whole and with the program
broken underneath; the ``engine.reduce`` span and the cell's readers.

On the CPU but the tests marked ``gpu``, which skip without a CUDA device.
This file imports no JAX, so it also runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_groups.py
"""

import contextlib
import json
import shutil
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import gen, groups, run, work_f32
from port_bench.cell import Ctx, load_cell, load_module
from port_bench.reference import groups as ref
from port_bench.trace import Spans, Trace
from tpu_pruner_torch import obs
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import kernels

ROOT = Path(__file__).resolve().parents[1]
CELL = "eval-260k-t360-f32-groups"
MIX = json.loads((ROOT / "port_bench" / "traffic" / "eval-t360-f32-groups.json").read_text())
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "gke-65k-nodes-mixed.json").read_text())
POLICIES = [tuple(p) for p in MIX["policies"]]
# the deployment's group sizes, with the counts cut
CUT = [[1, 50944], [1, 8960], [1, 256], [1, 64], [4, 16], [8, 4]]


def config(table, T=12, chips_per_host=4):
    return dict(CONFIG, groups=table, chips=sum(n * c for n, c in table),
                slices=sum(n for n, _ in table), chips_per_host=chips_per_host,
                window_samples=T)


def draw(cfg, seed, **mix):
    """The fleet and its samples, as the cell's driver draws them, on the CPU."""
    mix = dict(MIX, **mix)
    fleet = groups.make_fleet(cfg, mix, seed, "cpu")
    g = gen.generator(seed, "cpu", 2)
    tc, hbm, valid = groups.samples(fleet, mix, g, cfg["window_samples"], 0, cfg["chips"])
    return fleet, tc, hbm, valid


def params(policy):
    lookback, threshold = policy
    return tp.params_array(tp.PolicyParams(lookback_s=lookback, hbm_threshold=threshold),
                           device="cpu")


def want(tc, hbm, valid, age, slice_id, num_slices, policy, block=1000):
    """The reference, over blocks of ``block`` rows."""
    arrays = [x.numpy() for x in (tc, hbm, valid)]
    blocks = [tuple(x[r0:r0 + block] for x in arrays) for r0 in range(0, len(age), block)]
    return ref.verdicts(blocks, np.asarray(age), np.asarray(slice_id), num_slices, *policy)


@pytest.fixture(scope="module")
def cut_fleet():
    return draw(config(CUT), 2**31 + 77)


# --- the generator ------------------------------------------------------------


def test_the_layout_keeps_hosts_whole_and_shuffles_them(cut_fleet):
    fleet, *_ = cut_fleet
    cfg = config(CUT)
    sid = fleet.slice_id.numpy()
    assert fleet.slice_id.dtype == torch.int32 and len(sid) == cfg["chips"] == 60320
    by_host = sid.reshape(-1, 4)
    assert (by_host == by_host[:, :1]).all()  # a host's chips stay adjacent
    sizes = np.bincount(sid, minlength=cfg["slices"])
    assert sorted(sizes.tolist()) == sorted(n for c, n in CUT for _ in range(c))
    assert (np.diff(sid) != 0).sum() > 10 * cfg["slices"]  # groups are not contiguous
    table_order = fleet.group.numpy()
    assert not np.array_equal(sid[np.unique(table_order, return_index=True)[1]],
                              np.arange(cfg["slices"]))  # ids permuted
    for s in range(cfg["slices"]):  # each group's chips numbered 0..n-1 within it
        mask = table_order == s
        assert np.array_equal(np.sort(fleet.local.numpy()[mask]), np.arange(mask.sum()))


def test_the_multislice_group_vetoes_and_the_shares_are_exact_counts(cut_fleet):
    fleet, tc, _, valid = cut_fleet
    kinds = fleet.kinds.numpy()
    big = int(np.argmax(fleet.size.numpy()))
    assert fleet.size[big] == 50944 and kinds[big] == gen.VETO
    assert Counter(kinds.tolist()) == {gen.IDLE: 8, gen.BUSY: 4, gen.VETO: 4}
    chips = (fleet.group == big).numpy()
    busy_samples = ((tc.numpy() > 0) & (tc.numpy() >= gen.FLT_MIN) & valid.numpy())[chips]
    assert busy_samples.sum() == 1  # idle but for one sample of one chip
    host_age = fleet.age.numpy().reshape(-1, 4)
    assert (host_age == host_age[:, :1]).all()
    assert (host_age[:, 0] < 2100).sum() >= np.floor(0.005 * 60320 / 4)


def test_a_table_that_does_not_add_up_is_refused():
    with pytest.raises(ValueError, match="groups give"):
        groups.make_fleet(dict(config(CUT), chips=60321), MIX, 1, "cpu")
    with pytest.raises(ValueError, match="whole hosts"):
        groups.make_fleet(config([[2, 6]], chips_per_host=4), MIX, 1, "cpu")
    with pytest.raises(ValueError, match="shuffled"):
        groups.make_fleet(config(CUT), dict(MIX, host_order="grouped"), 1, "cpu")


# --- the port against the reference -------------------------------------------


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: f"{p[0]}-{p[1]}")
def test_port_matches_the_reference_in_host_order(cut_fleet, policy):
    fleet, tc, hbm, valid = cut_fleet
    S = fleet.slices
    verdicts, candidates = tp.evaluate_fleet(tc, hbm, valid, fleet.age, fleet.slice_id,
                                             params(policy), num_slices=S)
    want_v, want_c = want(tc, hbm, valid, fleet.age, fleet.slice_id, S, policy)
    np.testing.assert_array_equal(verdicts.numpy(), want_v)
    np.testing.assert_array_equal(candidates.numpy(), want_c)
    assert 0 < want_v.sum() < S and 0 < want_c.sum() < len(want_c)

    # the same chips sorted by group through the contiguous evaluator
    order = torch.argsort(fleet.slice_id, stable=True)
    bounds = tp.slice_bounds(fleet.slice_id[order], S, device="cpu")
    verdicts_c, candidates_c = tp.evaluate_fleet_c(tc[order], hbm[order], valid[order],
                                                   fleet.age[order], bounds, params(policy))
    np.testing.assert_array_equal(verdicts_c.numpy(), want_v)
    np.testing.assert_array_equal(candidates_c.numpy(), want_c[order.numpy()])


def idle_fleet(sizes, T=6, cph=4, seed=0):
    """Chips of groups ``sizes`` (table order) in shuffled host order, every
    sample idle and valid, pods a day old: (tc, hbm, valid, age, slice_id,
    table group of each chip, host of each chip)."""
    rng = np.random.default_rng(seed)
    host_group = np.repeat(np.arange(len(sizes)), np.asarray(sizes) // cph)
    order = rng.permutation(len(host_group))
    host = np.repeat(order, cph)
    group = host_group[host]
    C = len(group)
    tc = np.zeros((C, T), np.float32)
    hbm = np.full((C, T), 0.01, np.float32)
    return tc, hbm, np.ones((C, T), bool), np.full(C, 86400.0, np.float32), group, host


def edge_multislice_busy_on_its_last_host():
    tc, hbm, valid, age, group, host = idle_fleet([64, 16, 8, 4])
    last = np.flatnonzero(group == 0)[-1]  # the last chip of the group's last host
    tc[last, 3] = 0.25
    return tc, hbm, valid, age, group, [False, True, True, True]


def edge_restarted_host_in_an_idle_group():
    tc, hbm, valid, age, group, host = idle_fleet([16, 16, 8])
    age[host == host[np.flatnonzero(group == 1)[0]]] = 600.0  # below both lookbacks
    return tc, hbm, valid, age, group, [True, False, True]


def edge_group_of_one_host():
    tc, hbm, valid, age, group, _ = idle_fleet([4, 4, 16])
    hbm[group == 1, 0] = 0.3  # rescued where the cutoff is on
    return tc, hbm, valid, age, group, None


def edge_permuted_ids():
    tc, hbm, valid, age, group, _ = idle_fleet([16, 8, 8, 4, 4], seed=3)
    tc[np.flatnonzero(group == 2)[1], 0] = 0.5
    ids = np.array([3, 0, 4, 1, 2])
    return tc, hbm, valid, age, ids[group], [True, True, True, True, False]


EDGES = [edge_multislice_busy_on_its_last_host, edge_restarted_host_in_an_idle_group,
         edge_group_of_one_host, edge_permuted_ids]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("case", EDGES, ids=lambda f: f.__name__[5:])
def test_edge_cases_match_the_reference(case, policy):
    tc, hbm, valid, age, slice_id, expected = case()
    S = int(slice_id.max()) + 1
    tensors = [torch.from_numpy(x) for x in (tc, hbm, valid, age)]
    sid = torch.from_numpy(slice_id.astype(np.int32))
    verdicts, candidates = tp.evaluate_fleet(*tensors, sid, params(policy), num_slices=S)
    want_v, want_c = want(*tensors, slice_id, S, policy, block=7)
    np.testing.assert_array_equal(verdicts.numpy(), want_v)
    np.testing.assert_array_equal(candidates.numpy(), want_c)
    if expected is None:  # the one-host group is rescued by its HBM alone
        expected = [True, policy[1] <= 0, True]
    assert want_v.tolist() == expected


# --- the cell, through the harness -------------------------------------------

TINY = config([[1, 64], [1, 32], [2, 16], [4, 8], [8, 4]], T=40)
SEED = 2**31 + 5


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark, so that a run writes inside it alone."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def run_tiny(tree, trace=False, seed=SEED):
    return run.run(CELL, seed, 0.3, trace, device="cpu", root=tree, config=TINY)[0]


def test_the_cell_runs_correct_on_the_cpu(tree):
    result = run_tiny(tree)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "eval_ms"}
    assert set(result["compared"]) == {"slices_wrong", "chips_wrong", "answers_missing",
                                       "failed"}
    traced = run_tiny(tree, trace=True)
    assert traced["correct"]
    assert set(traced["metrics"]) == {"reduce_host_ms.groups"}  # no device metric on the CPU
    assert traced["metrics"]["reduce_host_ms.groups"]["value"] > 0


def drop_last_chip(orig):
    def fault(candidate, slice_id, num_slices):
        return orig(candidate[:-1], slice_id[:-1], num_slices)
    return fault


def flip_one_verdict(orig):
    def fault(*args, **kwargs):
        verdicts, candidates = orig(*args, **kwargs)
        verdicts = verdicts.clone()
        verdicts[0] = ~verdicts[0]
        return verdicts, candidates
    return fault


def seed_showing_a_dropped_last_chip(tree):
    """The first seed from SEED on at which leaving out the fleet's last chip
    changes the reference's verdicts under two policies or more, so that the
    run's sample of answers holds such a policy whatever its length."""
    cell = load_cell(tree, CELL)
    for seed in range(SEED, SEED + 64):
        driver = cell.driver(Ctx(CELL, TINY, cell.mix, seed, torch.device("cpu"), tree,
                                 Spans()))
        driver.release()
        changed = 0
        for i in range(len(POLICIES)):
            verdicts, candidate = driver.reference(i)
            without = ref.fleet.slice_verdicts(candidate[:-1], driver._slice_id[:-1],
                                               TINY["slices"])
            changed += bool((verdicts != without).any())
        if changed >= 2:
            return seed
    raise AssertionError("no seed lets a dropped last chip show")


@pytest.mark.parametrize("module, attr, fault", [
    (kernels, "slice_counts", drop_last_chip), (tp, "evaluate_fleet", flip_one_verdict)],
    ids=["slice_counts-drops-the-last-chip", "evaluate_fleet-flips-a-verdict"])
def test_broken_program_is_not_correct(tree, monkeypatch, module, attr, fault):
    seed = seed_showing_a_dropped_last_chip(tree) if attr == "slice_counts" else SEED
    assert run_tiny(tree, seed=seed)["correct"]
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    result = run_tiny(tree, seed=seed)
    assert not result["correct"]
    assert result["compared"]["slices_wrong"]["value"] > 0


def test_the_bf16_control_is_not_correct():
    from port_bench import control

    r = control.readings(CELL, 7, 0.2, True, device="cpu", config=config(CUT, T=40))
    assert not any(r["program"].values())
    assert r["control"]["slices_wrong"] > 0 and r["control"]["chips_wrong"] > 0


# --- the engine.reduce span ---------------------------------------------------


def off():
    """One span with no profiler running, which ends any session."""
    with obs.span("off"):
        pass


@contextlib.contextmanager
def profiled(cuda=False):
    off()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof


def small(q=False):
    fleet, tc, hbm, valid = draw(config(CUT[2:], T=8), 11)
    if q:
        tc_q, hbm_q = gen.quantize(tc, valid), gen.quantize(hbm, valid)
        parr = torch.from_numpy(tp.quantize_params(params(POLICIES[3])))
        return tp.evaluate_fleet_q, (tc_q, hbm_q, fleet.age, fleet.slice_id, parr, fleet.slices)
    return tp.evaluate_fleet, (tc, hbm, valid, fleet.age, fleet.slice_id, params(POLICIES[3]),
                               fleet.slices)


@pytest.mark.parametrize("q", [False, True], ids=["evaluate_fleet", "evaluate_fleet_q"])
def test_reduce_span_records_only_under_a_profiler_inside_evaluate(q):
    fn, args = small(q)
    off()
    before = obs.summary()
    fn(*args)
    assert obs.summary() == before  # off: no session, no record
    with profiled() as prof:
        fn(*args)
    recs = obs.records()
    assert [r[0] for r in recs] == ["engine.evaluate", "engine.reduce"]
    assert recs[1][3] == 0  # inside engine.evaluate
    assert obs.summary()["spans"]["engine.reduce"]["count"] == 1
    assert sum(e.name == "tp.engine.reduce" for e in prof.events()) == 1


@pytest.mark.parametrize("q", [False, True], ids=["evaluate_fleet", "evaluate_fleet_q"])
def test_reduce_span_adds_no_operation(q, monkeypatch):
    fn, args = small(q)

    def ops():
        with profiled() as prof:
            fn(*args)
        return Counter(e.name for e in prof.events() if not e.name.startswith(obs.PREFIX))

    recording = ops()
    with monkeypatch.context() as m:
        m.setattr(obs, "span", lambda name: obs._NOOP)
        stubbed = ops()
    assert recording == stubbed and recording["aten::index_add_"] == 2


def test_the_contiguous_and_uniform_paths_open_no_reduce_span():
    fleet, tc, hbm, valid = draw(config([[16, 4]], T=8), 3)
    order = torch.argsort(fleet.slice_id, stable=True)
    tc, hbm, valid, age = tc[order], hbm[order], valid[order], fleet.age[order]
    bounds = tp.slice_bounds(fleet.slice_id[order], 16, device="cpu")
    tc_q, hbm_q = gen.quantize(tc, valid), gen.quantize(hbm, valid)
    parr = torch.tensor([2100.0, 5.0])
    with profiled():
        tp.evaluate_fleet_c(tc, hbm, valid, age, bounds, params(POLICIES[0]))
        tp.evaluate_fleet_qc(tc_q, hbm_q, age, bounds, parr)
        tp.evaluate_fleet_qu(tc_q, hbm_q, age, parr, 4)
    assert obs.summary()["spans"]["engine.evaluate"]["count"] == 3
    assert "engine.reduce" not in obs.summary()["spans"]


# --- the cell's readers and bytes ---------------------------------------------


def read(metric, run_):
    path = ROOT / "port_bench" / "metrics" / f"{metric}.py"
    return load_module(path, f"groups_test_{metric}").read(run_)


def test_the_cells_bytes_and_readers(monkeypatch):
    assert work_f32.evaluate_fleet_bytes(260000, 360, 23149) == 844_763_157
    bound_s = 844_763_157 / work_f32.HBM_BYTES_PER_S
    assert bound_s * 1e3 == pytest.approx(0.2522, abs=1e-4)
    shape = {"chips": 260000, "samples": 360, "slices": 23149}
    # two calls: each the pass at twice its bound, a memset, and 0.1 ms idle
    trace = Trace((0.0, 2e-3), device=[
        ("chip_pass_long_kernel", 0.0, 2 * bound_s), ("Memset (Device)", 0.6e-3, 0.7e-3),
        ("chip_pass_long_kernel", 1e-3, 1e-3 + 2 * bound_s), ("index_add", 1.6e-3, 1.9e-3)])
    traced = run.Run(CELL, trace, 2, {}, shape)
    assert read("eval_f32_roofline", traced) == pytest.approx(
        100 * 2 * bound_s / (4 * bound_s + 0.3e-3))
    assert read("device_ops.groups", traced) == 2
    busy = 4 * bound_s + 0.4e-3
    assert read("idle_pct.groups", traced) == pytest.approx(100 * (1 - busy / 2e-3))

    fn, args = small()
    with profiled():
        for _ in range(3):
            fn(*args)
    span = obs.summary()["spans"]["engine.reduce"]
    assert read("reduce_host_ms.groups", run.Run(CELL, object(), 3, {}, shape)) == \
        pytest.approx(span["total_ms"] / 3)
    for metric in ("eval_f32_roofline", "device_ops.groups", "idle_pct.groups",
                   "reduce_host_ms.groups"):
        assert read(metric, run.Run(CELL, None, 0, {}, shape)) is None
    with monkeypatch.context() as m:  # a program without obs
        m.setitem(sys.modules, "tpu_pruner_torch.obs", None)
        assert read("reduce_host_ms.groups", run.Run(CELL, object(), 3, {}, shape)) is None
    with profiled():  # a program without the span, as the parent's
        with obs.span("engine.evaluate"):
            pass
    assert read("reduce_host_ms.groups", run.Run(CELL, object(), 3, {}, shape)) is None


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_reduce_span_puts_no_operation_on_the_card(cuda, monkeypatch):
    from port_bench.trace import trace_window

    fleet, tc, hbm, valid = draw(config(CUT, T=360), 13)
    args = [x.to(cuda) for x in (tc, hbm, valid, fleet.age, fleet.slice_id)]
    parr = params(POLICIES[1]).to(cuda)

    def call():
        verdicts, candidates = tp.evaluate_fleet(*args, parr, num_slices=fleet.slices)
        return verdicts.cpu(), candidates.cpu()

    for _ in range(3):
        got = call()

    def ops():
        off()
        trace = trace_window(call, cuda)
        return Counter(name for name, _, _ in trace.device)

    recording = ops()
    assert obs.summary()["spans"]["engine.reduce"]["count"] == 1
    assert not any(name.startswith(obs.PREFIX) for name in recording)
    with monkeypatch.context() as m:
        m.setattr(obs, "span", lambda name: obs._NOOP)
        stubbed = ops()
    assert recording == stubbed
    assert sum("chip_pass_long" in n for n in recording.elements()) == 1
    assert not any("chip_pass_q" in n or "slice_gate" in n for n in recording)
    want_v, want_c = want(tc, hbm, valid, fleet.age, fleet.slice_id, fleet.slices, POLICIES[1],
                          block=8192)
    np.testing.assert_array_equal(got[0].numpy(), want_v)
    np.testing.assert_array_equal(got[1].numpy(), want_c)
