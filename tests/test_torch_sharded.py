"""The port's sharded evaluators over 8 gloo ranks against the JAX mesh.

The JAX evaluators run on the 8-device virtual CPU mesh that
tests/conftest.py sets up; the port's run on 8 spawned ranks of a gloo
process group on the CPU (one spawn serves every case of this file). Both
see the same seeded numpy inputs. Outputs are booleans and int8 bytes:
exact equality. Mirrors tests/test_policy.py:119-184 and :573-678,
including cross-shard vetoes and chip counts that need padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_pruner.policy import engine as jeng
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import sharded

RANKS = 8


def jax_mesh():
    devices = jax.devices()
    assert len(devices) == RANKS, f"expected {RANKS} virtual devices, got {len(devices)}"
    return Mesh(np.array(devices), axis_names=("fleet",))


def jax_local(evaluator, *args):
    """A JAX shard_map evaluator on the mesh: chip arrays sharded, params whole."""
    mesh = jax_mesh()
    *rows, params = args
    placed = [jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("fleet"))) for x in rows]
    return [np.asarray(x) for x in evaluator(*placed, jnp.asarray(params))]


def example(C, S, idle_fraction):
    inputs, expected = jeng.make_example_fleet(num_chips=C, num_slices=S,
                                               idle_fraction=idle_fraction)
    return tuple(np.asarray(x) for x in inputs), expected


def quantized(inputs):
    return tuple(np.asarray(x) for x in jeng.quantize_fleet_inputs(
        tuple(jnp.asarray(x) for x in inputs)))


def busy_last_chip(C, S):
    """One slice over every shard (or two), the last chip busy."""
    inputs, _ = example(C, S, idle_fraction=1.0)
    tc = inputs[0].copy()
    tc[C - 1, 0] = 0.9
    return (tc, *inputs[1:])


def heterogeneous_fleet():
    """tests/test_policy.py's qc fleet: sizes 1..23, C=100 (pads to 104)."""
    rng = np.random.default_rng(7)
    sizes = [1, 23, 4, 9, 17, 2, 11, 6, 13, 14]
    C, S = sum(sizes), len(sizes)
    slice_id = np.repeat(np.arange(S, dtype=np.int32), sizes)
    tc = rng.uniform(0, 1, (C, 12)).astype(np.float32)
    tc[np.isin(slice_id, [1, 4, 7])] = 0.0
    inputs = (tc, np.zeros_like(tc), np.ones((C, 12), dtype=bool),
              np.full((C,), 7200.0, np.float32), slice_id,
              np.asarray(jeng.params_array(jeng.PolicyParams())))
    return quantized(inputs), np.asarray(jeng.slice_bounds(slice_id, S))


def widened(q, dtype, salt):
    """int8-path inputs with the samples in ``dtype`` and salted: salt maps
    (array index, chip, sample) to a value that int8 cannot hold."""
    tc, hbm = (q[i].astype(dtype) for i in (0, 1))
    for (i, chip, sample), value in salt.items():
        (tc, hbm)[i][chip, sample] = value
    return (tc, hbm, *q[2:])


def veto_qc_fleet():
    """Slice 0 is chips 0..47 (6 a shard), its busy chip in a late shard."""
    C = 64
    slice_id = np.array([0] * 48 + [1] * 16, dtype=np.int32)
    tc = np.zeros((C, 4), dtype=np.float32)
    tc[47, 2] = 0.9
    inputs = (tc, np.zeros((C, 4), np.float32), np.ones((C, 4), dtype=bool),
              np.full((C,), 7200.0, np.float32), slice_id,
              np.asarray(jeng.params_array(jeng.PolicyParams())))
    return quantized(inputs), np.asarray(jeng.slice_bounds(slice_id, 2))


def stream_chunks():
    """tests/test_policy.py's streaming run: C=64, 4 chips a slice, 8 cycles."""
    rng = np.random.default_rng(3)
    C, T_new = 64, 3
    tcs, hbms = [], []
    for _ in range(8):
        util = rng.uniform(0, 1, (C, T_new)).astype(np.float32)
        util[rng.uniform(size=C) < 0.6] = 0.0
        valid = rng.uniform(size=(C, T_new)) < 0.9
        tcs.append(jeng.quantize_samples(util, valid))
        hbms.append(jeng.quantize_samples(np.zeros_like(util), valid))
    age = np.full((C,), 7200.0, np.float32)
    pq = jeng.quantize_params(jeng.params_array(jeng.PolicyParams()))
    return tcs, hbms, age, pq


def cases():
    """name -> (the port's rank call, the JAX reference as a thunk)."""
    f32_128, _ = example(128, 16, 0.5)
    q_128 = quantized(f32_128)
    f32_100, _ = example(100, 10, 0.5)
    q_100 = quantized(f32_100)
    veto = busy_last_chip(64, 1)
    veto_q = quantized(veto)
    het_q, het_bounds = heterogeneous_fleet()
    vq, vq_bounds = veto_qc_fleet()
    u_100 = quantized(example(100, 10, 0.3)[0])
    u_128 = quantized(example(128, 8, 0.5)[0])
    tcs, hbms, age, pq = stream_chunks()
    # 200 and 300 veto an idle slice (1 and 0); an int8 wrap would read them idle
    q_100_u8 = widened(q_100, np.uint8, {(0, 3, 0): 200})
    het_i16 = widened(het_q, np.int16, {(0, 5, 0): 300, (1, 40, 3): -300})
    u_100_u8 = widened(u_100, np.uint8, {(0, 2, 1): 200})
    ids_i8 = (np.arange(100) - 10).astype(np.int8)  # 200 slices, the first ten ids dropped
    mesh = jax_mesh()
    lb_128 = np.asarray(jeng.shard_bounds(
        jeng.slice_bounds(f32_128[4], 16), RANKS, 128 // RANKS))
    lb_het = np.asarray(jeng.shard_bounds(het_bounds, RANKS, 104 // RANKS))
    # the builders take whole shards: pad 100 chips to 104 with -1 rows
    het_padded = [np.pad(x, ((0, 4),) + ((0, 0),) * (x.ndim - 1), constant_values=pv)
                  for x, pv in zip(het_q[:3], (-1, -1, 0.0))]

    def jax_stream():
        step = jeng.make_sharded_stream_step(mesh, chips_per_slice=4)
        state, out = jeng.init_window(64, 5), []
        for tc_new, hbm_new in zip(tcs, hbms):
            state, v = step(state, jnp.asarray(tc_new), jnp.asarray(hbm_new),
                            jnp.asarray(age), jnp.asarray(pq))
            out.append((np.asarray(v), np.asarray(state[0]), np.asarray(state[1]),
                        int(state[2])))
        return out

    return {
        "evaluator_f32": (
            (sharded.run_local, (tp.make_sharded_evaluator, 16, *f32_128)),
            lambda: jax_local(jeng.make_sharded_evaluator(mesh, 16), *f32_128)),
        "evaluator_f32_veto": (
            (sharded.run_local, (tp.make_sharded_evaluator, 1, *veto)),
            lambda: jax_local(jeng.make_sharded_evaluator(mesh, 1), *veto)),
        "evaluator_q": (
            (sharded.run_local, (tp.make_sharded_evaluator_q, 16, *q_128)),
            lambda: jax_local(jeng.make_sharded_evaluator_q(mesh, 16), *q_128)),
        "evaluator_qc": (
            (sharded.run_local, (tp.make_sharded_evaluator_qc, 16, *q_128[:3], lb_128,
                                 q_128[4])),
            lambda: jax_local(jeng.make_sharded_evaluator_qc(mesh, 16), *q_128[:3],
                              lb_128, q_128[4])),
        "evaluator_qc_heterogeneous": (
            (sharded.run_local, (tp.make_sharded_evaluator_qc, 10, *het_padded, lb_het,
                                 het_q[4])),
            lambda: jax_local(jeng.make_sharded_evaluator_qc(mesh, 10), *het_padded, lb_het,
                              het_q[4])),
        "evaluator_qu": (
            (sharded.run_local, (tp.make_sharded_evaluator_qu, 16, *u_128[:3], u_128[4])),
            lambda: jax_local(jeng.make_sharded_evaluator_qu(mesh, 16), *u_128[:3],
                              u_128[4])),
        "fleet_sharded_uneven": (
            (tp.evaluate_fleet_sharded, (*f32_100, 10)),
            lambda: jeng.evaluate_fleet_sharded(*f32_100, num_slices=10)),
        "fleet_sharded_q_uneven": (
            (tp.evaluate_fleet_sharded_q, (*q_100, 10)),
            lambda: jeng.evaluate_fleet_sharded_q(*q_100, num_slices=10)),
        "fleet_sharded_q_veto": (
            (tp.evaluate_fleet_sharded_q, (*veto_q, 1)),
            lambda: jeng.evaluate_fleet_sharded_q(*veto_q, num_slices=1)),
        "fleet_sharded_qc_heterogeneous": (
            (tp.evaluate_fleet_sharded_qc, (*het_q[:3], het_bounds, het_q[4])),
            lambda: jeng.evaluate_fleet_sharded_qc(*het_q[:3], jnp.asarray(het_bounds),
                                                   het_q[4])),
        "fleet_sharded_qc_veto": (
            (tp.evaluate_fleet_sharded_qc, (*vq[:3], vq_bounds, vq[4])),
            lambda: jeng.evaluate_fleet_sharded_qc(*vq[:3], jnp.asarray(vq_bounds), vq[4])),
        "fleet_sharded_qu_padded_slices": (
            (tp.evaluate_fleet_sharded_qu, (*u_100[:3], u_100[4], 10)),
            lambda: jeng.evaluate_fleet_sharded_qu(*u_100[:3], u_100[4],
                                                   chips_per_slice=10)),
        "stream_step": (
            (sharded.run_stream_local, (4, 5, tcs, hbms, age, pq)),
            jax_stream),
        "fleet_sharded_q_uneven_uint8": (
            (tp.evaluate_fleet_sharded_q, (*q_100_u8, 10)),
            lambda: jeng.evaluate_fleet_q(*q_100_u8, num_slices=10)),
        "fleet_sharded_qc_heterogeneous_int16": (
            (tp.evaluate_fleet_sharded_qc, (*het_i16[:3], het_bounds, het_q[4])),
            lambda: jeng.evaluate_fleet_qc(*het_i16[:3], jnp.asarray(het_bounds), het_q[4])),
        "fleet_sharded_qu_padded_slices_uint8": (
            (tp.evaluate_fleet_sharded_qu, (*u_100_u8[:3], u_100[4], 10)),
            lambda: jeng.evaluate_fleet_qu(*u_100_u8[:3], u_100[4], chips_per_slice=10)),
        "fleet_sharded_int8_ids_200_slices": (
            (tp.evaluate_fleet_sharded, (*f32_100[:4], ids_i8, f32_100[5], 200)),
            lambda: jeng.evaluate_fleet(*f32_100[:4], ids_i8, f32_100[5], num_slices=200)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's port results on each of the 8 ranks (one spawn), and the
    JAX results."""
    table = cases()
    calls = [table[name][0] for name in table]
    per_rank = sharded.spawn_ranks(RANKS, calls, device="cpu", timeout_s=120,
                                   workdir=tmp_path_factory.mktemp("rendezvous"))
    return {name: ([out[i] for out in per_rank], table[name][1]())
            for i, name in enumerate(table)}


def assert_equal(ref, got, what):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


BUILDER_CASES = ["evaluator_f32", "evaluator_f32_veto", "evaluator_q", "evaluator_qc",
                 "evaluator_qc_heterogeneous"]


@pytest.mark.parametrize("case", BUILDER_CASES)
def test_builder_matches_mesh(runs, case):
    """Replicated verdicts equal on every rank; candidates are each rank's
    part of the mesh's sharded candidates."""
    per_rank, (ref_v, ref_c) = runs[case]
    for rank, (v, _) in enumerate(per_rank):
        assert_equal(ref_v, v, f"rank {rank} verdicts")
    assert_equal(ref_c, np.concatenate([c for _, c in per_rank]), "candidates")


def test_builder_cross_rank_veto(runs):
    """A busy chip on the last rank vetoes a slice held by every rank."""
    per_rank, _ = runs["evaluator_f32_veto"]
    assert all(v.tolist() == [False] for v, _ in per_rank)
    assert not per_rank[-1][1][-1] and per_rank[0][1].all()


def test_builder_qu_matches_mesh(runs):
    """The uniform builder is collective-free: verdicts and candidates are
    each rank's part of the mesh's sharded outputs (one slice a rank)."""
    per_rank, (ref_v, ref_c) = runs["evaluator_qu"]
    assert all(v.shape == (1,) for v, _ in per_rank)
    assert_equal(ref_v, np.concatenate([v for v, _ in per_rank]), "verdicts")
    assert_equal(ref_c, np.concatenate([c for _, c in per_rank]), "candidates")


GLOBAL_CASES = ["fleet_sharded_uneven", "fleet_sharded_q_uneven", "fleet_sharded_q_veto",
                "fleet_sharded_qc_heterogeneous", "fleet_sharded_qc_veto",
                "fleet_sharded_qu_padded_slices", "fleet_sharded_q_uneven_uint8",
                "fleet_sharded_qc_heterogeneous_int16", "fleet_sharded_qu_padded_slices_uint8",
                "fleet_sharded_int8_ids_200_slices"]


@pytest.mark.parametrize("case", GLOBAL_CASES)
def test_evaluate_fleet_sharded_matches_mesh(runs, case):
    """Global results, the same on every rank, equal the mesh's (the
    single-device reference's for samples int8 cannot hold, and for int8
    ids whose padding segment, 200, int8 cannot hold); chip counts of 100
    pad to 104, and 10 uniform slices pad to 16."""
    per_rank, ref = runs[case]
    for rank, got in enumerate(per_rank):
        assert_equal(ref[0], got[0], f"rank {rank} verdicts")
        assert_equal(ref[1], got[1], f"rank {rank} candidates")


def test_evaluate_fleet_sharded_vetoes(runs):
    assert runs["fleet_sharded_q_veto"][0][0][0].tolist() == [False]
    v, c = runs["fleet_sharded_qc_veto"][0][3]
    assert v.tolist() == [False, True] and not c[47]
    assert runs["fleet_sharded_qc_heterogeneous"][0][0][0].sum() == 3


def test_stream_step_matches_mesh(runs):
    """Per cycle, each rank's verdicts and ring rows are its part of the
    mesh's, over more cycles than the ring holds; cursors agree."""
    per_rank, ref = runs["stream_step"]
    for cycle, (ref_v, ref_tc, ref_hbm, ref_cursor) in enumerate(ref):
        assert_equal(ref_v, np.concatenate([r[cycle][0] for r in per_rank]), f"cycle {cycle}")
        assert_equal(ref_tc, np.concatenate([r[cycle][1] for r in per_rank]), "tc ring")
        assert_equal(ref_hbm, np.concatenate([r[cycle][2] for r in per_rank]), "hbm ring")
        assert all(int(r[cycle][3]) == ref_cursor for r in per_rank)


def test_shard_bounds_matches_reference():
    _, bounds = heterogeneous_fleet()
    for n, size in ((8, 13), (4, 25), (3, 34)):
        got = tp.shard_bounds(bounds, n, size, device="cpu")
        assert got.dtype == torch.int32
        assert_equal(np.asarray(jeng.shard_bounds(bounds, n, size)), got.numpy(), str(n))


def test_builders_need_a_process_group():
    assert not dist.is_initialized()
    for build in (tp.make_sharded_evaluator, tp.make_sharded_evaluator_q,
                  tp.make_sharded_evaluator_qc, tp.make_sharded_evaluator_qu,
                  tp.make_sharded_stream_step):
        with pytest.raises(RuntimeError, match="no initialized process group"):
            build(4)


def test_one_rank_group_in_process(tmp_path):
    """A one-rank gloo group in this process: the sharded forms equal the
    single-device ones, and a ragged uniform fleet is refused."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        inputs, expected = tp.make_example_fleet(96, 8, 6, device="cpu")
        q = tp.quantize_fleet_inputs(inputs)
        v, c = tp.evaluate_fleet_sharded(*inputs, num_slices=6)
        assert v.numpy().tolist() == expected.tolist()
        assert torch.equal(c, tp.evaluate_fleet(*inputs, num_slices=6)[1])
        vq, cq = tp.evaluate_fleet_sharded_qu(q[0], q[1], q[2], q[4], 16)
        assert torch.equal(vq, v) and torch.equal(cq, c)
        with pytest.raises(ValueError, match="do not divide"):
            tp.evaluate_fleet_sharded_qu(q[0][:95], q[1][:95], q[2][:95], q[4], 16)
    finally:
        dist.destroy_process_group()


def test_spawn_ranks_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the spawn with its traceback; nothing hangs."""
    with pytest.raises(RuntimeError, match=r"rank \d failed"):
        sharded.spawn_ranks(2, [(tp.evaluate_fleet_sharded_qu,
                                 (np.zeros((3, 2), np.int8), np.zeros((3, 2), np.int8),
                                  np.zeros(3, np.float32), np.zeros(2, np.float32), 2))],
                            device="cpu", timeout_s=60, workdir=tmp_path)
