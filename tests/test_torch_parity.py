"""The port's engine against the JAX engine where their inputs are unusual:
branched windows, slice ids outside [0, S) and of every integer dtype,
every sample dtype and layout the reference takes on the f32 and int8
paths, contiguous bounds outside [0, C], and window cursors outside [0, K).

The same seeded numpy inputs go through tpu_pruner.policy and
tpu_pruner_torch.policy (CPU tensors, so the kernels' plain versions); the
sharded forms run in a one-rank gloo group in this process, the reference's
on the 8-device virtual CPU mesh of tests/conftest.py. Outputs are booleans
and int8 bytes: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from torch_kernel_cases import gate_cases
from tpu_pruner.policy import engine as jeng
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import engine as teng
from tpu_pruner_torch.policy import sharded

CPU = "cpu"


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def params():
    return np.array([2100.0, 0.05], dtype=np.float32)


def assert_same(ref, got, what=""):
    """JAX outputs against the port's, dtype, shape and values."""
    for r, g in zip(ref, got):
        r = np.asarray(r)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert r.dtype == g.dtype and r.shape == g.shape, what
        np.testing.assert_array_equal(g, r, err_msg=what)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, for the sharded forms."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- branched windows ---------------------------------------------------------


def branch_chunks(C):
    """(idle, busy) int8 chunks of 2 samples: all zeros, and tc at 70%."""
    valid = np.ones((C, 2), bool)
    idle = jeng.quantize_samples(np.zeros((C, 2), np.float32), valid)
    busy = jeng.quantize_samples(np.full((C, 2), 0.7, np.float32), valid)
    return idle, busy


def test_branched_window_matches_reference():
    """s1 = update_window(s0, idle); update_window(s0, busy); s1 still reads
    all idle, as in the reference, and s0 keeps its bytes."""
    C, S, K = 32, 4, 3
    idle, busy = branch_chunks(C)
    slice_id = np.repeat(np.arange(S, dtype=np.int32), C // S)
    age, pq = np.full(C, 7200, np.float32), jeng.quantize_params(params())

    j0 = jeng.init_window(C, K)
    j1 = jeng.update_window(j0, jnp.asarray(idle), jnp.asarray(idle))
    jeng.update_window(j0, jnp.asarray(busy), jnp.asarray(idle))
    ref = jeng.evaluate_window_qc(j1, jnp.asarray(age), jeng.slice_bounds(slice_id, S),
                                  jnp.asarray(pq))

    s0 = tp.init_window(C, K, device=CPU)
    kept = tuple(x.clone() for x in s0)
    s1 = tp.update_window(s0, t(idle), t(idle))
    tp.update_window(s0, t(busy), t(idle))
    got = tp.evaluate_window_qc(s1, t(age), tp.slice_bounds(slice_id, S, device=CPU), t(pq))
    assert_same(ref, got)
    assert got[0].tolist() == [True] * S
    assert all(torch.equal(a, b) for a, b in zip(s0, kept))


def test_branched_stream_step_matches_reference(one_rank):
    """The sharded stream step from one state twice (idle, then busy), then
    on from the idle branch: all idle, as the reference's jitted step."""
    C, K, cps = 32, 3, 4
    idle, busy = branch_chunks(C)
    age, pq = np.full(C, 7200, np.float32), jeng.quantize_params(params())

    jstep = jeng.make_sharded_stream_step(Mesh(np.array(jax.devices()), ("fleet",)),
                                          chips_per_slice=cps)
    jargs = (jnp.asarray(age), jnp.asarray(pq))
    j0 = jeng.init_window(C, K)
    j1, _ = jstep(j0, jnp.asarray(idle), jnp.asarray(idle), *jargs)
    jstep(j0, jnp.asarray(busy), jnp.asarray(idle), *jargs)
    j3, ref_v = jstep(j1, jnp.asarray(idle), jnp.asarray(idle), *jargs)

    step = tp.make_sharded_stream_step(cps)
    s0 = tp.init_window(C, K, device=CPU)
    kept = tuple(x.clone() for x in s0)
    s1, _ = step(s0, t(idle), t(idle), t(age), t(pq))
    step(s0, t(busy), t(idle), t(age), t(pq))
    s3, v = step(s1, t(idle), t(idle), t(age), t(pq))
    assert_same([ref_v, *j3], [v, *s3])
    assert v.tolist() == [True] * (C // cps)
    assert all(torch.equal(a, b) for a, b in zip(s0, kept))


# -- slice ids outside [0, S) ---------------------------------------------------

ID_CASES = {
    "probe": [0, 0, 1, 7, -1, 2],      # 7 and -1 with S = 4
    "edges": [0, 1, 4, -4, 2, 2],      # S and -S
}


def id_fleet(ids, id_dtype, bad_busy):
    """Six chips, every one a candidate unless bad_busy makes the chips with
    an out-of-range id busy (they must veto nothing)."""
    ids = np.array(ids, dtype=id_dtype)
    C, T = ids.size, 4
    tc = np.zeros((C, T), np.float32)
    if bad_busy:
        tc[(ids < 0) | (ids >= 4), 1] = 0.9
    return (tc, np.zeros((C, T), np.float32), np.ones((C, T), bool),
            np.full(C, 7200, np.float32), ids, params())


@pytest.mark.parametrize("bad_busy", [False, True])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_out_of_range_ids_are_dropped(case, id_dtype, bad_busy, one_rank):
    """evaluate_fleet, evaluate_fleet_q and the sharded forms drop chips
    whose id is outside [0, S), as the reference's segment_sum does."""
    S = 4
    fleet = id_fleet(ID_CASES[case], id_dtype, bad_busy)
    jfleet = tuple(jnp.asarray(x) for x in fleet)
    jq = jeng.quantize_fleet_inputs(jfleet)
    ref = jeng.evaluate_fleet(*jfleet, num_slices=S)
    ref_q = jeng.evaluate_fleet_q(*jq, num_slices=S)
    assert_same(ref, jeng.evaluate_fleet_sharded(*jfleet, num_slices=S))
    assert_same(ref_q, jeng.evaluate_fleet_sharded_q(*jq, num_slices=S))
    assert np.asarray(ref[0]).tolist() == [True, True, True, False]

    inputs = tuple(t(x) for x in fleet)
    q = tp.quantize_fleet_inputs(inputs)
    assert q[3].dtype == torch.from_numpy(np.zeros(1, id_dtype)).dtype
    assert_same(ref, tp.evaluate_fleet(*inputs, num_slices=S), "evaluate_fleet")
    assert_same(ref_q, tp.evaluate_fleet_q(*q, num_slices=S), "evaluate_fleet_q")
    assert_same(ref, tp.evaluate_fleet_sharded(*inputs, num_slices=S), "sharded")
    assert_same(ref_q, tp.evaluate_fleet_sharded_q(*q, num_slices=S), "sharded_q")
    assert_same(ref, sharded.run_local(tp.make_sharded_evaluator, S, *inputs), "builder")
    assert_same(ref_q, sharded.run_local(tp.make_sharded_evaluator_q, S, *q), "builder_q")


@pytest.mark.parametrize("seed", [61, 62, 63])
def test_salted_out_of_range_ids_match_reference(seed):
    """A random fleet whose ids are drawn from [-S, 2S): a third of the chips
    lie outside every slice."""
    rng = np.random.default_rng(seed)
    C, T, S = 200, 12, 9
    ids = rng.integers(-S, 2 * S, size=C).astype(np.int32)
    # chips outside every slice are mostly busy: counted anywhere, they would veto
    busy = rng.uniform(size=C) < np.where(np.isin(ids, np.arange(S)), 0.08, 0.7)
    tc = (busy[:, None] * rng.uniform(0.2, 1, size=(C, T))).astype(np.float32)
    hbm = np.zeros((C, T), np.float32)
    valid = rng.uniform(size=(C, T)) < 0.9
    age = np.full(C, 7200, np.float32)
    fleet = (tc, hbm, valid, age, ids, params())
    jfleet = tuple(jnp.asarray(x) for x in fleet)
    inputs = tuple(t(x) for x in fleet)
    ref = jeng.evaluate_fleet(*jfleet, num_slices=S)
    assert 0 < int(np.asarray(ref[0]).sum()) < S
    assert_same(ref, tp.evaluate_fleet(*inputs, num_slices=S))
    assert_same(jeng.evaluate_fleet_q(*jeng.quantize_fleet_inputs(jfleet), num_slices=S),
                tp.evaluate_fleet_q(*tp.quantize_fleet_inputs(inputs), num_slices=S))


# -- dtypes and layouts ---------------------------------------------------------

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "float64": torch.float64, "int32": torch.int32}
# a subnormal of each float dtype; f16's widens to a normal f32 (busy), the
# others are f32 subnormals after the cast (flushed: idle)
SUBNORMAL = {"bfloat16": 1e-39, "float16": 6e-8, "float32": 1e-40, "float64": 1e-45}
LAYOUTS = ("contiguous", "transposed", "strided")


def samples(rng, quiet, T, dtype, scale):
    """[C, T] samples in ``dtype``, zero on the quiet rows; a quarter of the
    rows get one special value: a subnormal, NaN, +inf or -0.0 (floats)."""
    C = quiet.size
    if dtype == "int32":
        x = (rng.uniform(size=(C, T)) < 0.2).astype(np.float64)
    else:
        x = np.where(rng.uniform(size=(C, T)) < 0.5, rng.uniform(0, scale, (C, T)), 0.0)
    x[quiet] = 0.0
    if dtype != "int32":
        rows = np.flatnonzero(rng.uniform(size=C) < 0.25)
        specials = np.array([SUBNORMAL[dtype], -SUBNORMAL[dtype], np.nan, np.inf, -0.0])
        x[rows, rng.integers(0, T, size=rows.size)] = rng.choice(specials, size=rows.size)
    return torch.from_numpy(x).to(TORCH_DTYPES[dtype])


def to_jax(x: torch.Tensor):
    """The same values for the reference: bf16 by its bits, the rest as numpy
    (f64 narrowed to f32, as JAX does with x64 off)."""
    if x.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(jnp.asarray(x.view(torch.int16).numpy()),
                                            jnp.bfloat16)
    return jnp.asarray(x.numpy())


def laid_out(x: torch.Tensor, layout: str) -> torch.Tensor:
    """x as a contiguous tensor, a column-major view or every other column of
    a wider tensor."""
    if layout == "transposed":
        return x.t().contiguous().t()
    if layout == "strided":
        wide = torch.zeros((x.shape[0], 2 * x.shape[1]), dtype=x.dtype)
        wide[:, ::2] = x
        return wide[:, ::2]
    return x


def dtype_fleet(seed, dtype, layout, C=96, T=12, S=24):
    """Four chips a slice, the even slices quiet, a few young pods."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(S, dtype=np.int32), C // S)
    quiet = ids % 2 == 0
    tc, hbm = samples(rng, quiet, T, dtype, 1.0), samples(rng, quiet, T, dtype, 0.1)
    valid = torch.from_numpy(rng.uniform(size=(C, T)) < 0.9)
    age = np.where(rng.uniform(size=C) < 0.05, 60.0, 7200.0).astype(np.float32)
    age, slice_id = torch.from_numpy(age), torch.from_numpy(ids)
    inputs = (laid_out(tc, layout), laid_out(hbm, layout), laid_out(valid, layout),
              age, slice_id, torch.from_numpy(params()))
    return inputs, (to_jax(tc), to_jax(hbm), jnp.asarray(valid.numpy()),
                    jnp.asarray(age.numpy()), jnp.asarray(slice_id.numpy()),
                    jnp.asarray(params()))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", sorted(TORCH_DTYPES))
def test_sample_dtypes_and_layouts_match_reference(dtype, layout):
    """bf16, f16, f64 and integer samples, contiguous or not, through every
    f32 entry point and the device quantizer into the int8 paths."""
    S = 24
    inputs, jinputs = dtype_fleet(71, dtype, layout)
    if layout != "contiguous":
        assert not inputs[0].is_contiguous()
    ref = jeng.evaluate_fleet(*jinputs, num_slices=S)
    assert 0 < int(np.asarray(ref[0]).sum()) < S
    assert_same(ref, tp.evaluate_fleet(*inputs, num_slices=S), "evaluate_fleet")
    bounds = tp.slice_bounds(inputs[4], S, device=CPU)
    assert_same(jeng.evaluate_fleet_c(*jinputs[:4], jeng.slice_bounds(jinputs[4], S),
                                      jinputs[5]),
                tp.evaluate_fleet_c(*inputs[:4], bounds, inputs[5]), "evaluate_fleet_c")
    assert_same([jeng.evaluate_chips(*jinputs[:4], 2100.0, 0.05)],
                [tp.evaluate_chips(*inputs[:4], 2100.0, 0.05)], "evaluate_chips")

    jq = jeng.quantize_fleet_inputs(jinputs)
    q = tp.quantize_fleet_inputs(inputs)
    assert_same(jq[:2], q[:2], "quantized samples")
    assert_same(jeng.evaluate_fleet_qc(jq[0], jq[1], jq[2], jeng.slice_bounds(jinputs[4], S),
                                       jq[4]),
                tp.evaluate_fleet_qc(q[0], q[1], q[2], bounds, q[4]), "evaluate_fleet_qc")


@pytest.mark.parametrize("dtype", sorted(SUBNORMAL))
@pytest.mark.parametrize("special", ["subnormal", "nan"])
def test_special_sample_verdicts(dtype, special):
    """One chip whose only non-zero sample is a subnormal or NaN of ``dtype``:
    an f16 subnormal reads busy (it widens to a normal f32), a bf16, f32 or
    f64 subnormal idle (flushed after the cast), NaN busy, in both packages."""
    value = SUBNORMAL[dtype] if special == "subnormal" else np.nan
    x = np.zeros((1, 4))
    x[0, 1] = value
    tc = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    zeros = torch.zeros((1, 4), dtype=tc.dtype)
    rest = (np.ones((1, 4), bool), np.full(1, 7200, np.float32), np.zeros(1, np.int32),
            params())
    ref = jeng.evaluate_fleet(to_jax(tc), to_jax(zeros), *(jnp.asarray(r) for r in rest),
                              num_slices=1)
    got = tp.evaluate_fleet(tc, zeros, *(t(r) for r in rest), num_slices=1)
    assert_same(ref, got)
    idle = special == "subnormal" and dtype != "float16"
    assert got[0].tolist() == [idle]


MASK_DTYPES = {"bool": bool, "int32": np.int32, "int64": np.int64, "uint8": np.uint8}
AGE_DTYPES = {"float32": np.float32, "float64": np.float64, "int32": np.int32,
              "int64": np.int64}


@pytest.mark.parametrize("age_dtype", sorted(AGE_DTYPES))
@pytest.mark.parametrize("mask_dtype", sorted(MASK_DTYPES))
def test_mask_and_age_dtypes_match_reference(mask_dtype, age_dtype):
    """Integer validity masks (nonzero is valid, 3 and 255 too) and f64 or
    integer ages, some a hair under the lookback, through the f32 and int8
    entry points and the device quantizer."""
    rng = np.random.default_rng(83)
    C, T, S = 96, 12, 24
    cps = C // S
    slice_id = np.repeat(np.arange(S, dtype=np.int32), cps)
    quiet = slice_id % 2 == 0
    tc = ((rng.uniform(size=(C, T)) < 0.3) * rng.uniform(size=(C, T))).astype(np.float32)
    hbm = rng.uniform(0, 0.1, size=(C, T)).astype(np.float32)
    tc[quiet] = hbm[quiet] = 0.0
    on = rng.uniform(size=(C, T)) < 0.85
    valid = on if mask_dtype == "bool" else np.where(
        on, rng.choice(np.array([1, 3, 255 if mask_dtype == "uint8" else -2]), size=(C, T)),
        0).astype(MASK_DTYPES[mask_dtype])
    age = np.full(C, 7200.0)
    # f64 2100 - 1e-9 rounds to 2100.0f (eligible); the integers straddle 2100
    age[::7] = 2100 - 1e-9 if age_dtype == "float64" else 2099
    age[::11] = 2100
    age = age.astype(AGE_DTYPES[age_dtype])
    fleet = (tc, hbm, valid, age, slice_id, params())
    jfleet = tuple(jnp.asarray(x) for x in fleet)
    inputs = tuple(t(x) for x in fleet)

    ref = jeng.evaluate_fleet(*jfleet, num_slices=S)
    assert 0 < int(np.asarray(ref[0]).sum()) < S
    assert_same(ref, tp.evaluate_fleet(*inputs, num_slices=S), "evaluate_fleet")
    jq = jeng.quantize_fleet_inputs(jfleet)
    q = tp.quantize_fleet_inputs(inputs)
    assert_same(jq[:2], q[:2], "quantized samples")
    assert_same(jeng.evaluate_fleet_q(*jq, num_slices=S),
                tp.evaluate_fleet_q(*q, num_slices=S), "evaluate_fleet_q")
    assert_same(jeng.evaluate_fleet_qu(jq[0], jq[1], jq[2], jq[4], chips_per_slice=cps),
                tp.evaluate_fleet_qu(q[0], q[1], q[2], q[4], cps), "evaluate_fleet_qu")
    assert_same([jeng.evaluate_chips_q(jq[0], jq[1], jq[2], 2100.0, 5.0)],
                [tp.evaluate_chips_q(q[0], q[1], q[2], 2100.0, 5.0)], "evaluate_chips_q")


def test_sharded_f32_evaluators_normalize_inputs(one_rank):
    """The two sharded f32 evaluators take bf16 strided samples, an integer
    mask and f64 ages, and equal the reference's evaluate_fleet."""
    S = 24
    inputs, jinputs = dtype_fleet(73, "bfloat16", "strided")
    tc, hbm, valid, age, slice_id, parr = inputs
    inputs = (tc, hbm, valid.to(torch.uint8), age.double(), slice_id, parr.double())
    ref = jeng.evaluate_fleet(*jinputs, num_slices=S)
    assert_same(ref, tp.evaluate_fleet_sharded(*inputs, num_slices=S), "sharded")
    assert_same(ref, sharded.run_local(tp.make_sharded_evaluator, S, *inputs), "builder")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_make_example_fleet_dtype_matches_reference(dtype):
    """make_example_fleet(dtype=...) casts tc and hbm only, to the same bits
    as the reference's jnp.asarray(x, dtype=...)."""
    jdtype = getattr(jnp, dtype)
    j_inputs, j_expected = jeng.make_example_fleet(128, 12, 8, 0.5, 4, dtype=jdtype)
    t_inputs, t_expected = tp.make_example_fleet(128, 12, 8, 0.5, 4,
                                                 dtype=TORCH_DTYPES[dtype], device=CPU)
    assert t_inputs[0].dtype == t_inputs[1].dtype == TORCH_DTYPES[dtype]
    for j, g in zip(j_inputs, t_inputs):
        j = np.asarray(j)
        assert g.element_size() == j.itemsize and tuple(g.shape) == j.shape
        assert g.contiguous().view(torch.uint8).numpy().tobytes() == j.tobytes()
    np.testing.assert_array_equal(t_expected, j_expected)
    v, _ = tp.evaluate_fleet(*t_inputs, num_slices=8)
    np.testing.assert_array_equal(v.numpy(), np.asarray(
        jeng.evaluate_fleet(*j_inputs, num_slices=8)[0]))
    np.testing.assert_array_equal(v.numpy(), t_expected)


# -- window cursors outside [0, K) ------------------------------------------------

K_CURSOR = 3
# cursor -> (column written, next cursor), probed on the reference
CURSOR_TABLE = {-5: (0, 2), -4: (0, 0), -3: (0, 1), -1: (2, 0), 0: (0, 1), 2: (2, 0),
                3: (2, 1), 5: (2, 0)}


def written(ring_before: np.ndarray, ring_after: np.ndarray) -> int:
    changed = np.flatnonzero((ring_before != ring_after).any(axis=0))
    assert changed.size == 1
    return int(changed[0])


@pytest.mark.parametrize("cursor", range(-2 * K_CURSOR, 2 * K_CURSOR + 1))
def test_window_cursor_matches_reference(cursor):
    """Any cursor in -2K..2K: the column written and the next cursor equal the
    reference's, for update_window, update_window_ and a plain int cursor."""
    C = 4
    new = np.full((C, 2), 9, np.int8)
    j0 = jeng.init_window(C, K_CURSOR)
    j1 = jeng.update_window((j0[0], j0[1], jnp.int32(cursor)), jnp.asarray(new),
                            jnp.asarray(new))
    want = (written(np.asarray(j0[0]), np.asarray(j1[0])), int(j1[2]))
    if cursor in CURSOR_TABLE:
        assert want == CURSOR_TABLE[cursor]

    for form, c in ((tp.update_window, torch.tensor(cursor, dtype=torch.int32)),
                    (tp.update_window_, torch.tensor(cursor, dtype=torch.int32)),
                    (tp.update_window, cursor)):
        s0 = tp.init_window(C, K_CURSOR, device=CPU)
        before = s0[0].clone()
        s1 = form((s0[0], s0[1], c), t(new), t(new))
        assert s1[2].dtype == torch.int32 and s1[2].dim() == 0
        assert (written(before.numpy(), s1[0].numpy()), int(s1[2])) == want, form.__name__
        assert_same(j1[:2], s1[:2])


# -- int8-path samples of any dtype ---------------------------------------------

Q_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
            "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
            "uint8": torch.uint8}
Q_PATHS = ("evaluate_chips_q", "evaluate_fleet_q", "evaluate_fleet_qc", "evaluate_fleet_qu")
Q_CUTOFFS = (5.0, np.inf)


def q_values(dtype, values):
    """The values of ``values`` that ``dtype`` holds (no NaN or inf in an
    integer dtype, nothing negative in uint8, nothing over 127 in int8)."""
    v = np.array(values, dtype=np.float64)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        v = v[np.isfinite(v) & (v >= info.min) & (v <= info.max)]
    return v


def q_fleet(seed, dtype, C=96, T=12, S=24):
    """int8-path inputs in ``dtype``: four chips a slice, the even slices
    quiet. tc is 0 or -1 on quiet rows, and up to 255 (uint8) or 300 (wider)
    on busy rows; hbm lies under the cutoff. One row in eight gets a tc
    special (NaN, +-inf, -0.0, +-subnormal for floats, 200, 255), one in six
    an hbm special or a value at or around the cutoff. Returns (port inputs, JAX inputs)
    with the cutoff still to be chosen: (tc, hbm, age, slice_id)."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(S, dtype=np.int32), C // S)
    quiet = ids % 2 == 0
    sub = SUBNORMAL.get(dtype, 0.0)
    idle_vals = q_values(dtype, [0, 0, 0, -1])
    tc = np.where(quiet[:, None], rng.choice(idle_vals, size=(C, T)),
                  np.where(rng.uniform(size=(C, T)) < 0.5,
                           rng.choice(q_values(dtype, [1, 5, 100, 127, 200, 255, 300, 0.5,
                                                       np.inf]), size=(C, T)), 0.0))
    hbm = rng.choice(q_values(dtype, [0, 1, 4, -1, 4.5]), size=(C, T))
    specials = q_values(dtype, [np.nan, np.inf, -np.inf, -0.0, sub, -sub, 200, 255])
    for x, share, vals in ((tc, 1 / 8, specials),
                           (hbm, 1 / 6, np.concatenate([specials, q_values(
                               dtype, [5, 6, 4.999, 5.001, 5 + 2 ** -20, 128, 300])]))):
        rows = np.flatnonzero(rng.uniform(size=C) < share)
        x[rows, rng.integers(0, T, size=rows.size)] = rng.choice(vals, size=rows.size)
    age = np.where(rng.uniform(size=C) < 0.05, 60.0, 7200.0).astype(np.float32)
    tc, hbm = (torch.from_numpy(x).to(Q_DTYPES[dtype]) for x in (tc, hbm))
    return ((tc, hbm, torch.from_numpy(age), torch.from_numpy(ids)),
            (to_jax(tc), to_jax(hbm), jnp.asarray(age), jnp.asarray(ids)))


def q_path(module, path, tc, hbm, age, ids, pq, S, bounds):
    """One int8 entry point of the JAX engine or the port on the same inputs."""
    if path == "evaluate_chips_q":
        return [module.evaluate_chips_q(tc, hbm, age, pq[0], pq[1])]
    if path == "evaluate_fleet_q":
        return module.evaluate_fleet_q(tc, hbm, age, ids, pq, num_slices=S)
    if path == "evaluate_fleet_qc":
        return module.evaluate_fleet_qc(tc, hbm, age, bounds, pq)
    return module.evaluate_fleet_qu(tc, hbm, age, pq, chips_per_slice=tc.shape[0] // S)


@pytest.mark.parametrize("path", Q_PATHS)
@pytest.mark.parametrize("dtype", sorted(Q_DTYPES))
def test_q_sample_dtypes_match_reference(dtype, path):
    """int16/32/64, uint8 (over 127 too), f32, f16 and bf16 samples on the
    int8 paths, with a finite and a disabled (+inf) quantized cutoff: the
    reference runs its max in the samples' own dtype, the port maps them
    to int8 first (normalize_inputs_q)."""
    S = 24
    inputs, jinputs = q_fleet(91, dtype)
    bounds = tp.slice_bounds(inputs[3], S, device=CPU)
    jbounds = jeng.slice_bounds(np.asarray(jinputs[3]), S)
    for cutoff in Q_CUTOFFS:
        pq = np.array([2100.0, cutoff], np.float32)
        ref = q_path(jeng, path, *jinputs, jnp.asarray(pq), S, jbounds)
        got = q_path(tp, path, *inputs, t(pq), S, bounds)
        assert_same(ref, got, f"{path}, cutoff {cutoff}")
        if cutoff == Q_CUTOFFS[0] and path != "evaluate_chips_q":
            assert 0 < int(np.asarray(ref[0]).sum()) < S



# special -> (tc row, hbm row, quantized cutoff, idle in f16, idle in bf16/f32/f64);
# "sub" is the dtype's subnormal, and the answers are the reference's
Q_SPECIALS = {
    "tc subnormal": ([0, "sub", 0, 0], [0, 0, 0, 0], 5e-8, False, True),
    "tc nan": ([0, np.nan, 0, 0], [0, 0, 0, 0], 5e-8, False, False),
    "hbm subnormal": ([0, 0, 0, 0], [0, "sub", 0, 0], 5e-8, False, True),
    "hbm nan": ([0, 0, 0, 0], [0, np.nan, 9, 0], 5e-8, True, True),
    "hbm -subnormal, cutoff 0": ([0, 0, 0, 0], [-1, "-sub", -1, -1], 0.0, True, False),
    "hbm 0, subnormal cutoff": ([0, 0, 0, 0], [-1, 0, -1, -1], 1e-40, False, False),
}


@pytest.mark.parametrize("dtype", sorted(SUBNORMAL))
@pytest.mark.parametrize("special", sorted(Q_SPECIALS))
def test_special_q_sample_verdicts(dtype, special):
    """One chip on the int8 path with one special sample of ``dtype``, the
    rule the reference's answers give: a float is cast to f32 and then
    flushed, so a tc or hbm subnormal is non-zero in f16 (it widens to a
    normal f32) and zero in bf16, f32 and f64; a tc NaN reads busy; a NaN
    hbm row never meets the cutoff, even with a 9 beside the NaN; and a
    subnormal cutoff is flushed to 0."""
    tc_row, hbm_row, cutoff, idle_f16, idle_other = Q_SPECIALS[special]
    sub = {"sub": SUBNORMAL[dtype], "-sub": -SUBNORMAL[dtype]}
    tc, hbm = (torch.tensor([[sub.get(v, v) for v in row]], dtype=torch.float64)
               .to(TORCH_DTYPES[dtype]) for row in (tc_row, hbm_row))
    pq = np.array([2100.0, cutoff], np.float32)
    rest = (np.full(1, 7200, np.float32), np.zeros(1, np.int32), pq)
    ref = jeng.evaluate_fleet_q(to_jax(tc), to_jax(hbm), *(jnp.asarray(r) for r in rest),
                                num_slices=1)
    got = tp.evaluate_fleet_q(tc, hbm, *(t(r) for r in rest), num_slices=1)
    assert_same(ref, got)
    assert got[0].tolist() == [idle_f16 if dtype == "float16" else idle_other]


@pytest.mark.parametrize("dtype", ["int16", "uint8"])
def test_sharded_q_evaluators_take_any_sample_dtype(dtype, one_rank):
    """The sharded int8 entry points and builders map samples to int8 before
    they pad, and equal the reference's single-device results."""
    S = 24
    cps = 4
    inputs, jinputs = q_fleet(93, dtype)
    tc, hbm, age, ids = inputs
    bounds = tp.slice_bounds(ids, S, device=CPU)
    for cutoff in Q_CUTOFFS:
        pq = np.array([2100.0, cutoff], np.float32)
        jpq = jnp.asarray(pq)
        ref_q = jeng.evaluate_fleet_q(*jinputs, jpq, num_slices=S)
        ref_qc = jeng.evaluate_fleet_qc(*jinputs[:3], jeng.slice_bounds(np.asarray(ids), S),
                                        jpq)
        ref_qu = jeng.evaluate_fleet_qu(*jinputs[:3], jpq, chips_per_slice=cps)
        assert_same(ref_q, tp.evaluate_fleet_sharded_q(*inputs, t(pq), num_slices=S), "q")
        assert_same(ref_qc, tp.evaluate_fleet_sharded_qc(tc, hbm, age, bounds, t(pq)), "qc")
        assert_same(ref_qu, tp.evaluate_fleet_sharded_qu(tc, hbm, age, t(pq), cps), "qu")
        assert_same(ref_q, sharded.run_local(tp.make_sharded_evaluator_q, S, *inputs, t(pq)),
                    "builder q")
        assert_same(ref_qc, sharded.run_local(
            tp.make_sharded_evaluator_qc, S, tc, hbm, age,
            tp.shard_bounds(bounds, 1, tc.shape[0], device=CPU), t(pq)), "builder qc")
        assert_same(ref_qu, sharded.run_local(tp.make_sharded_evaluator_qu, cps, tc, hbm, age,
                                              t(pq)), "builder qu")


def test_main_path_inputs_pass_untouched():
    """int8 contiguous samples, f32 ages and params, and int32 or int64 ids
    come back as the very tensors given: no copy and no device work."""
    tc = torch.zeros((8, 3), dtype=torch.int8)
    hbm, age, pq = tc.clone(), torch.zeros(8), torch.tensor([2100.0, 5.0])
    out = teng.normalize_inputs_q(tc, hbm, age, pq)
    assert all(a is b for a, b in zip(out, (tc, hbm, age, pq)))
    for dtype in (torch.int32, torch.int64):
        ids = torch.zeros(8, dtype=dtype)
        assert teng.normalize_slice_ids(ids) is ids


# -- contiguous bounds outside [0, C] --------------------------------------------

BOUND_CASES = {
    "past the end": [0, 4, 8, 12, 20],
    "far negative": [-40, -17, -3, 0, 16],
    "out of order, past the end": [0, 4, 20, 8, 16],
    "all past the end": [0, 100, 200, 300, 400],
    "negative, descending past the start": [-1, -2, -3, -17, -18],
}


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_out_of_range_bounds_match_reference(case):
    """Bounds outside [0, C] on 16 chips with two busy chips: read as the
    reference's gather reads them (negative from the end, then clamped),
    through slice_verdicts_contiguous, evaluate_fleet_c and _qc."""
    C, T = 16, 4
    bounds = np.array(BOUND_CASES[case], np.int32)
    tc = np.zeros((C, T), np.float32)
    tc[[5, 14], 1] = 0.5
    fleet = (tc, np.zeros((C, T), np.float32), np.ones((C, T), bool),
             np.full(C, 7200, np.float32))
    jfleet = tuple(jnp.asarray(x) for x in fleet)
    inputs = tuple(t(x) for x in fleet)
    candidate = tc.max(axis=1) == 0
    assert_same([jeng.slice_verdicts_contiguous(jnp.asarray(candidate), jnp.asarray(bounds))],
                [tp.slice_verdicts_contiguous(t(candidate), t(bounds))], "verdicts")
    assert_same(jeng.evaluate_fleet_c(*jfleet, jnp.asarray(bounds), jnp.asarray(params())),
                tp.evaluate_fleet_c(*inputs, t(bounds), t(params())), "evaluate_fleet_c")
    jq = jeng.quantize_fleet_inputs((*jfleet, None, jnp.asarray(params())))
    q = tp.quantize_fleet_inputs((*inputs, None, t(params())))
    assert_same(jeng.evaluate_fleet_qc(jq[0], jq[1], jq[2], jnp.asarray(bounds), jq[4]),
                tp.evaluate_fleet_qc(q[0], q[1], q[2], t(bounds), q[4]), "evaluate_fleet_qc")


GATE_CASES = gate_cases(31)


@pytest.mark.parametrize("case", sorted(c for c, (cand, _) in GATE_CASES.items()
                                        if c != "int64 wrap" and cand.size <= 1003))
def test_contiguous_gate_cases_match_reference(case):
    """The slice gate's adversarial bounds (torch_kernel_cases.gate_cases: bounds
    outside [0, C], out of order, empty, inverted and one-chip slices in
    int32, int64, int8, int16 and uint8, int32 wrap, 1-chip slices, one
    slice of all chips, uneven fleets with thrown bounds, S = 0, C = 0)
    through evaluate_fleet_c and _qc, on fleets whose candidates are the
    case's. JAX with x64 off narrows int64 bounds to int32, so the int64
    wrap case is held to the plain version in test_torch_policy.py."""
    cand, bounds = GATE_CASES[case]
    C, T = cand.size, 3
    tc = np.repeat(np.where(cand, 0.0, 0.5).astype(np.float32)[:, None], T, axis=1)
    fleet = (tc, np.zeros((C, T), np.float32), np.ones((C, T), bool),
             np.full(C, 7200, np.float32))
    jfleet = tuple(jnp.asarray(x) for x in fleet)
    inputs = tuple(t(x) for x in fleet)
    ref = jeng.evaluate_fleet_c(*jfleet, jnp.asarray(bounds), jnp.asarray(params()))
    np.testing.assert_array_equal(np.asarray(ref[1]), cand)
    assert_same(ref, tp.evaluate_fleet_c(*inputs, t(bounds), t(params())), "evaluate_fleet_c")
    jq = jeng.quantize_fleet_inputs((*jfleet, None, jnp.asarray(params())))
    q = tp.quantize_fleet_inputs((*inputs, None, t(params())))
    assert_same(jeng.evaluate_fleet_qc(jq[0], jq[1], jq[2], jnp.asarray(bounds), jq[4]),
                tp.evaluate_fleet_qc(q[0], q[1], q[2], t(bounds), q[4]), "evaluate_fleet_qc")


@pytest.mark.parametrize("bounds_dtype", ["bool", "float32", "float64"])
def test_bool_and_float_bounds_are_refused(bounds_dtype):
    """The reference refuses bool and float contiguous bounds; so does the
    port, on either device, with a TypeError that names the dtype (its
    plain cumsum and gather alone would have read float bounds)."""
    cand = np.array([True, False, True, True])
    bounds = np.array([0, 1, 3, 4]).astype(bounds_dtype)
    with pytest.raises((IndexError, TypeError)):
        jeng.slice_verdicts_contiguous(jnp.asarray(cand), jnp.asarray(bounds))
    with pytest.raises(TypeError, match=bounds_dtype):
        tp.slice_verdicts_contiguous(t(cand), t(bounds))
    fleet = tuple(t(x) for x in (np.zeros((4, 2), np.float32), np.zeros((4, 2), np.float32),
                                 np.ones((4, 2), bool), np.full(4, 7200, np.float32)))
    with pytest.raises(TypeError, match=bounds_dtype):
        tp.evaluate_fleet_c(*fleet, t(bounds), t(params()))


# -- slice ids of every integer dtype ---------------------------------------------

NARROW_ID_DTYPES = ("int8", "int16", "uint8", "uint16", "uint32")


@pytest.mark.parametrize("id_dtype", NARROW_ID_DTYPES)
def test_narrow_and_unsigned_ids_match_reference(id_dtype, one_rank):
    """Ids of every narrow or unsigned integer dtype, over 200 slices (more
    than int8 holds, so the sharded forms' sentinel segment needs the ids
    widened), some ids outside [0, S): slice_verdicts, evaluate_fleet(_q)
    and their sharded forms equal the reference."""
    rng = np.random.default_rng(97)
    C, T, S = 400, 4, 200
    info = np.iinfo(id_dtype)
    ids = rng.integers(max(info.min, -20), min(info.max, 260) + 1, size=C).astype(id_dtype)
    tc = ((rng.uniform(size=(C, T)) < 0.02) * 0.5).astype(np.float32)
    fleet = (tc, np.zeros((C, T), np.float32), np.ones((C, T), bool),
             np.full(C, 7200, np.float32), ids, params())
    jfleet = tuple(jnp.asarray(x) for x in fleet)
    inputs = tuple(t(x) for x in fleet)
    assert inputs[4].dtype == getattr(torch, id_dtype)
    ref = jeng.evaluate_fleet(*jfleet, num_slices=S)
    assert 0 < int(np.asarray(ref[0]).sum()) < S
    assert_same([jeng.slice_verdicts(ref[1], jfleet[4], S)],
                [tp.slice_verdicts(t(np.array(ref[1])), inputs[4], S)], "slice_verdicts")
    assert_same(ref, tp.evaluate_fleet(*inputs, num_slices=S), "evaluate_fleet")
    assert_same(ref, tp.evaluate_fleet_sharded(*inputs, num_slices=S), "sharded")
    jq = jeng.quantize_fleet_inputs(jfleet)
    q = tp.quantize_fleet_inputs(inputs)
    ref_q = jeng.evaluate_fleet_q(*jq, num_slices=S)
    assert_same(ref_q, tp.evaluate_fleet_q(*q, num_slices=S), "evaluate_fleet_q")
    assert_same(ref_q, tp.evaluate_fleet_sharded_q(*q, num_slices=S), "sharded_q")


@pytest.mark.parametrize("id_dtype", ["bool", "float32"])
def test_bool_and_float_ids_are_refused(id_dtype):
    """The reference refuses bool and float slice ids; so does the port,
    with a TypeError that names the dtype."""
    C, S = 6, 3
    ids = np.array([0, 0, 1, 1, 0, 1]).astype(id_dtype)
    fleet = (np.zeros((C, 4), np.float32), np.zeros((C, 4), np.float32),
             np.ones((C, 4), bool), np.full(C, 7200, np.float32), ids, params())
    with pytest.raises((IndexError, TypeError)):
        jeng.evaluate_fleet(*(jnp.asarray(x) for x in fleet), num_slices=S)
    inputs = tuple(t(x) for x in fleet)
    for run in (lambda: tp.evaluate_fleet(*inputs, num_slices=S),
                lambda: tp.slice_verdicts(torch.ones(C, dtype=torch.bool), inputs[4], S)):
        with pytest.raises(TypeError, match=id_dtype):
            run()
