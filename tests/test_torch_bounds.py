"""engine.slice_bounds' native pass against its plain version, on the CPU.

Every input gives what the plain version (the reference's body: ``np.diff``
and ``np.searchsorted``) gives, bit for bit, or the same exception; each case
also checks which path answered (the ``obs`` counters ``bounds_native`` and
``bounds_fallback``). The pass is built with the host's C++ compiler at
first use. Only ``test_bounds_match_the_jax_reference`` imports JAX: on the
card's machine, ``python -m pytest --noconftest tests/test_torch_bounds.py
-k "not jax"`` holds that machine's compiler to the same cases.
"""

import numpy as np
import pytest
import torch

from torch_kernel_cases import mixed_sizes
from tpu_pruner_torch import hostlib, obs
from tpu_pruner_torch import policy as tp
from tpu_pruner_torch.policy import engine

I32_MIN, I32_MAX = -2**31, 2**31 - 1
I64_MIN, I64_MAX = -2**63, 2**63 - 1


def repeat_ids(sizes, dtype=np.int32):
    return np.repeat(np.arange(len(sizes), dtype=dtype), sizes)


def gaps(dtype):
    """Uneven slices, a run of empty ones, and ids missing at both ends."""
    rng = np.random.default_rng(22)
    sizes = rng.integers(0, 40, size=300)
    sizes[100:130] = 0
    return np.repeat(np.arange(5, 305, dtype=dtype), sizes), 320


def random_sorted(seed):
    """Seeded sorted ids: lengths 0-70 with runs of one length, ids from
    below 0 to past S, int32 or int64."""
    rng = np.random.default_rng(seed)
    dtype = (np.int32, np.int64)[seed % 2]
    sizes = np.where(rng.random(400) < 0.5, 16, rng.integers(0, 70, size=400))
    ids = np.repeat(np.arange(400, dtype=dtype) - int(rng.integers(0, 20)), sizes)
    return ids, int(rng.integers(0, 420))


# name: (ids, num_slices, the path that answers)
CASES = {
    "uniform-8192x16": (repeat_ids(np.full(8192, 16)), 8192, "native"),
    "uniform-65536x16": (repeat_ids(np.full(65536, 16)), 65536, "native"),
    "uniform-8192x16-int64": (repeat_ids(np.full(8192, 16), np.int64), 8192, "native"),
    "mixed-131072": (repeat_ids(mixed_sizes(131072)), len(mixed_sizes(131072)), "native"),
    "one-chip-slices": (np.arange(4096, dtype=np.int32), 4096, "native"),
    "one-slice": (np.zeros(1000, np.int32), 1, "native"),
    "gaps-int32": (*gaps(np.int32), "native"),
    "gaps-int64": (*gaps(np.int64), "native"),
    "negative-and-past-S": (np.array([-7, -7, -1, 0, 0, 2, 5, 5, 9, 40], np.int32), 6, "native"),
    "all-negative": (np.array([-3, -2, -2], np.int32), 4, "native"),
    "all-past-S": (np.array([8, 8, 9], np.int64), 4, "native"),
    "num-slices-0": (np.array([-1, 0, 0, 1], np.int32), 0, "native"),
    "num-slices-1": (np.array([0, 0, 1, 1], np.int32), 1, "native"),
    "num-slices-numpy-int": (np.array([0, 1, 1, 3], np.int32), np.int64(4), "native"),
    "num-slices-past-ids": (np.array([0, 0, 1], np.int32), 50, "native"),
    "empty": (np.zeros(0, np.int32), 5, "native"),
    "empty-num-slices-0": (np.zeros(0, np.int64), 0, "native"),
    "int64-beyond-int32": (np.array([-2**40, -5, 0, 0, 3, 2**33, 2**62], np.int64), 5,
                           "native"),
    "int64-ends": (np.array([I64_MIN, -1, 0, 1], np.int64), 3, "native"),
    "int32-ends": (np.array([I32_MIN, -1, 0, 1, I32_MAX], np.int32), 3, "native"),
    # np.diff's difference wraps: refused by the plain version's error
    "int32-span-refused": (np.array([I32_MIN, I32_MAX], np.int32), 2, "plain"),
    "int64-span-refused": (np.array([I64_MIN, 0, I64_MAX], np.int64), 2, "plain"),
    # every wrapped difference >= 0, but the ids descend: not refused, bounds
    # from the plain version's binary search
    "int32-wraps-ascending": (np.array([0, I32_MAX, I32_MIN], np.int32), 3, "plain"),
    "int32-wraps-in-a-block": (np.arange(I32_MAX - 100, I32_MAX + 101).astype(np.int32), 10,
                               "plain"),
    "int64-wraps-ascending": (np.array([0, I64_MAX, I64_MIN], np.int64), 2, "plain"),
    "descent-first": (np.array([1, 0, 2, 3, 4], np.int32), 5, "plain"),
    "descent-middle": (np.array([0, 1, 2, 1, 3, 4], np.int64), 5, "plain"),
    "descent-last": (np.concatenate([np.arange(200, dtype=np.int32), [5]]), 200, "plain"),
    "descent-last-of-block": (np.concatenate([np.arange(64, dtype=np.int32), [3]]), 64,
                              "plain"),
    "strided-view": (repeat_ids(np.full(64, 4))[::2], 64, "plain"),
    "uint8": (np.repeat(np.arange(200, dtype=np.uint8), 3), 200, "plain"),
    "int16": (np.repeat(np.arange(-5, 200, dtype=np.int16), 2), 190, "plain"),
    "big-endian-int32": (np.arange(10, dtype=">i4"), 10, "plain"),
    "two-dimensional": (np.arange(12, dtype=np.int32).reshape(3, 4), 12, "plain"),
    "python-list": ([0, 0, 1, 3, 3], 4, "native"),
    "float-num-slices": (np.array([0, 1, 2], np.int32), 2.5, "plain"),
    "negative-num-slices": (np.array([0, 1, 2], np.int32), -1, "plain"),
    **{f"random-{seed}": (*random_sorted(seed), "native") for seed in range(8)},
}


def outcome(fn):
    """("ok", dtype, values) or ("raise", type, message)."""
    try:
        bounds = np.asarray(fn())
    except Exception as exc:  # the exception is part of the result
        return ("raise", type(exc), str(exc))
    return ("ok", bounds.dtype, bounds.tolist())


def port_bounds(ids, num_slices):
    return tp.slice_bounds(ids, num_slices, device="cpu").numpy()


@pytest.mark.parametrize("name", CASES)
def test_native_pass_matches_plain_version(name):
    ids, num_slices, path = CASES[name]
    before = dict(obs.counts)
    got = outcome(lambda: port_bounds(ids, num_slices))
    assert got == outcome(lambda: engine.slice_bounds_plain(np.asarray(ids), num_slices))
    assert got[0] == "raise" or got[1] == np.int32
    taken = {key: obs.counts[key] - before[key] for key in ("bounds_native", "bounds_fallback")}
    assert taken == {"bounds_native": int(path == "native"),
                     "bounds_fallback": int(path == "plain")}


@pytest.mark.parametrize("name", CASES)
def test_bounds_match_the_jax_reference(name):
    from tpu_pruner.policy import engine as jeng  # the reference; JAX on the CPU only
    ids, num_slices, _ = CASES[name]
    assert outcome(lambda: port_bounds(ids, num_slices)) == \
        outcome(lambda: jeng.slice_bounds(ids, num_slices))


def test_slice_bounds_of_a_tensor_reads_it_on_the_host():
    ids = repeat_ids(mixed_sizes(131072))
    S = len(mixed_sizes(131072))
    got = tp.slice_bounds(torch.from_numpy(ids), S, device="cpu")
    np.testing.assert_array_equal(got.numpy(), engine.slice_bounds_plain(ids, S))


def test_without_the_library_the_plain_version_answers(monkeypatch):
    names = ("uniform-8192x16", "gaps-int64", "negative-and-past-S", "empty",
             "int32-span-refused")
    want = {name: outcome(lambda: port_bounds(*CASES[name][:2])) for name in names}
    monkeypatch.setattr(hostlib, "load", lambda: None)
    for name in names:
        before = dict(obs.counts)
        assert outcome(lambda: port_bounds(*CASES[name][:2])) == want[name]
        assert obs.counts["bounds_fallback"] - before["bounds_fallback"] == 1
        assert obs.counts["bounds_native"] == before["bounds_native"]
    monkeypatch.undo()
    before = dict(obs.counts)
    port_bounds(*CASES["uniform-8192x16"][:2])
    assert obs.counts["bounds_native"] - before["bounds_native"] == 1
    assert obs.counts["bounds_fallback"] == before["bounds_fallback"]
