"""Entry points of the PyTorch port: `python -m tpu_pruner_torch.entry`.

Counterpart of __graft_entry__.py.

- entry(): the single-device fleet evaluation and its example inputs (a
  2,048-chip, 32-sample fleet in 256 slices), on the card by default.
- dryrun_multichip(n): spawns n ranks of a torch.distributed group and runs
  every sharded evaluator on them: the f32 segment-sum evaluator, an uneven
  fleet that needs padding, the int8 segment sum, the contiguous cumsum
  (qc), the uniform path (qu) with one slice per rank, and the streaming
  step over more cycles than the ring holds. Each rank asserts that its
  results equal the port's single-device results and the fleet's expected
  verdicts. The backend is NCCL on the card (one card per rank) and gloo
  on the CPU; gloo on the card runs several ranks on one card.

    python -m tpu_pruner_torch.entry [N] [--device cuda|cpu] [--backend nccl|gloo]
"""

from __future__ import annotations

import argparse
from functools import partial

import torch

from tpu_pruner_torch.policy import (
    LAUNCHES, assert_uniform_slices, evaluate_fleet, evaluate_fleet_q,
    evaluate_fleet_qc, evaluate_fleet_qu, evaluate_fleet_sharded,
    evaluate_fleet_sharded_q, evaluate_fleet_sharded_qc, evaluate_fleet_sharded_qu,
    evaluate_window_qu, init_window, make_example_fleet, make_sharded_evaluator,
    quantize_fleet_inputs, reset_launches, slice_bounds, update_window)
from tpu_pruner_torch.policy.sharded import (local_rows, run_local, run_stream_local,
                                             spawn_ranks)

NUM_SLICES = 256
STREAM_CHUNKS = 3


def entry(device="cuda"):
    """The fleet evaluation step and example args: fn(*args) evaluates."""
    fn = partial(evaluate_fleet, num_slices=NUM_SLICES)
    example_inputs, _ = make_example_fleet(
        num_chips=2048, num_samples=32, num_slices=NUM_SLICES, idle_fraction=0.5,
        device=device)
    return fn, example_inputs


def _same(got: torch.Tensor, want, what: str) -> None:
    want = torch.as_tensor(want, device=got.device)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: sharded result differs from the reference")


def _counted(launches: dict, path: str, run):
    """run() with the kernel counts zeroed just before it and read just after."""
    reset_launches()
    out = run()
    launches[path] = dict(LAUNCHES)
    return out


def _dryrun_rank(device: str, chips_per_rank: int, num_samples: int) -> dict:
    """One rank of dryrun_multichip (runs in the default group)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    launches = {}
    # chips split evenly over the ranks; num_slices < chips, so slices span
    # ranks and every verdict takes part in the all-reduce
    num_chips = n * chips_per_rank
    num_slices = max(2, num_chips // 16)
    inputs, expected = make_example_fleet(num_chips, num_samples, num_slices,
                                          idle_fraction=0.5, device=device)
    ref_v, ref_c = evaluate_fleet(*inputs, num_slices=num_slices)
    _same(ref_v, expected, "single-device evaluate_fleet")

    verdicts, candidates = _counted(launches, "make_sharded_evaluator", lambda: run_local(
        make_sharded_evaluator, num_slices, *inputs))
    _same(verdicts, expected, "make_sharded_evaluator verdicts")
    _same(candidates, local_rows(ref_c), "make_sharded_evaluator candidates")

    # uneven fleet: chips not divisible by the ranks go through the padding
    odd_chips = num_chips - 3
    odd = [x[:odd_chips] for x in inputs[:5]]
    v, c = _counted(launches, "evaluate_fleet_sharded", lambda: evaluate_fleet_sharded(
        *odd, inputs[5], num_slices=num_slices))
    want_v, want_c = evaluate_fleet(*odd, inputs[5], num_slices=num_slices)
    _same(v, want_v, "evaluate_fleet_sharded verdicts (uneven)")
    _same(c, want_c, "evaluate_fleet_sharded candidates (uneven)")

    q = quantize_fleet_inputs(inputs)
    v, c = _counted(launches, "evaluate_fleet_sharded_q", lambda: evaluate_fleet_sharded_q(
        *q, num_slices=num_slices))
    _same(v, expected, "evaluate_fleet_sharded_q verdicts")
    _same(c, evaluate_fleet_q(*q, num_slices=num_slices)[1], "evaluate_fleet_sharded_q")

    bounds = slice_bounds(inputs[4], num_slices, device=device)
    v, c = _counted(launches, "evaluate_fleet_sharded_qc", lambda: evaluate_fleet_sharded_qc(
        q[0], q[1], q[2], bounds, q[4]))
    want_v, want_c = evaluate_fleet_qc(q[0], q[1], q[2], bounds, q[4])
    _same(v, expected, "evaluate_fleet_sharded_qc verdicts")
    _same(v, want_v, "evaluate_fleet_sharded_qc verdicts")
    _same(c, want_c, "evaluate_fleet_sharded_qc candidates")

    # the uniform path on the layout it is for: one slice per rank
    u_cps = num_chips // n
    u_inputs, u_expected = make_example_fleet(num_chips, num_samples, n,
                                              idle_fraction=0.5, device=device)
    assert_uniform_slices(u_inputs[4], u_cps)
    uq = quantize_fleet_inputs(u_inputs)
    v, c = _counted(launches, "evaluate_fleet_sharded_qu", lambda: evaluate_fleet_sharded_qu(
        uq[0], uq[1], uq[2], uq[4], chips_per_slice=u_cps))
    want_v, want_c = evaluate_fleet_qu(uq[0], uq[1], uq[2], uq[4], u_cps)
    _same(v, u_expected, "evaluate_fleet_sharded_qu verdicts")
    _same(v, want_v, "evaluate_fleet_sharded_qu verdicts")
    _same(c, want_c, "evaluate_fleet_sharded_qu candidates")

    # the streaming step over more cycles than the ring holds (eviction),
    # each rank holding its rows of the rings
    cols = [cycle % num_samples for cycle in range(STREAM_CHUNKS + 2)]
    tc_chunks = [uq[0][:, c:c + 1] for c in cols]
    hbm_chunks = [uq[1][:, c:c + 1] for c in cols]
    cycles = _counted(launches, "make_sharded_stream_step", lambda: run_stream_local(
        u_cps, STREAM_CHUNKS, tc_chunks, hbm_chunks, uq[2], uq[4]))
    ref_state = init_window(num_chips, STREAM_CHUNKS, device=device)
    for cycle, (tc_new, hbm_new) in enumerate(zip(tc_chunks, hbm_chunks)):
        ref_state = update_window(ref_state, tc_new, hbm_new)
        want_v, _ = evaluate_window_qu(ref_state, uq[2], uq[4], u_cps)
        v, tc_ring, hbm_ring, cursor = cycles[cycle]
        _same(v, local_rows(want_v), f"make_sharded_stream_step verdicts, cycle {cycle}")
        _same(tc_ring, local_rows(ref_state[0]), f"stream tc ring, cycle {cycle}")
        _same(hbm_ring, local_rows(ref_state[1]), f"stream hbm ring, cycle {cycle}")
        _same(cursor, ref_state[2], f"stream cursor, cycle {cycle}")
    return {"world_size": n, "num_chips": num_chips, "num_slices": num_slices,
            "odd_chips": odd_chips, "idle_slices": int(verdicts.sum()),
            "stream_idle": int(v.sum()), "launches": launches}


def dryrun_multichip(n_devices: int, device="cuda", backend=None, chips_per_rank: int = 8,
                     num_samples: int = 4, timeout_s: float = 300.0, workdir=None) -> list:
    """Run every sharded evaluator on n spawned ranks; return each rank's summary
    (sizes, idle counts and, per path, the kernel launches of that rank)."""
    device = torch.device(device).type
    calls = [(_dryrun_rank, (device, chips_per_rank, num_samples))]
    summaries = [out[0] for out in spawn_ranks(n_devices, calls, device=device,
                                               backend=backend, timeout_s=timeout_s,
                                               workdir=workdir)]
    s = summaries[0]
    print(f"dryrun_multichip: {n_devices} ranks ({backend or 'default backend'}, "
          f"{device}), {s['num_chips']} chips, {s['num_slices']} slices -> "
          f"{s['idle_slices']} idle slices; uneven {s['odd_chips']}-chip fleet "
          f"padded and verified; int8 segment sum, int8+cumsum (all-reduce) and "
          f"int8+uniform (no collective) verified; streaming window "
          f"({STREAM_CHUNKS}-chunk ring, {s['stream_idle']} idle on rank 0) verified")
    return summaries


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpu_pruner_torch.entry",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("ranks", nargs="?", type=int, default=8,
                        help="ranks of the dry run (default 8)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="default: nccl on cuda, gloo on cpu")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry() ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.ranks, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
