"""Offline fleet idleness audit: `python -m tpu_pruner_torch.analyze dump.json`.

The batch fleet-evaluation mode of tpu_pruner/analyze.py, on the PyTorch
engine: the per-chip pass runs in the CUDA kernels on the card
(``--device cuda``, the default) or in their plain versions on the CPU
(``--device cpu``).

Input format (JSON):

    {
      "lookback_s": 2100,          # optional, default 30m + 300s grace
      "hbm_threshold": 0.05,       # optional, default disabled
      "chips": [
        {"slice": "tpu-jobs/v5e-16",   # slice/workload identity
         "id": "ns/pod/0",             # optional chip identity
         "pod_age_s": 7200,
         "tc": [0.0, 0.0, ...],        # tensorcore utilization samples, 0-1
         "hbm": [0.01, 0.0, ...]},     # optional, HBM bandwidth util
        ...
      ]
    }

Chips may have different sample counts; series are right-aligned and
padded with invalid samples. Output: one human table on stderr and one
machine-readable JSON line on stdout, the same as tpu_pruner.analyze's.
The default evaluates f32 samples with the contiguous cumsum reduction
(evaluate_fleet_c); ``--quantize`` evaluates int8 samples
(evaluate_fleet_qc).

Sharded mode (``--shard``): the chip axis is split over the ranks of a
torch.distributed group, evaluate_fleet_sharded (f32) or
evaluate_fleet_sharded_q (``--quantize``). Under ``torchrun`` the group,
the rank and the card (``cuda:LOCAL_RANK``) come from the environment:

    torchrun --standalone --nproc-per-node 4 -m tpu_pruner_torch.analyze \
        dump.json --shard

Without torchrun it runs in a one-rank group on ``--device``. The backend
is NCCL on the card and gloo on the CPU. Only rank 0 prints.

Incremental mode (``--stream STATE.npz``): successive invocations feed
successive dumps (one per daemon cycle) into a ring of per-chunk maxima
carried in STATE (the engine's streaming window), and the JSON line
carries per-cycle verdict deltas (newly_reclaimable /
no_longer_reclaimable) and the window's staleness. Chips need stable ids;
a changed fleet is an error (start over with ``--reset``). STATE has the
same keys and dtypes as tpu_pruner.analyze's, so either package continues
a window the other began.

The other modes of tpu_pruner.analyze (the audit-trail, ledger, replay,
gym, capacity, signal and trace reports) are not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np

# Options of tpu_pruner.analyze whose modes this port does not have yet.
UNPORTED_OPTIONS = (
    "--explain", "--audit-log", "--decisions-url", "--fleet-report", "--ledger-file",
    "--workloads-url", "--merged-ledger-out", "--replay", "--what-if", "--gym",
    "--gym-policy", "--regret-window", "--as-recorded", "--assume-interval",
    "--capacity-report", "--signal-report", "--trace", "--traces-url", "--slow",
)


def load_fleet(doc: dict):
    """Dump document -> ((tc, hbm, valid, age, slice_id), slice_names,
    chip_ids, default_ids), numpy, chips grouped by (slice, chip id)."""
    chips = doc["chips"]
    if not chips:
        raise ValueError("empty fleet: no chips in dump")
    num_chips = len(chips)
    # HBM may be scraped at a different cadence than tensorcore; size the
    # sample axis to the longest series of either kind, and at least 1 so
    # an all-gap cycle still gives a well-formed all-invalid tensor.
    T = max(1, max(max(len(c["tc"]), len(c.get("hbm") or [])) for c in chips))

    slice_names = sorted({c["slice"] for c in chips})
    slice_index = {name: i for i, name in enumerate(slice_names)}

    tc = np.zeros((num_chips, T), dtype=np.float32)
    hbm = np.zeros((num_chips, T), dtype=np.float32)
    valid = np.zeros((num_chips, T), dtype=bool)
    age = np.zeros(num_chips, dtype=np.float32)
    slice_id = np.zeros(num_chips, dtype=np.int32)

    chip_ids = []
    default_ids = 0  # chips relying on positional identity (no "id" key)
    for i, c in enumerate(chips):
        if "id" not in c:
            default_ids += 1
        samples = np.asarray(c["tc"], dtype=np.float32)
        n = len(samples)
        if n:
            tc[i, T - n:] = samples
            valid[i, T - n:] = True
        hbm_samples = c.get("hbm")
        if hbm_samples:
            # HBM validity is the tensorcore series' validity
            h = np.asarray(hbm_samples, dtype=np.float32)
            hbm[i, T - len(h):] = h
        age[i] = float(c.get("pod_age_s", 0))
        slice_id[i] = slice_index[c["slice"]]
        chip_ids.append(str(c.get("id", i)))

    # Group chips by (slice, chip id), which the contiguous cumsum slice
    # reduction needs; the order is then a function of the fleet alone.
    ids = np.asarray(chip_ids)
    order = np.lexsort((ids, slice_id))
    return ((tc[order], hbm[order], valid[order], age[order],
             slice_id[order]), slice_names, ids[order], default_ids)


def evaluate_loaded(fleet, num_slices: int, params, quantize: bool = False,
                    device="cuda", shard: bool = False):
    """Evaluate load_fleet's arrays on ``device``.

    Returns (slice verdicts bool[S], chip candidates bool[C]) as numpy.
    f32 storage runs evaluate_fleet_c; ``quantize`` runs evaluate_fleet_qc
    on int8 samples quantized on the device. ``shard`` runs
    evaluate_fleet_sharded(_q) over the default process group instead.
    """
    from tpu_pruner_torch.policy import (
        evaluate_fleet_c, evaluate_fleet_qc, evaluate_fleet_sharded,
        evaluate_fleet_sharded_q, fleet_from_numpy, quantize_fleet_inputs,
        slice_bounds)

    tc, hbm, valid, age, slice_id = fleet
    parr = np.array([params.lookback_s, params.hbm_cutoff()], dtype=np.float32)
    inputs = fleet_from_numpy((tc, hbm, valid, age, slice_id, parr), device)
    if quantize:
        q = quantize_fleet_inputs(inputs)
        if shard:
            verdicts, candidates = evaluate_fleet_sharded_q(*q, num_slices=num_slices)
        else:
            bounds = slice_bounds(slice_id, num_slices, device=device)
            verdicts, candidates = evaluate_fleet_qc(q[0], q[1], q[2], bounds, q[4])
    elif shard:
        verdicts, candidates = evaluate_fleet_sharded(*inputs, num_slices=num_slices)
    else:
        bounds = slice_bounds(slice_id, num_slices, device=device)
        verdicts, candidates = evaluate_fleet_c(*inputs[:4], bounds, inputs[5])
    return verdicts.cpu().numpy(), candidates.cpu().numpy()


@contextlib.contextmanager
def _process_group(device: str):
    """Run the body in a process group; yields this rank's device.

    Joins the group that ``torchrun`` launched (WORLD_SIZE, RANK and
    LOCAL_RANK in the environment, card ``cuda:LOCAL_RANK``) or, without
    torchrun, a group of one rank on ``device``. NCCL on the card, gloo on
    the CPU.
    """
    import torch
    import torch.distributed as dist

    from tpu_pruner_torch.policy.engine import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "WORLD_SIZE" in os.environ:
            if dev.type == "cuda":
                dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
                torch.cuda.set_device(dev)
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, rank=0, world_size=1,
                                    init_method="file://" + os.path.join(tmp, "rendezvous"))
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _run_stream(args, doc, fleet, slice_names, chip_ids, params) -> int:
    """One incremental cycle: fold this dump's samples into the ring state
    and emit verdict deltas + window staleness (the qc window path, so
    slices may be heterogeneous)."""
    import time

    import torch

    from tpu_pruner_torch.policy import (
        evaluate_window_qc, fleet_from_numpy, init_window, quantize_params,
        quantize_samples_device, slice_bounds, update_window, window_from_numpy)

    tc, hbm, valid, age, slice_id = fleet
    parr = np.array([params.lookback_s, params.hbm_cutoff()], dtype=np.float32)
    num_chips, num_slices = len(slice_id), len(slice_names)
    K = args.window_chunks
    now = float(doc.get("timestamp", time.time()))

    state_path = args.stream
    if args.reset or not os.path.exists(state_path):
        ring = init_window(num_chips, K, device=args.device)
        chunk_times = np.full(K, np.nan)
        prev_verdicts = np.zeros(num_slices, dtype=bool)
    else:
        with np.load(state_path, allow_pickle=False) as saved:
            names = np.asarray(slice_names)
            if (saved["chip_ids"].shape != chip_ids.shape
                    or (saved["chip_ids"] != chip_ids).any()
                    or saved["slice_names"].shape != names.shape
                    or (saved["slice_names"] != names).any()):
                raise SystemExit(
                    "stream state fleet mismatch: the dump's chips/slices differ "
                    f"from {state_path} (chips carry stable ids?); re-init with "
                    "--reset to start a fresh window")
            if int(saved["tc_ring"].shape[1]) != K:
                raise SystemExit(
                    f"stream state has {saved['tc_ring'].shape[1]} window chunks, "
                    f"--window-chunks asked for {K}; re-init with --reset")
            ring = window_from_numpy(
                (saved["tc_ring"], saved["hbm_ring"], saved["cursor"]), args.device)
            chunk_times = saved["chunk_times"]
            prev_verdicts = saved["prev_verdicts"]

    cursor_before = int(ring[2])
    tc_t, hbm_t, valid_t, age_t, _, parr_t = fleet_from_numpy(
        (tc, hbm, valid, age, slice_id, parr), args.device)
    ring = update_window(ring, quantize_samples_device(tc_t, valid_t),
                         quantize_samples_device(hbm_t, valid_t))
    chunk_times[cursor_before] = now

    parr_q = torch.from_numpy(quantize_params(parr_t)).to(parr_t.device)
    bounds = slice_bounds(slice_id, num_slices, device=args.device)
    verdicts, candidates = evaluate_window_qc(ring, age_t, bounds, parr_q)
    verdicts = verdicts.cpu().numpy()
    candidates = candidates.cpu().numpy()

    # Atomic replace (a crash mid-write must not destroy the accumulated
    # window) via a same-directory temp file; writing through the file
    # object also stops np.savez from appending .npz to plain paths.
    tmp_path = state_path + ".tmp"
    with open(tmp_path, "wb") as f:
        np.savez(f, tc_ring=ring[0].cpu().numpy(), hbm_ring=ring[1].cpu().numpy(),
                 cursor=int(ring[2]), chunk_times=chunk_times, chip_ids=chip_ids,
                 slice_names=np.asarray(slice_names), prev_verdicts=verdicts)
    os.replace(tmp_path, state_path)

    newly = [slice_names[i] for i in range(num_slices)
             if verdicts[i] and not prev_verdicts[i]]
    gone = [slice_names[i] for i in range(num_slices)
            if prev_verdicts[i] and not verdicts[i]]
    filled = int(np.count_nonzero(~np.isnan(chunk_times)))
    ages = now - chunk_times[~np.isnan(chunk_times)]  # >= 1: this cycle's chunk
    window = {
        "chunks": K,
        "filled": filled,
        "fill_fraction": round(filled / K, 3),
        # verdicts over a part-filled window cover only the cycles seen so far
        "partial": filled < K,
        "oldest_chunk_age_s": round(float(ages.max()), 1),
        "newest_chunk_age_s": round(float(ages.min()), 1),
    }

    for name in newly:
        print(f"{name}: newly IDLE — reclaimable", file=sys.stderr)
    for name in gone:
        print(f"{name}: active again", file=sys.stderr)
    print(f"window {filled}/{K} chunks"
          + (" (PARTIAL — verdicts cover only the cycles seen)"
             if window["partial"] else ""), file=sys.stderr)

    print(json.dumps({
        "num_chips": num_chips,
        "num_slices": num_slices,
        "idle_chips": int(candidates.sum()),
        "reclaimable_slices": [slice_names[i] for i in range(num_slices)
                               if verdicts[i]],
        "newly_reclaimable": newly,
        "no_longer_reclaimable": gone,
        "window": window,
        "lookback_s": params.lookback_s,
        "hbm_threshold": params.hbm_threshold,
    }))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_pruner_torch.analyze", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dump", help="metrics dump JSON path, or '-' for stdin")
    parser.add_argument("--lookback-s", type=float, default=None,
                        help="override lookback seconds (default: dump value or 2100)")
    parser.add_argument("--hbm-threshold", type=float, default=None,
                        help="override HBM corroboration threshold (0 disables)")
    parser.add_argument("--shard", action="store_true",
                        help="shard the chip axis over the ranks of the process "
                             "group torchrun launched, or a one-rank group "
                             "without torchrun (pads chips to a rank multiple; "
                             "verdicts are identical to the single-device path)")
    parser.add_argument("--quantize", action="store_true",
                        help="evaluate on int8 quantized samples (1%% buckets, "
                             "4.5x fewer bytes; == 0 idle predicate stays exact, "
                             "threshold errs only toward rescue)")
    parser.add_argument("--stream", metavar="STATE",
                        help="incremental mode: fold this dump's samples into "
                             "the sliding-window ring state carried in STATE "
                             "(.npz) and emit per-cycle verdict deltas + window "
                             "staleness; one invocation per daemon cycle. "
                             "Always evaluates int8 (--quantize is implied)")
    parser.add_argument("--window-chunks", type=int, default=12,
                        help="sliding-window size in cycles for --stream "
                             "(default 12 — a 35min lookback at 180s cycles)")
    parser.add_argument("--reset", action="store_true",
                        help="with --stream: discard STATE and start a fresh "
                             "window from this dump")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to evaluate: the CUDA kernels on the card "
                             "(default) or their plain versions on the CPU")
    argv = sys.argv[1:] if argv is None else list(argv)
    for arg in argv:
        option = arg.split("=", 1)[0]
        if option in UNPORTED_OPTIONS:
            parser.error(f"{option} is not ported to tpu_pruner_torch yet; "
                         "use python -m tpu_pruner.analyze for that mode")
    args = parser.parse_args(argv)
    if args.window_chunks < 1:
        parser.error("--window-chunks must be >= 1")
    if args.stream and args.shard:
        # the window pass reads [C, K] chunk maxima, which is tiny, so
        # sharding it buys nothing; make_sharded_stream_step is the API for
        # streaming over a process group
        parser.error("--shard does not apply to --stream (the window pass "
                     "is single-device; see make_sharded_stream_step for "
                     "process-group deployments)")

    from tpu_pruner_torch.policy import PolicyParams

    if args.dump == "-":
        doc = json.load(sys.stdin)
    else:
        with open(args.dump) as f:
            doc = json.load(f)
    fleet, slice_names, chip_ids, default_ids = load_fleet(doc)
    slice_id = fleet[4]
    if args.stream and default_ids:
        # Positional ids make the --stream fleet-identity check vacuous: a
        # producer that reorders chips between cycles passes it while ring
        # rows silently swap physical chips.
        print(f"WARNING: {default_ids}/{len(chip_ids)} chips have no explicit "
              "'id' and fall back to positional identity; --stream cannot "
              "detect producers that reorder chips between cycles — ring "
              "rows would silently swap physical chips. Give chips stable "
              "ids (dump.py emits namespace/pod/accelerator).",
              file=sys.stderr)
    params = PolicyParams(
        lookback_s=(args.lookback_s if args.lookback_s is not None
                    else float(doc.get("lookback_s", 30 * 60 + 300))),
        hbm_threshold=(args.hbm_threshold if args.hbm_threshold is not None
                       else float(doc.get("hbm_threshold", 0.0))),
    )
    num_slices = len(slice_names)
    if args.stream:
        return _run_stream(args, doc, fleet, slice_names, chip_ids, params)
    if args.shard:
        import torch.distributed as dist

        with _process_group(args.device) as device:
            verdicts, candidates = evaluate_loaded(fleet, num_slices, params,
                                                   quantize=args.quantize,
                                                   device=device, shard=True)
            if dist.get_rank() != 0:
                return 0
    else:
        verdicts, candidates = evaluate_loaded(fleet, num_slices, params,
                                               quantize=args.quantize,
                                               device=args.device)

    chips_per_slice = np.bincount(slice_id, minlength=num_slices)
    idle_per_slice = np.bincount(slice_id, weights=candidates, minlength=num_slices)
    print(f"{'slice':40s} {'chips':>6s} {'idle':>6s} verdict", file=sys.stderr)
    for i, name in enumerate(slice_names):
        print(f"{name:40s} {int(chips_per_slice[i]):6d} "
              f"{int(idle_per_slice[i]):6d} "
              f"{'IDLE — reclaimable' if verdicts[i] else 'active'}",
              file=sys.stderr)

    print(json.dumps({
        "num_chips": int(len(slice_id)),
        "num_slices": num_slices,
        "idle_chips": int(candidates.sum()),
        "reclaimable_slices": [slice_names[i] for i in range(num_slices)
                               if verdicts[i]],
        "lookback_s": params.lookback_s,
        "hbm_threshold": params.hbm_threshold,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
