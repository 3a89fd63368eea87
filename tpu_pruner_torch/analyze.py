"""Offline fleet idleness audit: `python -m tpu_pruner_torch.analyze dump.json`.

The port of tpu_pruner/analyze.py: every mode and option of
``python -m tpu_pruner.analyze``, plus ``--device``. The batch, sharded
and incremental modes evaluate a dump on the PyTorch engine: the per-chip
pass runs in the CUDA kernels on the card (``--device cuda``, the default)
or in their plain versions on the CPU (``--device cpu``). The report modes
read the daemon's records and touch no tensor.

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

Decision-audit mode (``--explain <ns>/<pod>``): read the daemon's
DecisionRecord trail, from the ``--audit-log`` JSONL file or the live
``/debug/decisions`` endpoint (``--decisions-url http://host:8080``), and
print one pod's decision history: per cycle, the observed signal, the
owner chain, and the reason the pod was (or was not) acted on.

Fleet-savings mode (``--fleet-report``): read N workload utilization
ledgers (``--ledger-file`` checkpoints and/or ``--workloads-url``
endpoints, both repeatable) and render per-namespace (and, across
clusters, per-cluster) savings: chip-hours reclaimed, workload counts,
pause/resume churn and the top offenders. Schema-2 sources merge, a
duplicate cluster resolving to the higher checkpoint epoch;
``--merged-ledger-out`` writes the merge back as one checkpoint.

Replay mode (``--replay <capsule.json|url>``): re-run one flight-recorder
cycle capsule through the daemon's decision pipeline with zero network
calls and assert it reproduces the recorded decisions bit-for-bit; drift
prints a per-pod diff and exits 1. ``--what-if key=value ...`` re-decides
under altered config and reports which decisions flip.

Policy-gym mode (``--gym <flight-dir|capsule.json|url>``): replay a
capsule corpus against N candidate policies (``--gym-policy``,
repeatable) in one pass, scoring reclaimed chip-hours against false
pauses and actuation churn; the winner prints as a daemon flag line.

Defragmentation-report mode (``--capacity-report <source>``): recompute
each capsule's capacity inventory from its recorded inputs (byte drift
exits 1), integrate the consolidation potential over the window, and
list the moves that would free whole slices.

Replay, gym and capacity reports run the daemon's C++ core
(tpu_pruner_torch.native, built from ``native/`` at first use).

Signal-health mode (``--signal-report <capsule.json|url>``): the
signal-quality watchdog's per-pod evidence verdicts, the coverage ratio
and whether the cycle browned out, from a capsule or the live
``/debug/signals`` endpoint.

Trace modes: ``--trace <id|url|flight-dir|capsule>`` renders one
action-provenance trace as a span waterfall joined with the cycle's
decisions (a 32-hex id needs ``--traces-url``); ``--slow <url>`` lists the
worst retained traces and the SLO burn from a daemon's ``/debug/traces``.

Report modes print a human summary on stderr and one JSON document on
stdout, byte for byte what tpu_pruner.analyze prints, except that
``--slow``'s hint names this module.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import sys
import tempfile
import urllib.request

import numpy as np


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
        quantize_samples_device, slice_bounds, update_window_, window_from_numpy)

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
    # this cycle owns the state alone: write the rings in place
    ring = update_window_(ring, quantize_samples_device(tc_t, valid_t),
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


def _load_decision_records(args) -> list[dict]:
    """DecisionRecords from the JSONL audit log or /debug/decisions."""
    if args.audit_log:
        records = []
        with open(args.audit_log) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    # a torn tail line (daemon killed mid-write) is expected;
                    # anything else is worth surfacing but not fatal
                    print(f"WARNING: skipping unparseable audit line {lineno}",
                          file=sys.stderr)
        return records
    # Bare host:port expands to the live endpoint; a full /debug/... URL
    # passes through verbatim (same ergonomics as --signal-report).
    url = args.decisions_url
    if "/debug/" not in url:
        url = url.rstrip("/") + "/debug/decisions"
    return _fetch_json(url)["decisions"]


def _run_explain(args) -> int:
    """Decision history for one pod (the audit-trail consumer)."""
    target = args.explain
    if "/" not in target:
        print("--explain expects <namespace>/<pod>", file=sys.stderr)
        return 2
    ns, pod = target.split("/", 1)
    records = [r for r in _load_decision_records(args)
               if r.get("namespace") == ns and r.get("pod") == pod]
    records.sort(key=lambda r: (r.get("cycle", 0), r.get("ts", "")))

    if not records:
        print(f"no decisions recorded for {ns}/{pod} (pod never appeared in "
              "the idle candidate set, or the trail rotated past it)",
              file=sys.stderr)
    for r in records:
        sig = r.get("signal") or {}
        signal = (f"{sig.get('metric', '?')}={sig.get('value')}"
                  if sig else "no signal")
        chain = " -> ".join(r.get("owner_chain") or []) or "(no owner walk)"
        root = r.get("root")
        root_s = (f"{root['kind']}/{root['namespace']}/{root['name']}"
                  if root else "(none)")
        print(f"cycle {r.get('cycle', '?')} {r.get('ts', '?')}  "
              f"{r.get('reason', '?'):<24} action={r.get('action', 'none')}\n"
              f"  signal: {signal} (lookback {r.get('lookback_s', '?')}s)\n"
              f"  chain:  {chain}\n"
              f"  root:   {root_s}"
              + (f"\n  detail: {r['detail']}" if r.get("detail") else "")
              + (f"\n  trace:  {r['trace_id']}" if r.get("trace_id") else ""),
              file=sys.stderr)
    print(json.dumps({"namespace": ns, "pod": pod, "decisions": records}))
    return 0


def _run_replay(args) -> int:
    """Deterministic capsule replay / what-if (the flight-recorder consumer).

    Pure replay exits 0 only when the replayed decisions reproduce the
    recorded ones bit-for-bit; drift prints a per-pod diff and exits 1.
    With --what-if the flip report is the product and the exit is 0
    (flips are the expected outcome, not drift)."""
    source = args.replay
    if source.startswith(("http://", "https://")):
        capsule = _fetch_json(source)
    else:
        with open(source) as f:
            capsule = json.load(f)

    # --what-if is repeatable AND takes several key=value pairs per
    # occurrence: `--what-if lookback=10m grace=60 --what-if run_mode=...`
    # all fold into ONE combined overlay (one flip report).
    what_if = {}
    for group in args.what_if or []:
        for pair in group:
            if "=" not in pair:
                print(f"--what-if expects key=value, got {pair!r}", file=sys.stderr)
                return 2
            key, value = pair.split("=", 1)
            what_if[key] = value

    from tpu_pruner_torch import native

    result = native.replay_cycle(capsule, what_if or None)

    cycle = result.get("cycle")
    actions = result.get("actions", {})
    if what_if:
        flips = result.get("flips", [])
        print(f"cycle {cycle}: what-if {what_if} flips "
              f"{len(flips)} decision(s) "
              f"(scale_downs {actions.get('recorded_scale_downs')} -> "
              f"{actions.get('replayed_scale_downs')})", file=sys.stderr)
        for f in flips:
            marker = " [predicted]" if f.get("predicted") else ""
            print(f"  {f['pod']}: {f['from']['reason']}/{f['from']['action']}"
                  f" -> {f['to']['reason']}/{f['to']['action']}{marker}",
                  file=sys.stderr)
        if result.get("query_changed"):
            print("NOTE: this what-if changes the PromQL itself; decisions "
                  "above are evaluated against the RECORDED response — "
                  "re-run live to see the new query's candidate set:\n  "
                  + result.get("replay_query", ""), file=sys.stderr)
        print(json.dumps(result))
        return 0

    if result.get("match"):
        print(f"cycle {cycle}: replay reproduced all "
              f"{len(result.get('recorded', []))} recorded decision(s) "
              "bit-for-bit", file=sys.stderr)
        print(json.dumps(result))
        return 0
    print(f"cycle {cycle}: REPLAY DRIFT — {len(result.get('drift', []))} "
          "decision(s) differ:", file=sys.stderr)
    for d in result.get("drift", []):
        print(f"  {d['pod']}:", file=sys.stderr)
        print(f"    recorded: {json.dumps(d.get('recorded'))}", file=sys.stderr)
        print(f"    replayed: {json.dumps(d.get('replayed'))}", file=sys.stderr)
    print(json.dumps(result))
    return 1


def _load_gym_capsules(source: str) -> list[dict]:
    """Capsule corpus from a --flight-dir directory, one capsule file, or
    a daemon URL (bare host:port expands to /debug/cycles; each indexed
    capsule is then fetched from /debug/cycles/<id>)."""
    if source.startswith(("http://", "https://")):
        base = source.rstrip("/")
        index_url = base if "/debug/" in base else base + "/debug/cycles"
        index = _fetch_json(index_url)
        root = index_url.rsplit("/debug/", 1)[0]
        return [_fetch_json(f"{root}/debug/cycles/{entry['id']}")
                for entry in index.get("capsules", [])]
    if os.path.isdir(source):
        paths = sorted(glob.glob(os.path.join(source, "cycle-*.json")))
    else:
        paths = [source]
    capsules = []
    for path in paths:
        with open(path) as f:
            capsules.append(json.load(f))
    return capsules


def _run_gym(args) -> int:
    """Policy-gym mode: score N policies over a capsule corpus."""
    capsules = _load_gym_capsules(args.gym)
    if not capsules:
        print(f"no capsules found at {args.gym} (need a --flight-dir "
              "directory, capsule file, or daemon URL)", file=sys.stderr)
        return 1

    from tpu_pruner_torch import native

    result = native.gym_simulate(
        capsules, policies=args.gym_policy or None,
        regret_window_s=args.regret_window,
        assume_scale_down=not args.as_recorded,
        assume_interval_s=args.assume_interval)

    print(f"policy gym: {result['cycles']} capsule cycle(s), "
          f"{len(result['policies'])} policies, regret window "
          f"{result['regret_window_s']}s"
          + (" (as recorded)" if args.as_recorded else ""), file=sys.stderr)
    print(f"\n{'policy':36s} {'reclaimed':>12s} {'false':>6s} {'churn':>6s} "
          f"{'held':>5s} {'score':>9s}", file=sys.stderr)
    print(f"{'':36s} {'chip-hrs':>12s} {'pauses':>6s} {'':>6s} {'':>5s} "
          f"{'':>9s}", file=sys.stderr)
    for p in result["policies"]:
        print(f"{p['name']:36s} {p['reclaimed_chip_hours']:12.3f} "
              f"{p['false_pauses']:6d} {p['actuation_churn']:6d} "
              f"{p['right_size_held']:5d} {p['score']:9.3f}", file=sys.stderr)
    winner = result["winner"]
    print(f"\nwinner: {winner['name']}\napply with: {winner['flag_line']}",
          file=sys.stderr)
    print(json.dumps(result))
    return 0


def _run_capacity_report(args) -> int:
    """Replayable defragmentation report over capsule capacity stamps."""
    capsules = _load_gym_capsules(args.capacity_report)
    if not capsules:
        print(f"no capsules found at {args.capacity_report} (need a "
              "--flight-dir directory, capsule file, or daemon URL)",
              file=sys.stderr)
        return 1
    stamps = []
    for c in capsules:
        stamp = c.get("capacity")
        if not stamp:
            continue  # recorded without --capacity on
        stamps.append({"cycle": c.get("cycle"), "now_unix": c.get("now_unix"),
                       "inputs": stamp.get("inputs"), "doc": stamp.get("doc")})
    if not stamps:
        print(f"{len(capsules)} capsule(s) but no capacity stamps — the "
              "recording daemon ran without --capacity on", file=sys.stderr)
        return 1

    from tpu_pruner_torch import native

    result = native.capacity_report(stamps)

    cons = result["consolidation"]
    inv = result["inventory"]["totals"]
    print(f"capacity report: {result['capsules']} stamp(s), cycles "
          f"{result['first_cycle']}..{result['last_cycle']}, window "
          f"{result['window_s']}s", file=sys.stderr)
    print(f"  now: {inv['slices']} slice(s), {inv['free_chips']} free / "
          f"{inv['chips']} chips, {inv['whole_free_slices']} whole-free, "
          f"{inv['fragmented_chips']} fragmented", file=sys.stderr)
    print(f"  {result['summary']}", file=sys.stderr)
    for m in result.get("moves", []):
        print(f"    {m['action']:10s} {m['root']:40s} slice {m['pool']} "
              f"({m['idle_chips']} idle chip(s))", file=sys.stderr)
    if result["drift"]:
        print(f"  REPLAY DRIFT — {len(result['drifted_cycles'])} cycle(s) "
              "whose recorded inventory differs from the recomputed one: "
              f"{result['drifted_cycles']}", file=sys.stderr)
        print(json.dumps(result))
        return 1
    print(f"  replay: all {result['capsules']} recorded inventories "
          "reproduced bit-for-bit", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _run_signal_report(args) -> int:
    """Fleet evidence-health report (the signal-watchdog consumer)."""
    source = args.signal_report
    if source.startswith(("http://", "https://")):
        url = source
        if "/debug/" not in url:  # bare daemon base → the live endpoint
            url = url.rstrip("/") + "/debug/signals"
        doc = _fetch_json(url)
    else:
        with open(source) as f:
            doc = json.load(f)

    if "decisions" in doc or "prom" in doc:  # a flight-recorder capsule
        sig = doc.get("signal")
        if not sig:
            print("capsule carries no signal assessment — the recorded cycle "
                  "ran without --signal-guard on", file=sys.stderr)
            return 1
        cfg = doc.get("config", {})
        sig.setdefault("thresholds", {
            "scrape_interval_s": cfg.get("signal_scrape_interval_s"),
            "max_age_s": cfg.get("signal_max_age_s"),
            "min_coverage": cfg.get("signal_min_coverage"),
        })
        sig["source"] = {"capsule": doc.get("id"), "cycle": doc.get("cycle")}
        doc = sig
    if doc.get("enabled") is False:
        print("signal watchdog not enabled on this daemon — run it with "
              "--signal-guard on", file=sys.stderr)
        return 1

    details = doc.get("details", [])
    counts = doc.get("pods") or {}
    total = sum(counts.values()) if counts else len(details)
    coverage = doc.get("coverage_ratio", 1.0)
    print(f"evidence health (cycle {doc.get('cycle', '?')}): coverage "
          f"{coverage:.3f} over {total} candidate pod(s)"
          + ("   ** BROWNOUT — all scale-downs deferred **"
             if doc.get("brownout") else ""), file=sys.stderr)
    print("  " + "  ".join(f"{v}={counts.get(v, 0)}"
                           for v in ("healthy", "stale", "gappy", "absent")),
          file=sys.stderr)
    unhealthy = [d for d in details if d.get("verdict") != "healthy"]
    if unhealthy:
        print(f"\n{'pod':48s} {'verdict':>8s} {'samples':>9s} {'age s':>9s}",
              file=sys.stderr)
        for d in unhealthy:
            samples = d.get("sample_count")
            age = d.get("last_age_s")
            print(f"{d.get('namespace', '?') + '/' + d.get('pod', '?'):48s} "
                  f"{d.get('verdict', '?'):>8s} "
                  f"{'-' if samples is None else format(samples, '.0f'):>9s} "
                  f"{'-' if age is None else format(age, '.0f'):>9s}",
                  file=sys.stderr)
    elif total:
        print("every candidate's evidence is healthy", file=sys.stderr)
    print(json.dumps(doc))
    return 0


def _fetch_json(url: str):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.load(resp)


def _render_waterfall(total_us: int, spans: list[dict]) -> None:
    """ASCII span waterfall to stderr: one row per span, bars positioned
    on a shared timeline whose width is the root span's duration."""
    width = 48
    total = max(int(total_us), 1)
    print(f"\n{'span':16s} {'start ms':>9s} {'dur ms':>9s}  timeline",
          file=sys.stderr)
    for s in sorted(spans, key=lambda s: (s.get("start_us", 0),
                                          s.get("end_us", 0))):
        start = int(s.get("start_us", 0))
        end = max(int(s.get("end_us", 0)), start)
        lo = min(int(width * start / total), width - 1)
        hi = max(lo + 1, min(int(-(-width * end // total)), width))
        bar = "." * lo + "#" * (hi - lo) + "." * (width - hi)
        extra = []
        attrs = s.get("attrs") or {}
        for k, v in attrs.items():
            extra.append(f"{k}={v}")
        events = s.get("events") or []
        if events:
            extra.append(f"{len(events)} event(s): "
                         + ",".join(e.get("name", "?") for e in events[:4])
                         + ("…" if len(events) > 4 else ""))
        if s.get("error"):
            extra.append(f"ERROR {s.get('error_message', '')}".rstrip())
        print(f"{s.get('name', '?'):16s} {start / 1000:9.2f} "
              f"{(end - start) / 1000:9.2f}  |{bar}|"
              + (f"  {' '.join(extra)}" if extra else ""), file=sys.stderr)


def _render_decision_join(decisions: list[dict]) -> None:
    if not decisions:
        return
    print(f"\ncapsule decisions ({len(decisions)}):", file=sys.stderr)
    for d in decisions:
        pod = f"{d.get('namespace', '?')}/{d.get('pod', '?')}"
        print(f"  {pod:48s} {d.get('reason', '?'):>16s} "
              f"{d.get('action', 'none')}", file=sys.stderr)


def _run_trace(args) -> int:
    """Waterfall one provenance trace: a retained trace fetched from the
    daemon's /debug/traces ring (by id or URL), or the offline `trace`
    stamp a flight-recorder capsule carries — joined with the capsule's
    decision records when they travel together."""
    source = args.trace
    doc = None
    decisions: list[dict] = []
    if re.fullmatch(r"[0-9a-f]{32}", source):
        if not args.traces_url:
            print("--trace <id> needs --traces-url pointing at the daemon's "
                  "metrics port (e.g. http://host:8080) — ids alone don't "
                  "say which ring to search", file=sys.stderr)
            return 1
        base = args.traces_url.rstrip("/")
        root = base.rsplit("/debug/", 1)[0] if "/debug/" in base else base
        doc = _fetch_json(f"{root}/debug/traces/{source}")
    elif source.startswith(("http://", "https://")):
        base = source.rstrip("/")
        if "/debug/traces/" in base:  # a full per-trace URL
            doc = _fetch_json(base)
        else:
            index_url = base if "/debug/" in base else base + "/debug/traces"
            index = _fetch_json(index_url)
            traces = index.get("traces", [])
            if not traces:
                print("daemon retains no completed traces yet"
                      + ("" if index.get("enabled", True)
                         else " — run it with --trace on"), file=sys.stderr)
                return 1
            root = index_url.rsplit("/debug/", 1)[0]
            doc = _fetch_json(f"{root}/debug/traces/{traces[0]['trace_id']}")
    else:
        capsules = [c for c in _load_gym_capsules(source) if c.get("trace")]
        if not capsules:
            print(f"no capsule at {source} carries a trace stamp — the "
                  "recording daemon ran without --trace on", file=sys.stderr)
            return 1
        capsule = capsules[-1]  # newest stamped cycle in a flight-dir
        stamp = capsule["trace"]
        spans = stamp.get("spans", [])
        total_us = max([int(s.get("end_us", 0)) for s in spans] + [1])
        doc = {"trace_id": stamp.get("trace_id"),
               "cycle": capsule.get("cycle"),
               "trigger": stamp.get("trigger"),
               "root_ms": total_us / 1000.0,
               "root": {"name": "evaluate", "duration_ms": total_us / 1000.0},
               "span_tree": spans,
               "source": {"capsule": capsule.get("id")}}
        decisions = capsule.get("decisions", [])

    if doc.get("cycle") is not None and not decisions \
            and source.startswith(("http://", "https://")):
        # Same daemon records capsules too? Join on the cycle id; a
        # daemon running without --flight-dir just 404s here.
        try:
            root = source.rstrip("/")
            root = root.rsplit("/debug/", 1)[0] if "/debug/" in root else root
            capsule = _fetch_json(f"{root}/debug/cycles/{doc['cycle']}")
            decisions = capsule.get("decisions", [])
        except Exception:
            pass

    root_span = doc.get("root", {})
    total_ms = root_span.get("duration_ms", doc.get("root_ms", 0.0))
    print(f"trace {doc.get('trace_id', '?')}  cycle {doc.get('cycle', '?')}  "
          f"trigger={doc.get('trigger', '?')}  root {total_ms:.2f}ms"
          + (f"  ingress lag {root_span['ingress_lag_ms']}ms"
             if root_span.get("ingress_lag_ms") else "")
          + ("  ** SLO BREACH (pinned) **" if doc.get("breached") else ""),
          file=sys.stderr)
    _render_waterfall(int(total_ms * 1000), doc.get("span_tree", []))
    _render_decision_join(decisions)
    out = dict(doc)
    if decisions:
        out["decisions"] = decisions
    print(json.dumps(out))
    return 0


def _run_slow(args) -> int:
    """Worst retained traces + SLO burn from a daemon's /debug/traces
    index (a bare http://host:port is expanded)."""
    url = args.slow
    if "/debug/" not in url:
        url = url.rstrip("/") + "/debug/traces"
    index = _fetch_json(url)
    if index.get("enabled") is False:
        print("tracing not enabled on this daemon — run it with --trace on",
              file=sys.stderr)
        return 1
    slo = index.get("slo", {})
    print(f"traces: {index.get('retained', 0)} retained "
          f"({index.get('pinned', 0)} pinned), "
          f"{index.get('completed_total', 0)} completed, "
          f"{index.get('evicted_total', 0)} evicted", file=sys.stderr)
    if slo.get("enabled"):
        print(f"SLO {slo.get('slo_ms')}ms: {slo.get('breaches', 0)} "
              f"breach(es), burn ratio {slo.get('burn_ratio', 0.0):.3f} "
              f"({slo.get('bad', 0)} bad / "
              f"{slo.get('good', 0) + slo.get('bad', 0)} total)",
              file=sys.stderr)
    worst = slo.get("worst") or sorted(
        index.get("traces", []), key=lambda t: -t.get("root_ms", 0.0))[:5]
    if worst:
        print(f"\n{'trace id':34s} {'cycle':>7s} {'trigger':>12s} "
              f"{'root ms':>10s} {'slo':>8s}", file=sys.stderr)
        for t in worst:
            print(f"{t.get('trace_id', '?'):34s} {t.get('cycle', 0):7d} "
                  f"{t.get('trigger', '?'):>12s} {t.get('root_ms', 0.0):10.2f} "
                  f"{'BREACH' if t.get('breached') else 'ok':>8s}",
                  file=sys.stderr)
        print("\ninspect one: python -m tpu_pruner_torch.analyze --trace <id> "
              "--traces-url " + args.slow.rstrip("/"), file=sys.stderr)
    else:
        print("no completed traces retained yet", file=sys.stderr)
    print(json.dumps(index))
    return 0


def _load_ledger_sources(args) -> list[dict]:
    """Workload accounts from N ledger JSONL checkpoints and/or
    /debug/workloads endpoints (both flags are repeatable).

    Each source is {"name", "records", "cluster"?}. Schema-2 sources
    (daemon stamps cluster identity + a monotonic checkpoint epoch on
    every line) are merge-safe; a schema-1 source (no cluster identity)
    is only accepted ALONE — merging it would silently conflate clusters.
    A source whose lines disagree about carrying a cluster is rejected
    outright (a torn mixed-schema checkpoint must never half-merge)."""
    sources = []
    for path in (args.ledger_file or []):
        records = []
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    # a torn tail line can only exist if the atomic-rename
                    # checkpoint was interrupted pre-rename; tolerate it
                    print(f"WARNING: skipping unparseable ledger line {lineno}",
                          file=sys.stderr)
        sources.append({"name": path, "records": records})
    for url in (args.workloads_url or []):
        # Bare host:port expands; full /debug/... URLs pass through.
        full = url if "/debug/" in url else url.rstrip("/") + "/debug/workloads"
        doc = _fetch_json(full)
        sources.append({"name": url, "records": doc.get("workloads", []),
                        "cluster": doc.get("cluster")})

    for src in sources:
        stamped = [r for r in src["records"] if r.get("cluster")]
        if stamped and len(stamped) != len(src["records"]):
            raise SystemExit(
                f"{src['name']}: mixed-schema checkpoint — "
                f"{len(src['records']) - len(stamped)} of {len(src['records'])} "
                "line(s) carry no cluster identity; refusing to merge a "
                "half-stamped ledger (re-checkpoint it with a current daemon)")
        src["schema2"] = bool(stamped) or bool(src.get("cluster"))
    if len(sources) > 1:
        # An empty checkpoint (a daemon that never tracked a workload) is
        # schema-agnostic and merges fine; only sources with actual
        # unstamped accounts are unmergeable.
        legacy = [s["name"] for s in sources
                  if s["records"] and not s["schema2"]]
        if legacy:
            raise SystemExit(
                "cannot merge schema-1 ledger source(s) without cluster "
                f"identity: {legacy} — every merged checkpoint needs the "
                "daemon's cluster + epoch stamps (--cluster-name; any "
                "current daemon writes them)")
    return sources


def _merge_ledger_sources(sources: list[dict]) -> tuple[list[dict], list[str]]:
    """Merge N schema-2 sources into one record list, deterministically.

    Conflict rule for the same cluster appearing in several sources: the
    source with the HIGHER checkpoint epoch wins wholesale (epochs are
    monotonic per daemon, so higher = fresher); equal epochs are accepted
    only when the records are identical (the same file given twice),
    otherwise the merge refuses — two divergent checkpoints claiming the
    same cluster at the same epoch cannot be ordered."""
    by_cluster: dict[str, dict] = {}
    for src in sources:
        groups: dict[str, list[dict]] = {}
        for r in src["records"]:
            groups.setdefault(r.get("cluster") or src.get("cluster") or "",
                              []).append(r)
        for cluster, records in groups.items():
            epoch = max(int(r.get("epoch", 0)) for r in records)
            incumbent = by_cluster.get(cluster)
            if incumbent is None or epoch > incumbent["epoch"]:
                by_cluster[cluster] = {"epoch": epoch, "records": records,
                                       "name": src["name"]}
            elif epoch == incumbent["epoch"]:
                def keyed(rows):
                    return sorted(json.dumps(r, sort_keys=True) for r in rows)
                if keyed(records) != keyed(incumbent["records"]):
                    raise SystemExit(
                        f"sources {incumbent['name']!r} and {src['name']!r} "
                        f"both claim cluster {cluster!r} at epoch {epoch} "
                        "with DIVERGENT accounts; refusing to merge "
                        "(two daemons sharing one --cluster-name?)")
            # lower epoch: the incumbent is fresher — drop this copy
    merged, clusters = [], []
    for cluster in sorted(by_cluster):
        clusters.append(cluster)
        merged.extend(by_cluster[cluster]["records"])
    return merged, clusters


def _run_fleet_report(args) -> int:
    """Per-namespace (and, with merged sources, per-cluster) savings
    report over N workload utilization ledgers."""
    sources = _load_ledger_sources(args)
    schema2 = any(s["schema2"] for s in sources)
    if schema2:
        records, cluster_names = _merge_ledger_sources(sources)
    else:  # single legacy schema-1 source: the pre-federation report
        records, cluster_names = sources[0]["records"], []
    # Cluster-qualified workload keys and table columns only earn their
    # noise once the report actually spans clusters; a single-cluster
    # report keeps the familiar shape (plus the "clusters" section).
    multi = len(cluster_names) > 1

    if args.merged_ledger_out:
        # Merged-checkpoint writer: the output is itself a valid schema-2
        # multi-cluster JSONL source, so reports compose (feed it back in,
        # alone or with fresher per-cluster checkpoints).
        with open(args.merged_ledger_out, "w") as f:
            for r in records:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        print(f"wrote merged checkpoint ({len(records)} account(s), "
              f"{len(cluster_names)} cluster(s)) to {args.merged_ledger_out}",
              file=sys.stderr)

    def wl_key(r):
        base = r.get("workload") or (f"{r.get('kind')}/{r.get('namespace')}"
                                     f"/{r.get('name')}")
        return f"{r['cluster']}:{base}" if multi and r.get("cluster") else base

    clusters: dict[str, dict] = {}
    for r in records if schema2 else []:
        cl = r.get("cluster", "")
        agg = clusters.setdefault(cl, {
            "cluster": cl, "workloads": 0, "chips": 0,
            "reclaimed_chip_hours": 0.0, "idle_hours": 0.0,
            "active_hours": 0.0, "pauses": 0, "resumes": 0,
            "epoch": 0,
            # raw seconds, NEVER rounded: the bit-for-bit join key against
            # each member's own /debug/workloads totals
            "reclaimed_chip_seconds": 0.0, "idle_seconds": 0.0,
            "active_seconds": 0.0,
        })
        agg["workloads"] += 1
        agg["chips"] += int(r.get("chips", 0))
        agg["reclaimed_chip_seconds"] += float(r.get("reclaimed_chip_seconds", 0))
        agg["idle_seconds"] += float(r.get("idle_seconds", 0))
        agg["active_seconds"] += float(r.get("active_seconds", 0))
        agg["reclaimed_chip_hours"] += float(r.get("reclaimed_chip_seconds", 0)) / 3600
        agg["idle_hours"] += float(r.get("idle_seconds", 0)) / 3600
        agg["active_hours"] += float(r.get("active_seconds", 0)) / 3600
        agg["pauses"] += int(r.get("pauses", 0))
        agg["resumes"] += int(r.get("resumes", 0))
        agg["epoch"] = max(agg["epoch"], int(r.get("epoch", 0)))

    namespaces: dict[tuple, dict] = {}
    pause_events = resume_events = 0
    for r in records:
        ns = r.get("namespace", "")
        ns_key = (r.get("cluster", ""), ns) if multi else ("", ns)
        agg = namespaces.setdefault(ns_key, {
            **({"cluster": r.get("cluster", "")} if multi else {}),
            "namespace": ns, "workloads": 0, "chips": 0,
            "reclaimed_chip_hours": 0.0, "idle_hours": 0.0,
            "active_hours": 0.0, "pauses": 0, "resumes": 0,
        })
        agg["workloads"] += 1
        agg["chips"] += int(r.get("chips", 0))
        agg["reclaimed_chip_hours"] += float(r.get("reclaimed_chip_seconds", 0)) / 3600
        agg["idle_hours"] += float(r.get("idle_seconds", 0)) / 3600
        agg["active_hours"] += float(r.get("active_seconds", 0)) / 3600
        agg["pauses"] += int(r.get("pauses", 0))
        agg["resumes"] += int(r.get("resumes", 0))
        pause_events += int(r.get("pauses", 0))
        resume_events += int(r.get("resumes", 0))

    ns_rows = sorted(namespaces.values(),
                     key=lambda a: a["reclaimed_chip_hours"], reverse=True)
    offenders = sorted(records,
                       key=lambda r: float(r.get("reclaimed_chip_seconds", 0)),
                       reverse=True)[:10]
    total_reclaimed = sum(a["reclaimed_chip_hours"] for a in ns_rows)

    if not records:
        print("ledger is empty: no workloads tracked yet", file=sys.stderr)
    else:
        if multi:
            print(f"{'cluster':20s} {'workloads':>9s} {'chips':>6s} "
                  f"{'reclaimed chip-hrs':>18s} {'idle hrs':>9s} {'epoch':>6s}",
                  file=sys.stderr)
            for cl in sorted(clusters):
                a = clusters[cl]
                print(f"{a['cluster']:20s} {a['workloads']:9d} {a['chips']:6d} "
                      f"{a['reclaimed_chip_hours']:18.3f} "
                      f"{a['idle_hours']:9.3f} {a['epoch']:6d}",
                      file=sys.stderr)
            print("", file=sys.stderr)
        ns_label = "cluster/namespace" if multi else "namespace"
        print(f"{ns_label:32s} {'workloads':>9s} {'chips':>6s} "
              f"{'reclaimed chip-hrs':>18s} {'idle hrs':>9s} {'pauses':>6s} "
              f"{'resumes':>7s}", file=sys.stderr)
        for a in ns_rows:
            ns_name = (f"{a['cluster']}/{a['namespace']}" if multi
                       else a["namespace"])
            print(f"{ns_name:32s} {a['workloads']:9d} {a['chips']:6d} "
                  f"{a['reclaimed_chip_hours']:18.3f} {a['idle_hours']:9.3f} "
                  f"{a['pauses']:6d} {a['resumes']:7d}", file=sys.stderr)
        print(f"\ntotal: {total_reclaimed:.3f} chip-hours reclaimed across "
              f"{len(records)} tracked workload(s)"
              + (f" in {len(clusters)} cluster(s)" if multi else "")
              + f"; {pause_events} pause / "
              f"{resume_events} resume event(s)", file=sys.stderr)
        print("\ntop offenders (reclaimed capacity):", file=sys.stderr)
        for r in offenders:
            if float(r.get("reclaimed_chip_seconds", 0)) <= 0:
                continue
            print(f"  {wl_key(r):48s} "
                  f"{float(r['reclaimed_chip_seconds']) / 3600:10.3f} "
                  f"chip-hrs ({r.get('state', '?')})", file=sys.stderr)

    def round3(x):
        return round(x, 3)

    doc = {
        "tracked_workloads": len(records),
        "reclaimed_chip_hours": round3(total_reclaimed),
        "idle_workload_hours": round3(sum(a["idle_hours"] for a in ns_rows)),
        "pause_events": pause_events,
        "resume_events": resume_events,
        "namespaces": [{k: (round3(v) if isinstance(v, float) else v)
                        for k, v in a.items()} for a in ns_rows],
        "top_offenders": [
            {"workload": wl_key(r),
             "state": r.get("state"),
             "chips": int(r.get("chips", 0)),
             "reclaimed_chip_hours": round3(
                 float(r.get("reclaimed_chip_seconds", 0)) / 3600),
             "pauses": int(r.get("pauses", 0)),
             "resumes": int(r.get("resumes", 0))}
            for r in offenders if float(r.get("reclaimed_chip_seconds", 0)) > 0],
    }
    if schema2:
        # Per-cluster sections + fleet totals that provably sum: the fleet
        # figures ARE the sum of the cluster rows (same floats, same
        # order), so a consumer can re-add them and land on the totals
        # bit-for-bit.
        raw_keys = ("reclaimed_chip_seconds", "idle_seconds", "active_seconds")
        doc["clusters"] = [
            {k: (round3(v) if isinstance(v, float) and k not in raw_keys else v)
             for k, v in clusters[cl].items()}
            for cl in sorted(clusters)]
        doc["fleet_totals"] = {
            "reclaimed_chip_hours": round3(sum(
                clusters[cl]["reclaimed_chip_hours"] for cl in sorted(clusters))),
            "idle_workload_hours": round3(sum(
                clusters[cl]["idle_hours"] for cl in sorted(clusters))),
            "chips": sum(clusters[cl]["chips"] for cl in sorted(clusters)),
            # raw seconds: sums of the per-cluster raw figures, bit-for-bit
            **{k: sum(clusters[cl][k] for cl in sorted(clusters))
               for k in raw_keys},
        }
    print(json.dumps(doc))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_pruner_torch.analyze", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dump", nargs="?",
                        help="metrics dump JSON path, or '-' for stdin "
                             "(omit with --explain)")
    parser.add_argument("--explain", metavar="NS/POD",
                        help="decision-audit mode: print the DecisionRecord "
                             "history for one pod from --audit-log or "
                             "--decisions-url instead of evaluating a dump")
    parser.add_argument("--audit-log", metavar="FILE",
                        help="with --explain: read the daemon's --audit-log "
                             "JSONL file")
    parser.add_argument("--decisions-url", metavar="URL",
                        help="with --explain: query /debug/decisions on the "
                             "daemon's metrics port (e.g. http://host:8080)")
    parser.add_argument("--fleet-report", action="store_true",
                        help="fleet-savings mode: render the per-namespace "
                             "(and per-cluster, when sources carry cluster "
                             "identity) savings table from N workload "
                             "utilization ledgers instead of evaluating a "
                             "dump; merged totals provably sum and a stale "
                             "duplicate of one cluster loses by checkpoint "
                             "epoch")
    parser.add_argument("--ledger-file", metavar="FILE", action="append",
                        help="with --fleet-report: read a daemon's "
                             "--ledger-file JSONL checkpoint (repeatable — "
                             "one per cluster)")
    parser.add_argument("--workloads-url", metavar="URL", action="append",
                        help="with --fleet-report: query /debug/workloads on "
                             "a daemon's metrics port (e.g. "
                             "http://host:8080; repeatable)")
    parser.add_argument("--merged-ledger-out", metavar="FILE",
                        help="with --fleet-report: also write the merged "
                             "accounts as one schema-2 JSONL checkpoint "
                             "(itself a valid --ledger-file source, so "
                             "reports compose)")
    parser.add_argument("--replay", metavar="CAPSULE",
                        help="replay mode: deterministically re-run a "
                             "flight-recorder cycle capsule (a --flight-dir "
                             "file or a /debug/cycles/<id> URL) with zero "
                             "network calls; exits non-zero when the "
                             "replayed decisions drift from the recorded "
                             "ones")
    parser.add_argument("--what-if", nargs="+", action="append",
                        metavar="KEY=VALUE",
                        help="with --replay: re-decide under altered config "
                             "(lookback=10m, duration=45, grace=600, "
                             "run_mode=scale-down, enabled_resources=dr, "
                             "max_scale_per_cycle=2, hbm_threshold=0.05, "
                             "signal_min_coverage=0.5, signal_guard=off, "
                             "right_size=on, right_size_threshold=0.8) "
                             "and report which decisions flip; repeatable, "
                             "and several key=value pairs may ride one "
                             "occurrence — all fold into ONE combined flip "
                             "report")
    parser.add_argument("--gym", metavar="SOURCE",
                        help="policy-gym mode: replay a capsule corpus (a "
                             "--flight-dir directory, a capsule file, or a "
                             "daemon URL whose /debug/cycles index is "
                             "fetched) against N candidate policies in one "
                             "pass, scoring reclaimed chip-hours vs false "
                             "pauses vs actuation churn; the winner's "
                             "config prints as a ready-to-apply flag line")
    parser.add_argument("--gym-policy", metavar="SPEC", action="append",
                        help="with --gym: a policy to score (repeatable): "
                             "baseline | sweep:<k=v,...> | "
                             "right-size[:threshold=0.8] | "
                             "hysteresis[:pause_after=3]; default panel "
                             "scores all three kinds")
    parser.add_argument("--regret-window", type=int, default=600,
                        help="with --gym: a pause whose root shows busy "
                             "evidence within this window counts as a "
                             "false pause (seconds, default 600)")
    parser.add_argument("--as-recorded", action="store_true",
                        help="with --gym: score run modes exactly as "
                             "recorded (a dry-run corpus then reclaims "
                             "nothing); default scores every policy as if "
                             "run_mode=scale-down")
    parser.add_argument("--assume-interval", type=int, default=0,
                        help="with --gym: score cycles this many seconds "
                             "apart instead of using the capsules' own "
                             "clocks — for synthetic corpora recorded "
                             "back-to-back (default 0 = capsule clocks)")
    parser.add_argument("--capacity-report", metavar="SOURCE",
                        help="defragmentation-report mode: recompute every "
                             "capsule's capacity inventory from its recorded "
                             "inputs (bit-for-bit, drift flagged), "
                             "dt-integrate consolidation potential across "
                             "the window, and list the pause/right-size "
                             "moves that free whole slices. SOURCE is a "
                             "--flight-dir directory, capsule file, or "
                             "daemon URL (bare http://host:port expands to "
                             "/debug/cycles)")
    parser.add_argument("--signal-report", metavar="SOURCE",
                        help="signal-health mode: render the fleet's "
                             "evidence health (per-pod verdicts, coverage, "
                             "brownout) from a flight-recorder capsule file/"
                             "URL or the daemon's /debug/signals endpoint "
                             "(a bare http://host:port is expanded)")
    parser.add_argument("--trace", metavar="ID|SOURCE",
                        help="waterfall mode: render one action-provenance "
                             "trace as a span waterfall joined with the "
                             "capsule's decision records. Accepts a 32-hex "
                             "trace id (with --traces-url), a "
                             "/debug/traces/<id> URL, a bare daemon URL "
                             "(newest retained trace), or a --flight-dir "
                             "directory / capsule file whose `trace` stamp "
                             "renders offline")
    parser.add_argument("--traces-url", metavar="URL",
                        help="with --trace <id>: the daemon metrics port "
                             "whose /debug/traces ring holds the id (e.g. "
                             "http://host:8080)")
    parser.add_argument("--slow", metavar="URL",
                        help="slow-trace mode: list the worst retained "
                             "traces and SLO budget burn from a daemon's "
                             "/debug/traces index (a bare http://host:port "
                             "is expanded)")
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
    args = parser.parse_args(argv)
    if args.trace:
        if (args.gym or args.replay or args.explain or args.fleet_report
                or args.signal_report or args.capacity_report or args.slow):
            parser.error("--trace is mutually exclusive with the other "
                         "report modes")
        return _run_trace(args)
    if args.traces_url:
        parser.error("--traces-url only applies with --trace")
    if args.slow:
        if (args.gym or args.replay or args.explain or args.fleet_report
                or args.signal_report or args.capacity_report):
            parser.error("--slow is mutually exclusive with the other "
                         "report modes")
        return _run_slow(args)
    if args.gym:
        if (args.replay or args.explain or args.fleet_report
                or args.signal_report or args.capacity_report):
            parser.error("--gym is mutually exclusive with --replay, "
                         "--explain, --fleet-report, --signal-report and "
                         "--capacity-report")
        return _run_gym(args)
    if args.gym_policy or args.as_recorded:
        parser.error("--gym-policy/--as-recorded only apply with --gym")
    if args.capacity_report:
        if args.replay or args.explain or args.fleet_report or args.signal_report:
            parser.error("--capacity-report is mutually exclusive with "
                         "--replay, --explain, --fleet-report and "
                         "--signal-report")
        return _run_capacity_report(args)
    if args.signal_report:
        if args.replay or args.explain or args.fleet_report:
            parser.error("--signal-report is mutually exclusive with "
                         "--replay, --explain and --fleet-report")
        return _run_signal_report(args)
    if args.replay:
        if args.explain or args.fleet_report:
            parser.error("--replay is mutually exclusive with --explain and "
                         "--fleet-report")
        return _run_replay(args)
    if args.what_if:
        parser.error("--what-if only applies with --replay")
    if args.fleet_report:
        if args.explain:
            parser.error("--fleet-report and --explain are mutually exclusive")
        if not args.ledger_file and not args.workloads_url:
            parser.error("--fleet-report needs at least one --ledger-file "
                         "or --workloads-url source (both repeatable)")
        return _run_fleet_report(args)
    if args.ledger_file or args.workloads_url or args.merged_ledger_out:
        parser.error("--ledger-file/--workloads-url/--merged-ledger-out only "
                     "apply with --fleet-report")
    if args.explain:
        if bool(args.audit_log) == bool(args.decisions_url):
            parser.error("--explain needs exactly one of --audit-log or "
                         "--decisions-url")
        return _run_explain(args)
    if args.audit_log or args.decisions_url:
        parser.error("--audit-log/--decisions-url only apply with --explain")
    if not args.dump:
        parser.error("a metrics dump path is required (or use --explain)")
    if args.window_chunks < 1:
        parser.error("--window-chunks must be >= 1")
    if args.stream and args.shard:
        # the window pass reads [C, K] chunk maxima, which is tiny, so
        # sharding it buys nothing; make_sharded_stream_step is the API for
        # streaming over a process group. The text is the reference's.
        parser.error("--shard does not apply to --stream (the window pass "
                     "is single-device; see make_sharded_stream_step for "
                     "mesh deployments)")

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
