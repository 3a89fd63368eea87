"""Export a fleet metrics dump for `tpu_pruner_torch.analyze` from Prometheus.

    python -m tpu_pruner_torch.dump --prometheus-url URL > dump.json
    python -m tpu_pruner_torch.analyze dump.json

The port of tpu_pruner/dump.py, with the same options, and two changes to
its output: the samples' spacing, ``step_s`` (``--step-s``), is stamped on
the document, and every series is placed in time: it spans the window, one
sample a step from the oldest to the newest, with ``null`` at each step
for which Prometheus returned no sample (a missed scrape, a pod not yet
running or gone), in tc and hbm alike. ``analyze`` reads a null sample as
invalid, so a window of the newest samples (``analyze --sweep``) holds
what the chip reported in that time and nothing older. Queries
`/api/v1/query_range` over the lookback window and emits the analyze input
format: one chip per returned series, grouped into slices by
`--slice-label` (JobSet membership when the label exists, falling back to
per-pod slices). The daemon's PromQL evaluates idleness inside Prometheus
(query.cpp); this tool pulls the raw utilization matrices so the policy
engine can re-evaluate them offline under other thresholds, or
incrementally with `analyze --stream` (export each cycle with
`--window-s` = the cycle).

Auth: `PROMETHEUS_TOKEN` (Bearer), the env the daemon honors first in its
chain (native/src/auth.cpp).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.parse
import urllib.request


def _label(metric: dict, name: str):
    """Prometheus label with `exported_` tolerance (honor_labels scrape
    configs — the same switch the query layer handles, metrics.cpp)."""
    return metric.get(name) or metric.get("exported_" + name)


def fetch_range(base_url: str, query: str, start: float, end: float,
                step: float, token: str | None):
    params = urllib.parse.urlencode({
        "query": query, "start": f"{start:.3f}", "end": f"{end:.3f}",
        "step": str(int(step)),
    })
    req = urllib.request.Request(
        base_url.rstrip("/") + "/api/v1/query_range?" + params)
    if token:
        req.add_header("Authorization", "Bearer " + token)
    with urllib.request.urlopen(req, timeout=60) as resp:
        payload = json.load(resp)
    if payload.get("status") != "success":
        raise SystemExit(f"prometheus error: {payload.get('error', payload)}")
    data = payload.get("data", {})
    if data.get("resultType") != "matrix":
        raise SystemExit(
            f"expected a matrix from query_range, got {data.get('resultType')}")
    return data.get("result", [])


def place(values, start: float, step_s: float, steps: int) -> list:
    """A query_range series' ``[timestamp, value]`` pairs as ``steps``
    samples, the k-th that of ``start + k * step_s``, None where the series
    has none (pairs off the grid of steps are dropped)."""
    samples = [None] * steps
    for ts, v in values:
        k = round((float(ts) - start) / step_s)
        if 0 <= k < steps:
            samples[k] = float(v)
    return samples


def build_dump(tc_result, hbm_result, slice_label: str, pod_age_s: float,
               lookback_s: float, step_s: float | None = None, start: float | None = None,
               steps: int | None = None):
    """Join tc/hbm range series into the analyze chip list.

    Chip identity = (namespace, pod, accelerator_id) — stable across
    exports, so successive dumps feed `analyze --stream` directly.
    ``step_s``, where given, is stamped on the document after
    ``lookback_s``: the samples' spacing, which ``analyze --sweep`` needs to
    cut a window of a given duration from the newest samples. With
    ``start`` and ``steps`` too, each series is placed in time (``place``):
    ``steps`` samples from ``start``, null where it has none; without them
    the values are listed as they come, as tpu_pruner/dump.py lists them.
    """
    def samples(series):
        values = series.get("values", [])
        if start is None or steps is None or step_s is None:
            return [float(v) for _, v in values]
        return place(values, start, step_s, steps)

    def key(metric):
        # accelerator_id needs the same exported_ tolerance as the identity
        # labels: under an honor_labels scrape it arrives as
        # exported_accelerator_id, and a plain .get would collapse every
        # chip of a pod onto accelerator '0' (duplicate ids, wrong hbm join)
        return (_label(metric, "namespace") or "",
                _label(metric, "pod") or "",
                _label(metric, "accelerator_id") or "0")

    hbm_by_key = {}
    for series in hbm_result or []:
        hbm_by_key[key(series["metric"])] = samples(series)

    chips = []
    for series in tc_result:
        metric = series["metric"]
        ns, pod, accel = key(metric)
        if not pod:
            continue  # aggregate rows (no pod identity) cannot be chips
        slice_name = (_label(metric, slice_label)
                      or f"{ns}/{pod}")  # fallback: the pod is its own slice
        chip = {
            "slice": slice_name,
            "id": f"{ns}/{pod}/{accel}",
            "pod_age_s": pod_age_s,
            "tc": samples(series),
        }
        hbm = hbm_by_key.get((ns, pod, accel))
        if hbm is not None:
            chip["hbm"] = hbm
        chips.append(chip)
    doc = {"lookback_s": lookback_s}
    if step_s is not None:
        doc["step_s"] = step_s
    return {**doc, "timestamp": time.time(), "chips": chips}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_pruner_torch.dump", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--prometheus-url", required=True)
    parser.add_argument("--window-s", type=float, default=30 * 60 + 300,
                        help="lookback window to export (default "
                             "duration+grace = 2100s); for analyze --stream "
                             "set this to one check-interval")
    parser.add_argument("--lookback-s", type=float, default=None,
                        help="lookback_s stamped on the dump (analyze's age "
                             "gate). Defaults to --window-s, which is right "
                             "for one-shot audits but NOT for per-cycle "
                             "stream exports — there, pass the full policy "
                             "lookback (e.g. 2100) or the age gate shrinks "
                             "to one cycle")
    parser.add_argument("--step-s", type=float, default=300,
                        help="sample resolution (default 300s — the typical "
                             "GMP TPU metric cadence)")
    parser.add_argument("--tc-metric", default="tensorcore_utilization",
                        help="tensorcore utilization metric (0-1 or 0-100 "
                             "with --percent). Any instant-vector PromQL "
                             "expression works — e.g. the gke-system "
                             "node-to-pod group_left join (`tpu-pruner "
                             "--print-query` shows the daemon's), since "
                             "node-scoped series alone carry no pod "
                             "identity to group chips by")
    parser.add_argument("--hbm-metric",
                        default="hbm_memory_bandwidth_utilization",
                        help="HBM bandwidth metric (the daemon's gmp-schema "
                             "default, query.cpp); pass '' to skip the "
                             "corroboration series")
    parser.add_argument("--percent", action="store_true",
                        help="series are 0-100 duty-cycle percent; divide "
                             "by 100 on export (the query layer's /100)")
    parser.add_argument("--slice-label",
                        default="label_jobset_sigs_k8s_io_jobset_name",
                        help="series label carrying slice/workload identity "
                             "(exported_* tolerated); chips without it get "
                             "per-pod slices")
    parser.add_argument("--pod-age-s", type=float, default=7200,
                        help="pod_age_s stamped on every chip (Prometheus "
                             "alone cannot answer it; the daemon's own age "
                             "gate uses the live API server — offline audits "
                             "usually want the gate satisfied)")
    args = parser.parse_args(argv)

    token = os.environ.get("PROMETHEUS_TOKEN")
    end = round(time.time(), 3)  # as fetch_range sends it
    start = round(end - args.window_s, 3)
    tc = fetch_range(args.prometheus_url, args.tc_metric, start, end,
                     args.step_s, token)
    hbm = (fetch_range(args.prometheus_url, args.hbm_metric, start, end,
                       args.step_s, token)
           if args.hbm_metric else [])
    # query_range evaluates at start, start + step, ... while <= end, in
    # milliseconds, at the whole seconds of step that fetch_range sends
    step = float(int(args.step_s))
    steps = (round(end * 1000) - round(start * 1000)) // round(step * 1000) + 1
    doc = build_dump(tc, hbm, args.slice_label, args.pod_age_s,
                     args.lookback_s if args.lookback_s is not None
                     else args.window_s, step, start, steps)
    if args.percent:
        for chip in doc["chips"]:
            chip["tc"] = [None if v is None else v / 100.0 for v in chip["tc"]]
            if "hbm" in chip:
                chip["hbm"] = [None if v is None else v / 100.0 for v in chip["hbm"]]
    if not doc["chips"]:
        print(f"WARNING: query '{args.tc_metric}' returned no pod-keyed "
              "series over the window", file=sys.stderr)
    json.dump(doc, sys.stdout)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
