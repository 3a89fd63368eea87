"""The daemon cycle on a fleet that changes between cycles: ``analyze
--stream --follow-fleet``'s calls, from host arrays and chip keys.

Each operation is one cycle of ``tpu_pruner_torch.analyze._run_stream``
with ``--follow-fleet``, in its order, without the state file and the
printing: the window's rows are carried to this cycle's chips by key
(``rekey_window``), the cycle's host arrays go up with ``fleet_from_numpy``,
are quantized on the card and folded into the rings in place
(``update_window_``, which writes the kept rows' column as no data); then
``quantize_params``, ``slice_bounds`` over this cycle's groups and
``evaluate_window_qc`` over its chips, and the verdicts and candidates come
back to the host.

Set-up makes every cycle of the pool (``churn.Churn``: ``pool_cycles``
cycles that wrap without a jump), cycle i taking pool cycle i mod
pool_cycles; the timed step holds only the program's calls. The reference
(``reference/churn.py``) judges each sampled cycle from the chunk peaks of
the ids of its window's cycles.
"""

from __future__ import annotations

import numpy as np
import torch

import tpu_pruner_torch.policy as tp
from tpu_pruner_torch import obs
from port_bench import work_churn
from port_bench.check import Compared, mismatches
from port_bench.churn import Churn
from port_bench.reference import churn as ref


class Driver:
    def __init__(self, ctx):
        if not hasattr(tp, "rekey_window"):
            raise SystemExit("this program keeps no window keyed by chip (no rekey_window)")
        cfg, mix = ctx.config, ctx.mix
        self.dev, self.spans = ctx.device, ctx.spans
        self.K, self.T = cfg["window_chunks"], cfg["chunk_samples"]
        self.lookback, self.threshold = cfg["lookback_s"], cfg["hbm_threshold"]
        churn = Churn(cfg, mix, ctx.seed, self.dev)
        self.pool = [churn.cycle(t, mix) for t in range(churn.N)]
        self.pool_n = churn.N
        params = tp.PolicyParams(lookback_s=self.lookback, hbm_threshold=self.threshold)
        self.parr = np.array([params.lookback_s, params.hbm_cutoff()], dtype=np.float32)
        self.ring = tp.init_window(0, self.K, device=self.dev)
        self.rows = tp.WindowRows.of(np.zeros(0, dtype=np.int64), 0)
        self.tracing = False
        self.traced = {"cycles": 0, "bytes": 0}
        self._peaks: dict = {}

    def shape(self) -> dict:
        return {"new_samples": self.T, "chunks": self.K, **self.traced}

    def trace(self, on: bool) -> None:
        self.tracing = on

    def step(self, i: int):
        c = self.pool[i % self.pool_n]
        span = self.spans
        with span("cursor"):
            int(self.ring[2])  # _run_stream reads the cursor, for its chunk clock
        with span("rekey"):
            new, up = obs.counts["window_rows_new"], obs.counts["h2d_bytes"]
            rekeyed = tp.rekey_window(self.ring, self.rows, c.keys, i)
            self.ring, self.rows = ring, rows = rekeyed.state, rekeyed.rows
        with span("upload"):
            tc_t, hbm_t, valid_t, age_t, _, parr_t = tp.fleet_from_numpy(
                (c.tc, c.hbm, c.valid, c.age, c.slice_id, self.parr), self.dev)
        with span("quantize"):
            tc_q = tp.quantize_samples_device(tc_t, valid_t)
            hbm_q = tp.quantize_samples_device(hbm_t, valid_t)
        with span("update"):
            self.ring = ring = tp.update_window_(ring, tc_q, hbm_q)
        with span("params"):
            parr_q = torch.from_numpy(tp.quantize_params(parr_t)).to(parr_t.device)
        with span("bounds"):
            bounds = tp.slice_bounds(c.slice_id, c.slices, device=self.dev)
        with span("evaluate"):
            verdicts, candidates = tp.evaluate_window_qc(ring, age_t, bounds, parr_q)
        if self.tracing:  # the carry's bytes from the program's counters
            rows_out = len(rows.keys) + len(rows.kept_keys)
            carried = rows_out - (obs.counts["window_rows_new"] - new)
            runs_bytes = obs.counts["h2d_bytes"] - up
            self.traced["cycles"] += 1
            self.traced["bytes"] += work_churn.cycle_bytes(len(c.keys), rows_out, carried,
                                                           runs_bytes, self.T, self.K, c.slices)
        with span("readback"):
            return verdicts.cpu().numpy(), candidates.cpu().numpy()

    def release(self) -> None:
        self.ring = None

    # --- the reference -----------------------------------------------------

    def _chunk_peaks(self, j: int, precision: str):
        key = (j, precision)
        if key not in self._peaks:
            c = self.pool[j]
            self._peaks[key] = ref.by_id(c.keys, *ref.chunk_peaks(c.tc, c.hbm, c.valid,
                                                                   precision))
        return self._peaks[key]

    def reference(self, i: int, precision: str = "int8"):
        """Cycle i's (verdicts, candidates): each chip's window is its chunks
        of cycles max(0, i - K + 1) .. i."""
        window = [self._chunk_peaks(m % self.pool_n, precision)
                  for m in range(max(0, i - self.K + 1), i + 1)]
        c = self.pool[i % self.pool_n]
        return ref.verdicts(window, c.keys, c.age, c.slice_id, c.slices, self.lookback,
                            self.threshold, precision)

    def control(self, i: int):
        """The reference in place of the program, with int4 buckets."""
        return self.reference(i, "int4")

    def compare(self, kept) -> list[Compared]:
        slices = chips = missing = 0
        for i, answer in kept:
            want_v, want_c = self.reference(i)
            if answer is None:
                missing += 1
                continue
            slices += mismatches(answer[0], want_v)
            chips += mismatches(answer[1], want_c)
        return [Compared("slices_wrong", slices, 0), Compared("chips_wrong", chips, 0),
                Compared("answers_missing", missing, 0)]
