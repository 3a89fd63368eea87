"""The streaming daemon cycle: ``analyze --stream``'s calls, from host arrays.

Each operation is one cycle of ``tpu_pruner_torch.analyze._run_stream``,
in its order, without the state file and the printing: the cycle's host
arrays (as ``load_fleet`` returns them) go up with ``fleet_from_numpy``, are
quantized on the card and folded into the window's int8 rings in place
(``update_window_``); then ``quantize_params``, ``slice_bounds`` and
``evaluate_window_qc``, and the verdicts and candidates come back to the host.

The cycles' inputs are a pool of ``pool_chunks`` chunks made in set-up, cycle
i taking chunk i mod pool_chunks, with the ages grown by ``cycle_s`` a chunk.
The reference takes each sampled cycle's window as the last ``window_chunks``
chunks' samples and computes its verdicts from them alone.
"""

from __future__ import annotations

import numpy as np
import torch

import tpu_pruner_torch.policy as tp
from port_bench import gen
from port_bench.check import Compared, mismatches
from port_bench.reference import fleet as ref


class Driver:
    def __init__(self, ctx):
        cfg, mix = ctx.config, ctx.mix
        self.dev, self.spans = ctx.device, ctx.spans
        self.C, self.S = cfg["chips"], cfg["slices"]
        self.K, self.T = cfg["window_chunks"], cfg["chunk_samples"]
        self.lookback, self.threshold = cfg["lookback_s"], cfg["hbm_threshold"]
        self.pool_n = mix["pool_chunks"]
        fleet = gen.make_fleet(cfg, mix, ctx.seed, self.dev, chunks=self.pool_n)
        g = gen.generator(ctx.seed, self.dev, 1)
        self.pool = []
        for j in range(self.pool_n):
            tc, hbm, valid = gen.samples(fleet, mix, g, j, self.T, 0, self.C)
            age = fleet.age + np.float32(j * cfg["cycle_s"])
            self.pool.append(tuple(x.cpu().numpy() for x in (tc, hbm, valid, age)))
        self.slice_id = fleet.slice_id
        params = tp.PolicyParams(lookback_s=self.lookback, hbm_threshold=self.threshold)
        self.parr = np.array([params.lookback_s, params.hbm_cutoff()], dtype=np.float32)
        self.ring = tp.init_window(self.C, self.K, device=self.dev)
        self._peaks: dict = {}

    def shape(self) -> dict:
        return {"chips": self.C, "new_samples": self.T, "chunks": self.K, "slices": self.S}

    def trace(self, on: bool) -> None:
        pass

    def step(self, i: int):
        tc, hbm, valid, age = self.pool[i % self.pool_n]
        span = self.spans
        ring = self.ring
        with span("cursor"):
            int(ring[2])  # _run_stream reads the cursor first, for its chunk clock
        with span("upload"):
            tc_t, hbm_t, valid_t, age_t, _, parr_t = tp.fleet_from_numpy(
                (tc, hbm, valid, age, self.slice_id, self.parr), self.dev)
        with span("quantize"):
            tc_q = tp.quantize_samples_device(tc_t, valid_t)
            hbm_q = tp.quantize_samples_device(hbm_t, valid_t)
        with span("update"):
            self.ring = ring = tp.update_window_(ring, tc_q, hbm_q)
        with span("params"):
            parr_q = torch.from_numpy(tp.quantize_params(parr_t)).to(parr_t.device)
        with span("bounds"):
            bounds = tp.slice_bounds(self.slice_id, self.S, device=self.dev)
        with span("evaluate"):
            verdicts, candidates = tp.evaluate_window_qc(ring, age_t, bounds, parr_q)
        with span("readback"):
            return verdicts.cpu().numpy(), candidates.cpu().numpy()

    def release(self) -> None:
        self.ring = None

    # --- the reference -----------------------------------------------------

    def _chunk_peaks(self, j: int, precision: str):
        key = (j, precision)
        if key not in self._peaks:
            tc, hbm, valid, _ = self.pool[j]
            self._peaks[key] = (ref.peaks_q(ref.quantize(tc, valid, precision)),
                                ref.peaks_q(ref.quantize(hbm, valid, precision)))
        return self._peaks[key]

    def reference(self, i: int, precision: str = "int8"):
        """Cycle i's (verdicts, candidates): its window is the samples of
        cycles max(0, i - K + 1) .. i."""
        peaks = [self._chunk_peaks(m % self.pool_n, precision)
                 for m in range(max(0, i - self.K + 1), i + 1)]
        candidate = ref.candidates_q(ref.window_peaks(p[0] for p in peaks),
                                     ref.window_peaks(p[1] for p in peaks),
                                     self.pool[i % self.pool_n][3], self.lookback,
                                     ref.cutoff_q(self.threshold, precision))
        return ref.slice_verdicts(candidate, self.slice_id, self.S), candidate

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
