"""The device-resident fleet evaluation: ``evaluate_fleet_qc`` on a window
held on the card.

Set-up makes the window as int8 samples [C, T] on the card from the seed
(the 1% buckets the recommended storage holds), the ages, the slice bounds
(``slice_bounds``) and each policy's quantized params (``quantize_params``).
Each operation is one ``evaluate_fleet_qc`` call under the next of the
mix's ``policies`` ([lookback_s, hbm_threshold] each), ending with the
slice verdicts and chip candidates on the host.
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
        self.C, self.S, self.T = cfg["chips"], cfg["slices"], cfg["window_samples"]
        fleet = gen.make_fleet(cfg, mix, ctx.seed, self.dev)
        g = gen.generator(ctx.seed, self.dev, 2)
        self.tc_q = torch.empty((self.C, self.T), dtype=torch.int8, device=self.dev)
        self.hbm_q = torch.empty_like(self.tc_q)
        block = mix["block_rows"]
        for r0 in range(0, self.C, block):
            r1 = min(self.C, r0 + block)
            tc, hbm, valid = gen.samples(fleet, mix, g, 0, self.T, r0, r1)
            self.tc_q[r0:r1] = gen.quantize(tc, valid)
            self.hbm_q[r0:r1] = gen.quantize(hbm, valid)
            del tc, hbm, valid
        self.age = fleet.age
        self.slice_id = fleet.slice_id
        self.policies = [tuple(p) for p in mix["policies"]]
        self.bounds = tp.slice_bounds(self.slice_id, self.S, device=self.dev)
        self.params_q = []
        for lookback, threshold in self.policies:
            params = tp.PolicyParams(lookback_s=lookback, hbm_threshold=threshold)
            parr = np.array([params.lookback_s, params.hbm_cutoff()], dtype=np.float32)
            self.params_q.append(torch.from_numpy(tp.quantize_params(parr)).to(self.dev))

    def shape(self) -> dict:
        return {"chips": self.C, "samples": self.T, "slices": self.S}

    def trace(self, on: bool) -> None:
        pass

    def step(self, i: int):
        params_q = self.params_q[i % len(self.params_q)]
        with self.spans("evaluate"):
            verdicts, candidates = tp.evaluate_fleet_qc(self.tc_q, self.hbm_q, self.age,
                                                        self.bounds, params_q)
        with self.spans("readback"):
            return verdicts.cpu().numpy(), candidates.cpu().numpy()

    def release(self) -> None:
        """Read the window back for the reference, in blocks, and free it."""
        block = 1 << 17
        peaks = [[], []]
        for r0 in range(0, self.C, block):
            for k, x in enumerate((self.tc_q, self.hbm_q)):
                peaks[k].append(ref.peaks_q(x[r0:r0 + block].cpu().numpy()))
        self._peaks = (np.concatenate(peaks[0]), np.concatenate(peaks[1]))
        self._age = self.age.cpu().numpy()
        self.tc_q = self.hbm_q = self.age = self.bounds = self.params_q = None

    # --- the reference -----------------------------------------------------

    def reference(self, i: int, precision: str = "int8"):
        lookback, threshold = self.policies[i % len(self.policies)]
        peak_tc, peak_hbm = (ref.requantize(p, precision) for p in self._peaks)
        candidate = ref.candidates_q(peak_tc, peak_hbm, self._age, lookback,
                                     ref.cutoff_q(threshold, precision))
        return ref.slice_verdicts(candidate, self.slice_id, self.S), candidate

    def control(self, i: int):
        """The reference in place of the program, with int4 buckets."""
        return self.reference(i, "int4")

    def compare(self, kept) -> list[Compared]:
        wants = {}
        slices = chips = missing = 0
        for i, answer in kept:
            policy = i % len(self.policies)
            if policy not in wants:
                wants[policy] = self.reference(i)
            want_v, want_c = wants[policy]
            if answer is None:
                missing += 1
                continue
            slices += mismatches(answer[0], want_v)
            chips += mismatches(answer[1], want_c)
        return [Compared("slices_wrong", slices, 0), Compared("chips_wrong", chips, 0),
                Compared("answers_missing", missing, 0)]
