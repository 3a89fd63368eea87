"""The f32 fleet evaluation over chips in host order: ``evaluate_fleet`` on
inputs held on the card.

Set-up makes the fleet's layout (``groups.make_fleet``: JobSet groups of
mixed sizes, hosts shuffled, group ids permuted) and its samples, in blocks,
as f32 tc and hbm [C, T] and a bool validity mask on the card, with the ages,
the int32 group ids and one ``params_array`` for each of the mix's
``policies`` ([lookback_s, hbm_threshold] each). Each operation is one
``evaluate_fleet`` call under the next policy, ending with the slice
verdicts and chip candidates on the host.
"""

from __future__ import annotations

import torch

import tpu_pruner_torch.policy as tp
from port_bench import gen, groups
from port_bench.check import Compared, mismatches
from port_bench.reference import groups as ref


class Driver:
    def __init__(self, ctx):
        cfg, mix = ctx.config, ctx.mix
        self.dev, self.spans = ctx.device, ctx.spans
        self.C, self.S, self.T = cfg["chips"], cfg["slices"], cfg["window_samples"]
        fleet = groups.make_fleet(cfg, mix, ctx.seed, self.dev)
        g = gen.generator(ctx.seed, self.dev, 2)
        self.tc = torch.empty((self.C, self.T), dtype=torch.float32, device=self.dev)
        self.hbm = torch.empty_like(self.tc)
        self.valid = torch.empty((self.C, self.T), dtype=torch.bool, device=self.dev)
        self.block = mix["block_rows"]
        for r0 in range(0, self.C, self.block):
            r1 = min(self.C, r0 + self.block)
            self.tc[r0:r1], self.hbm[r0:r1], self.valid[r0:r1] = groups.samples(
                fleet, mix, g, self.T, r0, r1)
        self.age = fleet.age
        self.slice_id = fleet.slice_id
        self.policies = [tuple(p) for p in mix["policies"]]
        self.params = [tp.params_array(tp.PolicyParams(lookback_s=lookback,
                                                       hbm_threshold=threshold),
                                       device=self.dev)
                       for lookback, threshold in self.policies]

    def shape(self) -> dict:
        return {"chips": self.C, "samples": self.T, "slices": self.S}

    def trace(self, on: bool) -> None:
        pass

    def step(self, i: int):
        params = self.params[i % len(self.params)]
        with self.spans("evaluate"):
            verdicts, candidates = tp.evaluate_fleet(self.tc, self.hbm, self.valid, self.age,
                                                     self.slice_id, params,
                                                     num_slices=self.S)
        with self.spans("readback"):
            return verdicts.cpu().numpy(), candidates.cpu().numpy()

    def release(self) -> None:
        """Read the inputs back for the reference, in blocks, and free them."""
        self._blocks = [tuple(x[r0:r0 + self.block].cpu().numpy()
                              for x in (self.tc, self.hbm, self.valid))
                        for r0 in range(0, self.C, self.block)]
        self._age = self.age.cpu().numpy()
        self._slice_id = self.slice_id.cpu().numpy()
        self._refs = {}
        self.tc = self.hbm = self.valid = self.age = self.slice_id = self.params = None

    # --- the reference -----------------------------------------------------

    def reference(self, i: int, precision: str = "f32"):
        """The reference's answer to operation ``i``, computed once a policy
        and precision (a pass over the whole fleet takes seconds)."""
        key = (i % len(self.policies), precision)
        if key not in self._refs:
            lookback, threshold = self.policies[key[0]]
            self._refs[key] = ref.verdicts(self._blocks, self._age, self._slice_id, self.S,
                                           lookback, threshold, precision)
        return self._refs[key]

    def control(self, i: int):
        """The reference in place of the program, with bfloat16 samples,
        ages and params."""
        return self.reference(i, "bf16")

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
