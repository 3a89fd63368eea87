"""A policy sweep over a day of raw samples: ``evaluate_fleet_sweep`` on
inputs held on the card.

Set-up makes the cluster (``sweep.make_fleet``: JobSet groups of mixed sizes,
hosts shuffled, group ids permuted, idle, veto and age edges around the
grid's) and its samples, in blocks, as f32 tc and hbm [C, T] and a bool
validity mask on the card, with the ages and the int32 group ids, and one
``sweep_grid`` a grace of the configuration's grid (``sweep.grids_of``).
Each operation is one ``evaluate_fleet_sweep`` call under the next grid,
ending with the slice masks, chip masks and per-policy counts on the host.
The reference (``reference/sweep.py``) judges each grid once, policy by
policy, from the inputs read back in ``release``.
"""

from __future__ import annotations

import numpy as np
import torch

import tpu_pruner_torch.policy as tp
from port_bench import gen, sweep
from port_bench.check import Compared
from port_bench.reference import sweep as ref


def bits_differing(got, want, policies: int) -> int:
    """Bits of the first ``policies`` that differ between two int64 mask
    arrays; every such bit where the shapes differ."""
    if got is None or got.shape != want.shape:
        return max(len(want), 1) * policies
    keep = np.int64(-1) if policies == 64 else np.int64((1 << policies) - 1)
    diff = np.ascontiguousarray((got ^ want) & keep)
    return int(np.unpackbits(diff.view(np.uint8)).sum())


class Driver:
    def __init__(self, ctx):
        if not hasattr(tp, "evaluate_fleet_sweep"):
            raise SystemExit("this program judges one policy a call (no evaluate_fleet_sweep)")
        cfg, mix = ctx.config, ctx.mix
        self.dev, self.spans = ctx.device, ctx.spans
        self.C, self.S, self.T = cfg["chips"], cfg["slices"], cfg["window_samples"]
        self.grids = sweep.grids_of(cfg)
        fleet = sweep.make_fleet(cfg, mix, ctx.seed, self.dev)
        g = gen.generator(ctx.seed, self.dev, 2)
        self.tc = torch.empty((self.C, self.T), dtype=torch.float32, device=self.dev)
        self.hbm = torch.empty_like(self.tc)
        self.valid = torch.empty((self.C, self.T), dtype=torch.bool, device=self.dev)
        self.block = mix["block_rows"]
        for r0 in range(0, self.C, self.block):
            r1 = min(self.C, r0 + self.block)
            self.tc[r0:r1], self.hbm[r0:r1], self.valid[r0:r1] = sweep.samples(
                fleet, mix, g, self.T, r0, r1)
        self.age = fleet.age
        self.slice_id = fleet.slice_id
        self.P = self.grids[0].num_policies

    def shape(self) -> dict:
        return {"chips": self.C, "samples": int(self.grids[0].samples.max()), "slices": self.S,
                "policies": self.P}

    def trace(self, on: bool) -> None:
        pass

    def step(self, i: int):
        grid = self.grids[i % len(self.grids)]
        with self.spans("evaluate"):
            slices, chips, counts = tp.evaluate_fleet_sweep(self.tc, self.hbm, self.valid,
                                                            self.age, self.slice_id, grid,
                                                            num_slices=self.S)
        with self.spans("readback"):
            return slices.cpu().numpy(), chips.cpu().numpy(), counts.cpu().numpy()

    def release(self) -> None:
        """Read the inputs back for the reference, in blocks, and free them."""
        self._blocks = [tuple(x[r0:r0 + self.block].cpu().numpy()
                              for x in (self.tc, self.hbm, self.valid))
                        for r0 in range(0, self.C, self.block)]
        self._age = self.age.cpu().numpy()
        self._slice_id = self.slice_id.cpu().numpy()
        self._refs = {}
        self.tc = self.hbm = self.valid = self.age = self.slice_id = None

    # --- the reference -----------------------------------------------------

    def reference(self, i: int, precision: str = "f32"):
        """The reference's answer to operation ``i``, computed once a grid
        and precision, as numpy arrays."""
        key = (i % len(self.grids), precision)
        if key not in self._refs:
            grid = self.grids[key[0]]
            answer = ref.sweep(self._blocks, self._age, self._slice_id, self.S, grid.durations_s,
                               grid.hbm_thresholds, grid.grace_s, grid.step_s, precision)
            self._refs[key] = tuple(x.numpy() for x in answer)
        return self._refs[key]

    def control(self, i: int):
        """The reference in place of the program, with bfloat16 samples,
        ages and params."""
        return self.reference(i, "bf16")

    def compare(self, kept) -> list[Compared]:
        slices = chips = counts = missing = 0
        for i, answer in kept:
            want_s, want_c, want_n = self.reference(i)
            if answer is None:
                missing += 1
                continue
            slices += bits_differing(answer[0], want_s, self.P)
            chips += bits_differing(answer[1], want_c, self.P)
            got_n = answer[2]
            counts += (int((got_n != want_n).sum()) if got_n.shape == want_n.shape
                       else want_n.size)
        return [Compared("slices_wrong", slices, 0), Compared("chips_wrong", chips, 0),
                Compared("counts_wrong", counts, 0), Compared("answers_missing", missing, 0)]
