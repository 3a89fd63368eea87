"""The offline audit: ``analyze.main([dump, "--device", "cuda"])`` in-process.

Set-up draws one window of samples from the seed and writes it as a dump
(``dumpfile``) at a fixed path in the checkout, with the configuration's
lookback and HBM threshold as the dump's own keys. Each operation is one
audit, from the dump on disk to the printed table (stderr) and JSON line
(stdout), both captured. In a traced run ``analyze.load_fleet`` and
``analyze.evaluate_loaded`` are wrapped in spans (the module attributes,
for the traced window only; the program is not edited).
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np

from port_bench import dumpfile, gen
from port_bench.check import Compared
from port_bench.reference import fleet as ref
from tpu_pruner_torch import analyze

VERDICTS = {"IDLE — reclaimable": True, "active": False}


class Driver:
    def __init__(self, ctx):
        cfg, mix = ctx.config, ctx.mix
        self.dev, self.spans = ctx.device, ctx.spans
        self.C, self.S, T = cfg["chips"], cfg["slices"], cfg["window_samples"]
        self.lookback, self.threshold = cfg["lookback_s"], cfg["hbm_threshold"]
        fleet = gen.make_fleet(cfg, mix, ctx.seed, self.dev)
        g = gen.generator(ctx.seed, self.dev, 3)
        tc, hbm, valid = (x.cpu().numpy() for x in gen.samples(fleet, mix, g, 0, T, 0, self.C))
        age = fleet.age.cpu().numpy()
        self.slice_index = fleet.slice_id
        self.names, ids = dumpfile.names(self.S, fleet.chips_per_slice, ctx.seed)
        order = np.random.default_rng(ctx.seed).permutation(self.C)
        ctx.workdir.mkdir(parents=True, exist_ok=True)
        self.path = ctx.workdir / f"{ctx.workload}.dump.json"
        self.dump_bytes = dumpfile.write(self.path, tc, hbm, valid, age, self.slice_index,
                                         self.names, ids, order, self.lookback, self.threshold)
        self.argv = [str(self.path), "--device", self.dev.type]
        self._inputs = (tc, hbm, valid, age)
        self._own = None

    def shape(self) -> dict:
        return {"chips": self.C, "slices": self.S}

    def _wrapped(self, name: str, fn):
        def wrapper(*args, **kwargs):
            with self.spans(name):
                return fn(*args, **kwargs)
        return wrapper

    def trace(self, on: bool) -> None:
        if on and self._own is None:
            self._own = (analyze.load_fleet, analyze.evaluate_loaded)
            analyze.load_fleet = self._wrapped("load_fleet", self._own[0])
            analyze.evaluate_loaded = self._wrapped("evaluate_loaded", self._own[1])
        elif not on and self._own is not None:
            analyze.load_fleet, analyze.evaluate_loaded = self._own
            self._own = None

    def step(self, i: int):
        out, err = io.StringIO(), io.StringIO()
        with self.spans("main"), redirect_stdout(out), redirect_stderr(err):
            rc = analyze.main(self.argv)
        return rc, out.getvalue(), err.getvalue()

    def release(self) -> None:
        self.path.unlink(missing_ok=True)

    # --- the reference -----------------------------------------------------

    def reference(self, precision: str = "f32"):
        """{slice name: (chips, idle chips, reclaimable)}, and the total of
        idle chips."""
        tc, hbm, valid, age = self._inputs
        candidate = ref.candidates_f32(tc, hbm, valid, age, self.lookback, self.threshold,
                                       precision)
        chips, idle = ref.slice_counts(candidate, self.slice_index, self.S)
        rows = {name: (int(chips[k]), int(idle[k]), bool(chips[k] > 0 and idle[k] == chips[k]))
                for k, name in enumerate(self.names)}
        return rows, int(candidate.sum())

    def control(self, i: int):
        """The reference in place of the program, in bfloat16: its answer
        printed as the CLI prints it."""
        rows, idle_chips = self.reference("bf16")
        names = sorted(rows)
        err = "header\n" + "".join(
            f"{n:40s} {rows[n][0]:6d} {rows[n][1]:6d} "
            f"{'IDLE — reclaimable' if rows[n][2] else 'active'}\n" for n in names)
        out = json.dumps({"idle_chips": idle_chips,
                          "reclaimable_slices": [n for n in names if rows[n][2]]}) + "\n"
        return 0, out, err

    @staticmethod
    def parse(answer):
        """(table rows by slice, the JSON line) of one audit's output."""
        rc, out, err = answer
        if rc != 0:
            return None
        rows = {}
        for line in err.splitlines()[1:]:
            for text, verdict in VERDICTS.items():
                if line.endswith(text):
                    name, chips, idle = line[:-len(text)].split()
                    rows[name] = (int(chips), int(idle), verdict)
        return rows, json.loads(out.strip().splitlines()[-1])

    def compare(self, kept) -> list[Compared]:
        want_rows, want_idle = self.reference()
        want_reclaimable = sorted(n for n, r in want_rows.items() if r[2])
        slices = reclaimable = idle_off = missing = 0
        for _, answer in kept:
            parsed = None if answer is None else self.parse(answer)
            if parsed is None:
                missing += 1
                continue
            rows, line = parsed
            slices += sum(rows.get(n) != r for n, r in want_rows.items())
            slices += len(set(rows) - set(want_rows))
            reclaimable += len(set(line["reclaimable_slices"]) ^ set(want_reclaimable))
            reclaimable += int(line["reclaimable_slices"] != sorted(line["reclaimable_slices"]))
            idle_off += abs(line["idle_chips"] - want_idle)
        return [Compared("slices_wrong", slices, 0),
                Compared("reclaimable_wrong", reclaimable, 0),
                Compared("idle_chips_off", idle_off, 0),
                Compared("answers_missing", missing, 0)]
