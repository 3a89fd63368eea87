"""The dump writer: what analyze's reader gets back is what was generated."""

import json
from pathlib import Path

import numpy as np
import torch

from port_bench import dumpfile, gen
from tpu_pruner_torch.analyze import load_fleet

CONFIG = {"chips": 512, "slices": 32, "hbm_threshold": 0.05}
MIX = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "audit-dump8.json")
                 .read_text())


def test_round_trip_through_load_fleet(tmp_path):
    fleet = gen.make_fleet(CONFIG, MIX, 17, "cpu")
    tc, hbm, valid = (x.numpy() for x in gen.samples(fleet, MIX, gen.generator(17, "cpu", 3),
                                                     0, 8, 0, 512))
    age = fleet.age.numpy()
    names, ids = dumpfile.names(32, 16, 17)
    order = np.random.default_rng(17).permutation(512)
    path = tmp_path / "dump.json"
    dumpfile.write(path, tc, hbm, valid, age, fleet.slice_id, names, ids, order, 2100, 0.05)
    doc = json.loads(path.read_text())
    assert doc["lookback_s"] == 2100 and doc["hbm_threshold"] == 0.05
    assert [c["id"] for c in doc["chips"]] == [ids[i] for i in order]
    (ltc, lhbm, lvalid, lage, lsid), lnames, lids, default_ids = load_fleet(doc)
    assert default_ids == 0 and lnames == sorted(names)
    assert (np.diff(lsid) >= 0).all()  # grouped by slice
    row = {chip_id: k for k, chip_id in enumerate(lids)}
    for i in range(512):
        k = row[ids[i]]
        n = int(valid[i].sum())
        assert lvalid[k].tolist() == [False] * (8 - n) + [True] * n  # left-padded
        assert np.array_equal(ltc[k, 8 - n:].view(np.uint32), tc[i, valid[i]].view(np.uint32))
        assert np.array_equal(lhbm[k, 8 - n:].view(np.uint32), hbm[i, valid[i]].view(np.uint32))
        assert lage[k] == age[i] and lnames[lsid[k]] == names[fleet.slice_id[i]]


def test_generator_shares_and_gaps():
    cfg = {"chips": 4096, "slices": 256, "hbm_threshold": 0.05}
    fleet = gen.make_fleet(cfg, MIX, 5, "cpu")
    kinds = fleet.kinds[0]
    assert [(kinds == k).sum().item() for k in (0, 1, 2)] == [128, 64, 64]
    tc, hbm, valid = gen.samples(fleet, MIX, gen.generator(5, "cpu", 3), 0, 8, 0, 4096)
    gap_rows = torch.arange(4096) % 7 == 0
    missing = (~valid).sum(dim=1)
    assert ((missing[gap_rows] >= 1) | (missing[gap_rows] == 8)).all()
    lead = valid[gap_rows & (missing < 8)]
    assert (lead.int().diff(dim=1) >= 0).all()  # gaps are leading in an audit dump
    sub = (tc > 0) & (tc < gen.FLT_MIN)
    assert sub.any()
    near = torch.from_numpy(gen.near_values([0.05], MIX["idle_hbm"]["near_bf16_steps"]))
    assert torch.isin(hbm, near).any()
