"""An audit dump, in the format ``dump.py`` emits and ``analyze`` reads.

Written from numpy arrays in one pass (after ``write_dump`` of
``chip_smoke.py``, which wrote chip by chip through ``json.dump``): each
chip's series is its valid samples in order, so ``load_fleet`` right-aligns
them and pads the missing leading ones as invalid. Every float is written
as the shortest text of its double (``repr``), which reads back to the same
f32. Chips are written in a shuffled order, under names whose sorted order
is not the order they were made in, so the reader's grouping by slice is
exercised.
"""

from __future__ import annotations

import json

import numpy as np


def names(num_slices: int, chips_per_slice: int, seed: int):
    """(slice names [S], chip ids [C]) as ``dump.py`` forms them:
    slices by their JobSet, chips as namespace/pod/accelerator."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_slices)
    slices = [f"team-{k % 23:02d}/v5e16-{perm[k]:05d}" for k in range(num_slices)]
    ids = []
    for k, name in enumerate(slices):
        ns, jobset = name.split("/")
        ids.extend(f"{ns}/{jobset}-{c // 4}/{c % 4}" for c in range(chips_per_slice))
    return slices, ids


def write(path, tc, hbm, valid, age, slice_index, slice_names, chip_ids, order,
          lookback_s: float, hbm_threshold: float) -> int:
    """Write the dump; returns its size in bytes."""
    T = tc.shape[1]
    tcs = list(map(repr, tc.ravel().tolist()))
    hbms = list(map(repr, hbm.ravel().tolist()))
    ages = age.tolist()
    rows = valid.tolist()
    head = json.dumps({"timestamp": 1000.0, "lookback_s": lookback_s,
                       "hbm_threshold": hbm_threshold})[:-1]
    parts = [head, ', "chips": [']
    sep = ""
    for i in order.tolist():
        keep = [k for k, v in enumerate(rows[i]) if v]
        base = i * T
        parts.append(
            f'{sep}{{"slice": "{slice_names[slice_index[i]]}", "id": "{chip_ids[i]}", '
            f'"pod_age_s": {ages[i]!r}, "tc": [{", ".join(tcs[base + k] for k in keep)}], '
            f'"hbm": [{", ".join(hbms[base + k] for k in keep)}]}}')
        sep = ", "
    parts.append("]}\n")
    text = "".join(parts)
    with open(path, "w") as f:
        f.write(text)
    return len(text)
