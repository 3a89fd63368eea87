"""What decides ``correct``: numbers compared with their limits, and the
sample of answers that is compared.

Every number here counts answers that differ from the plain reference's,
so the comparison is exact and every limit is 0 (see PERF.md for the
readings of the program and of the lower-precision controls).
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass
class Compared:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Reservoir:
    """A uniform sample of up to ``size`` of the answers offered, drawn
    from the seed (reservoir sampling), kept with their operation index."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self._rng = random.Random(seed)

    def offer(self, index: int, answer) -> None:
        if len(self.kept) < self.size:
            self.kept.append((index, answer))
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (index, answer)
        self.seen += 1


def mismatches(got, want) -> int:
    """Elements of two equal-length boolean arrays that differ; the whole
    length where the shapes differ."""
    if got is None:
        return len(want)
    if getattr(got, "shape", None) != want.shape:
        return max(len(want), 1)
    return int((got != want).sum())
