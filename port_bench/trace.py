"""Host spans, and the device trace of a window.

The drivers open a span around each call into the program. Spans are off,
and nearly free, in a measured run; in a traced run each is a
``torch.profiler.record_function`` range, and its host-clock duration is
kept as well.

``trace_window`` traces one window with ``torch.profiler`` and returns its
device operations, spans and the window's own range, all on the profiler's
clock. The trace opens with a spin kernel that is not counted: on the H100 a
trace could lose its first device operation (copied from the launch counting
of ``chip_smoke.py``).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

SPAN = "pb."  # the benchmark's own span names start with this
WINDOW = SPAN + "window"
SPIN_NAMES = ("spin_kernel", "sleep")


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    def __init__(self, spans: "Spans", name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.range = torch.profiler.record_function(SPAN + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.spans.seconds[self.name].append(time.perf_counter() - self.t0)
        return self.range.__exit__(*exc)


class Spans:
    """``with spans("upload"): ...``: a named host span while ``on``."""

    def __init__(self):
        self.on = False
        self.seconds: dict[str, list[float]] = defaultdict(list)

    def __call__(self, name: str):
        return _On(self, name) if self.on else _OFF


@dataclass
class Trace:
    """One traced window: times in seconds on the profiler's clock."""

    window: tuple[float, float]
    device: list[tuple[str, float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def trace_window(body, device: torch.device) -> Trace | None:
    """Run ``body()`` under the profiler; None if the trace has no window."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        if device.type == "cuda":
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            body()
            if device.type == "cuda":
                torch.cuda.synchronize()
    window, device_ops, spans = None, [], []
    for event in prof.events():
        start, end = event.time_range.start / 1e6, event.time_range.end / 1e6
        if event.device_type == torch.autograd.DeviceType.CUDA:
            # spans reappear on the device's timeline as annotations: no operation
            if not event.name.startswith(SPAN) and not any(w in event.name
                                                           for w in SPIN_NAMES):
                device_ops.append((event.name, start, end))
        elif event.name == WINDOW:
            window = (start, end)
        elif event.name.startswith(SPAN):
            spans.append((event.name[len(SPAN):], start, end))
    if window is None:
        return None
    lo, hi = window
    return Trace(window, [d for d in device_ops if d[1] >= lo and d[2] <= hi + 1e-3],
                 spans)


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    lo, hi = trace.window
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in merged((s, e) for _, s, e in trace.device))


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The window's intervals in which no device operation ran."""
    lo, hi = trace.window
    gaps, at = [], lo
    for s, e in merged((s, e) for _, s, e in trace.device):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return [g for g in gaps if g[1] > g[0]]


def device_seconds(trace: Trace, kind: str) -> float:
    """Summed device time of the kernels (``kernels``), of the host-to-device
    copies (``h2d``) or of every operation (``all``)."""
    if kind == "kernels":
        keep = lambda n: not _is_copy(n)  # noqa: E731
    elif kind == "h2d":
        keep = lambda n: n.startswith("Memcpy HtoD")  # noqa: E731
    else:
        keep = lambda n: True  # noqa: E731
    return sum(e - s for n, s, e in trace.device if keep(n))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    time of the window by what the host was doing: each part of a gap goes
    to the innermost span open then (``harness`` where none of the drivers'
    spans was)."""
    by_op: dict[str, float] = defaultdict(float)
    for name, s, e in trace.device:
        by_op[name[:80]] += e - s
    by_span: dict[str, float] = defaultdict(float)
    spans = sorted(trace.spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    edges = sorted({t for _, s, e in spans for t in (s, e)})

    def innermost(t: float) -> str:
        last = bisect.bisect_right(starts, t) - 1
        for k in range(last, max(-1, last - 64), -1):  # spans nest shallowly
            if spans[k][2] >= t:
                return spans[k][0]
        return "harness"

    for g0, g1 in idle_gaps(trace):
        cuts = [g0] + edges[bisect.bisect_right(edges, g0):bisect.bisect_left(edges, g1)] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            by_span[innermost((a + b) / 2)] += b - a
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
