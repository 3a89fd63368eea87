"""The port's own spans and counters, read while a ``torch.profiler`` records.

``with span("engine.upload"): ...`` times one layer's work. Off, which it is
unless a ``torch.profiler`` is recording, a span is one check of the
profiler's flag and returns a shared no-op. On, it opens a
``_RecordFunctionFast`` range named ``tp.<name>``, an ordinary CPU range on
the profiler's own clock that PyTorch does not mirror onto the device's
timeline, and keeps a record: name, start and end (``perf_counter_ns``) and
the index of the enclosing span's record. ``spanned(name)`` puts a whole
function in one span.

A session starts with the first span that finds the profiler on after one
that found it off (or after none): it clears the records and takes the
counters' values; the next span that finds the profiler off ends it.
``summary()`` reports the current or last session: for each span name its
count, total and self ms (self: the total less what its child spans cover),
and for each counter its growth in the session. Records stop at ``CAP`` a
session; past it only the per-name totals grow, and ``dropped`` says how
many records were left out. A span never opens inside an open span of the
same name, so an entry that calls another entry of its layer is one span.
Spans belong to one thread.

The counters are always on, like ``kernels.LAUNCHES``, which ``summary()``
reports too: ``h2d_bytes`` and ``d2h_bytes`` (the bytes of every copy
between the host and a device the program makes, counted by ``to_device``
and ``to_host``) and ``host_syncs`` (each ``.cpu()``, ``int()`` or
``.item()`` on a device tensor). A copy that stays on the host counts
nothing. ``ingest_native`` and ``ingest_fallback`` count the dumps that
``analyze`` read with its native reader and with ``json.load``
(``dump_reader.read``); ``bounds_native`` and ``bounds_fallback`` the
``engine.slice_bounds`` calls that the native pass and the plain version
answered; ``window_rows_new``, ``_retained``, ``_dropped`` and ``_moved``
the streaming window's rows that ``engine.rekey_window`` added for new
chips, kept for absent ones, dropped, and carried to another place;
``rekey_card``, ``rekey_native`` and ``rekey_plain`` its calls that the
join on the card, the native host join and the plain version answered;
``sweep_policies`` and ``sweep_window_passes`` the policies that
``engine.evaluate_fleet_sweep`` judged and its passes over the samples (one
a call, whatever the policies). The
card's join copies the chips' keys up from pinned memory in its own call,
and writes its counts and kept rows into pinned host memory, for which the
host waits once: those bytes count in ``h2d_bytes`` and ``d2h_bytes``, and
the wait in ``host_syncs``.

``profile(path, body, cuda)`` runs ``body`` under ``torch.profiler``, writes
a Chrome trace to ``path`` and prints the summary to stderr, on the card
with the device's idle time by innermost span (``idle_by_span``); it is
``analyze --profile``.

Importing this module imports no torch: it reads the profiler's flag only
once torch is loaded.
"""

from __future__ import annotations

import bisect
import functools
import sys
import time

CAP = 65_536  # records a session
PREFIX = "tp."  # the profiler's name of a span
OUTSIDE = "(no span)"  # idle time outside every span, in ``idle_by_span``
SPIN_NAMES = ("spin_kernel", "sleep")  # the kernel that opens a traced window

counts = {"h2d_bytes": 0, "d2h_bytes": 0, "host_syncs": 0, "ingest_native": 0,
          "ingest_fallback": 0, "bounds_native": 0, "bounds_fallback": 0,
          "window_rows_new": 0, "window_rows_retained": 0, "window_rows_dropped": 0,
          "window_rows_moved": 0, "rekey_card": 0, "rekey_native": 0, "rekey_plain": 0,
          "sweep_policies": 0, "sweep_window_passes": 0}
# kernels.py's launch counters, reported by summary() under these prefixes
_KERNEL_COUNTERS = (("launches", "LAUNCHES"), ("design_launches", "DESIGN_LAUNCHES"),
                    ("f32_design_launches", "F32_DESIGN_LAUNCHES"))


class _NoProfiler:
    """Stands in for ``torch.autograd.profiler`` until torch is loaded."""

    _is_profiler_enabled = False


_profiler = _NoProfiler  # whose _is_profiler_enabled is the flag


def _find_profiler():
    global _profiler
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and hasattr(prof, "_is_profiler_enabled"):
        _profiler = prof


def _counter_values() -> dict:
    """Every counter's value now: ``counts`` and the kernels' launches."""
    values = dict(counts)
    kernels = sys.modules.get("tpu_pruner_torch.policy.kernels")
    for prefix, attr in _KERNEL_COUNTERS:
        for key, n in getattr(kernels, attr, {}).items():
            values[f"{prefix}.{key}"] = n
    return values


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Session:
    def __init__(self):
        self.records: list[list] = []  # [name, start_ns, end_ns, parent index]
        self.totals: dict[str, list[int]] = {}  # name -> [count, total_ns, self_ns]
        self.dropped = 0
        self.stack: list[_Span] = []
        self.open: set[str] = set()
        self.start_counts = _counter_values()
        self.end_counts: dict | None = None
        torch = sys.modules.get("torch")
        profiler = getattr(getattr(torch, "_C", None), "_profiler", None)
        self.range = getattr(profiler, "_RecordFunctionFast", None)


_session: _Session | None = None
_live = False


class _Span:
    __slots__ = ("session", "name", "range", "t0", "index", "child_ns")

    def __init__(self, session: _Session, name: str):
        self.session, self.name = session, name

    def __enter__(self):
        s = self.session
        self.range = None
        if s.range is not None:
            self.range = s.range(PREFIX + self.name)
            self.range.__enter__()
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        if len(s.records) < CAP:
            self.index = len(s.records)
            s.records.append([self.name, self.t0, self.t0, s.stack[-1].index if s.stack else -1])
        else:
            self.index = -1
            s.dropped += 1
        s.stack.append(self)
        s.open.add(self.name)
        return None

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        s = self.session
        s.stack.pop()
        s.open.discard(self.name)
        took = t1 - self.t0
        total = s.totals.get(self.name)
        if total is None:
            total = s.totals[self.name] = [0, 0, 0]
        total[0] += 1
        total[1] += took
        total[2] += took - self.child_ns
        if s.stack:
            s.stack[-1].child_ns += took
        if self.index >= 0:
            s.records[self.index][2] = t1
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: the span ``name`` while a profiler records, else
    a shared no-op."""
    global _session, _live
    if not _profiler._is_profiler_enabled:
        if _profiler is _NoProfiler:
            _find_profiler()
            if _profiler._is_profiler_enabled:
                return span(name)
        if _live:
            _live = False
            _session.end_counts = _counter_values()
        return _NOOP
    if not _live:
        _session, _live = _Session(), True
    if name in _session.open:
        return _NOOP
    return _Span(_session, name)


def spanned(name: str):
    """Decorator: each call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _live or _profiler._is_profiler_enabled or _profiler is _NoProfiler:
                with span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)  # off, and no session to end
        return wrapper
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    counts[name] = counts.get(name, 0) + n


def to_device(x, device):
    """``x.to(device)``; a host tensor's bytes count in ``h2d_bytes`` when
    ``device`` is not the host."""
    out = x.to(device)
    if out is not x and x.is_cpu and not out.is_cpu:
        counts["h2d_bytes"] += out.nbytes
    return out


def to_host(x):
    """``x.cpu()``; a device tensor's bytes count in ``d2h_bytes``, and the
    wait in ``host_syncs``."""
    if not x.is_cpu:
        counts["d2h_bytes"] += x.nbytes
        counts["host_syncs"] += 1
    return x.cpu()


def records() -> list[tuple]:
    """The current or last session's records: (name, start_ns, end_ns,
    parent index), in the order the spans opened; -1 is no parent."""
    return [] if _session is None else [tuple(r) for r in _session.records]


def summary() -> dict:
    """The current or last session: spans by name (count, total_ms,
    self_ms), counters' growth, records kept and dropped."""
    s = _session
    if s is None:
        return {"spans": {}, "counters": {}, "records": 0, "dropped": 0}
    end = s.end_counts if s.end_counts is not None else _counter_values()
    return {
        "spans": {name: {"count": c, "total_ms": total / 1e6, "self_ms": own / 1e6}
                  for name, (c, total, own) in s.totals.items()},
        "counters": {k: v - s.start_counts.get(k, 0) for k, v in end.items()},
        "records": len(s.records),
        "dropped": s.dropped,
    }


def idle_by_span(spans, device) -> tuple[float, dict]:
    """The device's idle time by innermost span, as ``port_bench``'s trace
    breakdown gives it: (window seconds, {span name: idle seconds}).

    ``spans`` and ``device`` are (name, start, end) in seconds on one clock;
    the window runs from the first span's start to the last one's end, and
    idle time in it outside every span goes to ``OUTSIDE``.
    """
    if not spans:
        return 0.0, {}
    spans = sorted(spans, key=lambda x: x[1])
    lo, hi = spans[0][1], max(e for _, _, e in spans)
    busy: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in device if s < hi and e > lo):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    starts = [s for _, s, _ in spans]
    edges = sorted({t for _, s, e in spans for t in (s, e)})

    def innermost(t: float) -> str:
        for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[k][2] >= t:
                return spans[k][0]
        return OUTSIDE

    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        cuts = [g0] + edges[bisect.bisect_right(edges, g0):bisect.bisect_left(edges, g1)] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            name = innermost((a + b) / 2)
            idle[name] = idle.get(name, 0.0) + (b - a)
    return hi - lo, idle


def profiler_spans(events) -> tuple[list, list]:
    """(spans, device operations) of a profiler's ``events()``, as
    (name, start s, end s): the ``tp.`` ranges, and every event on a CUDA
    device but the spin kernel."""
    import torch

    spans, device = [], []
    for ev in events:
        start, end = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not any(w in ev.name for w in SPIN_NAMES):
                device.append((ev.name, start, end))
        elif ev.name.startswith(PREFIX):
            spans.append((ev.name[len(PREFIX):], start, end))
    return spans, device


def format_summary(summ: dict, idle: tuple[float, dict] | None = None) -> str:
    """``summary()`` (and ``idle_by_span``'s result, on the card) as text."""
    lines = [f"{'span':28s} {'count':>7s} {'total ms':>12s} {'self ms':>12s}"]
    for name, s in sorted(summ["spans"].items(), key=lambda kv: -kv[1]["total_ms"]):
        lines.append(f"{name:28s} {s['count']:7d} {s['total_ms']:12.3f} {s['self_ms']:12.3f}")
    if summ["dropped"]:
        lines.append(f"records: {summ['records']} kept, {summ['dropped']} dropped")
    lines.append("counters: " + ", ".join(f"{k} {v}" for k, v in summ["counters"].items()))
    if idle is not None:
        window_s, by_span = idle
        total = sum(by_span.values())
        share = total / window_s * 100 if window_s else 0.0
        lines.append(f"device idle {total * 1e3:.3f} ms of a {window_s * 1e3:.3f} ms window "
                     f"({share:.2f}%), by innermost span:")
        for name, s in sorted(by_span.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:26s} {s * 1e3:12.3f} ms {s / total * 100 if total else 0:7.2f}%")
    return "\n".join(lines)


def profile(path: str, body, cuda: bool):
    """``body()`` under ``torch.profiler`` (CPU, and CUDA if ``cuda`` and
    a card is present): a Chrome trace to ``path``, the summary to stderr;
    returns what ``body`` returns."""
    import torch

    cuda = cuda and torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:  # the card's trace may lose its first operation: a spin opens it
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        result = body()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    idle = idle_by_span(*profiler_spans(prof.events())) if cuda else None
    print(format_summary(summary(), idle), file=sys.stderr)
    return result
