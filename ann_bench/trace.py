"""The device trace of a ``--trace 1`` run, reduced to arrays.

``Tracer`` runs ``torch.profiler`` over the first rounds of the window,
a fixed number of them, with the CUDA activity alone: the profiler's own
processing costs about 0.6 s for each second traced (paid between two
ops, once the traced rounds end), and recording every host-side op too
would slow the host it measures. A span (``window``
and one per op: ``op.query``, ``op.insert``, ``op.delete``) is marked on
the device itself: entering and leaving it launches a one-cycle
``torch.cuda._sleep`` on the stream the program uses, and every op ends
with the host holding its answer, so the op's kernels lie between its two
marks on the device's clock. After the window the raw events are read
once (not the profiler's per-op tables) into a ``TraceView``: every device
activity's name, start and end, and the spans from the marks.

Compute activities are the device's kernels, copies and fills, without
NCCL's kernels (which spin while a peer is late): ``busy_s`` is the union
of their intervals within the window, so kernels that overlap count once.
A per-layer metric reads the view through these helpers; one that finds
nothing to read returns None.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

SPAN_NAMES = ("window", "op.query", "op.insert", "op.delete")
MARK_KERNEL = "spin_kernel"              # torch.cuda._sleep's kernel


class Tracer:
    """Traces the first ``rounds`` rounds of a window: a fixed amount of
    work, whatever the program's speed. ``counts`` then holds the runner's
    counters over those rounds."""

    def __init__(self, enabled: bool, rounds: int):
        self.enabled = bool(enabled) and rounds > 0
        self.rounds = int(rounds)
        self.active = False
        self.prof = None
        self.marks: list[tuple] = []         # (span name, host ns) of each mark, in order
        self.view: TraceView | None = None
        self.counts: dict | None = None
        self.timing: dict = {}

    def start(self) -> None:
        import torch

        if not (self.enabled and torch.cuda.is_available()):
            return          # a run on the CPU has no device to trace

        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.active = True
        self._mark(torch, "window")

    def stop(self, counts: dict) -> None:
        """End the traced rounds (the profiler's own processing runs here,
        between two ops); ``counts`` are the runner's over them."""
        import torch

        self._mark(torch, "window")
        self.active = False
        t0 = time.perf_counter()
        self.prof.stop()
        self.timing["stop_s"] = time.perf_counter() - t0
        self.counts = dict(counts)

    def read(self) -> None:
        """Reduce the profile to a ``TraceView`` (after the window)."""
        if self.prof is None:
            return
        self.view = TraceView.from_profile(self.prof, self.marks, self.timing)
        self.prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        import torch

        self._mark(torch, name)
        try:
            yield
        finally:
            self._mark(torch, name)

    def _mark(self, torch, name: str) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self.marks.append((name, time.perf_counter_ns()))
            torch.cuda._sleep(1)


MARK_TOLERANCE_NS = 300_000     # under half the least gap between two marks


def place_marks(found: np.ndarray, host: np.ndarray) -> np.ndarray | None:
    """The device time of each of the marks launched at host times ``host``
    (ns), given the sorted device times ``found`` that the profile holds.
    All found: themselves. Some lost (the profiler can drop an activity
    record): the found ones matched to their launches by the one offset
    between the two clocks that matches the most, and a lost one placed at
    its launch time shifted by the median offset of the matched ones."""
    if found.size == host.size:
        return found
    if found.size == 0:
        return None
    best, best_hit = None, 0
    for d in found[0] - host:
        k = np.clip(np.searchsorted(host + d, found), 1, host.size - 1)
        near = np.where(np.abs(host[k - 1] + d - found) < np.abs(host[k] + d - found), k - 1, k)
        hit = np.abs(host[near] + d - found) < MARK_TOLERANCE_NS
        if hit.sum() > best_hit:
            best, best_hit = (near, hit), hit.sum()
    if best is None:
        return None
    near, hit = best
    out = host + np.median(found[hit] - host[near[hit]]).astype(np.int64)
    out[near[hit]] = found[hit]
    return out


def union_s(start: np.ndarray, end: np.ndarray) -> float:
    """Seconds covered by the union of ``[start, end)`` intervals (ns)."""
    if start.size == 0:
        return 0.0
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    grp = np.cumsum(new) - 1
    lo = s[new]
    hi = np.zeros(lo.size, np.int64)
    np.maximum.at(hi, grp, e)
    return float((hi - lo).sum()) / 1e9


class TraceView:
    """Device activities (``code`` into the name ``table``, ``start``,
    ``end`` in ns, ``compute`` mask, ``kernel`` mask) and harness spans
    (``spans[name]`` → sorted arrays of starts and ends), on one clock."""

    def __init__(self, names, start, end, kernel, spans):
        index: dict = {}
        self.code = np.fromiter((index.setdefault(n, len(index)) for n in names),
                                np.int32, count=len(names))
        self.table = list(index)
        self.start = np.asarray(start, np.int64)
        self.end = np.asarray(end, np.int64)
        self.kernel = np.asarray(kernel, bool)
        self.nccl = self.named("nccl", case=False)
        self.compute = ~self.nccl
        self.spans = {}
        for k, (lo, hi) in spans.items():
            lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
            order = np.argsort(lo, kind="stable")
            self.spans[k] = (lo[order], hi[order])
        ws, we = self.spans["window"]
        self.window = (int(ws.min()), int(we.max())) if ws.size else (0, 0)

    @classmethod
    def from_profile(cls, prof, marks: list[tuple], timing: dict) -> "TraceView":
        """The view of a profile whose spans were marked in the order
        ``marks`` (each span's name and launch time at its entry and again
        at its exit)."""
        from torch.autograd import DeviceType

        cuda = DeviceType.CUDA
        names, start, end, kernel = [], [], [], []
        mark_at = []
        t0 = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        timing["events_s"] = time.perf_counter() - t0
        timing["events"] = len(events)
        t0 = time.perf_counter()
        for ev in events:
            if ev.device_type() != cuda:
                continue
            name = ev.name()
            if MARK_KERNEL in name:
                mark_at.append(ev.start_ns())
                continue
            names.append(name)
            start.append(ev.start_ns())
            end.append(ev.end_ns())
            kernel.append(not name.startswith(("Memcpy", "Memset")))
        timing["loop_s"] = time.perf_counter() - t0
        timing["marks"] = [len(marks), len(mark_at)]
        spans = {n: ([], []) for n in SPAN_NAMES}
        placed = place_marks(np.sort(np.asarray(mark_at, np.int64)),
                             np.asarray([h for _, h in marks], np.int64))
        if placed is not None:
            open_at: dict = {}
            for (name, _), at in zip(marks, placed.tolist()):
                if name in open_at:
                    spans[name][0].append(open_at.pop(name))
                    spans[name][1].append(at)
                else:
                    open_at[name] = at
        return cls(names, start, end, kernel, spans)

    @property
    def empty(self) -> bool:
        """No device activity, or no window marked, was traced."""
        return self.start.size == 0 or self.spans["window"][0].size == 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _in(self, mask: np.ndarray, lo: int, hi: int):
        s = np.clip(self.start[mask], lo, hi)
        e = np.clip(self.end[mask], lo, hi)
        keep = e > s
        return s[keep], e[keep]

    def busy_s(self, mask: np.ndarray | None = None) -> float:
        """Union of the compute activities (and ``mask``) in the window."""
        m = self.compute if mask is None else self.compute & mask
        return union_s(*self._in(m, *self.window))

    def in_spans_s(self, span: str, mask: np.ndarray | None = None) -> float | None:
        """Union of the compute activities (and ``mask``) inside every
        ``span`` the harness opened; None where it opened none."""
        m = self.compute if mask is None else self.compute & mask
        if self.spans[span][0].size == 0:
            return None
        total = 0.0
        for lo, hi in zip(*self.spans[span]):
            total += union_s(*self._in(m, int(lo), int(hi)))
        return total

    def kernels_in_window(self) -> int:
        lo, hi = self.window
        m = self.compute & self.kernel & (self.start >= lo) & (self.start < hi)
        return int(m.sum())

    def named(self, fragment: str, case: bool = True) -> np.ndarray:
        """Mask of the activities whose name holds ``fragment``."""
        hit = np.array([fragment in (n if case else n.lower()) for n in self.table], bool)
        return hit[self.code] if self.code.size else np.zeros(0, bool)

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the compute activities that took most time."""
        lo, hi = self.window
        m = self.compute & (self.start >= lo) & (self.start < hi)
        totals = np.bincount(self.code[m], weights=(self.end[m] - self.start[m]) / 1e9,
                             minlength=len(self.table))
        top = np.argsort(-totals, kind="stable")[:n]
        return [[self.table[i], float(totals[i])] for i in top if totals[i] > 0]

    def idle_gaps(self, n: int = 10) -> list:
        """[what the host was doing, seconds] of the device's idle time in
        the window, summed by the op span it fell in ("between ops"
        outside them), longest first."""
        lo, hi = self.window
        s, e = self._in(self.compute, lo, hi)
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        gap_lo = np.concatenate([[lo], e])
        gap_hi = np.concatenate([s, [hi]])
        keep = gap_hi > gap_lo
        gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]
        totals: dict = {}
        mid = (gap_lo + gap_hi) // 2
        where = np.full(mid.size, "between ops", dtype=object)
        for span in SPAN_NAMES[1:]:
            ss, se = self.spans.get(span, (np.zeros(0, np.int64), np.zeros(0, np.int64)))
            if ss.size:
                i = np.searchsorted(ss, mid, side="right") - 1
                inside = (i >= 0) & (mid < se[np.clip(i, 0, None)])
                where[inside] = span
        for w, d in zip(where, (gap_hi - gap_lo) / 1e9):
            totals[w] = totals.get(w, 0.0) + float(d)
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]
