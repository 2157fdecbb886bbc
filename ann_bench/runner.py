"""The op loop: warm-up, the measured window, and the record the judge reads.

A deployment wraps the program's session in an adapter with three calls, each
of which returns only once the host holds the acknowledgement:

  ``query(q, k)``     → (ids i64 [n, k'], scores f32 [n, k']) on the host;
  ``insert(x, rows)`` → acknowledged ids i64 [n] (``rows`` is the route);
  ``delete(ids)``     → None, after the deletes are applied (``flush``).

The runner times each op on the host clock from its issue to its
acknowledgement, and marks a span around it while a traced run traces
(``op.query``, ``op.insert``, ``op.delete``; ``window`` around the traced
rounds). The inputs of an op are drawn before its clock starts. The window
runs whole rounds until ``seconds`` have passed, so every window holds
the round's mix of ops; its rate is over all of its work and all of its
time.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from ann_bench.data.streams import Op, Plan

NULL = -1


def host(t) -> np.ndarray:
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


class Runner:
    def __init__(self, plan: Plan, index, base_ids: np.ndarray, *,
                 span=None, on_query=None):
        self.plan, self.index = plan, index
        self.k = plan.k
        self.row_id = np.full(base_ids.size + (1 << 16), NULL, np.int64)
        self.row_id[:base_ids.size] = base_ids
        self.events: list[dict] = []
        self.span = span or (lambda name: contextlib.nullcontext())
        self.on_query = on_query          # (before, after) hooks of a query op
        self.timed = False
        self.latency_s: list[float] = []
        self.untraced_from = 0            # the first of latency_s after the traced rounds
        self.items = 0                    # acknowledged in the window
        self.attempted = 0                # asked in the window
        self.query_ops = 0
        self.n_by_kind = {"query": 0, "insert": 0, "delete": 0}

    def _remember(self, rows: np.ndarray, ids: np.ndarray) -> None:
        need = int(rows.max()) + 1
        if need > self.row_id.size:
            grown = np.full(max(need, 2 * self.row_id.size), NULL, np.int64)
            grown[:self.row_id.size] = self.row_id
            self.row_id = grown
        self.row_id[rows] = ids

    def do(self, op: Op) -> None:
        ev = {"kind": op.kind, "t": op.index, "n": op.n}
        if op.kind == "query":
            q = host(self.plan.queries(op))
            hook = self.on_query() if self.on_query else None
            with self.span("op.query"):
                t0 = time.perf_counter()
                ids, scores = self.index.query(q, self.k)
                dt = time.perf_counter() - t0
            if hook is not None:
                hook()
            ids, scores = np.asarray(ids, np.int64), np.asarray(scores, np.float32)
            ev.update(ids=ids, sample=op.sample, q=q[op.sample],
                      s=_lanes(scores, op.sample, self.k))
            done = ids.shape[0] if ids.ndim == 2 else 0
            if self.timed:
                self.latency_s.append(dt)
                self.query_ops += 1
        elif op.kind == "insert":
            x = host(self.plan.insert_rows(op))
            with self.span("op.insert"):
                ids = np.asarray(self.index.insert(x, op.rows), np.int64)
            self._remember(op.rows, ids if ids.shape == op.rows.shape
                           else np.full(op.rows.size, NULL, np.int64))
            ev.update(rows=op.rows, x=x, ids=ids)
            done = int((ids != NULL).sum())
        else:
            ids = self.row_id[op.rows]
            with self.span("op.delete"):
                self.index.delete(ids)
            ev.update(rows=op.rows, ids=ids)
            done = op.n
        self.events.append(ev)
        if self.timed:
            self.items += done
            self.attempted += op.n
            self.n_by_kind[op.kind] += done

    def warmup(self) -> None:
        for op in self.plan.warmup():
            self.do(op)

    def counts(self) -> dict:
        return {"by_kind": dict(self.n_by_kind), "items": self.items,
                "query_ops": self.query_ops}

    def window(self, seconds: float, agree=None, tracer=None) -> float:
        """Whole rounds until ``seconds`` have passed (``agree`` makes every
        rank stop after the same round), the first ``tracer.rounds`` of them
        traced and at least as many after them, for the readings taken
        outside the trace; the window's length in seconds."""
        self.timed = True
        t0 = time.perf_counter()
        if tracer is not None:
            tracer.start()
        rounds = 0
        while True:
            for op in self.plan.next_round():
                self.do(op)
            rounds += 1
            if tracer is not None and tracer.active and rounds >= tracer.rounds:
                tracer.stop(self.counts())
                self.untraced_from = len(self.latency_s)
            done = time.perf_counter() - t0 >= seconds
            if tracer is not None and tracer.enabled and rounds < 2 * tracer.rounds:
                done = False
            if agree is not None:
                done = agree(done)
            if done:
                break
        if tracer is not None and tracer.active:
            tracer.stop(self.counts())
            self.untraced_from = len(self.latency_s)
        self.timed = False
        return time.perf_counter() - t0


def _lanes(scores: np.ndarray, sample: np.ndarray, k: int) -> np.ndarray:
    """The sampled lanes' first k scores, -inf where the answer is short."""
    out = np.full((sample.size, k), -np.inf, np.float32)
    if scores.ndim == 2:
        have = sample[sample < scores.shape[0]]
        w = min(k, scores.shape[1])
        out[:have.size, :w] = scores[have, :w]
    return out
