"""GRAPH-MAINTENANCE (Alg 3) — ``repro.core.maintenance``.

``IPGMIndex`` is the synchronous per-op facade over a :class:`Session`:
each method dispatches one op and flushes. ``run_workload`` drives an
(op, payload) stream — the §6 protocol's outer loop — on either.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.graph import GraphState
from repro_torch.core.params import IndexParams
from repro_torch.core.session import OpHandle, PhaseTimers, Session

__all__ = ["IPGMIndex", "PhaseTimers", "run_workload"]


class IPGMIndex:
    """Online proximity-graph index — thin per-op facade over a Session,
    with the seed API's ``strategy``/chunk overrides, a settable ``state``
    and queries padded to ``params.query_chunk``."""

    def __init__(self, params: IndexParams, *, strategy: str | None = None,
                 seed: int = 0, delete_chunk: int | None = None,
                 insert_chunk: int | None = None,
                 state: GraphState | None = None, checkpoint_dir=None,
                 device=None):
        mp = params.maintenance
        mp = dataclasses.replace(
            mp,
            strategy=strategy if strategy is not None else mp.strategy,
            insert_chunk=insert_chunk if insert_chunk is not None
            else mp.insert_chunk,
            delete_chunk=delete_chunk if delete_chunk is not None
            else mp.delete_chunk)
        params = dataclasses.replace(params, maintenance=mp)
        self.session = Session(params, seed=seed, state=state, device=device,
                               checkpoint_dir=checkpoint_dir)

    @property
    def params(self) -> IndexParams:
        return self.session.params

    @property
    def strategy(self) -> str:
        return self.session.strategy

    @strategy.setter
    def strategy(self, value: str) -> None:
        self.session.strategy = value

    @property
    def state(self) -> GraphState:
        return self.session.state

    @state.setter
    def state(self, value: GraphState) -> None:
        self.session.set_state(value)

    @property
    def timers(self) -> PhaseTimers:
        return self.session.timers

    def _set_maintenance(self, **kw) -> None:
        p = self.session.params
        self.session.params = dataclasses.replace(
            p, maintenance=dataclasses.replace(p.maintenance, **kw))

    @property
    def insert_chunk(self) -> int:
        return self.session.params.maintenance.insert_chunk

    @insert_chunk.setter
    def insert_chunk(self, value: int) -> None:
        self._set_maintenance(insert_chunk=int(value))

    @property
    def delete_chunk(self) -> int:
        return self.session.params.maintenance.delete_chunk

    @delete_chunk.setter
    def delete_chunk(self, value: int) -> None:
        self._set_maintenance(delete_chunk=int(value))

    # -- operations (Alg 3 branches), each = dispatch + flush --------------
    def query(self, queries, k: int | None = None):
        """(ids i32[B, k], scores f32[B, k]), in ``query_chunk`` batches."""
        h = self.session.query(queries, k=k,
                               chunk=self.session.params.query_chunk)
        self.session.flush()
        return h.result()

    def insert(self, vectors):
        """Insert a batch of vectors; returns their assigned ids."""
        h = self.session.insert(vectors)
        self.session.flush()
        return h.result()

    def delete(self, ids) -> None:
        """Delete a batch of vertex ids with the configured strategy."""
        self.session.delete(ids)
        self.session.flush()

    def consolidate(self, *, strategy: str | None = None,
                    chunk: int | None = None) -> int:
        """Remove every tombstone; returns the number consolidated."""
        n = self.session.consolidate(strategy=strategy, chunk=chunk)
        self.session.flush()
        return n

    def rebuild_from_alive(self) -> None:
        """ReBuild baseline: reconstruct the whole graph from alive vectors."""
        self.session.rebuild_from_alive()

    def ground_truth(self, queries, k: int):
        return self.session.ground_truth(queries, k)

    def recall(self, queries, k: int) -> float:
        return self.session.recall(queries, k)

    def stats(self) -> dict:
        return self.session.stats()


def _recall(ids: np.ndarray, true_ids: torch.Tensor, k: int) -> float:
    found = torch.as_tensor(ids).to(true_ids.device)
    return float(metrics.recall_at_k(found, true_ids, k))


def run_workload(index: IPGMIndex | Session,
                 workload: Iterable[tuple[str, object]], k: int = 10
                 ) -> list[dict]:
    """Drive an (op, payload) stream: ("query", Q) | ("insert", X) |
    ("delete", ids) | ("rebuild", None) | ("consolidate", None).

    On a :class:`Session` the stream is dispatched up front and consumed
    in order, with a final ``{"op": "summary"}`` record; on an
    :class:`IPGMIndex` ops run one at a time. Every record reports
    ``seconds``, ``n`` and ``ops_per_s``; query records add ``recall`` and
    the ground-truth cost ``gt_seconds``."""
    if isinstance(index, Session):
        return _run_workload_stream(index, workload, k)
    records = []
    for op, payload in workload:
        t0 = time.perf_counter()
        rec: dict = {"op": op}
        if op == "query":
            ids, _ = index.query(payload, k=k)
            rec["seconds"] = time.perf_counter() - t0
            rec["n"] = int(np.asarray(payload).shape[0])
            t_gt = time.perf_counter()
            _, true_ids = index.ground_truth(payload, k)
            rec["recall"] = _recall(ids, true_ids, k)
            rec["gt_seconds"] = time.perf_counter() - t_gt
        elif op == "insert":
            index.insert(payload)
            rec["n"] = int(np.asarray(payload).shape[0])
        elif op == "delete":
            index.delete(payload)
            rec["n"] = int(np.asarray(payload).shape[0])
        elif op == "rebuild":
            index.rebuild_from_alive()
            rec["n"] = 1
        elif op == "consolidate":
            rec["n"] = index.consolidate()
        else:
            raise ValueError(op)
        if "seconds" not in rec:
            rec["seconds"] = time.perf_counter() - t0
        rec["ops_per_s"] = rec["n"] / rec["seconds"] if rec["seconds"] else 0.0
        records.append(rec)
    return records


def _run_workload_stream(session: Session,
                         workload: Iterable[tuple[str, object]], k: int
                         ) -> list[dict]:
    """Dispatch everything, then consume in order.

    A query's ground truth is computed against the state at its stream
    position. JAX enqueues it and relies on buffer donation to keep that
    snapshot alive; the port updates the state in place, so the top-k is
    enqueued right behind the query, on the same stream and ahead of every
    later update (its alive-slot gather is taken at that point)."""
    t_start = time.perf_counter()
    staged: list[tuple[dict, OpHandle | None, object]] = []
    for op, payload in workload:
        rec: dict = {"op": op}
        gt = None
        if op == "query":
            h = session.query(payload, k=k)
            gt = metrics.brute_force_topk(session.state, payload, k)
            rec["n"] = int(np.asarray(payload).shape[0])
        elif op == "insert":
            h = session.insert(payload)
            rec["n"] = int(np.asarray(payload).shape[0])
        elif op == "delete":
            h = session.delete(payload)
            rec["n"] = int(np.asarray(payload).shape[0])
        elif op == "rebuild":
            t0 = time.perf_counter()
            session.rebuild_from_alive()
            rec["seconds"] = time.perf_counter() - t0
            h, rec["n"] = None, 1
        elif op == "consolidate":
            t0 = time.perf_counter()
            rec["n"] = session.consolidate()
            rec["seconds"] = time.perf_counter() - t0
            h = None
        else:
            raise ValueError(op)
        staged.append((rec, h, gt))

    records = []
    for rec, h, gt in staged:
        t0 = time.perf_counter()
        if h is not None and rec["op"] == "query":
            ids, _ = h.result()
            rec["seconds"] = time.perf_counter() - t0
            t_gt = time.perf_counter()
            rec["recall"] = _recall(ids, gt[1], k)
            rec["gt_seconds"] = time.perf_counter() - t_gt
        elif h is not None:
            h.result()
            rec["seconds"] = time.perf_counter() - t0
        rec["ops_per_s"] = rec["n"] / rec["seconds"] if rec["seconds"] else 0.0
        records.append(rec)
    timers = session.flush()
    total = time.perf_counter() - t_start
    n_items = sum(r["n"] for r in records
                  if r["op"] not in ("rebuild", "consolidate"))
    records.append({"op": "summary", "n": n_items, "seconds": total,
                    "ops_per_s": n_items / total if total else 0.0,
                    "timers": timers.to_dict()})
    return records
