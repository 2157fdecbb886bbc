"""Streaming session over one index — ``repro.core.session.Session``.

The session owns a device-resident ``GraphState`` and the PRNG chain, chops
every query/insert/delete into fixed-shape ``OpBatch`` micro-batches and
applies them. Work is enqueued on the CUDA stream without waiting; the host
synchronises on ``flush()`` or when a handle's ``result()`` is read (and
briefly where the beam engine tests its exit condition). The state is
updated in place where JAX donates it.

Keys: op number ``t`` uses ``fold_in(base_key, t)``; lanes fold their global
stream index on top, so results do not depend on chunking. Deletes fold the
chunk index into the op key. Maintenance passes draw from their own chains
(``core/maint.py``), so firing one never shifts the op keys.

Maintenance, as in JAX:
  consolidate  ``consolidate_threshold`` fires the compaction pass
               (OP_CONSOLIDATE micro-batches) at delete and flush boundaries
               once the tombstone share crosses it;
  refine       ``refine_threshold`` fires one pass over the stalest rows
               (OP_REFINE) at flush boundaries once that many update rows
               were dispatched since the last pass;
  grow         ``max_capacity`` lets the insert boundary move the state to a
               larger capacity tier (after compacting tombstones first);
               rows a full index refuses are counted in ``n_refused``.
The triggers are gated by host hints that only ever err toward checking;
the device-exact count (a sync) runs only when a hint crosses.

Journal and checkpoints are not ported yet: a session asked for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import delete as delete_mod
from repro_torch.core import maint, metrics, prng, quantize, rebuild
from repro_torch.core import ops as ops_mod
from repro_torch.core.graph import (
    NULL,
    GraphState,
    graph_stats,
    grow_state,
    init_graph,
    next_capacity_tier,
)
from repro_torch.core.ops import OP_DELETE, OP_INSERT, OP_QUERY
from repro_torch.core.params import IndexParams


@dataclasses.dataclass
class PhaseTimers:
    """Flush-based phase accounting: per-phase ``*_s`` fields are host
    dispatch time, ``flush_s`` the synchronous waits, ``wall_s`` the busy
    wall-clock from the first dispatch of a window to the flush closing it.
    ``merge_s``/``n_merges``/``n_merged`` stay zero until the two-tier index
    is ported."""

    query_s: float = 0.0
    insert_s: float = 0.0
    delete_s: float = 0.0
    rebuild_s: float = 0.0
    consolidate_s: float = 0.0
    grow_s: float = 0.0
    merge_s: float = 0.0
    refine_s: float = 0.0
    flush_s: float = 0.0
    wall_s: float = 0.0
    n_queries: int = 0
    n_inserts: int = 0
    n_deletes: int = 0
    n_consolidated: int = 0
    n_consolidations: int = 0
    n_refused: int = 0
    n_grows: int = 0
    n_rejected: int = 0
    n_retries: int = 0
    n_merges: int = 0
    n_merged: int = 0
    n_refines: int = 0
    n_refined: int = 0
    n_ops: int = 0

    def total(self) -> float:
        return (self.query_s + self.insert_s + self.delete_s
                + self.rebuild_s + self.consolidate_s + self.grow_s
                + self.merge_s + self.refine_s + self.flush_s)

    def maintenance_counters(self) -> dict:
        """Per-op (count, seconds) pairs of every registered maintenance op."""
        out: dict = {}
        for op in maint.REGISTRY:
            if op.count_field:
                out[op.count_field] = getattr(self, op.count_field)
            if op.time_field:
                out[op.time_field] = getattr(self, op.time_field)
        return out

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total_s"] = self.total()
        n_items = self.n_queries + self.n_inserts + self.n_deletes
        d["n_items"] = n_items
        wall = self.wall_s + self.rebuild_s
        d["ops_per_s"] = n_items / wall if wall > 0 else 0.0
        return d


class OpHandle:
    """Future for one dispatched op — resolves to host results on demand."""

    def __init__(self, op: str, n: int, k: int, chunks: list, on_done=None):
        self.op = op
        self.n = n
        self.k = k
        self._chunks = chunks  # [(ids_dev[B,K], scores_dev[B,K], n_valid)]
        self._on_done = on_done
        self._done = False
        # rows rejected at dispatch (NaN/Inf) come back as NULL ids
        self.row_map: np.ndarray | None = None
        self.total_rows: int | None = None

    def _finish(self) -> None:
        if not self._done:
            self._done = True
            if self._on_done is not None:
                self._on_done(self)

    def result(self):
        """query → (ids i32[n, k], scores f32[n, k]); insert → ids i32[n]
        (NULL where not inserted); delete → None; consolidate / refine →
        ids i32[n] of the compacted / re-wired slots."""
        try:
            if self.op == "insert" and self.total_rows is not None:
                out = (np.concatenate(
                    [i[:nv, 0].cpu().numpy() for i, _, nv in self._chunks])
                    if self.n else np.zeros((0,), np.int32))
                full = np.full((self.total_rows,), NULL, np.int32)
                full[self.row_map] = out
                return full
            if self.op == "delete" or self.n == 0:
                if self.op == "query":
                    return (np.full((0, self.k), NULL, np.int32),
                            np.full((0, self.k), -np.inf, np.float32))
                if self.op in ("insert", "consolidate", "refine"):
                    return np.zeros((0,), np.int32)
                self.block()
                return None
            if self.op == "query":
                ids = np.concatenate(
                    [i[:nv, : self.k].cpu().numpy() for i, _, nv in self._chunks])
                scores = np.concatenate(
                    [s[:nv, : self.k].cpu().numpy() for _, s, nv in self._chunks])
                return ids, scores
            return np.concatenate(
                [i[:nv, 0].cpu().numpy() for i, _, nv in self._chunks])
        finally:
            self._finish()

    def block(self) -> None:
        if self._chunks and self._chunks[0][0].is_cuda:
            torch.cuda.current_stream(self._chunks[0][0].device).synchronize()
        self._finish()


def consolidate_gate_crossed(thr: float | None, masked_hint: int,
                             present_floor: int) -> bool:
    """The free host-side consolidation gate: with an overestimated
    tombstone count and an underestimated present count it only ever errs
    toward *checking*."""
    return (thr is not None and masked_hint > 0
            and masked_hint >= thr * max(present_floor, 1))


def params_fingerprint(params: IndexParams, strategy: str) -> str:
    """Stable identity of (params minus capacity, strategy) — the same
    string as ``repro.core.session.params_fingerprint``."""
    def enc(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: enc(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        return obj
    d = enc(params)
    d.pop("capacity", None)
    return json.dumps({"params": d, "strategy": strategy,
                       "vector_codes": quantize.VECTOR_CODE_SCHEME},
                      sort_keys=True)


class Session:
    """Device-resident streaming session over one proximity-graph index."""

    def __init__(self, params: IndexParams, *, strategy: str | None = None,
                 seed: int = 0, state: GraphState | None = None, device=None,
                 checkpoint_dir=None, journal: bool | None = None):
        strategy = strategy if strategy is not None else params.maintenance.strategy
        if strategy in delete_mod.UNPORTED_STRATEGIES:
            raise NotImplementedError(
                f"delete strategy {strategy!r} is not ported to repro_torch")
        if strategy not in delete_mod.STRATEGIES:
            raise ValueError(f"strategy must be one of {delete_mod.STRATEGIES}")
        unported = [name for name, armed in (
            ("checkpoint_dir", checkpoint_dir is not None),
            ("journal", bool(journal))) if armed]
        if unported:
            raise NotImplementedError(
                f"not ported to repro_torch yet: {', '.join(unported)}")
        if state is not None and device is not None and (
                torch.device(device).type != state.device.type):
            raise ValueError(f"state lives on {state.device}, not {device}")
        self.device = state.device if state is not None else resolve_device(device)
        self.params = params
        self.strategy = strategy
        self.seed = seed
        self._base_key = prng.prng_key(seed)   # host-side key chain
        self._op_counter = 0
        self._state = state if state is not None else init_graph(
            params.capacity, params.dim, d_out=params.d_out,
            d_in=params.eff_d_in, metric=params.metric, device=self.device)
        self.timers = PhaseTimers()
        self._pending: list[OpHandle] = []
        self._window_t0: float | None = None
        # maintenance bookkeeping: each pass has its own key-chain counter;
        # `_masked_hint` overestimates the tombstones, `_present_floor`
        # underestimates the present slots and `_free_hint` the free ones,
        # so the host gates only ever err toward the device-exact check.
        # `_refine_wear` counts update rows dispatched since the last refine.
        self._consolidate_counter = 0
        self._in_consolidate = False
        self._masked_hint = 0
        self._present_floor = 0
        self.last_consolidate_handle: OpHandle | None = None
        self._refine_counter = 0
        self._refine_wear = 0
        self._in_refine = False
        self.last_refine_handle: OpHandle | None = None
        self._free_hint = self._state.capacity
        if (state is not None
                or params.maintenance.consolidate_threshold is not None):
            self._refresh_hints()

    @property
    def state(self) -> GraphState:
        return self._state

    def set_state(self, state: GraphState) -> None:
        """Replace the session state (flushes pending work first)."""
        self.flush()
        self._state = state
        self._refresh_hints()

    @property
    def chunk(self) -> int:
        return self.params.maintenance.insert_chunk

    def _op_key(self) -> torch.Tensor:
        key = prng.fold_in(self._base_key, self._op_counter)
        self._op_counter += 1
        return key

    def _dispatch(self, op_code: int, arr: np.ndarray, chunk: int, *,
                  fold_chunk_key: bool = False) -> OpHandle:
        """Chop one op into padded OpBatches and apply them in order."""
        for mop in maint.SESSION_OPS:
            if mop.op_code is not None and op_code == mop.op_code:
                raise ValueError(
                    f"OP_{mop.name.upper()} is not a stream op; "
                    f"use Session.{mop.name}()")
        key = self._op_key()  # consumed even for empty ops: stable chain
        n = arr.shape[0]
        if n == 0:
            self.timers.n_ops += 1
            return OpHandle(ops_mod.OP_NAMES[op_code], 0,
                            self.params.search.pool_size, [])
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        is_delete = op_code == OP_DELETE
        chunks = []
        for ci, lo in enumerate(range(0, n, chunk)):
            part = arr[lo:lo + chunk]
            batch = ops_mod.make_op(
                op_code, chunk, self.params.dim,
                payload=None if is_delete else part,
                ids=part if is_delete else None, offset=lo,
                device=self.device)
            ckey = prng.fold_in(key, ci) if fold_chunk_key else key
            self._state, ids, scores = ops_mod.apply_ops(
                self._state, batch, ckey, self.params, self.strategy)
            chunks.append((ids, scores, part.shape[0]))
        return self._track(ops_mod.OP_NAMES[op_code], n, chunks)

    def _track(self, op: str, n: int, chunks: list) -> OpHandle:
        handle = OpHandle(op, n, self.params.search.pool_size, chunks,
                          on_done=self._handle_done)
        self._pending.append(handle)
        self.timers.n_ops += 1
        return handle

    def _handle_done(self, handle: OpHandle) -> None:
        try:
            self._pending.remove(handle)
        except ValueError:
            return
        if not self._pending and self._window_t0 is not None:
            self.timers.wall_s += time.perf_counter() - self._window_t0
            self._window_t0 = None

    # -- the op surface ----------------------------------------------------
    def query(self, queries, k: int | None = None, *,
              chunk: int | None = None) -> OpHandle:
        """Batched ANN query; ``handle.result()`` → (ids, scores)."""
        q = np.asarray(queries, np.float32)
        k = k if k is not None else self.params.search.pool_size
        t0 = time.perf_counter()
        h = self._dispatch(OP_QUERY, q, chunk or self.chunk)
        h.k = min(k, self.params.search.pool_size)
        self.timers.query_s += time.perf_counter() - t0
        self.timers.n_queries += q.shape[0]
        return h

    def insert(self, vectors, *, chunk: int | None = None) -> OpHandle:
        """Batch insert; ``handle.result()`` → assigned ids. Rows with a
        NaN/Inf are rejected at dispatch (NULL id, ``timers.n_rejected``).
        The insert boundary is where the index compacts and grows to make
        room (:meth:`_ensure_room`); rows it still cannot take are counted
        in ``timers.n_refused``."""
        v = np.asarray(vectors, np.float32)
        total, keep = v.shape[0], None
        if total:
            finite = np.isfinite(v).all(axis=1)
            if not finite.all():
                self.timers.n_rejected += int(total - finite.sum())
                keep = np.flatnonzero(finite)
                v = v[keep]
        if v.shape[0]:
            self._ensure_room(v.shape[0])
        t0 = time.perf_counter()
        h = self._dispatch(OP_INSERT, v,
                           chunk or self.params.maintenance.insert_chunk)
        if keep is not None:
            h.row_map, h.total_rows = keep, total
        self._free_hint = max(self._free_hint - v.shape[0], 0)
        self._refine_wear += v.shape[0]
        self.timers.insert_s += time.perf_counter() - t0
        self.timers.n_inserts += v.shape[0]
        return h

    def delete(self, ids, *, chunk: int | None = None) -> OpHandle:
        """Batch delete with the session's strategy. A MASK delete grows the
        tombstone set, so it is a consolidation trigger point."""
        arr = np.asarray(ids, np.int32)
        eff_chunk = chunk or self.params.maintenance.delete_chunk
        t0 = time.perf_counter()
        h = self._dispatch(OP_DELETE, arr, eff_chunk, fold_chunk_key=True)
        self.timers.delete_s += time.perf_counter() - t0
        self.timers.n_deletes += arr.shape[0]
        self._refine_wear += arr.shape[0]
        if self.strategy == "mask":
            self._masked_hint += arr.shape[0]
            self._maybe_consolidate()
        else:
            self._present_floor = max(self._present_floor - arr.shape[0], 0)
        return h

    # -- maintenance -------------------------------------------------------
    def _maint_key(self, mop: maint.MaintOp) -> torch.Tensor:
        """Next key of ``mop``'s own chain."""
        counter = getattr(self, mop.counter_attr)
        setattr(self, mop.counter_attr, counter + 1)
        return maint.maint_key(self._base_key, mop, counter)

    def _refresh_hints(self) -> None:
        """Replace the host hints with device-exact counts (synchronises)."""
        self._masked_hint = int(self._state.masked.sum())
        self._present_floor = int(self._state.present.sum())
        self._free_hint = self._state.capacity - self._present_floor

    def _run_maint(self, mop: maint.MaintOp, chunk: int, n: int,
                   params: IndexParams) -> OpHandle:
        """Apply ceil(n/chunk) operand-free ``mop`` micro-batches."""
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        batch = ops_mod.make_op(mop.op_code, chunk, self.params.dim,
                                device=self.device)
        chunks = []
        for lo in range(0, n, chunk):
            self._state, ids, scores = ops_mod.apply_ops(
                self._state, batch, self._maint_key(mop), params,
                self.strategy)
            chunks.append((ids, scores, min(chunk, n - lo)))
        return self._track(mop.name, n, chunks)

    def consolidate(self, *, strategy: str | None = None,
                    chunk: int | None = None,
                    _n_masked: int | None = None) -> int:
        """Physically remove every tombstone: ceil(n/chunk) OP_CONSOLIDATE
        micro-batches, each compacting the lowest-id tombstones at its
        stream position with ``consolidate_strategy`` (or ``strategy``).
        Reads the exact tombstone count (a sync) unless the trigger passes
        the count it just measured. Returns the number consolidated; the
        work itself is enqueued (settled by ``flush`` or reads)."""
        t0 = time.perf_counter()
        n_masked = (int(self._state.masked.sum())
                    if _n_masked is None else int(_n_masked))
        if n_masked == 0:
            self._masked_hint = 0
            self.timers.consolidate_s += time.perf_counter() - t0
            return 0
        mp = self.params.maintenance
        chunk = int(chunk) if chunk else (mp.consolidate_chunk
                                          or mp.delete_chunk)
        params = self.params
        if strategy is not None and strategy != mp.consolidate_strategy:
            params = dataclasses.replace(self.params, maintenance=dataclasses.replace(
                mp, consolidate_strategy=strategy))
        self.last_consolidate_handle = self._run_maint(
            maint.CONSOLIDATE, chunk, n_masked, params)
        self.timers.n_consolidations += 1
        self.timers.n_consolidated += n_masked
        self.timers.consolidate_s += time.perf_counter() - t0
        self._masked_hint = 0
        self._present_floor = max(self._present_floor - n_masked, 0)
        self._free_hint += n_masked
        return n_masked

    def _maybe_consolidate(self) -> int:
        """Fire the compaction pass when the tombstone share crosses
        ``consolidate_threshold`` (the device-exact check only when the free
        host gate crosses)."""
        thr = self.params.maintenance.consolidate_threshold
        if self._in_consolidate or not consolidate_gate_crossed(
                thr, self._masked_hint, self._present_floor):
            return 0
        self._refresh_hints()
        if not consolidate_gate_crossed(
                thr, self._masked_hint, self._present_floor):
            return 0
        self._in_consolidate = True
        try:
            return self.consolidate(_n_masked=self._masked_hint)
        finally:
            self._in_consolidate = False

    def refine(self, *, n: int | None = None, chunk: int | None = None) -> int:
        """Re-wire the ``n`` (default one chunk) stalest alive slots at
        construction quality: ceil(n/chunk) OP_REFINE micro-batches. Returns
        the number submitted; the work itself is enqueued."""
        t0 = time.perf_counter()
        mp = self.params.maintenance
        chunk = int(chunk) if chunk else (mp.refine_chunk or mp.insert_chunk)
        n_alive = int(self._state.alive.sum())
        n_target = min(chunk if n is None else int(n), n_alive)
        self._refine_wear = 0
        if n_target <= 0:
            self.timers.refine_s += time.perf_counter() - t0
            return 0
        self.last_refine_handle = self._run_maint(maint.REFINE, chunk,
                                                  n_target, self.params)
        self.timers.n_refines += 1
        self.timers.n_refined += n_target
        self.timers.refine_s += time.perf_counter() - t0
        return n_target

    def _maybe_refine(self) -> int:
        """Fire one refine pass at a flush boundary once
        ``refine_threshold`` update rows of wear have accumulated."""
        thr = self.params.maintenance.refine_threshold
        if thr is None or self._in_refine or self._refine_wear < thr:
            return 0
        self._in_refine = True
        try:
            return self.refine()
        finally:
            self._in_refine = False

    def _ensure_room(self, n: int) -> None:
        """Room for ``n`` insert rows: free while ``_free_hint`` (an
        underestimate) covers them; otherwise read the exact counts,
        compact tombstones before growing, grow to the next tier when armed,
        and count the rows that still do not fit into ``n_refused``."""
        if self._free_hint >= n:
            return
        mp = self.params.maintenance
        self._refresh_hints()
        free = self._free_hint
        if free < n and self._masked_hint > 0 and (
                mp.consolidate_threshold is not None
                or mp.max_capacity is not None):
            free += self.consolidate(_n_masked=self._masked_hint)
        if free < n and mp.max_capacity is not None:
            cap = self._state.capacity
            target = next_capacity_tier(cap, cap - free + n, mp.growth_factor,
                                        mp.max_capacity)
            if target > cap:
                self.grow(target)
                free += target - cap
        if free < n:
            self.timers.n_refused += n - free
        self._free_hint = free

    def grow(self, new_capacity: int) -> None:
        """Move the state to a larger capacity tier (``graph.grow_state``):
        slots keep their ids, new slots arrive free. An armed session
        enforces ``maintenance.max_capacity``."""
        t0 = time.perf_counter()
        if new_capacity == self._state.capacity:
            return
        ceiling = self.params.maintenance.max_capacity
        if ceiling is not None and new_capacity > ceiling:
            raise ValueError(
                f"new_capacity {new_capacity} exceeds maintenance."
                f"max_capacity {ceiling}")
        if self._window_t0 is None:
            self._window_t0 = t0
        grown = grow_state(self._state, new_capacity)
        self._free_hint += grown.capacity - self._state.capacity
        self._state = grown
        self.timers.n_grows += 1
        self.timers.grow_s += time.perf_counter() - t0

    def flush(self) -> PhaseTimers:
        """Run the consolidate and refine triggers, then block until every
        dispatched op has run; settle the timers."""
        self._maybe_consolidate()
        self._maybe_refine()
        t0 = time.perf_counter()
        for h in list(self._pending):
            h.block()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._pending.clear()
        self.timers.flush_s += time.perf_counter() - t0
        if self._window_t0 is not None:
            self.timers.wall_s += time.perf_counter() - self._window_t0
            self._window_t0 = None
        return self.timers

    def _live_params(self) -> IndexParams:
        """``self.params`` with ``capacity`` pinned to the live tier."""
        if self.params.capacity == self._state.capacity:
            return self.params
        return dataclasses.replace(self.params, capacity=self._state.capacity)

    def rebuild_from_alive(self) -> None:
        """ReBuild baseline: bulk-build a new graph from the alive vectors,
        compacted to slots 0..n-1, at the live capacity tier."""
        self.flush()
        t0 = time.perf_counter()
        live_cap = self._state.capacity
        vecs = self._state.vectors[self._state.alive]
        n = vecs.shape[0]
        padded = torch.zeros((live_cap, self.params.dim), dtype=vecs.dtype,
                             device=vecs.device)
        padded[:n] = vecs
        valid = torch.arange(live_cap, device=vecs.device) < n
        self._state = rebuild.bulk_knn_build(padded, valid, self._live_params(),
                                             device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._masked_hint = 0
        self._present_floor = n
        self._free_hint = live_cap - n
        self.timers.rebuild_s += time.perf_counter() - t0

    # -- reporting ---------------------------------------------------------
    def ground_truth(self, queries, k: int):
        """Exact top-k over alive slots (``kernels.ops.score_topk``)."""
        self.flush()
        return metrics.brute_force_topk(self._state, queries, k)

    def recall(self, queries, k: int) -> float:
        ids, _ = self.query(queries, k=k).result()
        _, true_ids = self.ground_truth(queries, k)
        found = torch.as_tensor(ids).to(true_ids.device)
        return float(metrics.recall_at_k(found, true_ids, k))

    def stats(self) -> dict:
        self.flush()
        out = {k: v.item() for k, v in graph_stats(self._state).items()}
        out["capacity"] = self._state.capacity
        out["n_refused"] = self.timers.n_refused
        out.update(self.timers.maintenance_counters())
        return out
