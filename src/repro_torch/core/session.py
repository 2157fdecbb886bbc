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

Durability, as in JAX: a session with a ``checkpoint_dir`` arms a
write-ahead op journal (``checkpoint/journal.py``) — every op appends a
checksummed record *before* it is applied, ``save`` writes a checkpoint in
the JAX package's layout and truncates the log, and :meth:`Session.recover`
rebuilds a crashed session as the newest complete checkpoint plus a replay
of the journaled suffix. Replay is bit-exact: op keys are a pure function of
stream position, the auto-maintenance decisions a pure function of the
device-exact state, and the host-initiated trigger sites replay needs
(flushes, explicit consolidate/grow/refine) are journaled as marker records.
Auto-triggered maintenance is not journaled — the replayed stream re-derives
it. Checkpoints and journals cross between the two packages both ways.
Crash points (``repro_torch.testing.faults``) sit where JAX has them.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import journal as journal_mod
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.core import delete as delete_mod
from repro_torch.core import maint, metrics, prng, quantize, rebuild
from repro_torch.core import ops as ops_mod
from repro_torch.core.graph import (
    NULL,
    GraphState,
    graph_state_from_numpy,
    graph_stats,
    grow_state,
    init_graph,
    next_capacity_tier,
)
from repro_torch.core.ops import OP_DELETE, OP_INSERT, OP_QUERY
from repro_torch.core.params import IndexParams
from repro_torch.testing import faults


@dataclasses.dataclass
class PhaseTimers:
    """Flush-based phase accounting: per-phase ``*_s`` fields are host
    dispatch time, ``flush_s`` the synchronous waits, ``wall_s`` the busy
    wall-clock from the first dispatch of a window to the flush closing it.
    ``merge_s``/``n_merges``/``n_merged`` count the two-tier index's
    streaming merges (``core/merge.py``)."""

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
    """Device-resident streaming session over one proximity-graph index.

    The keyword arguments are JAX's, with their defaults, plus ``device``;
    JAX's ``unified_dispatch`` picks between compiled programs and has no
    counterpart in eager PyTorch. ``journal=None`` arms the write-ahead
    journal whenever ``checkpoint_dir`` is set; ``journal_fsync`` is its
    policy (``"always"``, ``"flush"`` or ``"never"``); ``flush_retries`` and
    ``flush_backoff_s`` bound the retries of a transient sync failure."""

    def __init__(self, params: IndexParams, *, strategy: str | None = None,
                 seed: int = 0, state: GraphState | None = None, device=None,
                 checkpoint_dir: str | Path | None = None,
                 checkpoint_keep: int = 3, journal: bool | None = None,
                 journal_fsync: str = "flush", flush_retries: int = 3,
                 flush_backoff_s: float = 0.005):
        strategy = strategy if strategy is not None else params.maintenance.strategy
        if strategy in delete_mod.UNPORTED_STRATEGIES:
            raise NotImplementedError(delete_mod.unported_message(strategy))
        if strategy not in delete_mod.STRATEGIES:
            raise ValueError(f"strategy must be one of {delete_mod.STRATEGIES}")
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
        # `_refine_wear` counts update rows dispatched since the last refine
        # (a pure function of the op stream, checkpointed with the counter).
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
        self._ckpt = None
        if checkpoint_dir is not None:
            self._ckpt = manager_mod.CheckpointManager(checkpoint_dir,
                                                       keep=checkpoint_keep)
        # a constructed session is a fresh timeline: attaching resets the
        # journal (a META record with the fingerprint); only recover()
        # extends an existing one. One writer per directory.
        self.recovering = False
        self.recovery_info: dict | None = None
        self._journal = None
        self._journal_fsync = journal_fsync
        self._flush_retries = int(flush_retries)
        self._flush_backoff_s = float(flush_backoff_s)
        if journal is None:
            journal = checkpoint_dir is not None
        if journal:
            self._require_ckpt()
            self._attach_journal(fresh=True)

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

    # -- write-ahead journal -----------------------------------------------
    def _fingerprint(self) -> str:
        return params_fingerprint(self.params, self.strategy)

    def _attach_journal(self, *, fresh: bool) -> None:
        path = Path(self._ckpt.dir) / "journal.bin"
        self._journal = journal_mod.OpJournal(path, fsync=self._journal_fsync)
        if fresh:
            self._journal.reset(meta={
                "fingerprint": self._fingerprint()})
        else:
            # recovery: drop the torn tail so new appends extend a clean prefix
            self._journal.repair()

    def _journal_append(self, code: int, *, payload=None, ids=None,
                        aux: dict | None = None) -> None:
        """Append one record *before* the action it describes. ``seq`` is
        the op counter; ``cseq`` a maintenance record's own counter (the
        consolidate counter for every other record), so recovery skips what
        a later checkpoint already holds."""
        if self._journal is None:
            return
        mop = maint.by_journal_code(code)
        cseq = (getattr(self, mop.counter_attr)
                if mop is not None and mop.counter_attr is not None
                else self._consolidate_counter)
        self._journal.append(code, seq=self._op_counter, cseq=cseq,
                             payload=payload, ids=ids, aux=aux)
        faults.crash_point("post-journal-append")

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
        # a query changes no state but consumes an op key: replay must know
        # it happened, so a count-only record keeps the journal cheap
        self._journal_append(OP_QUERY, aux={"n": int(q.shape[0])})
        t0 = time.perf_counter()
        h = self._dispatch(OP_QUERY, q, chunk or self.chunk)
        h.k = min(k, self.params.search.pool_size)
        self.timers.query_s += time.perf_counter() - t0
        self.timers.n_queries += q.shape[0]
        return h

    def insert(self, vectors, *, chunk: int | None = None) -> OpHandle:
        """Batch insert; ``handle.result()`` → assigned ids. Rows with a
        NaN/Inf are rejected at dispatch (NULL id, ``timers.n_rejected``);
        the journal keeps them raw, so replay rejects them again.
        The insert boundary is where the index compacts and grows to make
        room (:meth:`_ensure_room`); rows it still cannot take are counted
        in ``timers.n_refused``."""
        v = np.asarray(vectors, np.float32)
        self._journal_append(OP_INSERT, payload=v, aux={"chunk": chunk})
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
        # repair keys fold the chunk index, so the width is part of the op
        self._journal_append(OP_DELETE, ids=arr, aux={"chunk": int(eff_chunk)})
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
                   params: IndexParams, step_point: str | None = None
                   ) -> OpHandle:
        """Apply ceil(n/chunk) operand-free ``mop`` micro-batches, passing
        ``step_point`` after each."""
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
            if step_point is not None:
                faults.crash_point(step_point)
        return self._track(mop.name, n, chunks)

    def consolidate(self, *, strategy: str | None = None,
                    chunk: int | None = None,
                    _n_masked: int | None = None,
                    _auto: bool = False) -> int:
        """Physically remove every tombstone: ceil(n/chunk) OP_CONSOLIDATE
        micro-batches, each compacting the lowest-id tombstones at its
        stream position with ``consolidate_strategy`` (or ``strategy``).
        Reads the exact tombstone count (a sync) unless the trigger passes
        the count it just measured. Returns the number consolidated; the
        work itself is enqueued (settled by ``flush`` or reads). Only
        explicit calls journal (JR_CONSOLIDATE): auto passes (``_auto``)
        are re-derived by replay."""
        if not _auto:
            self._journal_append(ops_mod.JR_CONSOLIDATE,
                                 aux={"strategy": strategy, "chunk": chunk})
        faults.crash_point("pre-consolidate")
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
        faults.crash_point("post-consolidate")
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
            return self.consolidate(_n_masked=self._masked_hint, _auto=True)
        finally:
            self._in_consolidate = False

    def refine(self, *, n: int | None = None, chunk: int | None = None,
               _auto: bool = False) -> int:
        """Re-wire the ``n`` (default one chunk) stalest alive slots at
        construction quality: ceil(n/chunk) OP_REFINE micro-batches. Returns
        the number submitted; the work itself is enqueued. Only explicit
        calls journal (JR_REFINE)."""
        if not _auto:
            self._journal_append(
                maint.REFINE.journal_code,
                aux={"n": None if n is None else int(n),
                     "chunk": None if chunk is None else int(chunk)})
        faults.crash_point("refine-begin")
        t0 = time.perf_counter()
        mp = self.params.maintenance
        chunk = int(chunk) if chunk else (mp.refine_chunk or mp.insert_chunk)
        n_alive = int(self._state.alive.sum())
        n_target = min(chunk if n is None else int(n), n_alive)
        self._refine_wear = 0  # any pass resets the odometer (replay too)
        if n_target <= 0:
            self.timers.refine_s += time.perf_counter() - t0
            return 0
        self.last_refine_handle = self._run_maint(
            maint.REFINE, chunk, n_target, self.params,
            step_point="refine-step")
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
            return self.refine(_auto=True)
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
            free += self.consolidate(_n_masked=self._masked_hint, _auto=True)
        if free < n and mp.max_capacity is not None:
            cap = self._state.capacity
            target = next_capacity_tier(cap, cap - free + n, mp.growth_factor,
                                        mp.max_capacity)
            if target > cap:
                self.grow(target, _auto=True)
                free += target - cap
        if free < n:
            self.timers.n_refused += n - free
        self._free_hint = free

    def grow(self, new_capacity: int, *, _auto: bool = False) -> None:
        """Move the state to a larger capacity tier (``graph.grow_state``):
        slots keep their ids, new slots arrive free. An armed session
        enforces ``maintenance.max_capacity``. Explicit moves journal
        (JR_GROW)."""
        t0 = time.perf_counter()
        if new_capacity == self._state.capacity:
            return
        ceiling = self.params.maintenance.max_capacity
        if ceiling is not None and new_capacity > ceiling:
            raise ValueError(
                f"new_capacity {new_capacity} exceeds maintenance."
                f"max_capacity {ceiling}")
        if not _auto:
            self._journal_append(ops_mod.JR_GROW,
                                 aux={"new_capacity": int(new_capacity)})
        faults.crash_point("pre-grow")
        if self._window_t0 is None:
            self._window_t0 = t0
        grown = grow_state(self._state, new_capacity)
        self._free_hint += grown.capacity - self._state.capacity
        self._state = grown
        self.timers.n_grows += 1
        self.timers.grow_s += time.perf_counter() - t0
        faults.crash_point("post-grow")

    def flush(self) -> PhaseTimers:
        """Journal a JR_FLUSH marker, run the consolidate and refine
        triggers, then block until every dispatched op has run and settle
        the timers. The triggers make *when* a flush happened part of the
        stream, so replay re-flushes at the marked positions."""
        faults.crash_point("pre-flush")
        self._journal_append(ops_mod.JR_FLUSH)
        self._maybe_consolidate()
        self._maybe_refine()
        self._sync()
        faults.crash_point("post-flush")
        return self.timers

    def _sync(self) -> None:
        """The synchronisation body of :meth:`flush`, without the marker and
        the triggers: recovery settles replayed work through it, so it can
        fire no compaction the original timeline never saw. Transient
        failures are retried with exponential backoff (counted in
        ``timers.n_retries``); exhaustion re-raises. Under policy
        ``"flush"`` this is the journal's durability barrier."""
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                faults.transient_point("flush")
                for h in list(self._pending):  # block() retires in place
                    h.block()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                break
            except faults.TransientDispatchError:
                if attempt >= self._flush_retries:
                    raise
                self.timers.n_retries += 1
                time.sleep(self._flush_backoff_s * (2.0 ** attempt))
                attempt += 1
        self._pending.clear()
        if self._journal is not None and self._journal.fsync_policy == "flush":
            self._journal.sync()  # flush is the acknowledgement barrier
        self.timers.flush_s += time.perf_counter() - t0
        if self._window_t0 is not None:
            self.timers.wall_s += time.perf_counter() - self._window_t0
            self._window_t0 = None

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

    # -- checkpoints -------------------------------------------------------
    def _require_ckpt(self) -> manager_mod.CheckpointManager:
        if self._ckpt is None:
            raise ValueError(
                "session has no checkpoint_dir; pass checkpoint_dir= to "
                "Session(...) to enable save/restore")
        return self._ckpt

    def _ckpt_tree(self) -> dict:
        """The JAX session's checkpoint tree: the key as uint32[2]."""
        return {"graph": self._state, "base_key": key_to_uint32(self._base_key)}

    def save(self, step: int) -> Path:
        """Checkpoint the state, the PRNG chain, the counters and the params
        fingerprint; the live capacity tier is recorded beside it. A
        published checkpoint subsumes the journal, which is reset."""
        mgr = self._require_ckpt()
        self.flush()
        extra = {
            "fingerprint": self._fingerprint(),
            "capacity": int(self._state.capacity),
            "op_counter": self._op_counter,
            "timers": self.timers.to_dict(),
        }
        for mop in maint.SESSION_OPS:
            if mop.extra_key is not None:
                extra[mop.extra_key] = int(getattr(self, mop.counter_attr))
            for attr, ekey in mop.state_attrs:
                extra[ekey] = int(getattr(self, attr))
        path = mgr.save(step, self._ckpt_tree(), extra=extra)
        # a crash before the reset is safe: recovery skips the records whose
        # seq/cseq the restored counters already cover
        faults.crash_point("post-checkpoint-save")
        if self._journal is not None:
            self._journal.reset(meta={
                "fingerprint": self._fingerprint()})
        return path

    def restore(self, step: int | None = None) -> int:
        """Restore a saved step (the newest that validates when ``None``,
        walking back past corrupt ones; an explicit step raises
        ``CheckpointCorruptError``). Refuses a checkpoint of another
        (params, strategy) fingerprint or of a capacity below
        ``params.capacity``. Restoring rewinds the timeline, so an attached
        journal is reset. Returns the restored step."""
        mgr = self._require_ckpt()
        self.flush()
        step, tree, extra = restore_walking_back(mgr, step, self._ckpt_tree())
        if extra.get("fingerprint") != self._fingerprint():
            raise ValueError(
                "checkpoint params/strategy fingerprint mismatch — refusing "
                "to restore an index saved under a different configuration")
        saved_cap = int(extra.get("capacity", tree["graph"]["alive"].shape[0]))
        if saved_cap < self.params.capacity:
            raise ValueError(
                f"checkpoint capacity {saved_cap} is below this "
                f"configuration's initial capacity {self.params.capacity} "
                "— shrinking an allocator is not supported, refusing to "
                "restore")
        st = self._state
        t0 = time.perf_counter()
        self._state = graph_state_from_numpy(
            tree["graph"], capacity=saved_cap, dim=st.dim, d_out=st.d_out,
            d_in=st.d_in, metric=st.metric, device=self.device)
        mgr.timings["to_device_s"] = time.perf_counter() - t0
        self._base_key = key_from_uint32(tree["base_key"])
        self._op_counter = int(extra["op_counter"])
        for mop in maint.SESSION_OPS:
            if mop.extra_key is not None:
                setattr(self, mop.counter_attr,
                        int(extra.get(mop.extra_key, 0)))
            for attr, ekey in mop.state_attrs:
                setattr(self, attr, int(extra.get(ekey, 0)))
        self._refresh_hints()
        if self._journal is not None:
            self._journal.reset(meta={
                "fingerprint": self._fingerprint()})
        return step

    @classmethod
    def recover(cls, checkpoint_dir: str | Path, params: IndexParams, *,
                strategy: str | None = None, seed: int = 0, device=None,
                checkpoint_keep: int = 3, journal_fsync: str = "flush",
                flush_retries: int = 3, flush_backoff_s: float = 0.005
                ) -> "Session":
        """Rebuild a crashed session from ``checkpoint_dir``.

        Restores the newest checkpoint that validates, scans the journal
        (dropping a torn or corrupt tail) and replays the suffix through the
        normal op path: records whose ``seq``/``cseq`` the restored counters
        cover are skipped, queries only advance the key chain, JR_FLUSH
        re-runs the flush triggers, maintenance records go through the
        registry's replay hooks, and a sequence gap (the newest checkpoint
        was corrupt and the journal already truncated past the fallback)
        ends the replay. The result is bit-identical to the uninterrupted
        run over the same acknowledged prefix. Replayed records stay in the
        journal until the next ``save``, so a crash during or after recovery
        recovers again from the same disk state.
        """
        sess = cls(params, strategy=strategy, seed=seed, device=device,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_keep=checkpoint_keep, journal=False,
                   journal_fsync=journal_fsync, flush_retries=flush_retries,
                   flush_backoff_s=flush_backoff_s)
        replay_journal(sess, "session")
        return sess

    # replay_journal's hooks: what one journaled stream op does on replay
    def _replay_query(self, rec) -> None:
        self._op_key()  # results are gone; only the chain advances

    def _replay_insert(self, rec) -> None:
        self.insert(rec.payload, chunk=rec.aux.get("chunk"))

    def _replay_delete(self, rec) -> None:
        self.delete(rec.ids, chunk=rec.aux.get("chunk"))


def replay_journal(sess, tier: str) -> None:
    """The body of ``recover`` for a session of ``tier`` ("session" or
    "tiered") constructed without a journal: restore the newest valid
    checkpoint, replay the journal suffix, settle, attach the journal and
    fill ``recovery_info``.

    Records whose ``seq`` the restored op counter covers are skipped;
    stream ops replay through the session's ``_replay_*`` hooks; JR_FLUSH
    re-runs ``flush`` (its triggers); maintenance records go through the
    registry's replay hooks, which dedup on ``cseq``; a sequence gap (the
    newest checkpoint was corrupt and the journal already truncated past
    the fallback) ends the replay, and the dead suffix is discarded for a
    fresh journal. Settling uses ``_sync``, never the flush trigger.
    """
    sess.recovering = True
    t0 = time.perf_counter()
    records, _, dropped = journal_mod.scan_file(
        Path(sess._ckpt.dir) / "journal.bin")
    step = None
    try:
        step = sess.restore(None)  # journal not attached: no reset
    except FileNotFoundError:
        pass  # crashed before the first checkpoint: replay from empty
    want = sess._fingerprint()
    n_replayed = n_skipped = n_unreplayable = 0
    for idx, rec in enumerate(records):
        code = rec.code
        if code == ops_mod.JR_META:
            fp = rec.aux.get("fingerprint")
            if fp is not None and fp != want:
                raise ValueError(
                    "journal params/strategy fingerprint mismatch — refusing "
                    "to replay ops recorded under a different configuration")
            continue
        if code in (OP_QUERY, OP_INSERT, OP_DELETE, ops_mod.JR_FLUSH):
            if rec.seq < sess._op_counter:
                n_skipped += 1
                continue
            if code != ops_mod.JR_FLUSH and rec.seq > sess._op_counter:
                n_unreplayable = len(records) - idx
                break
        if code == OP_QUERY:
            sess._replay_query(rec)
        elif code == OP_INSERT:
            sess._replay_insert(rec)
        elif code == OP_DELETE:
            sess._replay_delete(rec)
        elif code == ops_mod.JR_FLUSH:
            sess.flush()
        else:
            mop = maint.by_journal_code(code)
            if mop is None or mop.tier != tier:
                raise ValueError(f"unknown journal record code {code}")
            if not mop.replay(sess, rec):
                n_skipped += 1
                continue
        n_replayed += 1
    sess._sync()
    sess._attach_journal(fresh=n_unreplayable > 0)
    sess.recovering = False
    sess.recovery_info = {
        "step": step,
        "n_replayed": n_replayed,
        "n_skipped": n_skipped,
        "n_unreplayable": n_unreplayable,
        "dropped_bytes": int(dropped),
        "replay_s": time.perf_counter() - t0,
    }


def key_to_uint32(key: torch.Tensor) -> np.ndarray:
    """A port key (int64 ``[2]`` of uint32 words) as JAX's uint32[2]."""
    return key.cpu().numpy().astype(np.uint32)


def key_from_uint32(words) -> torch.Tensor:
    """JAX's uint32[2] key data as a port key."""
    return torch.as_tensor(np.asarray(words, np.uint32).astype(np.int64))


def restore_walking_back(mgr: manager_mod.CheckpointManager,
                         step: int | None, like) -> tuple[int, dict, dict]:
    """``mgr.restore`` of ``step``, or of the newest complete step that
    validates when ``step`` is None. Returns (step, tree, extra)."""
    if step is not None:
        tree, extra = mgr.restore(step, like)
        return step, tree, extra
    steps = mgr.all_steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {mgr.dir}")
    errors: list[str] = []
    for s in reversed(steps):
        try:
            tree, extra = mgr.restore(s, like)
            return s, tree, extra
        except manager_mod.CheckpointCorruptError as e:
            errors.append(str(e))
    raise manager_mod.CheckpointCorruptError(
        "every checkpoint step is corrupt:\n  " + "\n  ".join(errors))
