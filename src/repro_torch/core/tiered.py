"""Two-tier streaming index — a small fresh tier in front of a big main tier
(``repro.core.tiered``).

``TieredSession`` writes every insert to a small *fresh*
:class:`~repro_torch.core.session.Session` (hard-delete strategy), turns
deletes of main-resident points into tombstones in the *main* tier's MASK
bitmap, and fans queries out to both tiers: an exact host scan of the fresh
tier and the beam engine on main, unioned by **external id**. A background
:class:`~repro_torch.core.merge.StreamingMerge` drains fresh into main in
bounded chunks (one step per insert/delete).

External ids are assigned monotonically by ``insert`` or chosen with
``insert(ids=...)``; slot ids never escape. Re-inserting a live external id
is an upsert: the old copy is deleted in the same op, so no query returns a
stale vector or an id twice.

Determinism, as in JAX: every public op consumes a fixed number of per-tier
op keys (queries one main key; deletes one per tier; inserts one delete key
per tier plus one fresh insert key) wherever its targets live; merge work
draws from its own key stream; merge progress is a pure function of the
mutation stream (queries and flushes never pump). So recovery lands
bit-exactly, mid-merge included.

Durability: with a ``checkpoint_dir`` the tiered session keeps its own
write-ahead journal (ops under their OP_* codes with *external* ids,
explicit merges under JR_MERGE); ``save`` completes an in-flight merge (the
merge barrier) and checkpoints both tiers and the slot→external-id maps in
the JAX package's layout; ``recover`` replays the journal suffix.

Host mirrors: exact numpy copies of each tier's ``present``/``masked``
bitmaps and slot→ext maps. Allocation and compaction picks are
deterministic (lowest free first, lowest-id tombstones first), so the
mirrors track the device without a sync and route ops at host rate.

The fresh scan keeps JAX's key, ⟨x,q⟩ − ‖x‖²/2 for l2 (exactly half the
engine's score; the winners are doubled back), as the same numpy
expression. The fan-in ranks like ``np.argsort(-keys, kind="stable")``
over [fresh | main]: descending, NaN last, ties to the lower column. It
cuts the fresh side to its top k first, in row blocks, so a fresh tier of
2^17 slots costs no [B, 2^17] sort; JAX sorts the whole row with numpy's
default (unstable) sort, so the two agree except on exact ties.
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
from repro_torch.core import maint, metrics, prng
from repro_torch.core import merge as merge_mod
from repro_torch.core import ops as ops_mod
from repro_torch.core.graph import NULL, GraphState, graph_state_from_numpy
from repro_torch.core.ops import OP_DELETE, OP_INSERT, OP_QUERY
from repro_torch.core.params import IndexParams
from repro_torch.core.session import (
    PhaseTimers,
    Session,
    key_from_uint32,
    key_to_uint32,
    params_fingerprint,
    replay_journal,
    restore_walking_back,
)
from repro_torch.testing import faults

_HARD_STRATEGIES = ("pure", "local", "global", "rwalk")
# query rows per block of the fresh scan: bounds its [rows, fresh_capacity]
# key matrix (128 MiB at 2^17 slots)
_SCAN_ROWS = 256


class _TierMirror:
    """Exact host mirror of one tier's occupancy and slot→ext map."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.present = np.zeros((capacity,), bool)
        self.masked = np.zeros((capacity,), bool)
        self.ext = np.full((capacity,), NULL, np.int32)

    def grow(self, new_capacity: int) -> None:
        extra = new_capacity - self.capacity
        if extra <= 0:
            return
        self.present = np.pad(self.present, (0, extra))
        self.masked = np.pad(self.masked, (0, extra))
        self.ext = np.pad(self.ext, (0, extra), constant_values=NULL)
        self.capacity = new_capacity

    @property
    def n_free(self) -> int:
        return int(self.capacity - np.sum(self.present))


def _order_keys(neg: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """int64 keys ordering ``neg`` ascending (NaN last), then ``cols``."""
    neg = np.where(np.isnan(neg), np.float32(np.nan), neg).astype(
        np.float32, copy=False)
    b = neg.view(np.int32)
    b = np.where(b < 0, b ^ np.int32(0x7FFFFFFF), b)     # IEEE total order
    return (b.astype(np.int64) << 32) | cols


def _top_columns(keys: np.ndarray, k: int) -> np.ndarray:
    """Columns of each row's top ``k <= keys.shape[1]`` float32 keys, best
    first, as ``np.argsort(-keys, kind="stable")[:, :k]``: descending, NaN
    last, -0.0 equal to +0.0, ties to the lower column.

    A float partition picks k columns per row; it is the answer unless the
    k-th key is tied beyond the pick (or NaN), and only such rows are ranked
    again over the whole row by (key, column)."""
    B, W = keys.shape
    neg = -keys + np.float32(0.0)                       # -0.0 → +0.0
    if k < W:
        part = np.argpartition(neg, k - 1, axis=1)[:, :k]
        kth = np.take_along_axis(neg, part, axis=1).max(axis=1, keepdims=True)
        redo = np.flatnonzero(np.count_nonzero(neg <= kth, axis=1) != k)
    else:
        part = np.broadcast_to(np.arange(W, dtype=np.int64), (B, W))
        redo = np.zeros((0,), np.int64)
    r = _order_keys(np.take_along_axis(neg, part, axis=1), part)
    out = np.take_along_axis(part, np.argsort(r, axis=1), axis=1)
    if len(redo):
        r = _order_keys(neg[redo], np.arange(W, dtype=np.int64))
        p = np.argpartition(r, k - 1, axis=1)[:, :k]
        out[redo] = np.take_along_axis(
            p, np.argsort(np.take_along_axis(r, p, axis=1), axis=1), axis=1)
    return out


def _union_topk(ext_ids: np.ndarray, scores: np.ndarray, k: int,
                device=None):
    """Dedup-by-ext union of per-tier top-k lists → (ids, scores) top-k.

    Duplicate external ids keep their best score; NULL lanes never rank.
    The final pick is the sharded fan-in, ``distributed.ann.topk_union``
    (``lax.top_k``'s order), on ``device`` (the CPU when None): JAX's
    ``device=True`` route, which gives the same order as its host route."""
    ids = np.ascontiguousarray(ext_ids, np.int32)
    sc = np.ascontiguousarray(scores, np.float32).copy()
    B, W = ids.shape
    if B == 0:
        return (np.full((0, k), NULL, np.int32),
                np.full((0, k), -np.inf, np.float32))
    sc[ids == NULL] = -np.inf
    # one lexsort across all rows: group (row, ext), keep the best score
    rowid = np.repeat(np.arange(B), W)
    flat_i, flat_s = ids.ravel(), sc.ravel()
    order = np.lexsort((-flat_s, flat_i, rowid))
    e, r = flat_i[order], rowid[order]
    dup = np.zeros(B * W, bool)
    dup[1:] = (e[1:] == e[:-1]) & (r[1:] == r[:-1]) & (e[1:] != NULL)
    flat_s = flat_s.copy()
    flat_s[order[dup]] = -np.inf
    sc = flat_s.reshape(B, W)
    from repro_torch.distributed.ann import topk_union  # import cycle
    ts, ti = topk_union(torch.from_numpy(sc).to(device or "cpu"),
                        torch.from_numpy(ids).to(device or "cpu"), k)
    top_s, top_i = ts.cpu().numpy(), ti.cpu().numpy()
    top_i = np.where(top_s > -np.inf, top_i, NULL).astype(np.int32, copy=False)
    return top_i, top_s


def _translate(slot_ids: np.ndarray, ext_map: np.ndarray) -> np.ndarray:
    """slot ids [B, K] → external ids under an ext map."""
    safe = np.clip(slot_ids, 0, len(ext_map) - 1)
    return np.where(slot_ids >= 0, ext_map[safe], NULL).astype(np.int32)


class TieredOpHandle:
    """Future for one tiered op — fans in the per-tier handles on demand."""

    def __init__(self, op: str, n: int, k: int = 0, subs=(),
                 ext_result: np.ndarray | None = None,
                 fresh_keys: np.ndarray | None = None,
                 fresh_ext: np.ndarray | None = None,
                 main_ext: np.ndarray | None = None,
                 halved: bool = False,
                 both: np.ndarray | None = None):
        self.op = op
        self.n = n
        self.k = k
        self._subs = list(subs)
        self._ext_result = ext_result   # insert: acked external ids
        self._fresh_keys = fresh_keys   # query: fresh top keys [B, k']
        self._fresh_ext = fresh_ext     # query: their external ids [B, k']
        self._main_ext = main_ext       # query: NULL-padded main slot→ext
        self._halved = halved           # query: keys are score/2 (l2)
        self._both = both               # query: mid-drain "both" ext ids

    def result(self):
        """Block until applied on both tiers; return the fan-in result.

        query  → (ext_ids i32[n, k], scores f32[n, k])
        insert → ext_ids i32[n] (NULL where rejected/refused/superseded)
        delete → None
        """
        if self.op == "query":
            mi, ms = self._subs[0].result()
            if self.n == 0:
                return (np.full((0, self.k), NULL, np.int32),
                        np.full((0, self.k), -np.inf, np.float32))
            # main scores halved to the fresh keys' scale (exact); the
            # padded map turns slot NULL into ext NULL
            mext = self._main_ext[mi]
            mkey = 0.5 * ms if self._halved else ms
            if self._both is not None:
                # a both-resident item is always in the exact fresh scan, so
                # its main copy is dropped
                mkey = np.where(np.isin(mext, self._both), -np.inf, mkey)
            allk = np.concatenate([self._fresh_keys, mkey], axis=1)
            allid = np.concatenate([self._fresh_ext, mext], axis=1)
            top = _top_columns(allk, self.k)
            tops = np.take_along_axis(allk, top, axis=1)
            topi = np.take_along_axis(allid, top, axis=1)
            if self._halved:
                tops *= 2.0
            if self._both is not None:
                # a dropped main lane keeps its (duplicate) id: NULL it
                topi = np.where(tops > -np.inf, topi, NULL).astype(
                    np.int32, copy=False)
            return topi, tops
        for h in self._subs:
            h.block()
        if self.op == "insert":
            return self._ext_result
        return None

    def block(self) -> None:
        for h in self._subs:
            h.block()


class TieredSession:
    """Two-tier streaming session: fresh-tier writes, fan-out reads.

    ``params`` configures the **main** tier (its strategy is forced to
    ``"mask"``: the tombstone bitmap makes cross-tier deletes O(1)); the
    fresh tier has the same geometry at ``fresh_capacity`` slots with a
    hard-delete ``fresh_strategy``. The ``maintenance.merge_*`` knobs arm
    the streaming-merge trigger. ``main_state`` (the port's addition, like
    ``Session(state=...)``) starts the main tier from a built index: each
    alive slot becomes the item whose external id is its slot id.
    JAX's ``unified_dispatch`` has no counterpart here.
    """

    def __init__(self, params: IndexParams, *,
                 fresh_capacity: int | None = None,
                 fresh_strategy: str = "global", seed: int = 0, device=None,
                 main_state: GraphState | None = None,
                 checkpoint_dir: str | Path | None = None,
                 checkpoint_keep: int = 3, journal: bool | None = None,
                 journal_fsync: str = "flush"):
        if fresh_strategy not in _HARD_STRATEGIES:
            raise ValueError(
                f"fresh_strategy must be a hard-delete strategy "
                f"{_HARD_STRATEGIES} (the fresh tier never tombstones)")
        mp = params.maintenance
        if fresh_capacity is None:
            fresh_capacity = max(2 * mp.insert_chunk, params.capacity // 8)
        if fresh_capacity < 1:
            raise ValueError("fresh_capacity must be >= 1")
        self.device = (main_state.device if main_state is not None
                       else resolve_device(device))
        self.params = params
        self.fresh_capacity = int(fresh_capacity)
        self.fresh_strategy = fresh_strategy
        self.seed = seed
        self._base_key = prng.prng_key(seed)
        # neither tier self-consolidates (merge compaction is the only
        # main-tier compactor, which keeps the mirrors exact) and the fresh
        # tier never grows (merge catch-up is its backpressure)
        fresh_params = dataclasses.replace(
            params, capacity=self.fresh_capacity,
            maintenance=dataclasses.replace(
                mp, strategy=fresh_strategy, consolidate_threshold=None,
                max_capacity=None, merge_fresh_threshold=None,
                merge_tombstone_threshold=None))
        main_params = dataclasses.replace(
            params, maintenance=dataclasses.replace(
                mp, strategy="mask", consolidate_threshold=None,
                merge_fresh_threshold=None, merge_tombstone_threshold=None))
        self._fresh = Session(fresh_params, strategy=fresh_strategy,
                              seed=2 * seed + 1, journal=False,
                              device=self.device)
        self._main = Session(main_params, strategy="mask", seed=2 * seed,
                             journal=False, device=self.device,
                             state=main_state)
        self._fm = _TierMirror(self.fresh_capacity)
        self._mm = _TierMirror(self._main.state.capacity)
        # host mirror of the fresh tier's rows for the exact fresh scan
        # (bitwise the device rows for l2/ip; cos rows may differ in the
        # last ulp of the normalisation)
        self._fvec = np.zeros((self.fresh_capacity, params.dim), np.float32)
        self._fsqh = np.zeros((self.fresh_capacity,), np.float32)  # ‖row‖²/2
        # the fresh scan's additive bias: −inf at absent slots, else −‖x‖²/2
        # (l2) or 0 (ip/cos); kept in step with _fm.present
        self._fbias = np.full((self.fresh_capacity,), -np.inf, np.float32)
        self._mext_pad: np.ndarray | None = None   # COW main slot→ext map
        self._loc: dict[int, tuple] = {}   # ext → ("fresh",f)|("main",m)|("both",f,m)
        self._both_set: set[int] = set()   # live "both" ext ids in _loc
        self._next_ext = 0
        self._op_counter = 0
        self._merge_counter = 0
        self._merges_done = 0
        self._active_merge: merge_mod.StreamingMerge | None = None
        self.timers = PhaseTimers()
        if main_state is not None:
            self._adopt_main(main_state)
        self.recovering = False
        self.recovery_info: dict | None = None
        self._ckpt = None
        if checkpoint_dir is not None:
            self._ckpt = manager_mod.CheckpointManager(checkpoint_dir,
                                                       keep=checkpoint_keep)
        self._journal = None
        self._journal_fsync = journal_fsync
        if journal is None:
            journal = checkpoint_dir is not None
        if journal:
            self._require_ckpt()
            self._attach_journal(fresh=True)

    def _adopt_main(self, state: GraphState) -> None:
        """Mirrors of a main tier that starts from a built state."""
        alive = state.alive.cpu().numpy()
        self._mm.present = state.present.cpu().numpy().copy()
        self._mm.masked = self._mm.present & ~alive
        slots = np.flatnonzero(alive)
        self._mm.ext[slots] = slots
        self._loc = {int(s): ("main", int(s)) for s in slots}
        self._next_ext = int(slots[-1]) + 1 if len(slots) else 0

    # -- tier access (read-only views for tests and tools) -----------------
    @property
    def fresh(self) -> Session:
        return self._fresh

    @property
    def main(self) -> Session:
        return self._main

    @property
    def active_merge(self) -> merge_mod.StreamingMerge | None:
        return self._active_merge

    @property
    def n_alive(self) -> int:
        """Number of live external ids (an item in both tiers counts once)."""
        return len(self._loc)

    @property
    def _merge_chunk(self) -> int:
        mp = self.params.maintenance
        return mp.merge_chunk or mp.insert_chunk

    # -- identity and durability plumbing ----------------------------------
    def _fingerprint(self) -> str:
        return json.dumps({
            "tiered": params_fingerprint(self.params, "mask"),
            "fresh_capacity": self.fresh_capacity,
            "fresh_strategy": self.fresh_strategy,
        }, sort_keys=True)

    def _require_ckpt(self) -> manager_mod.CheckpointManager:
        if self._ckpt is None:
            raise ValueError(
                "session has no checkpoint_dir; pass checkpoint_dir= to "
                "TieredSession(...) to enable save/restore")
        return self._ckpt

    def _attach_journal(self, *, fresh: bool) -> None:
        path = Path(self._ckpt.dir) / "journal.bin"
        self._journal = journal_mod.OpJournal(path, fsync=self._journal_fsync)
        if fresh:
            self._journal.reset(meta={"fingerprint": self._fingerprint()})
        else:
            self._journal.repair()

    def _journal_append(self, code: int, *, payload=None, ids=None,
                        aux: dict | None = None) -> None:
        if self._journal is None:
            return
        # every tiered record snapshots the MERGE entry's counter as cseq:
        # JR_MERGE replays dedup against merges a checkpoint already holds
        self._journal.append(code, seq=self._op_counter,
                             cseq=getattr(self, maint.MERGE.counter_attr),
                             payload=payload, ids=ids, aux=aux)
        faults.crash_point("post-journal-append")

    # -- merge engine plumbing ---------------------------------------------
    def _merge_key(self) -> torch.Tensor:
        # the MERGE op's key stream; _merge_counter advances per draw,
        # _merges_done (the dedup counter) per merge
        key = maint.maint_key(self._base_key, maint.MERGE, self._merge_counter)
        self._merge_counter += 1
        return key

    def _pump(self) -> None:
        """One bounded merge step per insert/delete while a merge runs."""
        if self._active_merge is not None and self._active_merge.step():
            self._active_merge = None

    def _maybe_merge_start(self) -> None:
        """Start a merge when either gate arm crosses. The gate reads the
        exact host mirrors, so it needs no device sync; it is never
        journaled (replay re-derives it from the same mirrors)."""
        if self._active_merge is not None:
            return
        mp = self.params.maintenance
        ft, tt = mp.merge_fresh_threshold, mp.merge_tombstone_threshold
        fire = False
        if ft is not None:
            fire |= int(np.sum(self._fm.present)) >= ft * self.fresh_capacity
        if tt is not None:
            n_masked = int(np.sum(self._mm.masked))
            n_present = int(np.sum(self._mm.present))
            fire |= n_masked > 0 and n_masked >= tt * max(n_present, 1)
        if fire:
            self._active_merge = merge_mod.StreamingMerge(self)

    def _merge_to_completion(self) -> int:
        if self._active_merge is None:
            self._active_merge = merge_mod.StreamingMerge(self)
        m = self._active_merge
        m.run()
        self._active_merge = None
        return m.n_drained

    def merge(self) -> int:
        """Run a streaming merge to completion (explicit, journaled):
        completes the in-flight merge if one is active, else starts one.
        Returns the number of items drained fresh→main."""
        self._journal_append(ops_mod.JR_MERGE)
        return self._merge_to_completion()

    # -- the op surface ----------------------------------------------------
    def _ext_snap_dirty(self) -> None:
        """Invalidate the COW main slot→ext snapshot after an ext-map write."""
        self._mext_pad = None

    def _fresh_topk(self, q: np.ndarray, k: int):
        """The exact fresh scan: each row's top ``min(k, fresh_capacity)``
        keys and their external ids. The key is JAX's ``q @ fvec.T +
        fbias`` (no fresh op key, no device work)."""
        B, kk = q.shape[0], min(k, self.fresh_capacity)
        keys = np.empty((B, kk), np.float32)
        exts = np.empty((B, kk), np.int32)
        for lo in range(0, B, _SCAN_ROWS):
            blk = q[lo:lo + _SCAN_ROWS] @ self._fvec.T + self._fbias
            top = _top_columns(blk, kk)
            keys[lo:lo + _SCAN_ROWS] = np.take_along_axis(blk, top, axis=1)
            exts[lo:lo + _SCAN_ROWS] = self._fm.ext[top]
        return keys, exts

    def query(self, queries, k: int | None = None) -> TieredOpHandle:
        """Fan-out ANN query over both tiers; returns a handle.

        The main tier runs the beam engine (one op key); the fresh tier is
        scanned exactly on the host. Queries never pump the merge.
        ``handle.result()`` → (ext_ids i32[B,k], scores f32[B,k]).
        """
        q = np.asarray(queries, np.float32)
        k = k if k is not None else self.params.search.pool_size
        k = min(k, self.params.search.pool_size)
        self._journal_append(OP_QUERY, aux={"n": int(q.shape[0])})
        self._op_counter += 1
        t0 = time.perf_counter()
        fkeys, fext = self._fresh_topk(q, k)
        hm = self._main.query(q, k=k)
        mp = self._mext_pad
        if mp is None:
            mp = self._mext_pad = np.append(self._mm.ext, np.int32(NULL))
        # duplicates across tiers exist only while an item is both-resident
        both = (np.fromiter(self._both_set, np.int32, len(self._both_set))
                if self._both_set else None)
        h = TieredOpHandle("query", q.shape[0], k, (hm,),
                           fresh_keys=fkeys, fresh_ext=fext, main_ext=mp,
                           halved=self.params.metric == "l2", both=both)
        self.timers.query_s += time.perf_counter() - t0
        self.timers.n_queries += q.shape[0]
        self.timers.n_ops += 1
        return h

    def insert(self, vectors, ids=None) -> TieredOpHandle:
        """Insert (or upsert) a batch into the fresh tier.

        ``ids`` picks the external ids (else assigned monotonically). A row
        whose external id is live anywhere replaces the old copy in the same
        op. ``handle.result()`` → the acked external ids, NULL at rejected
        (non-finite), refused (both tiers full) and superseded (a duplicate
        id within the batch: the last wins) positions.
        """
        v = np.asarray(vectors, np.float32)
        n = v.shape[0]
        if ids is None:
            ext = np.arange(self._next_ext, self._next_ext + n, dtype=np.int64)
        else:
            ext = np.asarray(ids, np.int64).reshape(-1)
            if ext.shape[0] != n:
                raise ValueError("ids must match vectors' row count")
            if n and (ext.min() < 0 or ext.max() >= 2**31):
                raise ValueError("external ids must be int32 and >= 0")
        ext = ext.astype(np.int32)
        if n:
            self._next_ext = max(self._next_ext, int(ext.max()) + 1)
        self._journal_append(OP_INSERT, payload=v, ids=ext)
        self._op_counter += 1
        self._pump()
        # dispatch-time validation (as Session.insert) and in-batch upsert
        # order: a duplicated external id keeps its LAST finite row
        live = (np.isfinite(v).all(axis=1) if n else np.zeros((0,), bool))
        self.timers.n_rejected += int(n - np.sum(live))
        seen: set[int] = set()
        for i in range(n - 1, -1, -1):
            if not live[i]:
                continue
            e = int(ext[i])
            if e in seen:
                live[i] = False
            else:
                seen.add(e)
        # cross-tier upsert: evict live duplicates first (one delete key per
        # tier, dispatched even when there are none)
        dups = np.asarray(
            [int(e) for e, ok in zip(ext, live) if ok and int(e) in self._loc],
            np.int32)
        sub = list(self._delete_exts(dups))
        vk = v[live]
        ek = ext[live]
        nk = vk.shape[0]
        # fresh-tier backpressure: when the batch outruns the merge, finish
        # the drain now (deterministic, re-derived on replay)
        if nk and self._fm.n_free < nk and (
                np.sum(self._fm.present) > 0
                or self._active_merge is not None):
            self._merge_to_completion()
        t0 = time.perf_counter()
        free_ids = np.flatnonzero(~self._fm.present)
        n_ok = min(nk, len(free_ids))
        self.timers.n_refused += nk - n_ok
        sub.append(self._fresh.insert(
            vk if nk else np.zeros((0, self.params.dim), np.float32)))
        slots = free_ids[:n_ok].astype(np.int32)
        self._fm.present[slots] = True
        self._fm.ext[slots] = ek[:n_ok]
        self._ext_snap_dirty()
        # the fresh scan's rows are what the device stores: verbatim f32
        # (cos: normalised, the numpy twin of distances.normalize)
        vstore = vk[:n_ok]
        if self.params.metric == "cos":
            vstore = vstore / np.sqrt(np.maximum(
                np.sum(np.square(vstore), -1, keepdims=True), 1e-12))
        self._fvec[slots] = vstore
        self._fsqh[slots] = 0.5 * np.sum(np.square(vstore), axis=-1)
        self._fbias[slots] = (-self._fsqh[slots]
                              if self.params.metric == "l2" else 0.0)
        for e, s in zip(ek[:n_ok], slots):
            self._loc[int(e)] = ("fresh", int(s))
        res = np.full((n,), NULL, np.int32)
        live_idx = np.flatnonzero(live)
        res[live_idx[:n_ok]] = ek[:n_ok]
        self.timers.insert_s += time.perf_counter() - t0
        self.timers.n_inserts += nk
        self.timers.n_ops += 1
        self._maybe_merge_start()
        return TieredOpHandle("insert", n, subs=sub, ext_result=res)

    def delete(self, ids) -> TieredOpHandle:
        """Delete a batch of external ids wherever each lives: fresh ids
        hard-delete, main ids tombstone, mid-drain ids leave both tiers;
        unknown ids are ignored. One delete key per tier is consumed."""
        arr = np.asarray(ids, np.int64).reshape(-1).astype(np.int32)
        self._journal_append(OP_DELETE, ids=arr)
        self._op_counter += 1
        self._pump()
        t0 = time.perf_counter()
        sub = self._delete_exts(arr)
        self.timers.delete_s += time.perf_counter() - t0
        self.timers.n_deletes += arr.shape[0]
        self.timers.n_ops += 1
        self._maybe_merge_start()
        return TieredOpHandle("delete", arr.shape[0], subs=sub)

    def _delete_exts(self, exts: np.ndarray):
        """Route external-id deletes to their tiers (mirrors and device):
        exactly one delete op per tier, empty where a tier holds no target,
        so the key chains advance the same wherever the ids live."""
        fslots, mslots = [], []
        m = self._active_merge
        for e in np.unique(exts):
            e = int(e)
            loc = self._loc.pop(e, None)
            if loc is None:
                continue
            if loc[0] in ("fresh", "both"):
                f = loc[1]
                fslots.append(f)
                self._fm.present[f] = False
                self._fbias[f] = -np.inf
                self._fm.ext[f] = NULL
                if loc[0] == "fresh" and m is not None and not m.done:
                    m.cancelled.add(e)
                if loc[0] == "both":
                    self._both_set.discard(e)
            if loc[0] == "main":
                mslots.append(loc[1])
                self._mm.masked[loc[1]] = True
                self._mm.ext[loc[1]] = NULL
            elif loc[0] == "both":
                mslots.append(loc[2])
                self._mm.masked[loc[2]] = True
                self._mm.ext[loc[2]] = NULL
        self._ext_snap_dirty()
        hf = self._fresh.delete(np.asarray(sorted(fslots), np.int32))
        hm = self._main.delete(np.asarray(sorted(mslots), np.int32))
        return hf, hm

    def flush(self) -> PhaseTimers:
        """Synchronise both tiers; also a merge *trigger* point. Flush never
        pumps, so a replayed JR_FLUSH or a re-run flush is idempotent."""
        faults.crash_point("pre-flush")
        self._journal_append(ops_mod.JR_FLUSH)
        self._maybe_merge_start()
        self._sync()
        faults.crash_point("post-flush")
        return self.timers

    def _sync(self) -> None:
        """Settle both tiers; under policy ``"flush"`` the journal's
        durability barrier."""
        self._fresh._sync()
        self._main._sync()
        if self._journal is not None and self._journal.fsync_policy == "flush":
            self._journal.sync()

    # -- reporting ---------------------------------------------------------
    def ground_truth(self, queries, k: int):
        """Exact top-k over the union of both tiers' alive sets:
        (ext ids i32[B, k], scores f32[B, k])."""
        self.flush()
        q = torch.as_tensor(np.asarray(queries, np.float32))
        fs, fi = metrics.brute_force_topk(self._fresh.state, q, k)
        ms, mi = metrics.brute_force_topk(self._main.state, q, k)
        ids = np.concatenate(
            [_translate(fi.cpu().numpy(), self._fm.ext),
             _translate(mi.cpu().numpy(), self._mm.ext)], axis=1)
        sc = np.concatenate([fs.cpu().numpy(), ms.cpu().numpy()], axis=1)
        return _union_topk(ids, sc, k, device=self.device)

    def recall(self, queries, k: int) -> float:
        ids, _ = self.query(queries, k=k).result()
        true_ids, _ = self.ground_truth(queries, k)
        return float(metrics.recall_at_k(torch.as_tensor(ids),
                                         torch.as_tensor(true_ids), k))

    def stats(self) -> dict:
        self.flush()
        out = {
            "n_alive": self.n_alive,
            "n_fresh": int(np.sum(self._fm.present)),
            "n_main": int(np.sum(self._mm.present & ~self._mm.masked)),
            "n_main_masked": int(np.sum(self._mm.masked)),
            "fresh_capacity": self._fresh.state.capacity,
            "main_capacity": self._main.state.capacity,
            "n_merged": self.timers.n_merged,
            "n_refused": self.timers.n_refused,
            "merge_active": self._active_merge is not None,
        }
        out.update(self.timers.maintenance_counters())
        return out

    def check_mirrors(self) -> None:
        """Raise AssertionError unless the host mirrors match the device
        bitmaps (and the fresh scan's rows, norms and bias) exactly."""
        self.flush()
        for name, sess, mir in (("fresh", self._fresh, self._fm),
                                ("main", self._main, self._mm)):
            if not np.array_equal(sess.state.present.cpu().numpy(),
                                  mir.present):
                raise AssertionError(f"{name} present mirror diverged")
            if not np.array_equal(sess.state.masked.cpu().numpy(),
                                  mir.masked):
                raise AssertionError(f"{name} masked mirror diverged")
        if self.params.metric != "cos":   # cos: last-ulp normalize skew
            dev = self._fresh.state.vectors.cpu().numpy()
            pres = np.flatnonzero(self._fm.present)
            if not np.array_equal(self._fvec[pres], dev[pres]):
                raise AssertionError("fresh vector mirror diverged")
            want = 0.5 * np.sum(np.square(self._fvec[pres]), axis=-1)
            if not np.array_equal(self._fsqh[pres], want):
                raise AssertionError("fresh sqnorm mirror diverged")
        for e, loc in self._loc.items():
            if loc[0] in ("fresh", "both") and self._fm.ext[loc[1]] != e:
                raise AssertionError(f"fresh ext map diverged at {e}")
            if loc[0] == "main" and self._mm.ext[loc[1]] != e:
                raise AssertionError(f"main ext map diverged at {e}")
            if loc[0] == "both" and self._mm.ext[loc[2]] != e:
                raise AssertionError(f"main ext map diverged at {e}")
        both = {e for e, loc in self._loc.items() if loc[0] == "both"}
        if both != self._both_set:
            raise AssertionError(
                f"_both_set diverged: {self._both_set} != {both}")
        alive_bias = (-self._fsqh if self.params.metric == "l2"
                      else np.float32(0.0))
        want_bias = np.where(self._fm.present, alive_bias,
                             np.float32(-np.inf))
        if not np.array_equal(self._fbias, want_bias):
            raise AssertionError("fresh scan bias diverged")
        if self._mext_pad is not None and not np.array_equal(
                self._mext_pad, np.append(self._mm.ext, np.int32(NULL))):
            raise AssertionError("main ext snapshot went stale")

    # -- checkpoints -------------------------------------------------------
    def _ckpt_tree(self) -> dict:
        """The JAX tiered checkpoint tree (int32 ext maps, uint32 key)."""
        return {
            "fresh_graph": self._fresh._state,
            "main_graph": self._main._state,
            "base_key": key_to_uint32(self._base_key),
            "fresh_ext": self._fm.ext,
            "main_ext": self._mm.ext,
        }

    def save(self, step: int) -> Path:
        """Checkpoint both tiers, the ext maps and the counters atomically.
        An in-flight merge completes first (the **merge barrier**, journaled
        through :meth:`merge`): a checkpoint never holds an item in both
        tiers."""
        mgr = self._require_ckpt()
        if self._active_merge is not None:
            self.merge()
        self.flush()
        path = mgr.save(step, self._ckpt_tree(), extra={
            "fingerprint": self._fingerprint(),
            "fresh_capacity": int(self._fresh.state.capacity),
            "main_capacity": int(self._main.state.capacity),
            "op_counter": self._op_counter,
            "fresh_op_counter": self._fresh._op_counter,
            "main_op_counter": self._main._op_counter,
            "merge_counter": self._merge_counter,
            maint.MERGE.extra_key: getattr(self, maint.MERGE.counter_attr),
            "next_ext": self._next_ext,
            "timers": self.timers.to_dict(),
        })
        faults.crash_point("post-checkpoint-save")
        if self._journal is not None:
            self._journal.reset(meta={"fingerprint": self._fingerprint()})
        return path

    def restore(self, step: int | None = None) -> int:
        """Restore both tiers from a saved step (the newest that validates
        when ``None``). Same guards as ``Session.restore``; the mirrors and
        the location table are rebuilt from the saved ext maps."""
        mgr = self._require_ckpt()
        self.flush()
        step, tree, extra = restore_walking_back(mgr, step, self._ckpt_tree())
        if extra.get("fingerprint") != self._fingerprint():
            raise ValueError(
                "checkpoint params/strategy fingerprint mismatch — refusing "
                "to restore an index saved under a different configuration")
        fc = int(extra["fresh_capacity"])
        mc = int(extra["main_capacity"])
        if fc != self.fresh_capacity:
            raise ValueError(
                f"checkpoint fresh capacity {fc} != configured "
                f"{self.fresh_capacity}")
        if mc < self.params.capacity:
            raise ValueError(
                f"checkpoint main capacity {mc} is below this "
                f"configuration's initial capacity {self.params.capacity}")
        p = self.params
        t0 = time.perf_counter()
        for sess, key, cap in ((self._fresh, "fresh_graph", fc),
                               (self._main, "main_graph", mc)):
            sess._state = graph_state_from_numpy(
                tree[key], capacity=cap, dim=p.dim, d_out=p.d_out,
                d_in=p.eff_d_in, metric=p.metric, device=self.device)
        mgr.timings["to_device_s"] = time.perf_counter() - t0
        self._base_key = key_from_uint32(tree["base_key"])
        self._op_counter = int(extra["op_counter"])
        self._fresh._op_counter = int(extra["fresh_op_counter"])
        self._main._op_counter = int(extra["main_op_counter"])
        self._merge_counter = int(extra["merge_counter"])
        setattr(self, maint.MERGE.counter_attr,
                int(extra[maint.MERGE.extra_key]))
        self._next_ext = int(extra["next_ext"])
        self._active_merge = None
        self._fm = _TierMirror(fc)
        self._fm.present = tree["fresh_graph"]["present"].copy()
        self._fm.ext = tree["fresh_ext"].astype(np.int32).copy()
        self._fvec = tree["fresh_graph"]["vectors"].astype(np.float32).copy()
        self._fsqh = (0.5 * np.sum(np.square(self._fvec), axis=-1)
                      ).astype(np.float32)
        alive_bias = (-self._fsqh if self.params.metric == "l2"
                      else np.float32(0.0))
        self._fbias = np.where(self._fm.present, alive_bias,
                               np.float32(-np.inf)).astype(np.float32)
        self._ext_snap_dirty()
        self._mm = _TierMirror(mc)
        mg = tree["main_graph"]
        self._mm.present = mg["present"].copy()
        self._mm.masked = mg["present"] & ~mg["alive"]
        self._mm.ext = tree["main_ext"].astype(np.int32).copy()
        self._loc = {}
        self._both_set = set()   # a checkpoint never holds mid-merge state
        for s in np.flatnonzero(self._fm.ext != NULL):
            self._loc[int(self._fm.ext[s])] = ("fresh", int(s))
        for s in np.flatnonzero(self._mm.ext != NULL):
            self._loc[int(self._mm.ext[s])] = ("main", int(s))
        self._fresh._refresh_hints()
        self._main._refresh_hints()
        if self._journal is not None:
            self._journal.reset(meta={"fingerprint": self._fingerprint()})
        return step

    @classmethod
    def recover(cls, checkpoint_dir: str | Path, params: IndexParams, *,
                fresh_capacity: int | None = None,
                fresh_strategy: str = "global", seed: int = 0, device=None,
                checkpoint_keep: int = 3, journal_fsync: str = "flush"
                ) -> "TieredSession":
        """Rebuild a crashed tiered session: the newest valid checkpoint
        plus a replay of the journal suffix (queries reproduce only their
        counter and main-key effects). The result, mid-merge progress
        included, is bit-identical to the uninterrupted run over the
        acknowledged prefix."""
        sess = cls(params, fresh_capacity=fresh_capacity,
                   fresh_strategy=fresh_strategy, seed=seed, device=device,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_keep=checkpoint_keep, journal=False,
                   journal_fsync=journal_fsync)
        replay_journal(sess, "tiered")
        return sess

    # replay_journal's hooks; a query reproduces its counter and main-key
    # effects only (the fresh scan draws no key, queries never pump)
    def _replay_query(self, rec) -> None:
        self._op_counter += 1
        self._main._op_key()

    def _replay_insert(self, rec) -> None:
        self.insert(rec.payload, ids=rec.ids)

    def _replay_delete(self, rec) -> None:
        self.delete(rec.ids)
