"""Streaming session over one index — ``repro.core.session.Session``.

The session owns a device-resident ``GraphState`` and the PRNG chain, chops
every query/insert/delete into fixed-shape ``OpBatch`` micro-batches and
applies them. Work is enqueued on the CUDA stream without waiting; the host
synchronises on ``flush()`` or when a handle's ``result()`` is read (and
briefly where the beam engine tests its exit condition). The state is
updated in place where JAX donates it.

Keys: op number ``t`` uses ``fold_in(base_key, t)``; lanes fold their global
stream index on top, so results do not depend on chunking. Deletes fold the
chunk index into the op key.

Ported: query, insert (NaN/Inf rows rejected), delete (pure, mask,
global), flush, ground_truth, recall, stats. Journal, checkpoints,
consolidation, growth and refinement are not ported yet: a session asked
for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import delete as delete_mod
from repro_torch.core import metrics, prng, quantize
from repro_torch.core import ops as ops_mod
from repro_torch.core.graph import NULL, GraphState, graph_stats, init_graph
from repro_torch.core.ops import OP_DELETE, OP_INSERT, OP_QUERY
from repro_torch.core.params import IndexParams

# (count field, time field) of each maintenance op, in the JAX registry's
# order (consolidate, grow, refine, merge)
_MAINT_FIELDS = (("n_consolidations", "consolidate_s"), ("n_grows", "grow_s"),
                 ("n_refines", "refine_s"), ("n_merges", "merge_s"))


@dataclasses.dataclass
class PhaseTimers:
    """Flush-based phase accounting: per-phase ``*_s`` fields are host
    dispatch time, ``flush_s`` the synchronous waits, ``wall_s`` the busy
    wall-clock from the first dispatch of a window to the flush closing it.
    The maintenance fields stay zero until those ops are ported."""

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
        out: dict = {}
        for count_field, time_field in _MAINT_FIELDS:
            out[count_field] = getattr(self, count_field)
            out[time_field] = getattr(self, time_field)
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
        (NULL where not inserted); delete → None."""
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
                if self.op == "insert":
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
        mp = params.maintenance
        unported = [name for name, armed in (
            ("checkpoint_dir", checkpoint_dir is not None),
            ("journal", bool(journal)),
            ("consolidate_threshold", mp.consolidate_threshold is not None),
            ("max_capacity", mp.max_capacity is not None),
            ("refine_threshold", mp.refine_threshold is not None)) if armed]
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

    @property
    def state(self) -> GraphState:
        return self._state

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
        handle = OpHandle(ops_mod.OP_NAMES[op_code], n,
                          self.params.search.pool_size, chunks,
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
        NaN/Inf are rejected at dispatch (NULL id, ``timers.n_rejected``);
        rows a full index cannot take are counted in ``timers.n_refused``."""
        v = np.asarray(vectors, np.float32)
        total, keep = v.shape[0], None
        if total:
            finite = np.isfinite(v).all(axis=1)
            if not finite.all():
                self.timers.n_rejected += int(total - finite.sum())
                keep = np.flatnonzero(finite)
                v = v[keep]
        if v.shape[0]:
            free = self._state.capacity - int(self._state.present.sum())
            self.timers.n_refused += max(0, v.shape[0] - free)
        t0 = time.perf_counter()
        h = self._dispatch(OP_INSERT, v,
                           chunk or self.params.maintenance.insert_chunk)
        if keep is not None:
            h.row_map, h.total_rows = keep, total
        self.timers.insert_s += time.perf_counter() - t0
        self.timers.n_inserts += v.shape[0]
        return h

    def delete(self, ids, *, chunk: int | None = None) -> OpHandle:
        """Batch delete with the session's strategy."""
        arr = np.asarray(ids, np.int32)
        eff_chunk = chunk or self.params.maintenance.delete_chunk
        t0 = time.perf_counter()
        h = self._dispatch(OP_DELETE, arr, eff_chunk, fold_chunk_key=True)
        self.timers.delete_s += time.perf_counter() - t0
        self.timers.n_deletes += arr.shape[0]
        return h

    def consolidate(self, *args, **kwargs):
        raise NotImplementedError("consolidate is not ported to repro_torch yet")

    def grow(self, *args, **kwargs):
        raise NotImplementedError("grow is not ported to repro_torch yet")

    def refine(self, *args, **kwargs):
        raise NotImplementedError("refine is not ported to repro_torch yet")

    def flush(self) -> PhaseTimers:
        """Block until every dispatched op has run; settle the timers."""
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
