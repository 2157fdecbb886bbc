"""Tombstone consolidation — ``repro.core.consolidate``, in place.

MASK deletes leave tombstones (present, not alive) that keep the graph
traversable but hold their slots forever (§5.2). The consolidation pass
removes them for real: :func:`consolidate_chunk_impl` repairs the surviving
in-neighbours of one chunk of tombstones with the configured
``consolidate_strategy`` (the delete module's ``REPAIR_APPLIERS``; "pure"
only scrubs), then scrubs their edges and frees their slots. The session
runs it as the ``OP_CONSOLIDATE`` branch of the op IR (``core/ops.py``),
auto-triggered by ``MaintenanceParams.consolidate_threshold``.

The host-side drivers keep the JAX package's surface: ``consolidate`` and
``maybe_consolidate`` take an ``IPGMIndex`` or a ``Session``;
``consolidate_reference`` is the revive-then-delete oracle, exception-safe.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import delete as delete_mod
from repro_torch.core.graph import DATA_FIELDS, NULL, GraphState
from repro_torch.core.params import IndexParams


def masked_fraction(state: GraphState) -> float:
    """Tombstone share of the traversable graph (host-side, synchronises)."""
    n_masked = float(state.masked.sum())
    n_present = float(state.present.sum())
    return n_masked / max(n_present, 1.0)


def consolidate_chunk_impl(state: GraphState, ids: torch.Tensor,
                           valid: torch.Tensor, key: torch.Tensor,
                           params: IndexParams
                           ) -> tuple[GraphState, torch.Tensor]:
    """Compact one chunk of tombstone slots ``ids i32[B]`` — in place.

    Lanes that are not tombstones (``present & ~alive``) are dropped, so the
    step is idempotent. Returns (state, n_consolidated i32[])."""
    strategy = params.maintenance.consolidate_strategy
    valid = valid & (ids != NULL)
    safe = torch.where(valid, ids, 0).long()
    valid = valid & state.masked[safe]
    dead = delete_mod._dead_mask(state, ids, valid)
    if strategy != "pure":
        delete_mod.REPAIR_APPLIERS[strategy](state, ids, valid, dead, key,
                                             params)
    delete_mod._finalize_removal(state, ids, valid)
    return state, valid.sum(dtype=torch.int32)


def _session_of(index):
    return getattr(index, "session", index)


def consolidate(index, *, strategy: str | None = None,
                chunk: int | None = None) -> int:
    """Remove every tombstone through the session's compaction pass and
    flush; returns the number of consolidated vertices."""
    sess = _session_of(index)
    n = sess.consolidate(strategy=strategy, chunk=chunk)
    sess.flush()
    return n


def maybe_consolidate(index, *, threshold: float = 0.2,
                      strategy: str | None = None) -> int:
    """Consolidate when tombstones exceed ``threshold`` of the graph."""
    if masked_fraction(_session_of(index).state) >= threshold:
        return consolidate(index, strategy=strategy)
    return 0


def consolidate_reference(index, *, strategy: str = "global") -> int:
    """The revive-then-delete pass — the parity oracle. Tombstones are
    revived (``alive=True``) so the delete strategy's precheck accepts them,
    then deleted with ``strategy`` through ``index.delete``. If that raises,
    the index's state and strategy roll back. The delete path updates the
    state in place, so the rollback snapshot clones every tensor. Returns
    the number of tombstones removed."""
    sess = _session_of(index)
    sess.flush()
    state = sess.state
    masked_ids = torch.nonzero(state.masked).flatten().cpu().numpy()
    if masked_ids.size == 0:
        return 0
    snapshot = dataclasses.replace(
        state, **{f: getattr(state, f).clone() for f in DATA_FIELDS})
    old_strategy = index.strategy
    try:
        alive = state.alive.clone()
        alive[torch.as_tensor(masked_ids, device=state.device)] = True
        index.state = dataclasses.replace(
            state, alive=alive, size=state.size + int(masked_ids.size))
        index.strategy = strategy
        index.delete(masked_ids)
    except BaseException:
        index.state = snapshot
        raise
    finally:
        index.strategy = old_strategy
    return int(masked_ids.size)
