"""DELETE-UPDATE-EDGES over a batch — ``repro.core.delete``, in place.

  PURE   (Alg 4): drop vertex + incident edges.
  MASK   (§5.2) : tombstone — traversable, not reportable, edges untouched.
  GLOBAL (Alg 6): every surviving in-neighbour u of a deleted vertex is
                  re-searched from its own vector (ONE batched beam-engine
                  call for the whole batch), re-selected and its out-row
                  replaced wholesale. The paper's recommended strategy.

The deleted batch is first marked dead but kept present, so the repair
searches still route through it; edges are scrubbed and slots freed only
after all repairs are applied. LOCAL, RWALK and the sequential reference
appliers of the JAX package are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import search, select
from repro_torch.core.graph import (
    NULL,
    GraphState,
    scrub_edges_to,
    set_out_edges_batch,
)
from repro_torch.core.params import IndexParams
from repro_torch.core.stable import argmax_first, scatter_max_, scatter_min_

STRATEGIES = ("pure", "mask", "global")
UNPORTED_STRATEGIES = ("local", "rwalk", "local_reference",
                       "global_reference", "rwalk_reference")


def _dead_mask(state: GraphState, ids: torch.Tensor, valid: torch.Tensor
               ) -> torch.Tensor:
    m = torch.zeros((state.capacity,), dtype=torch.bool, device=state.device)
    return scatter_max_(m, torch.where(valid, ids, 0), valid)


def _precheck(state: GraphState, ids: torch.Tensor, valid: torch.Tensor
              ) -> torch.Tensor:
    """Only alive vertices can be deleted."""
    safe = torch.where(valid, ids, 0).long()
    return valid & (ids != NULL) & state.alive[safe]


def _mark_dead(state: GraphState, ids: torch.Tensor, valid: torch.Tensor
               ) -> GraphState:
    """alive=False while still present; ``size`` drops by the number of
    *distinct* slots (first lane wins, by scatter-min over lane indices)."""
    B = ids.shape[0]
    dev = state.device
    safe = torch.where(valid, ids, 0).long()
    lane = torch.where(valid, torch.arange(B, device=dev), B)
    winner = torch.full((state.capacity,), B, dtype=torch.int64, device=dev)
    scatter_min_(winner, safe, lane)
    first = valid & (winner[safe] == lane)
    state.size -= first.sum(dtype=torch.int32)
    scatter_min_(state.alive, safe, ~valid)
    return state


def _finalize_removal(state: GraphState, ids: torch.Tensor,
                      valid: torch.Tensor) -> GraphState:
    dead = _dead_mask(state, ids, valid)
    scrub_edges_to(state, dead)
    scatter_min_(state.present, torch.where(valid, ids, 0), ~valid)
    state.codes.masked_fill_(dead[:, None], 0)
    state.scales.masked_fill_(dead, 0.0)
    state.stamps.masked_fill_(dead, -1)    # invariant I6
    state.touch.masked_fill_(dead, -1)     # invariant I7
    return state


def delete_pure(state, ids, valid, key, params: IndexParams) -> GraphState:
    valid = _precheck(state, ids, valid)
    _mark_dead(state, ids, valid)
    return _finalize_removal(state, ids, valid)


def delete_mask(state, ids, valid, key, params: IndexParams) -> GraphState:
    valid = _precheck(state, ids, valid)
    return _mark_dead(state, ids, valid)   # present stays True: tombstone


def _global_repair_plan(state: GraphState, ids: torch.Tensor,
                        valid: torch.Tensor, dead: torch.Tensor,
                        key: torch.Tensor, params: IndexParams):
    """Alg 6 lines 3–6: the unique surviving in-neighbours of the batch and
    their replacement rows. Returns (u_flat, u_valid, new_nbrs)."""
    d_in = state.d_in
    dev = state.device
    safe_ids = torch.where(valid, ids, 0).long()
    u_flat = state.radj[safe_ids].reshape(-1)                 # [B·d_in]
    E = u_flat.shape[0]
    u_valid = (u_flat != NULL) & valid.repeat_interleave(d_in)
    su = torch.where(u_valid, u_flat, 0).long()
    u_valid = u_valid & ~dead[su] & state.alive[su]
    # first occurrence wins: a u may point at several deleted vertices
    eq = (u_flat[:, None] == u_flat[None, :]) & u_valid[None, :] & u_valid[:, None]
    u_valid = u_valid & (argmax_first(eq, 1) == torch.arange(E, device=dev))
    su = torch.where(u_valid, u_flat, 0).long()

    # ONE batched repair search on the marked graph (the deleted batch is
    # already non-alive, so it never comes back as a candidate)
    sp = params.eff_insert_search
    u_vecs = state.vectors[su]
    starts = search.batch_entry_points(state, key, E, sp.num_starts,
                                       active=u_valid)
    res = search.beam_search(state, u_vecs, starts, sp)
    new_nbrs = select.select_from_pool(state, u_vecs, res.ids, params.d_out,
                                       exclude=su[:, None])
    return u_flat, u_valid, new_nbrs


def delete_global(state, ids, valid, key, params: IndexParams) -> GraphState:
    valid = _precheck(state, ids, valid)
    _mark_dead(state, ids, valid)
    dead = _dead_mask(state, ids, valid)
    u_flat, u_valid, new_nbrs = _global_repair_plan(state, ids, valid, dead,
                                                    key, params)
    set_out_edges_batch(state, u_flat, new_nbrs, u_valid)
    return _finalize_removal(state, ids, valid)


_STRATEGY_FNS = {"pure": delete_pure, "mask": delete_mask,
                 "global": delete_global}


def delete_batch(state: GraphState, ids, valid, key: torch.Tensor,
                 strategy: str, params: IndexParams) -> GraphState:
    """Delete the valid lanes of ``ids`` with ``strategy`` — in place."""
    if strategy in UNPORTED_STRATEGIES:
        raise NotImplementedError(
            f"delete strategy {strategy!r} is not ported to repro_torch yet")
    dev = state.device
    ids = torch.as_tensor(ids, dtype=torch.int32).to(dev)
    valid = torch.as_tensor(valid, dtype=torch.bool).to(dev)
    return _STRATEGY_FNS[strategy](state, ids, valid, key, params)
