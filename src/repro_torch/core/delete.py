"""DELETE-UPDATE-EDGES over a batch — ``repro.core.delete``, in place.

  PURE   (Alg 4): drop vertex + incident edges.
  MASK   (§5.2) : tombstone — traversable, not reportable, edges untouched.
  LOCAL  (Alg 5): each surviving in-neighbour u of a deleted x splices ONE
                  diverse edge chosen from x's out-neighbours.
  GLOBAL (Alg 6): every surviving in-neighbour u of a deleted vertex is
                  re-searched from its own vector (ONE batched beam-engine
                  call for the whole batch), re-selected and its out-row
                  replaced wholesale. The paper's recommended strategy.
  RWALK         : each surviving in-neighbour u splices ONE edge found by
                  short walks seeded at a random subset of x's
                  out-neighbourhood, guided by u's vector.

Each repair is a *plan* (which edges to splice or replace) and an *applier*
(grouped per source row, one ``set_out_edges_batch`` call). JAX vmaps
SELECT-NEIGHBORS over the B·d_in lanes of a plan; here each plan makes ONE
``select`` call with R = B·d_in rows, which is what puts the 4,096-row
batches on the ``score_matrix`` kernel.

The deleted batch is first marked dead but kept present, so the repair
searches still route through it; edges are scrubbed and slots freed only
after all repairs are applied. The sequential appliers of the JAX package
are kept as the parity oracle: ``delete_{local,global,rwalk}_reference``
share the batched plans and apply them edge by edge through the scalar
primitives (remove u→x, then add u→z; or ``set_out_edges`` per repaired
row), so a full reverse row refuses the newcomer instead of truncating by
rank.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng, search, select
from repro_torch.core.graph import (
    NULL,
    GraphState,
    add_edge,
    group_by_destination,
    mask_to_slots,
    pack_rows,
    remove_edge,
    scrub_edges_to,
    set_out_edges,
    set_out_edges_batch,
)
from repro_torch.core.params import IndexParams
from repro_torch.core.stable import argmax_first, scatter_max_, scatter_min_, top_k

STRATEGIES = ("pure", "mask", "local", "global", "rwalk")
REFERENCE_STRATEGIES = ("local_reference", "global_reference",
                        "rwalk_reference")


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


def _splice_lanes(state: GraphState, ids: torch.Tensor, valid: torch.Tensor,
                  dead: torch.Tensor):
    """The B·d_in (u, x) lanes shared by LOCAL and RWALK: u_flat, su (safe
    u), c_flat (x's out-row per lane) and u_valid (u survives)."""
    B, d_in, d_out = ids.shape[0], state.d_in, state.d_out
    safe_ids = torch.where(valid, ids, 0).long()
    u_flat = state.radj[safe_ids].reshape(-1)                  # [B·d_in]
    c_flat = state.adj[safe_ids][:, None, :].expand(
        B, d_in, d_out).reshape(B * d_in, d_out)
    u_valid = (u_flat != NULL) & valid.repeat_interleave(d_in)
    su = torch.where(u_valid, u_flat, 0).long()
    u_valid = u_valid & ~dead[su] & state.present[su]
    return u_flat, su, c_flat, u_valid


def _local_repair_plan(state: GraphState, ids: torch.Tensor,
                       valid: torch.Tensor, dead: torch.Tensor):
    """Alg 5 lines 3–6: SELECT-NEIGHBORS(u, N(x), 1, N(u) ∪ {u}) for every
    surviving in-neighbour u of each deleted x. Returns (u_flat, z_flat,
    u_valid) of length B·d_in."""
    u_flat, su, cands, u_valid = _splice_lanes(state, ids, valid, dead)
    sc = cands.clamp(min=0).long()
    exclude = torch.cat([state.adj[su], su[:, None].to(torch.int32)], dim=1)
    cv = (cands != NULL) & ~dead[sc] & state.alive[sc]
    cv = cv & ~torch.any(cands[:, :, None] == exclude[:, None, :], dim=2)
    z = select.select_neighbors(state.vectors[su], cands, state.vectors[sc],
                                cv & u_valid[:, None], 1, state.metric)
    return u_flat, z[:, 0], u_valid


def _splice_apply(state: GraphState, dead: torch.Tensor, u_flat: torch.Tensor,
                  z_flat: torch.Tensor, u_valid: torch.Tensor) -> GraphState:
    """One-edge-splice applier shared by LOCAL and RWALK: group the planned
    additions per surviving row u, drop each row's dying entries, and apply
    through one ``set_out_edges_batch`` call — in place."""
    cap, d_out = state.capacity, state.d_out
    adds, touched_u = group_by_destination(
        z_flat, u_flat, u_valid & (z_flat != NULL), cap, d_out)
    # compact frame over the ≤ B·d_in rows that gain an edge, lowest id first
    uid, u_ok = mask_to_slots(touched_u, min(u_flat.shape[0], cap))
    uv = torch.where(u_ok, uid, 0).long()
    adds_rows = adds[uv]                                        # [R_u, d_out]
    # dedup additions within a row (several x's may pick the same z for u)
    eqa = (adds_rows[:, :, None] == adds_rows[:, None, :]) & (
        adds_rows != NULL)[:, :, None]
    first = argmax_first(eqa, 2) == torch.arange(d_out, device=uv.device)
    adds_rows = torch.where(first, adds_rows, NULL)
    old_rows = state.adj[uv]
    # an addition already in u's row is a success, not a new edge
    dup = torch.any(adds_rows[:, :, None] == old_rows[:, None, :], dim=2)
    adds_rows = torch.where(dup, NULL, adds_rows)
    # new row = (old row minus the dying entries) ++ additions, cut at d_out
    old_rows = torch.where((old_rows != NULL) & dead[old_rows.clamp(min=0).long()],
                           NULL, old_rows)
    packed = pack_rows(torch.cat([old_rows, adds_rows], dim=1))
    return set_out_edges_batch(state, uid, packed[:, :d_out], u_ok)


def _local_repair_apply(state, ids, valid, dead, key,
                        params: IndexParams) -> GraphState:
    u_flat, z_flat, u_valid = _local_repair_plan(state, ids, valid, dead)
    return _splice_apply(state, dead, u_flat, z_flat, u_valid)


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


def _global_repair_apply(state, ids, valid, dead, key,
                         params: IndexParams) -> GraphState:
    u_flat, u_valid, new_nbrs = _global_repair_plan(state, ids, valid, dead,
                                                    key, params)
    return set_out_edges_batch(state, u_flat, new_nbrs, u_valid)


def _rwalk_walk_params(params: IndexParams):
    """The short-walk budget: a few beam-engine trips at beam_width 1 over
    a small pool."""
    mp = params.maintenance
    return dataclasses.replace(
        params.eff_insert_search, pool_size=mp.rwalk_pool,
        max_steps=mp.rwalk_steps,
        num_starts=min(mp.rwalk_starts, mp.rwalk_pool), beam_width=1,
        rerank_depth=0)


def _rwalk_repair_plan(state: GraphState, ids: torch.Tensor,
                       valid: torch.Tensor, dead: torch.Tensor,
                       key: torch.Tensor, params: IndexParams):
    """Per surviving in-neighbour u of a deleted x: walks from S random
    members of x's out-row, guided by u's vector, then ONE alive
    replacement z from the walk pool. Returns (u_flat, z_flat, u_valid).

    JAX picks the origins as the top-S of a per-lane Gumbel draw; Gumbel is
    monotone in the uniform draw, so the port ranks the draw's exact
    mantissa (ties, i.e. invalid entries, to the lowest position)."""
    d_out = state.d_out
    u_flat, su, cands, u_valid = _splice_lanes(state, ids, valid, dead)
    S = max(1, min(params.maintenance.rwalk_starts, d_out))
    n_lanes = u_flat.shape[0]
    lane_keys = prng.fold_in(key.to(state.device),
                             torch.arange(n_lanes, device=state.device))
    cv = cands != NULL
    cv = cv & state.present[torch.where(cv, cands, 0).long()]
    m = prng.uniform_mantissa(lane_keys, d_out)                  # [L, d_out]
    _, idx = top_k(torch.where(cv, m, -1), S)
    starts = torch.where(torch.gather(cv, 1, idx) & u_valid[:, None],
                         torch.gather(cands, 1, idx), NULL)
    # raw pools: tombstones steer the walk but are never selected
    u_vecs = state.vectors[su]
    res = search.beam_search(state, u_vecs, starts,
                             _rwalk_walk_params(params), raw=True)
    exclude = torch.cat([state.adj[su], su[:, None].to(torch.int32)], dim=1)
    z = select.select_from_pool(state, u_vecs, res.ids, 1, exclude=exclude,
                                keep_pruned=False)[:, 0]
    return u_flat, torch.where(u_valid, z, NULL), u_valid


def _rwalk_repair_apply(state, ids, valid, dead, key,
                        params: IndexParams) -> GraphState:
    u_flat, z_flat, u_valid = _rwalk_repair_plan(state, ids, valid, dead,
                                                 key, params)
    return _splice_apply(state, dead, u_flat, z_flat, u_valid)


# the repair appliers, keyed as the consolidation pass selects them; the
# caller supplies the ``dead`` mask, so they serve freshly marked deletions
# and long-lived tombstones alike
REPAIR_APPLIERS = {
    "local": _local_repair_apply,
    "global": _global_repair_apply,
    "rwalk": _rwalk_repair_apply,
}


def _repairing(strategy: str):
    def delete_fn(state, ids, valid, key, params: IndexParams) -> GraphState:
        valid = _precheck(state, ids, valid)
        _mark_dead(state, ids, valid)
        dead = _dead_mask(state, ids, valid)
        REPAIR_APPLIERS[strategy](state, ids, valid, dead, key, params)
        return _finalize_removal(state, ids, valid)
    delete_fn.__name__ = f"delete_{strategy}"
    return delete_fn


delete_local = _repairing("local")
delete_global = _repairing("global")
delete_rwalk = _repairing("rwalk")


# ---------------------------------------------------------------------------
# Sequential reference appliers — the parity oracle. Do not optimize.
# ---------------------------------------------------------------------------

def _splice_apply_reference(state: GraphState, u_flat: torch.Tensor,
                            x_flat: torch.Tensor, z_flat: torch.Tensor,
                            u_valid: torch.Tensor) -> GraphState:
    """Lane by lane: remove (u → x) first, which frees the row slot, then
    add (u → z) — in place."""
    lanes = zip(u_flat[u_valid].tolist(), x_flat[u_valid].tolist(),
                z_flat[u_valid].tolist())
    for u, x, z in lanes:
        remove_edge(state, u, x)
        if z != NULL:
            add_edge(state, u, z)
    return state


def _splice_delete_reference(state, ids, valid, plan) -> GraphState:
    """Mark, plan with ``plan(state, ids, valid, dead)``, splice lane by
    lane, free."""
    valid = _precheck(state, ids, valid)
    _mark_dead(state, ids, valid)
    dead = _dead_mask(state, ids, valid)
    u_flat, z_flat, u_valid = plan(state, ids, valid, dead)
    # the deleted vertex of every (u, x) lane
    x_flat = torch.where(valid, ids, 0).repeat_interleave(state.d_in)
    _splice_apply_reference(state, u_flat, x_flat, z_flat, u_valid)
    return _finalize_removal(state, ids, valid)


def delete_local_reference(state, ids, valid, key,
                           params: IndexParams) -> GraphState:
    """LOCAL's plan applied lane by lane (parity oracle)."""
    return _splice_delete_reference(state, ids, valid, _local_repair_plan)


def delete_rwalk_reference(state, ids, valid, key,
                           params: IndexParams) -> GraphState:
    """RWALK's plan applied lane by lane (parity oracle)."""
    return _splice_delete_reference(
        state, ids, valid,
        lambda st, i, v, dead: _rwalk_repair_plan(st, i, v, dead, key, params))


def delete_global_reference(state, ids, valid, key,
                            params: IndexParams) -> GraphState:
    """GLOBAL's plan applied row by row through ``set_out_edges``."""
    valid = _precheck(state, ids, valid)
    _mark_dead(state, ids, valid)
    dead = _dead_mask(state, ids, valid)
    u_flat, u_valid, new_nbrs = _global_repair_plan(state, ids, valid, dead,
                                                    key, params)
    for i in torch.nonzero(u_valid).flatten().tolist():
        set_out_edges(state, int(u_flat[i]), new_nbrs[i])
    return _finalize_removal(state, ids, valid)


_STRATEGY_FNS = {"pure": delete_pure, "mask": delete_mask,
                 "local": delete_local, "global": delete_global,
                 "rwalk": delete_rwalk,
                 "local_reference": delete_local_reference,
                 "global_reference": delete_global_reference,
                 "rwalk_reference": delete_rwalk_reference}


def delete_batch(state: GraphState, ids, valid, key: torch.Tensor,
                 strategy: str, params: IndexParams) -> GraphState:
    """Delete the valid lanes of ``ids`` with ``strategy`` — in place."""
    dev = state.device
    ids = torch.as_tensor(ids, dtype=torch.int32).to(dev)
    valid = torch.as_tensor(valid, dtype=torch.bool).to(dev)
    return _STRATEGY_FNS[strategy](state, ids, valid, key, params)
