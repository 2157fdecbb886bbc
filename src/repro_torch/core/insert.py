"""Batched vertex insertion (Alg 3, Insert branch) — ``repro.core.insert``.

One pipeline per micro-batch: allocate the lowest free slots in lane order,
run ONE beam search for the batch against the pre-batch snapshot, write the
vertices, select each new row's neighbours over its pool plus the batch's
own slots, then apply forward rows and back-links (NSW/HNSW bidirectional
practice) in one ``set_out_edges_batch`` call. The state is updated in
place where JAX donates it.

The sequential path of the JAX package is kept as the parity oracle:
``insert_one`` (search → select → connect, one vertex, back-links through
the scalar edge primitives, shrinking a full row by SELECT-NEIGHBORS) and
``insert_batch_reference``, which inserts a batch one row at a time so row
i + 1 may link to row i.
"""
from __future__ import annotations

import torch

from repro_torch.core import distances, quantize, search, select
from repro_torch.core import prng
from repro_torch.core.graph import (
    NULL,
    GraphState,
    add_edge,
    group_by_destination,
    next_free_slot,
    pack_rows,
    set_out_edges,
    set_out_edges_batch,
)
from repro_torch.core.params import IndexParams
from repro_torch.core.stable import set_drop, top_k


def insert_batch_impl(state: GraphState, vecs: torch.Tensor,
                      valid: torch.Tensor, key: torch.Tensor,
                      params: IndexParams, key_offset: int = 0
                      ) -> tuple[GraphState, torch.Tensor]:
    """Insert the valid rows of ``vecs [B, dim]`` — in place. Returns
    ``(state, slots i32[B])`` with NULL where a row was not inserted (an
    invalid lane, or no free slot left). Row ``i`` searches with
    ``fold_in(key, key_offset + i)``, so a padded micro-batch behaves like
    its unpadded twin."""
    dev = state.device
    vecs = vecs.to(dev, torch.float32)
    valid = valid.to(dev)
    B = vecs.shape[0]
    sp = params.eff_insert_search
    d_out, cap = params.d_out, state.capacity

    # ---- phase 1: the i-th valid row takes the i-th lowest free slot ----
    free_ids = torch.nonzero(~state.present).flatten()[:B]
    n_free = free_ids.shape[0]
    alloc_rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    ok = valid & (alloc_rank < n_free)
    pick = torch.where(ok, alloc_rank, 0)
    slots = (torch.where(ok, free_ids[pick.clamp(max=max(n_free - 1, 0))],
                         NULL) if n_free else
             torch.full((B,), NULL, dtype=torch.int64, device=dev))
    slots = slots.to(torch.int32)

    # ---- phase 2: one ef-search for the batch (pre-batch snapshot) ----
    starts = search.batch_entry_points(state, key, B, sp.num_starts,
                                       offset=key_offset, active=ok)
    res = search.beam_search(state, vecs, starts, sp)

    # ---- phase 3: write the vertices (codes in the same transaction, I5);
    # cast to the table's dtype first, so a bf16 state's norms and codes are
    # those of its bf16 rows (JAX's order) ----
    vec_cast = vecs.to(state.vectors.dtype)
    if params.metric == "cos":
        vec_cast = distances.normalize(vec_cast)
    code_rows, code_scales = quantize.quantize_rows(vec_cast)
    n_ok = ok.sum(dtype=torch.int32)
    set_drop(state.vectors, slots, vec_cast, ok)
    set_drop(state.sqnorms, slots, distances.sqnorm(vec_cast), ok)
    set_drop(state.codes, slots, code_rows, ok)
    set_drop(state.scales, slots, code_scales, ok)
    set_drop(state.alive, slots, True, ok)
    set_drop(state.present, slots, True, ok)
    set_drop(state.stamps, slots, state.clock + alloc_rank, ok)
    state.size += n_ok
    state.clock += n_ok

    # ---- phase 4: SELECT-NEIGHBORS with intra-batch candidates ----
    cands = torch.cat([res.ids, slots[None, :].expand(B, B)], dim=1)
    nbrs = select.select_from_pool(state, vecs, cands, d_out,
                                   exclude=slots[:, None])
    nbrs = torch.where(ok[:, None], nbrs, NULL)

    if not params.bidirectional_insert:
        set_out_edges_batch(state, slots, nbrs, ok)
        return state, slots

    # ---- phase 5: back-links grouped by target z, computed against the
    # virtual post-forward view, applied with the forward rows in one call
    src = slots[:, None].expand(B, d_out).reshape(-1)
    dst = nbrs.reshape(-1)
    bl, touched_z = group_by_destination(src, dst, dst != NULL, cap, d_out)
    R_z = min(B * d_out, cap)
    _, zid = top_k(touched_z.to(torch.int32), R_z)
    z_ok = touched_z[zid]
    zv = torch.where(z_ok, zid, 0)
    row_of_slot = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    set_drop(row_of_slot, slots, torch.arange(B, device=dev), ok)
    sidx = row_of_slot[zv]
    old_z = torch.where((sidx >= 0)[:, None], nbrs[sidx.clamp(min=0)],
                        state.adj[zv])                       # [R_z, d_out]
    bl_rows = bl[zv]
    dup = torch.any(bl_rows[:, :, None] == old_z[:, None, :], dim=2) & (
        bl_rows != NULL)
    bl_rows = torch.where(dup, NULL, bl_rows)
    comb = torch.cat([old_z, bl_rows], dim=1)                # [R_z, 2·d_out]
    counts = torch.sum(comb != NULL, dim=1)
    packed = pack_rows(comb)[:, :d_out]
    needs_shrink = counts > d_out
    shrunk = select.select_from_pool(state, state.vectors[zv], comb, d_out,
                                     exclude=zv[:, None], require_alive=False)
    z_rows = torch.where(needs_shrink[:, None], shrunk, packed)

    # where z is itself a new slot, its z row (forward ∪ back-links)
    # supersedes the slot lane
    slot_valid = ok & ~touched_z[torch.where(ok, slots, 0).long()]
    us_all = torch.cat([slots.long(), zid])
    rows_all = torch.cat([nbrs, z_rows], dim=0)
    valid_all = torch.cat([slot_valid, z_ok])
    set_out_edges_batch(state, us_all, rows_all, valid_all)
    return state, slots


def insert_batch(state: GraphState, vecs, valid, key: torch.Tensor,
                 params: IndexParams) -> tuple[GraphState, torch.Tensor]:
    """Vectorized batch insertion — updates ``state`` in place."""
    vecs = torch.as_tensor(vecs, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool)
    return insert_batch_impl(state, vecs, valid, key, params)


# ---------------------------------------------------------------------------
# Reference sequential path — the parity oracle. Do not optimize.
# ---------------------------------------------------------------------------

def _connect_backward(state: GraphState, z: int, new_id: int) -> GraphState:
    """Add z→new, shrinking z's row by SELECT-NEIGHBORS over (row ∪ new)
    when it is full; existing neighbours stay eligible even if masked — in
    place."""
    if not bool(torch.any(state.adj[z] == NULL)):
        cands = torch.cat([state.adj[z], state.adj.new_tensor([new_id])])
        picked = select.select_from_pool(
            state, state.vectors[z][None], cands[None], state.d_out,
            exclude=state.adj.new_tensor([[z]]), require_alive=False)[0]
        return set_out_edges(state, z, picked)
    return add_edge(state, z, new_id)


def insert_one(state: GraphState, vec: torch.Tensor, key: torch.Tensor,
               params: IndexParams) -> tuple[GraphState, torch.Tensor]:
    """Insert one vector ``vec [dim]`` into the lowest free slot — in place.
    Returns (state, new_id), new_id NULL when the graph is full. The
    ef-search is the batched engine at B = 1."""
    dev = state.device
    vec = vec.to(dev, torch.float32)
    sp = params.eff_insert_search
    slot = int(next_free_slot(state))
    ok = not bool(state.present[slot])

    starts = search.entry_points(state, key, sp.num_starts)
    res = search.beam_search(state, vec[None], starts[None], sp)
    nbrs = select.select_from_pool(
        state, vec[None], res.ids, params.d_out,
        exclude=torch.tensor([[slot]], dtype=torch.int32, device=dev))[0]
    if not ok:
        return state, torch.tensor(NULL, dtype=torch.int32, device=dev)

    # as a one-row batch, so the bytes are the batched path's
    vec_cast = vec[None].to(state.vectors.dtype)
    if params.metric == "cos":
        vec_cast = distances.normalize(vec_cast)
    code_row, code_scale = quantize.quantize_rows(vec_cast)
    state.vectors[slot] = vec_cast[0]
    state.sqnorms[slot] = distances.sqnorm(vec_cast)[0]
    state.codes[slot] = code_row[0]
    state.scales[slot] = code_scale[0]
    state.alive[slot] = True
    state.present[slot] = True
    state.stamps[slot] = state.clock
    state.size += 1
    state.clock += 1

    set_out_edges(state, slot, nbrs)
    if params.bidirectional_insert:
        for z in nbrs[: params.d_out].tolist():
            if z != NULL:
                _connect_backward(state, z, slot)
    return state, torch.tensor(slot, dtype=torch.int32, device=dev)


def insert_batch_reference_impl(state: GraphState, vecs: torch.Tensor,
                                valid: torch.Tensor, key: torch.Tensor,
                                params: IndexParams
                                ) -> tuple[GraphState, torch.Tensor]:
    """Sequential insertion of the valid rows of ``vecs [B, dim]`` (row i
    draws with ``fold_in(key, i)``) — in place. Returns (state, ids i32[B])."""
    dev = state.device
    ids = torch.full((vecs.shape[0],), NULL, dtype=torch.int32, device=dev)
    for i, v in enumerate(torch.as_tensor(valid).tolist()):
        if v:
            _, ids[i] = insert_one(state, vecs[i], prng.fold_in(key, i),
                                   params)
    return state, ids


def insert_batch_reference(state: GraphState, vecs, valid, key: torch.Tensor,
                           params: IndexParams
                           ) -> tuple[GraphState, torch.Tensor]:
    vecs = torch.as_tensor(vecs, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool)
    return insert_batch_reference_impl(state, vecs, valid, key, params)
