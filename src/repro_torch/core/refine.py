"""OP_REFINE — background refinement of stale rows (``repro.core.refine``).

:func:`stalest_slots` picks the alive slots whose out-rows were rewritten
longest ago (lowest ``touch`` stamp, invariant I7); :func:`refine_chunk_impl`
re-searches their own vectors through the batched beam engine at
construction quality, re-runs SELECT-NEIGHBORS over the search pool unioned
with the current out-row and applies the winners through
``set_out_edges_batch``, which bumps their stamps. Refinement rewires edges
only: alive/present sets, ``size``, vectors, codes and insertion stamps are
untouched. Its keys come from the REFINE chain of ``core/maint.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import search, select
from repro_torch.core.graph import NULL, GraphState, set_out_edges_batch
from repro_torch.core.params import IndexParams

_NEVER = 2**31 - 1     # stale key of a non-alive slot: never picked


def stalest_slots(state: GraphState, n: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ≤ n stalest alive slots in a fixed frame: (ids i32[n] NULL
    padded, valid bool[n]), ascending ``touch``, ties to the lowest id.

    JAX takes the head of a stable argsort over capacity; the n smallest of
    the unique key (touch, id) are the same slots in the same order."""
    cap = state.capacity
    take = min(n, cap)
    dev = state.device
    stale = torch.where(state.alive, state.touch, _NEVER).to(torch.int64)
    comp = (stale << 32) | torch.arange(cap, device=dev, dtype=torch.int64)
    _, ids = torch.topk(comp, take, largest=False, sorted=True)
    valid = state.alive[ids]
    ids = torch.where(valid, ids, NULL).to(torch.int32)
    if n > cap:
        ids = torch.cat([ids, torch.full((n - cap,), NULL, dtype=torch.int32,
                                         device=dev)])
        valid = torch.cat([valid, torch.zeros((n - cap,), dtype=torch.bool,
                                              device=dev)])
    return ids, valid


def refine_chunk_impl(state: GraphState, ids: torch.Tensor,
                      valid: torch.Tensor, key: torch.Tensor,
                      params: IndexParams) -> tuple[GraphState, torch.Tensor]:
    """Refine one chunk of slots ``ids i32[B]`` — in place. Lanes that are
    not alive are dropped. Returns (state, n_refined i32[])."""
    sp = params.eff_insert_search
    valid = valid & (ids != NULL)
    safe = torch.where(valid, ids, 0).long()
    valid = valid & state.alive[safe]
    B = ids.shape[0]
    vecs = state.vectors[safe]
    starts = search.batch_entry_points(state, key, B, sp.num_starts,
                                       active=valid)
    res = search.beam_search(state, vecs, starts, sp)
    cands = torch.cat([res.ids, state.adj[safe]], dim=1)       # [B, K+d_out]
    new_rows = select.select_from_pool(state, vecs, cands, params.d_out,
                                       exclude=safe[:, None])
    new_rows = torch.where(valid[:, None], new_rows, NULL)
    set_out_edges_batch(state, ids, new_rows, valid)
    return state, valid.sum(dtype=torch.int32)
