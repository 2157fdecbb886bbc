"""GREEDY-SEARCH (Alg 1) — the batched beam engine of ``repro.core.search``.

All ``B`` query pools advance together: each trip takes the top
``beam_width`` unexpanded pool entries per query, gathers their
out-neighbourhoods into a ``[B, W·d_out]`` candidate block, dedups it against
the pool (the pool doubles as the visited set) and within the block, scores
it through ``kernels.ops.gather_scores`` (``gather_scores_q8`` on the
quantized walk) and merges it into the pools with the stable top-k.

``lax.while_loop`` becomes a host loop that tests the exit condition every
``_CHECK_EVERY`` trips rather than synchronising on every trip. It never runs
past ``max_steps``; a trip after every pool has drained changes nothing (its
lanes are NULL/-inf and sort after the pools' own -inf padding), so testing
late gives the same pools and hop counts.

``search_one``/``search_one_raw`` are B = 1 views of the batched engine.
The per-query reference engine of the JAX package (``*_reference``, one
node expanded per trip, a visited bitmap) is kept as the slow-path oracle
the parity tests pin the batched engine against. JAX vmaps it over
queries; here it runs batched, with a ``[B, capacity]`` bitmap and a mask
of the queries still walking, so each query stops on its own.

Entry points: lane ``i`` draws ``fold_in(key, offset + i)`` and takes the
``num_starts`` present slots with the largest Gumbel draw. Gumbel is a
monotone function of the uniform draw, so the port ranks the uniform
draw's integer mantissa (exact on every device) instead of re-deriving the
float logs, whose last bit differs between XLA and torch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distances, prng
from repro_torch.core.graph import NULL, GraphState
from repro_torch.core.params import SearchParams
from repro_torch.core.stable import argmax_first, top_k
from repro_torch.kernels import ops as kernel_ops

NEG_INF = float("-inf")
_ENTRY_ELEMS = 1 << 25   # lanes × capacity drawn per entry-point group
_CHECK_EVERY = 8         # beam-loop trips between host syncs on the exit test


class SearchResult(NamedTuple):
    ids: torch.Tensor         # i32[..., k]  NULL padded, score-descending
    scores: torch.Tensor      # f32[..., k]  -inf padded
    n_expanded: torch.Tensor  # i32[...]     hop count


def _rank_starts(state: GraphState, keys: torch.Tensor, num_starts: int
                 ) -> torch.Tensor:
    """Top-``num_starts`` present slots per key by uniform draw, ties to the
    lowest slot; non-present picks (fewer present than starts) → NULL."""
    cap = state.capacity
    m = prng.uniform_mantissa(keys, cap)                       # [L, cap]
    idx = torch.arange(cap, device=keys.device, dtype=torch.int64)
    score = torch.where(state.present, m, -1).to(torch.int64)
    comp = (score << 32) | (0xFFFFFFFF - idx)
    _, ids = torch.topk(comp, num_starts, dim=-1)
    ok = state.present[ids]
    return torch.where(ok, ids, NULL).to(torch.int32)


def entry_points(state: GraphState, key: torch.Tensor, num_starts: int
                 ) -> torch.Tensor:
    """``num_starts`` distinct present slots for one key: i32[S]."""
    return _rank_starts(state, key.to(state.device)[None], num_starts)[0]


def batch_entry_points(state: GraphState, key: torch.Tensor, batch: int,
                       num_starts: int, offset: int = 0,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """Entry points per lane, i32[B, S]: lane ``i`` uses
    ``fold_in(key, offset + i)``. Lanes where ``active`` is False get NULL
    starts (an empty walk); callers pass it for lanes whose results they
    discard, which saves the capacity-wide draw for them."""
    dev = state.device
    lanes = torch.arange(batch, device=dev, dtype=torch.int64) + int(offset)
    keys = prng.fold_in(key.to(dev), lanes)                    # [B, 2]
    out = torch.full((batch, num_starts), NULL, dtype=torch.int32, device=dev)
    todo = (torch.arange(batch, device=dev) if active is None
            else torch.nonzero(active).flatten())
    group = max(1, _ENTRY_ELEMS // max(state.capacity, 1))
    for lo in range(0, todo.shape[0], group):
        sel = todo[lo:lo + group]
        out[sel] = _rank_starts(state, keys[sel], num_starts)
    return out


def _score_block(state: GraphState, queries: torch.Tensor, ids: torch.Tensor,
                 valid: torch.Tensor, quantized: bool = False) -> torch.Tensor:
    """f32[B, C] scores of each query against its candidate block; invalid
    lanes → -inf (the kernels' id contract does the masking)."""
    masked = torch.where(valid, ids, NULL).to(torch.int32)
    if quantized:
        return kernel_ops.gather_scores_q8(state.codes, state.scales, masked,
                                           queries, metric=state.metric)
    return kernel_ops.gather_scores(state.vectors, state.sqnorms, masked,
                                    queries, metric=state.metric)


def _merge_pools(pool_ids, pool_scores, pool_exp, new_ids, new_scores, k):
    all_ids = torch.cat([pool_ids, new_ids.to(torch.int32)], dim=1)
    all_scores = torch.cat([pool_scores, new_scores], dim=1)
    all_exp = torch.cat([pool_exp, torch.zeros_like(new_ids, dtype=torch.bool)],
                        dim=1)
    top_scores, idx = top_k(all_scores, k)
    return (torch.gather(all_ids, 1, idx), top_scores,
            torch.gather(all_exp, 1, idx))


def beam_search(state: GraphState, queries: torch.Tensor,
                start_ids: torch.Tensor, params: SearchParams, *,
                raw: bool = False) -> SearchResult:
    """The batched beam engine (``repro.core.search.beam_search``).

    ``raw=True`` returns the unfiltered traversal pools (masked slots
    included, compressed scores on the quantized walk)."""
    dev = state.device
    queries = queries.to(dev, torch.float32)
    start_ids = start_ids.to(dev, torch.int32)
    B = queries.shape[0]
    K, W, d_out = params.pool_size, params.beam_width, state.d_out
    C = W * d_out
    S = start_ids.shape[1]
    quant = params.quantized

    # ---- seed the pools with the (deduped, present) entry points ----
    sv = start_ids != NULL
    sv = sv & state.present[torch.where(sv, start_ids, 0).long()]
    eq = (start_ids[:, :, None] == start_ids[:, None, :])
    eq = eq & sv[:, :, None] & sv[:, None, :]
    sv = sv & (argmax_first(eq, 2) == torch.arange(S, device=dev)[None, :])
    seed_scores = _score_block(state, queries, start_ids, sv, quant)
    pool_ids = torch.full((B, K), NULL, dtype=torch.int32, device=dev)
    pool_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    pool_exp = torch.zeros((B, K), dtype=torch.bool, device=dev)
    n_expanded = torch.zeros((B,), dtype=torch.int32, device=dev)
    pool_ids, pool_scores, pool_exp = _merge_pools(
        pool_ids, pool_scores, pool_exp, torch.where(sv, start_ids, NULL),
        seed_scores, K)

    arange_k = torch.arange(K, device=dev)
    tri = (torch.arange(C, device=dev)[:, None]
           > torch.arange(C, device=dev)[None, :]) if W > 1 else None
    for step in range(params.max_steps):
        if step % _CHECK_EVERY == 0:
            frontier_left = torch.any((pool_ids != NULL) & ~pool_exp)
            if not bool(frontier_left):
                break
        frontier = torch.where((pool_ids != NULL) & ~pool_exp, pool_scores,
                               NEG_INF)
        top_w, wi = top_k(frontier, W)                          # [B, W]
        valid_w = top_w > NEG_INF
        hit = torch.any((arange_k[None, None, :] == wi[:, :, None])
                        & valid_w[:, :, None], dim=1)
        pool_exp = pool_exp | hit
        cur = torch.gather(pool_ids, 1, wi)
        nbrs3 = state.adj[torch.where(valid_w, cur, 0).long()]  # [B, W, d_out]
        nv = ((nbrs3 != NULL) & valid_w[:, :, None]).reshape(B, C)
        nbrs = nbrs3.reshape(B, C)
        nv = nv & state.present[torch.where(nv, nbrs, 0).long()]
        nv = nv & ~torch.any(nbrs[:, :, None] == pool_ids[:, None, :], dim=2)
        if W > 1:
            dup = torch.any((nbrs[:, :, None] == nbrs[:, None, :])
                            & nv[:, None, :] & tri[None], dim=2)
            nv = nv & ~dup
        nscores = _score_block(state, queries, nbrs, nv, quant)
        n_expanded = n_expanded + valid_w.sum(dim=1, dtype=torch.int32)
        pool_ids, pool_scores, pool_exp = _merge_pools(
            pool_ids, pool_scores, pool_exp, torch.where(nv, nbrs, NULL),
            nscores, K)

    if raw:
        return SearchResult(pool_ids, pool_scores, n_expanded)
    ok = (pool_ids != NULL) & state.alive[pool_ids.clamp(min=0).long()]
    rep_scores = torch.where(ok, pool_scores, NEG_INF)

    if quant and params.rerank_depth > 0:
        # one exact fp32 pass over the top-r alive entries by compressed
        # score; the reported top-k comes from those r candidates only
        r = min(params.rerank_depth, K)
        top_comp, idx = top_k(rep_scores, r)
        cand = torch.gather(pool_ids, 1, idx)
        cv = top_comp > NEG_INF
        exact = _score_block(state, queries, cand, cv)
        exact = torch.where(cv, exact, NEG_INF)
        if r < K:
            exact = torch.cat([exact, torch.full((B, K - r), NEG_INF,
                                                 device=dev)], dim=1)
            cand = torch.cat([cand, torch.full((B, K - r), NULL,
                                               dtype=torch.int32, device=dev)],
                             dim=1)
        top_scores, idx2 = top_k(exact, K)
        rep_ids = torch.where(top_scores > NEG_INF,
                              torch.gather(cand, 1, idx2), NULL)
        return SearchResult(rep_ids, top_scores, n_expanded)

    top_scores, idx = top_k(rep_scores, K)
    rep_ids = torch.where(top_scores > NEG_INF,
                          torch.gather(pool_ids, 1, idx), NULL)
    return SearchResult(rep_ids, top_scores, n_expanded)


def search_batch(state: GraphState, queries, key: torch.Tensor,
                 params: SearchParams) -> SearchResult:
    """Batched greedy search reporting alive slots only, on the state's
    device."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(state.device)
    starts = batch_entry_points(state, key, q.shape[0], params.num_starts)
    return beam_search(state, q, starts, params)


def search_batch_raw(state: GraphState, queries, key: torch.Tensor,
                     params: SearchParams) -> SearchResult:
    """Unfiltered traversal pools (masked slots included)."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(state.device)
    starts = batch_entry_points(state, key, q.shape[0], params.num_starts)
    return beam_search(state, q, starts, params, raw=True)


def search_one(state: GraphState, q: torch.Tensor, start_ids: torch.Tensor,
               params: SearchParams) -> SearchResult:
    """Single-query view of the batched engine (B = 1)."""
    res = beam_search(state, q[None], start_ids[None], params)
    return SearchResult(res.ids[0], res.scores[0], res.n_expanded[0])


def search_one_raw(state: GraphState, q: torch.Tensor,
                   start_ids: torch.Tensor, params: SearchParams
                   ) -> SearchResult:
    res = beam_search(state, q[None], start_ids[None], params, raw=True)
    return SearchResult(res.ids[0], res.scores[0], res.n_expanded[0])


# ---------------------------------------------------------------------------
# Reference engine — the pre-refactor best-first walk of the JAX package,
# kept as the slow-path oracle of the parity tests. Do not optimize: it
# synchronises with the host on every trip.
# ---------------------------------------------------------------------------

class _LoopState(NamedTuple):
    pool_ids: torch.Tensor       # i32[B, k]
    pool_scores: torch.Tensor    # f32[B, k]
    pool_expanded: torch.Tensor  # bool[B, k]
    bitmap: torch.Tensor         # bool[B, capacity] — pushed at least once
    steps: torch.Tensor          # i32[B]


def _merge_pool_ref(pool: _LoopState, new_ids: torch.Tensor,
                    new_scores: torch.Tensor, k: int) -> _LoopState:
    ids, scores, exp = _merge_pools(pool.pool_ids, pool.pool_scores,
                                    pool.pool_expanded, new_ids, new_scores, k)
    return pool._replace(pool_ids=ids, pool_scores=scores, pool_expanded=exp)


def _score_new(state: GraphState, q: torch.Tensor, ids: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Each query ``q [B, d]`` against its gathered rows ``ids [B, n]``,
    plain (no kernel); invalid lanes → -inf."""
    safe = torch.where(valid, ids, 0).long()
    s = distances.scores_vs_rows(state.vectors[safe], state.sqnorms[safe], q,
                                 state.metric)
    return torch.where(valid, s, NEG_INF)


def _mark(bitmap: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor
          ) -> None:
    """``bitmap[b, ids[b, j]] = True`` for every valid lane — in place."""
    rows, cols = torch.nonzero(valid, as_tuple=True)
    bitmap[rows, ids[rows, cols].long()] = True


def _run_loop(state: GraphState, q: torch.Tensor, start_ids: torch.Tensor,
              params: SearchParams) -> _LoopState:
    """The best-first walk of every query ``q [B, d]`` from its starts
    ``[B, S]``: each trip expands the first best unexpanded pool entry,
    pushes its present neighbours not yet in the query's bitmap, and merges
    them with the stable top-k. A query stops when its frontier is empty or
    after ``max_steps`` trips; ``steps`` counts its own trips."""
    dev = state.device
    q = q.to(dev, torch.float32)
    start_ids = start_ids.to(dev, torch.int32)
    B, k = q.shape[0], params.pool_size

    sv = start_ids != NULL
    sv = sv & state.present[torch.where(sv, start_ids, 0).long()]
    seed_scores = _score_new(state, q, start_ids, sv)
    bitmap = torch.zeros((B, state.capacity), dtype=torch.bool, device=dev)
    _mark(bitmap, start_ids, sv)
    pool = _LoopState(
        pool_ids=torch.full((B, k), NULL, dtype=torch.int32, device=dev),
        pool_scores=torch.full((B, k), NEG_INF, dtype=torch.float32,
                               device=dev),
        pool_expanded=torch.zeros((B, k), dtype=torch.bool, device=dev),
        bitmap=bitmap,
        steps=torch.zeros((B,), dtype=torch.int32, device=dev))
    pool = _merge_pool_ref(pool, torch.where(sv, start_ids, NULL),
                           seed_scores, k)

    rows = torch.arange(B, device=dev)
    while True:
        open_ = (pool.pool_ids != NULL) & ~pool.pool_expanded
        active = torch.any(open_, dim=1) & (pool.steps < params.max_steps)
        if not bool(active.any()):
            return pool
        frontier = torch.where(open_, pool.pool_scores, NEG_INF)
        # jnp.argmax: the first maximum
        best = argmax_first(frontier == frontier.max(dim=1, keepdim=True)
                            .values, 1)
        cur = pool.pool_ids[rows, best]
        expanded = pool.pool_expanded.clone()
        expanded[rows, best] = True        # inactive rows are restored below

        nbrs = state.adj[cur.clamp(min=0).long()]              # [B, d_out]
        nv = (nbrs != NULL) & active[:, None]
        safe = torch.where(nv, nbrs, 0).long()
        nv = nv & state.present[safe] & ~torch.gather(pool.bitmap, 1, safe)
        nscores = _score_new(state, q, nbrs, nv)
        _mark(pool.bitmap, nbrs, nv)

        stepped = pool._replace(pool_expanded=expanded,
                                steps=pool.steps + active.to(torch.int32))
        stepped = _merge_pool_ref(stepped, torch.where(nv, nbrs, NULL),
                                  nscores, k)
        keep = active[:, None]
        pool = stepped._replace(
            pool_ids=torch.where(keep, stepped.pool_ids, pool.pool_ids),
            pool_scores=torch.where(keep, stepped.pool_scores,
                                    pool.pool_scores),
            pool_expanded=torch.where(keep, stepped.pool_expanded,
                                      pool.pool_expanded))


def _report_alive(state: GraphState, pool: _LoopState, k: int
                  ) -> SearchResult:
    ids = pool.pool_ids
    ok = (ids != NULL) & state.alive[ids.clamp(min=0).long()]
    top_scores, idx = top_k(torch.where(ok, pool.pool_scores, NEG_INF), k)
    rep_ids = torch.where(top_scores > NEG_INF, torch.gather(ids, 1, idx),
                          NULL)
    return SearchResult(rep_ids, top_scores, pool.steps)


def search_one_reference(state: GraphState, q: torch.Tensor,
                         start_ids: torch.Tensor, params: SearchParams
                         ) -> SearchResult:
    """Single-query reference walk reporting alive slots only."""
    res = _report_alive(state, _run_loop(state, q[None], start_ids[None],
                                         params), params.pool_size)
    return SearchResult(res.ids[0], res.scores[0], res.n_expanded[0])


def search_one_reference_raw(state: GraphState, q: torch.Tensor,
                             start_ids: torch.Tensor, params: SearchParams
                             ) -> SearchResult:
    """Unfiltered reference traversal pool (masked slots included)."""
    pool = _run_loop(state, q[None], start_ids[None], params)
    return SearchResult(pool.pool_ids[0], pool.pool_scores[0], pool.steps[0])


def search_batch_reference(state: GraphState, queries, key: torch.Tensor,
                           params: SearchParams) -> SearchResult:
    """The reference walk of every query from ``batch_entry_points``,
    reporting alive slots only."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(state.device)
    starts = batch_entry_points(state, key, q.shape[0], params.num_starts)
    return _report_alive(state, _run_loop(state, q, starts, params),
                         params.pool_size)


def search_batch_reference_raw(state: GraphState, queries, key: torch.Tensor,
                               params: SearchParams) -> SearchResult:
    """Unfiltered reference traversal pools (masked slots included)."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(state.device)
    starts = batch_entry_points(state, key, q.shape[0], params.num_starts)
    pool = _run_loop(state, q, starts, params)
    return SearchResult(pool.pool_ids, pool.pool_scores, pool.steps)
