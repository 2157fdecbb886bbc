"""SELECT-NEIGHBORS (Alg 2) — the diversity heuristic, batched over rows.

Port of ``repro.core.select``: scan candidates in order of proximity to
``x``; keep ``y`` iff ``f(y, x) >= f(y, z)`` for every already-selected
``z`` (both scored with y in the query role, so the norm offsets cancel).
JAX vmaps a ``fori_loop`` over candidates per row; here the scan is a loop
over candidate rank, vectorised across all rows at once. The ``[R, n, n]``
pair matrix goes through ``distances.score_matrix``: one launch of the
hand-written ``score_matrix`` kernel for all R rows on the card.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.core import distances
from repro_torch.core.graph import NULL
from repro_torch.core.stable import argmax_first, top_k

NEG_INF = float("-inf")


@tracing.spanned("graph.select")
def select_neighbors(x_vec: torch.Tensor, cand_ids: torch.Tensor,
                     cand_vecs: torch.Tensor, cand_valid: torch.Tensor,
                     d: int, metric: str, keep_pruned: bool = False
                     ) -> torch.Tensor:
    """Rows ``x_vec [R, dim]``, candidates ``cand_ids [R, n]`` with vectors
    ``[R, n, dim]`` and validity ``[R, n]`` → i32[R, d] selected ids, NULL
    padded, proximity-descending."""
    R, n = cand_ids.shape
    dev = cand_ids.device
    x32 = x_vec.float()
    v32 = cand_vecs.float()
    dots = torch.bmm(v32, x32[:, :, None])[..., 0]             # [R, n]
    if metric == "l2":
        order_key = 2.0 * dots - distances.sqnorm(v32)          # x as query
        chk_to_x = 2.0 * dots - distances.sqnorm(x32)[:, None]  # y as query
    else:
        order_key = dots
        chk_to_x = dots

    order_key = torch.where(cand_valid, order_key, NEG_INF)
    okey_o, order = top_k(order_key, n)
    ids_o = torch.where(okey_o > NEG_INF,
                        torch.gather(cand_ids.to(torch.int32), 1, order), NULL)
    vecs_o = torch.gather(v32, 1, order[:, :, None].expand(R, n, v32.shape[2]))
    chk_o = torch.gather(chk_to_x, 1, order)
    valid_o = ids_o != NULL

    # pair[r, i, j] = f(y_i as query, y_j)
    pair = distances.score_matrix(vecs_o, distances.sqnorm(vecs_o), vecs_o,
                                  metric)                       # [R, n, n]
    selected = torch.zeros((R, n), dtype=torch.bool, device=dev)
    count = torch.zeros((R,), dtype=torch.int32, device=dev)
    for i in range(n):
        dominated = torch.any(selected & (pair[:, i, :] > chk_o[:, i:i + 1]),
                              dim=1)
        take = valid_o[:, i] & ~dominated & (count < d)
        selected[:, i] = take
        count = count + take.to(torch.int32)

    m = min(d, n)
    rank = torch.where(selected, okey_o, NEG_INF)
    top_scores, idx = top_k(rank, m)
    out = torch.where(top_scores > NEG_INF, torch.gather(ids_o, 1, idx), NULL)
    if keep_pruned:
        rank2 = torch.where(valid_o & ~selected, okey_o, NEG_INF)
        fs, fi = top_k(rank2, m)
        fill = torch.where(fs > NEG_INF, torch.gather(ids_o, 1, fi), NULL)
        pos = torch.arange(m, device=dev)[None, :]
        take_fill = torch.clamp(pos - count[:, None], 0, m - 1)
        out = torch.where(pos < count[:, None], out,
                          torch.gather(fill, 1, take_fill))
    if d > n:
        out = torch.cat([out, torch.full((R, d - n), NULL, dtype=torch.int32,
                                         device=dev)], dim=1)
    return out.to(torch.int32)


def select_from_pool(state, x_vec: torch.Tensor, cand_ids: torch.Tensor,
                     d: int, exclude: torch.Tensor | None = None,
                     require_alive: bool = True, keep_pruned: bool = True,
                     ) -> torch.Tensor:
    """Gather + validate candidate pools ``[R, n]`` from the graph, then
    select: i32[R, d]. ``exclude [R, m]`` is each row's invalid set I."""
    cand_ids = cand_ids.to(torch.int32)
    valid = cand_ids != NULL
    safe = torch.where(valid, cand_ids, 0).long()
    valid = valid & (state.alive[safe] if require_alive else state.present[safe])
    if exclude is not None:
        valid = valid & ~torch.any(
            cand_ids[:, :, None] == exclude.to(torch.int32)[:, None, :], dim=2)
    eq = cand_ids[:, :, None] == cand_ids[:, None, :]
    first = argmax_first(eq, 2) == torch.arange(
        cand_ids.shape[1], device=cand_ids.device)[None, :]
    valid = valid & first
    vecs = state.vectors[safe]
    return select_neighbors(x_vec, cand_ids, vecs, valid, d, state.metric,
                            keep_pruned=keep_pruned)
