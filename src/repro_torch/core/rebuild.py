"""Graph construction — ``repro.core.rebuild``.

``build_graph`` is the paper's incremental constructor: chunked batch
inserts, each chunk searching the graph built so far.

``bulk_knn_build`` builds from an exact kNN, for the ReBuild baseline and
large indexes.

JAX forms the dense ``[n, n]`` score matrix and vmaps SELECT-NEIGHBORS over
all n rows; at n = 10^6 that matrix alone is 4 TB. The port takes the kNN
in row blocks through ``kernels.ops.score_topk`` over the valid rows
(compacted in id order), asks for ``k_nn + 1`` neighbours and drops each
row's own entry — the same set and tie order as masking the diagonal, since
ties go to the lowest id either way — then selects in row chunks. The
reverse rows come from one stable argsort over the n·d_out forward edges.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import distances, insert, prng, quantize, select
from repro_torch.core.graph import NULL, GraphState, init_graph
from repro_torch.core.params import IndexParams
from repro_torch.kernels import ops as kernel_ops

KNN_ROW_BLOCK = 16384
SELECT_ROW_BLOCK = 16384


def exact_knn(vecs: torch.Tensor, sq: torch.Tensor, rows: torch.Tensor,
              k: int, metric: str) -> torch.Tensor:
    """i32[len(rows), k]: the k best rows of ``vecs`` for each row id in
    ``rows`` (ids into ``vecs``), excluding the row itself; NULL padded."""
    n = vecs.shape[0]
    out = torch.full((rows.shape[0], k), NULL, dtype=torch.int32,
                     device=vecs.device)
    kk = min(k + 1, n)
    for lo in range(0, rows.shape[0], KNN_ROW_BLOCK):
        r = rows[lo:lo + KNN_ROW_BLOCK]
        s, i = kernel_ops.score_topk(vecs, sq, vecs[r], kk, metric=metric)
        i = torch.where(s > float("-inf"), i, NULL)
        is_self = i == r[:, None].to(torch.int32)
        # drop the self entry, or the last entry when self fell outside
        drop = torch.where(is_self.any(1), is_self.to(torch.int8).argmax(1),
                           kk - 1)
        keep = torch.arange(kk, device=i.device)[None, :] != drop[:, None]
        kept = i[keep].reshape(r.shape[0], kk - 1)
        out[lo:lo + r.shape[0], : kk - 1] = kept[:, :k]
    return out


def build_graph(vectors, key: torch.Tensor, params: IndexParams,
                chunk: int = 64, device=None) -> GraphState:
    """Incremental construction: chunk ``i`` of ``vectors`` is inserted with
    ``fold_in(key, i)`` against the graph built so far."""
    dev = resolve_device(device)
    vecs = torch.as_tensor(np.asarray(vectors, np.float32)).to(dev)
    state = init_graph(params.capacity, params.dim, d_out=params.d_out,
                       d_in=params.eff_d_in, metric=params.metric, device=dev)
    n = vecs.shape[0]
    for i, lo in enumerate(range(0, n, chunk)):
        part = torch.zeros((chunk, vecs.shape[1]), dtype=torch.float32,
                           device=dev)
        part[:min(chunk, n - lo)] = vecs[lo:lo + chunk]
        valid = torch.arange(chunk, device=dev) < (n - lo)
        insert.insert_batch(state, part, valid, prng.fold_in(key, i), params)
    return state


def bulk_knn_build(vectors, valid, params: IndexParams, k_nn: int = 64,
                   device=None) -> GraphState:
    """Exact-kNN bulk build into a fresh state of ``params.capacity`` slots:
    rows ``[0, n)`` take ``vectors`` where ``valid`` (numpy arrays or
    tensors)."""
    dev = resolve_device(device)
    vecs = torch.as_tensor(vectors, dtype=torch.float32).to(dev)
    valid = torch.as_tensor(valid, dtype=torch.bool).to(dev)
    n, dim = vecs.shape
    state = init_graph(params.capacity, dim, d_out=params.d_out,
                       d_in=params.eff_d_in, metric=params.metric, device=dev)
    vec_cast = distances.normalize(vecs) if params.metric == "cos" else vecs
    sq = distances.sqnorm(vec_cast)
    code_rows, code_scales = quantize.quantize_rows(vec_cast)
    v2 = valid[:, None]
    state.vectors[:n] = torch.where(v2, vec_cast, 0.0)
    state.sqnorms[:n] = torch.where(valid, sq, 0.0)
    state.codes[:n] = torch.where(v2, code_rows, 0)
    state.scales[:n] = torch.where(valid, code_scales, 0.0)
    state.alive[:n] = valid
    state.present[:n] = valid
    n_valid = valid.sum(dtype=torch.int32)
    state.size.copy_(n_valid)
    state.stamps[:n] = torch.where(valid, torch.cumsum(valid.int(), 0) - 1, -1)
    state.clock.copy_(n_valid)
    state.touch[:n] = torch.where(valid, 0, -1)
    state.tclock.fill_(1)

    # ---- exact kNN among the valid rows (self and invalid rows excluded)
    vid = torch.nonzero(valid).flatten()
    comp_vecs = vec_cast[vid].contiguous()
    comp_sq = sq[vid].contiguous()
    k = min(k_nn, n)
    local = exact_knn(comp_vecs, comp_sq,
                      torch.arange(vid.shape[0], device=dev), k, params.metric)
    cand_ids = torch.where(local != NULL, vid.to(torch.int32)[local.clamp(min=0)
                                                               .long()], NULL)

    # ---- SELECT-NEIGHBORS per valid row, in row chunks
    nbrs = torch.full((n, params.d_out), NULL, dtype=torch.int32, device=dev)
    for lo in range(0, vid.shape[0], SELECT_ROW_BLOCK):
        rows = vid[lo:lo + SELECT_ROW_BLOCK]
        nbrs[rows] = select.select_from_pool(
            state, vec_cast[rows], cand_ids[lo:lo + SELECT_ROW_BLOCK],
            params.d_out, exclude=rows[:, None])

    # ---- reverse rows from the forward edges: keep the first d_in in-edges
    # per target in flat order, drop the overflow from adj too (I1)
    src = torch.arange(n, device=dev)[:, None].expand(n, params.d_out).reshape(-1)
    dst = nbrs.reshape(-1).long()
    ok = dst != NULL
    key_dst = torch.where(ok, dst, n)
    order = torch.argsort(key_dst, stable=True)
    sorted_key = key_dst[order]
    first_pos = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev) - first_pos
    keep = ok & (rank < state.d_in)
    state.radj[dst[keep], rank[keep]] = src[keep].to(torch.int32)
    nbrs.view(-1)[ok & (rank >= state.d_in)] = NULL
    state.adj[:n] = nbrs
    return state
