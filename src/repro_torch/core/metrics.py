"""Recall and ground truth (§6 "Retrieval Recall") — ``repro.core.metrics``."""
from __future__ import annotations

import torch

from repro_torch.core.graph import NULL, GraphState
from repro_torch.kernels import ops as kernel_ops

NEG_INF = float("-inf")


def brute_force_topk(state: GraphState, queries, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over alive slots: (scores f32[B, k], ids i32[B, k]).

    The alive rows are gathered in id order and scored through
    ``kernels.ops.score_topk``; positions map back to slot ids, so ties
    still go to the lowest id and missing entries are (-inf, NULL). A state
    with no alive slot returns only missing entries."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(state.device)
    alive_ids = torch.nonzero(state.alive).flatten()
    if alive_ids.numel() == 0:
        return (torch.full((q.shape[0], k), NEG_INF, device=state.device),
                torch.full((q.shape[0], k), NULL, dtype=torch.int32,
                           device=state.device))
    x = state.vectors[alive_ids].contiguous()
    xsq = state.sqnorms[alive_ids].contiguous()
    s, pos = kernel_ops.score_topk(x, xsq, q, k, metric=state.metric)
    ok = pos >= 0
    ids = torch.where(ok, alive_ids.to(torch.int32)[pos.clamp(min=0).long()],
                      NULL)
    return torch.where(ok, s, NEG_INF), ids


def recall_at_k(found_ids: torch.Tensor, true_ids: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Mean |found ∩ true| / |true| over the batch (paper's recall)."""
    f = found_ids[:, :k]
    hits = (f[:, :, None] == true_ids[:, None, :]) & (
        true_ids[:, None, :] != NULL)
    n_hits = torch.sum(torch.any(hits, dim=1), dim=1)
    n_true = torch.clamp(torch.sum(true_ids != NULL, dim=1), min=1)
    return torch.mean(n_hits / n_true)
