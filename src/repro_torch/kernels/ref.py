"""Plain PyTorch versions of the hand-written kernels.

Each computes, step by step, the same function as its CUDA kernel and as
the Pallas kernel it replaces, including the wrapper contract: an id < 0
or ≥ N scores -inf, and ``score_topk`` reports missing entries as
(-inf, -1). The wrappers in ``kernels/ops.py`` take these for CPU tensors
only; ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.stable import top_k

NEG_INF = float("-inf")


def _valid_ids(ids: torch.Tensor, n: int):
    valid = (ids >= 0) & (ids < n)
    return valid, torch.where(valid, ids, 0).long()


def gather_scores(table, tsq, ids, q, metric: str = "l2") -> torch.Tensor:
    """[B, C]: ``2<table[id], q[b]> - tsq[id]`` (l2) or ``<table[id], q[b]>``
    (ip/cos) per (b, c); invalid ids → -inf. A bf16 table's rows are
    widened to f32 (exact) before the product, as the Pallas kernel does."""
    valid, safe = _valid_ids(ids, table.shape[0])
    rows = table[safe].float()                                  # [B, C, d]
    dots = torch.bmm(rows, q.float()[:, :, None])[..., 0]
    s = 2.0 * dots - tsq[safe].float() if metric == "l2" else dots
    return torch.where(valid, s, NEG_INF)


def gather_scores_q8(codes, scales, ids, q, metric: str = "l2"
                     ) -> torch.Tensor:
    """[B, C] asymmetric scores over int8 codes: ``s·(2<c,q> − s·Σc²)``
    (l2) or ``s·<c,q>``; invalid ids → -inf."""
    valid, safe = _valid_ids(ids, codes.shape[0])
    rows = codes[safe].float()                                  # [B, C, d]
    s = scales[safe].float()
    dots = torch.bmm(rows, q.float()[:, :, None])[..., 0]
    if metric == "l2":
        out = s * (2.0 * dots - s * torch.sum(rows * rows, dim=-1))
    else:
        out = s * dots
    return torch.where(valid, out, NEG_INF)


def score_matrix(x, xsq, q, metric: str = "l2") -> torch.Tensor:
    """f32 ``[..., B, M]``: ``2<q, x> - xsq`` (l2) or ``<q, x>`` (ip/cos),
    batched over the leading axes; bf16 inputs are widened to f32 first."""
    dots = q.float() @ x.float().transpose(-1, -2)
    if metric == "l2":
        return 2.0 * dots - xsq.float()[..., None, :]
    return dots


def score_topk(x, xsq, q, k: int, metric: str = "l2",
               n_valid: int | None = None):
    """Exact top-k of the [B, M] score matrix over rows ``< n_valid``:
    (scores f32[B, k], ids i32[B, k]), ties to the lowest id, missing
    entries (-inf, -1)."""
    M = x.shape[0]
    n_valid = M if n_valid is None else min(n_valid, M)
    dots = q.float() @ x.float().T
    s = 2.0 * dots - xsq.float()[None, :] if metric == "l2" else dots
    s = torch.where(torch.arange(M, device=x.device)[None, :] < n_valid,
                    s, NEG_INF)
    if k > M:
        pad = torch.full((s.shape[0], k - M), NEG_INF, device=s.device)
        s = torch.cat([s, pad], dim=1)
    top_s, top_i = top_k(s, k)
    ok = top_s > NEG_INF
    return (torch.where(ok, top_s, NEG_INF),
            torch.where(ok, top_i, -1).to(torch.int32))
