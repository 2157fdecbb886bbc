"""Similarity measures f(x, q) — paper §3 (higher is better, Eq. 1).

  l2  : f(x,q) = -||x-q||^2      (squared L2 — monotone in L2)
  ip  : f(x,q) = <x, q>          (MIPS)
  cos : f(x,q) = <x, q>/(|x||q|) (vectors are normalized at insert, so
                                  this reduces to ip at query time)

The l2 form is computed as 2<x,q> - ||x||^2 (the query-constant ||q||^2 is
dropped), so the batched path is a product against the cached sqnorms.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops

NEG_INF = float("-inf")


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return torch.sum(x * x, dim=-1)


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.clamp(sqnorm(x), min=eps))
    return x / n[..., None].to(x.dtype)


def pair_score(x: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """Score between broadcastable batches of vectors. fp32 accumulate."""
    x32, q32 = x.float(), q.float()
    dot = torch.sum(x32 * q32, dim=-1)
    if metric == "l2":
        return 2.0 * dot - sqnorm(x32)
    if metric in ("ip", "cos"):
        return dot
    raise ValueError(metric)


def scores_vs_rows(rows: torch.Tensor, row_sqnorms: torch.Tensor,
                   q: torch.Tensor, metric: str) -> torch.Tensor:
    """Scores of one query ``q [d]`` against n gathered rows ``[n, d]``, or
    of each query ``q [B, d]`` against its own rows ``[B, n, d]``."""
    if rows.dim() == 3:
        dot = torch.bmm(rows.float(), q.float()[:, :, None])[..., 0]
    else:
        dot = rows.float() @ q.float()
    if metric == "l2":
        return 2.0 * dot - row_sqnorms
    return dot


def score_matrix(x: torch.Tensor, x_sqnorms: torch.Tensor, q: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """[..., b, m] score matrix of queries ``q [..., b, d]`` against rows
    ``x [..., m, d]`` (one leading batch axis at most): the hand-written
    ``score_matrix`` kernel on a CUDA tensor, its plain version on a CPU one."""
    return kernel_ops.score_matrix(x, x_sqnorms, q, metric=metric)


def true_l2(score: torch.Tensor, q_sqnorm: torch.Tensor) -> torch.Tensor:
    """Recover ||x-q||^2 >= 0 from the l2 score (for reporting only)."""
    return torch.clamp(q_sqnorm - score, min=0.0)
