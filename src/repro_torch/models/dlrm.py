"""DLRM RM2 (Naumov et al. 2019) — embedding bags + dot interaction + MLPs
(``repro.models.dlrm``).

Tables are stacked ``[n_sparse, rows, dim]``. The embedding bag is a
masked mean over a gather with JAX's index semantics: an id below zero
counts from the table's end and an id past either end is clamped to the
nearest row, so padded ids under a false mask read the rows JAX reads.
The MLPs have no bias; the bottom MLP ends in a ReLU, the top one does not.
Under autograd the tables' gradient is dense, as JAX's is.

``retrieval_scores`` (1 query × 10⁶ candidates) runs the port's
``score_topk`` with metric ip: the CUDA kernel for tensors on the card,
its plain version on the CPU — the brute-force scorer the index uses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, frozen, take_rows


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    n_rows: int = 1_000_000        # rows per table
    nnz: int = 1                   # multi-hot ids per field (padded)
    bot_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


class DLRM(nn.Module):
    """``tables [F, R, D]``, the bottom and top MLPs' weights."""

    def __init__(self, cfg: DLRMConfig, tables, bot: list, top: list):
        super().__init__()
        self.cfg = cfg
        self.tables = frozen(tables)
        self.bot = nn.ParameterList(frozen(w) for w in bot)
        self.top = nn.ParameterList(frozen(w) for w in top)

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self, batch, self.cfg)


def _mlp_init(g, d_in, widths, device):
    layers = []
    for w in widths:
        layers.append(dense_init(g, d_in, w, device=device))
        d_in = w
    return layers


def init_params(cfg: DLRMConfig, generator: torch.Generator, device=None
                ) -> DLRM:
    """Random parameters as JAX draws them (normal tables at 1/√D,
    truncated-normal MLPs at fan-in scale), from ``generator`` on
    ``device``."""
    tables = torch.randn((cfg.n_sparse, cfg.n_rows, cfg.embed_dim),
                         generator=generator, device=device)
    tables.mul_(1.0 / cfg.embed_dim ** 0.5)
    top_in = cfg.n_interact + cfg.bot_mlp[-1]
    return DLRM(cfg, tables, _mlp_init(generator, cfg.n_dense, cfg.bot_mlp, device),
                _mlp_init(generator, top_in, cfg.top_mlp, device))


def from_jax_params(cfg: DLRMConfig, tree: dict, device=None) -> DLRM:
    """``repro.models.dlrm.init_params``'s tree (numpy leaves) → the module."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return DLRM(cfg, t(tree["tables"]), [t(lp["w"]) for lp in tree["bot"]],
                [t(lp["w"]) for lp in tree["top"]])


def _mlp(layers, x, *, final_act=False):
    for i, w in enumerate(layers):
        x = x @ w
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """Mean-pooled multi-hot lookup ``tables [F, R, D]``, ``ids [B, F,
    nnz]``, ``mask bool[B, F, nnz]`` → [B, F, D]. Ids are read as JAX's
    ``tables[f, ids]`` reads them: below zero from the end, then clamped to
    ``[0, R)``; the gradient drops what the clamp moved, as JAX's does."""
    F_, R, D = tables.shape
    ids = ids.long()
    ids = torch.where(ids < 0, ids + R, ids)
    base = torch.arange(F_, device=ids.device)[None, :, None] * R
    read = (base + ids.clamp(0, R - 1)).reshape(-1)
    rows = take_rows(tables.reshape(F_ * R, D), read,
                     lambda: torch.where((ids >= 0) & (ids < R), base + ids, F_ * R).reshape(-1)
                     ).view(*ids.shape, D)
    rows.masked_fill_(~mask[..., None], 0.0)                   # [B, F, nnz, D]
    cnt = mask.sum(-1, keepdim=True).clamp_(min=1)
    return rows.sum(2) / cnt


def forward(params, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """batch = {dense f32[B, 13], sparse_ids int[B, F, nnz], sparse_mask
    bool[B, F, nnz]} → logits f32[B]."""
    emb = embedding_bag(params.tables, batch["sparse_ids"], batch["sparse_mask"])
    bot = _mlp(params.bot, batch["dense"], final_act=True)     # [B, D]
    z = torch.cat([bot[:, None, :], emb], dim=1)               # [B, F+1, D]
    # dot-product feature interaction: the lower triangle without the
    # diagonal, row-major as jnp.tril_indices orders it
    zz = torch.bmm(z, z.transpose(1, 2))                       # [B, F+1, F+1]
    f = z.shape[1]
    iu, ju = torch.tril_indices(f, f, -1, device=z.device)
    inter = zz[:, iu, ju]                                      # [B, f(f-1)/2]
    return _mlp(params.top, torch.cat([inter, bot], dim=1))[:, 0]


def bce_loss(params, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """Mean binary cross-entropy of the CTR logits against ``labels``, in
    JAX's stable form ``max(z, 0) − z·y + log1p(exp(−|z|))``."""
    z = forward(params, batch, cfg)
    y = batch["labels"].float()
    # torch.maximum splits the gradient of a tie as jnp.maximum does
    return torch.mean(torch.maximum(z, z.new_zeros(())) - z * y
                      + torch.log1p(torch.exp(-z.abs())))


def retrieval_scores(query_emb: torch.Tensor, candidates: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates by inner product: (scores f32[B, k], ids i32[B, k]),
    ties to the lower id — the ANN-serving hot path (ties into IPGM)."""
    csq = candidates.float().square().sum(-1)
    return ops.score_topk(candidates, csq, query_emb, k, metric="ip")
