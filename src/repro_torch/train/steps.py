"""Serving step builders (``repro.train.steps``, its serving half).

Each builder returns a function of (params, batch) or (params, cache,
batch) over tensors on one device. The train steps, the losses and the
GNN steps belong to later slices.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import transformer as tfm


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def make_lm_prefill_step(cfg: tfm.TransformerConfig, pad_to: int) -> Callable:
    """(params, {tokens [B, S]}) → (last-position logits f32[B, V], decode
    cache padded to ``pad_to`` positions)."""
    def step(params, batch):
        h, _, cache = tfm.forward(params, batch["tokens"], cfg,
                                  return_cache_pad=pad_to)
        return tfm.logits_from_hidden(params, h[:, -1], cfg), cache
    return step


def make_lm_decode_step(cfg: tfm.TransformerConfig) -> Callable:
    """(params, cache, {tokens [B, 1]}) → (logits f32[B, V], cache); the
    cache's k/v are written in place."""
    def step(params, cache, batch):
        return tfm.decode_step(params, cache, batch["tokens"], cfg)
    return step


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def make_dlrm_serve_step(cfg: dlrm_mod.DLRMConfig) -> Callable:
    """(params, batch) → click probabilities f32[B]."""
    def step(params, batch):
        return torch.sigmoid(dlrm_mod.forward(params, batch, cfg))
    return step


def make_dlrm_retrieval_step(cfg: dlrm_mod.DLRMConfig, k: int = 100) -> Callable:
    """(params, {dense [B, 13], candidates [M, D]}) → top-k (scores, ids).

    The query's dense features go through the bottom MLP to a query
    embedding, scored against the candidate store by ``retrieval_scores``.
    JAX's step passes ``use_pallas=False`` to keep its dry-run XLA-pure; the
    port routes by device like every other port path, so on the card this
    step launches the ``score_topk`` CUDA kernel (its plain version on the
    CPU)."""
    def step(params, batch):
        q = dlrm_mod._mlp(params.bot, batch["dense"], final_act=True)
        return dlrm_mod.retrieval_scores(q, batch["candidates"], k)
    return step
