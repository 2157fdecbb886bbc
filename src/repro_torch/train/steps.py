"""Step builders (``repro.train.steps``): the serving steps and the GNN
family's forward and train steps.

Each builder returns a function of (params, batch), (params, cache,
batch) or (params, opt_state, batch) over tensors on one device. A GNN
train step takes its loss's gradients through autograd and applies AdamW
to the model in place; it returns the same metrics as JAX's. The LM and
DLRM train steps and their losses belong to a later slice.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import dimenet as dimenet_mod
from repro_torch.models.gnn import gat as gat_mod
from repro_torch.models.gnn import gatedgcn as ggcn_mod
from repro_torch.models.gnn import graphsage as sage_mod
from repro_torch.models.gnn.common import GraphData
from repro_torch.train.optimizer import AdamWConfig, adamw_update


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
# GNN family
# ---------------------------------------------------------------------------

def batch_to(batch, device):
    """A batch (dicts, lists, ``GraphData``, numpy arrays or tensors) with
    every array a tensor on ``device``."""
    if isinstance(batch, dict):
        return {k: batch_to(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [batch_to(v, device) for v in batch]
    if isinstance(batch, GraphData):
        return batch.to(device)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    return batch.to(device)


def _on(params, device: torch.device) -> list:
    leaves = list(params.leaves())
    if any(p.device.type != device.type for p in leaves):
        raise ValueError(f"the model's parameters are not on {device}; move them "
                         f"with .to(device) first")
    return leaves


def _node_xent(logits, labels, mask):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def gnn_loss(params, batch, arch: str, cfg):
    """Masked node cross-entropy (classification) or graph MSE (dimenet)
    → (loss, parts)."""
    if arch == "graphsage" and "blocks" in batch:
        logits = sage_mod.forward_sampled(params, batch["blocks"], cfg)
        return _node_xent(logits, batch["block_labels"],
                          batch["block_label_mask"]), {}
    g = batch["graph"]
    if arch == "graphsage":
        logits = sage_mod.forward(params, g, cfg)
    elif arch == "gat":
        logits = gat_mod.forward(params, g, cfg)
    elif arch == "gatedgcn":
        logits = ggcn_mod.forward(params, g, cfg)
    elif arch == "dimenet":
        pred = dimenet_mod.forward(params, g, batch["triplets"], cfg)
        return torch.mean(torch.square(pred - g.targets)), {}
    else:
        raise ValueError(arch)
    return _node_xent(logits, g.labels, g.label_mask & g.node_mask), {}


def make_gnn_train_step(arch: str, cfg, opt: AdamWConfig, device=None) -> Callable:
    """(model, opt_state, batch) → (model, opt_state, {loss, grad_norm,
    lr}); the model's parameters are updated in place. The batch is moved
    to ``device`` (``cuda`` unless the caller passes ``"cpu"``); the model
    must be there already."""
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        leaves = _on(params, dev)
        loss, parts = gnn_loss(params, batch_to(batch, dev), arch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        _, opt_state, om = adamw_update(leaves, grads, opt_state, opt)
        return params, opt_state, {"loss": loss.detach(), **parts, **om}
    return step


def make_gnn_forward(arch: str, cfg, device=None) -> Callable:
    """(model, batch) → logits (per-graph predictions for dimenet), without
    autograd, on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    fwd = {
        "graphsage": sage_mod.forward,
        "gat": gat_mod.forward,
        "gatedgcn": ggcn_mod.forward,
    }

    @torch.no_grad()
    def step(params, batch):
        _on(params, dev)
        batch = batch_to(batch, dev)
        if arch == "dimenet":
            return dimenet_mod.forward(params, batch["graph"], batch["triplets"], cfg)
        return fwd[arch](params, batch["graph"], cfg)
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
