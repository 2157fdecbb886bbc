"""Step builders (``repro.train.steps``): the LM, GNN and DLRM train
steps, the serving steps and the GNN forward.

Each builder returns a function of (params, batch), (params, cache,
batch) or (params, opt_state, batch) over tensors on one device. A train
step turns ``requires_grad`` on for the model's parameters, takes its
loss's gradients through autograd and applies AdamW to the model in place;
it returns the same metrics as JAX's. Losses per family:

  lm     : sequence-chunked causal cross-entropy (+ MoE aux loss)
  gnn    : masked node cross-entropy (classification) or graph MSE (dimenet)
  recsys : BCE on CTR logits
"""
from __future__ import annotations

import types
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import dimenet as dimenet_mod
from repro_torch.models.gnn import gat as gat_mod
from repro_torch.models.gnn import gatedgcn as ggcn_mod
from repro_torch.models.gnn import graphsage as sage_mod
from repro_torch.models.gnn.common import GraphData, ParamTree
from repro_torch.train.optimizer import AdamWConfig, adamw_update


AUX_WEIGHT = 0.01


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
    """The model's leaves in the step's order (``ParamTree.leaves()``,
    else ``parameters()``), all on ``device``."""
    leaves = list(params.leaves() if isinstance(params, ParamTree) else params.parameters())
    if any(p.device.type != device.type for p in leaves):
        raise ValueError(f"the model's parameters are not on {device}; move them "
                         f"with .to(device) first")
    return leaves


def _train(loss_fn, params, opt_state, opt: AdamWConfig, device: torch.device):
    """One AdamW step of ``loss_fn(params) → (loss, parts)`` on the model's
    leaves, in place → (params, opt_state, {loss, **parts, grad_norm,
    lr})."""
    leaves = _on(params, device)
    for p in leaves:
        p.requires_grad_(True)
    loss, parts = loss_fn(params)
    # a leaf the loss does not reach gets a zero gradient, as in JAX
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    _, opt_state, om = adamw_update(leaves, grads, opt_state, opt)
    return params, opt_state, {"loss": loss.detach(),
                               **{k: v.detach() for k, v in parts.items()}, **om}


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _cast_params(params, dtype):
    """The model as its forward reads it, with every float32 parameter of
    two or more dimensions cast to ``dtype`` (``embed`` and the MoE router
    too); norm scales stay float32. As in JAX the cast is part of the
    differentiated function, so the gradients reach the fp32 masters. → a
    namespace tree with the module's attribute names (a module list becomes
    a list)."""
    def cast(p):
        return p.to(dtype) if p.dtype == torch.float32 and p.dim() >= 2 else p

    def tree(m):
        if isinstance(m, nn.ModuleList):
            return [tree(c) for c in m]
        ns = types.SimpleNamespace(**{n: cast(p) for n, p in m._parameters.items()})
        for n, c in m._modules.items():
            setattr(ns, n, tree(c))
        return ns
    return tree(params)


def lm_loss(params, batch, cfg: tfm.TransformerConfig):
    """(chunked cross-entropy + AUX_WEIGHT · MoE aux loss, {xent, aux})."""
    h, aux, _ = tfm.forward(params, batch["tokens"], cfg)
    loss = tfm.chunked_xent(params, h, batch["labels"], batch["mask"], cfg)
    return loss + AUX_WEIGHT * aux, {"xent": loss, "aux": aux}


def make_lm_train_step(cfg: tfm.TransformerConfig, opt: AdamWConfig, *,
                       cast_bf16: bool = True, device=None) -> Callable:
    """(model, opt_state, {tokens, labels, mask}) → (model, opt_state,
    {loss, xent, aux, grad_norm, lr}). The model keeps fp32 masters; with
    ``cast_bf16`` the forward reads them cast to ``cfg.compute_dtype``
    (:func:`_cast_params`). The batch is moved to ``device`` (``cuda``
    unless the caller passes ``"cpu"``); the model must be there already."""
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        batch = batch_to(batch, dev)

        def loss_fn(p):
            pc = _cast_params(p, cfg.compute_dtype) if cast_bf16 else p
            return lm_loss(pc, batch, cfg)
        return _train(loss_fn, params, opt_state, opt, dev)
    return step


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
        batch = batch_to(batch, dev)
        return _train(lambda p: gnn_loss(p, batch, arch, cfg), params, opt_state, opt, dev)
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

def make_dlrm_train_step(cfg: dlrm_mod.DLRMConfig, opt: AdamWConfig, device=None
                         ) -> Callable:
    """(model, opt_state, {dense, sparse_ids, sparse_mask, labels}) →
    (model, opt_state, {loss, grad_norm, lr}) on ``device`` (``cuda``
    unless the caller passes ``"cpu"``); the tables' gradient is dense."""
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        batch = batch_to(batch, dev)
        return _train(lambda p: (dlrm_mod.bce_loss(p, batch, cfg), {}), params, opt_state,
                      opt, dev)
    return step


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
