"""GAT (Veličković et al. 2018) — SDDMM edge scores → segment softmax → SpMM
(``repro.models.gnn.gat``).

Cora config: 2 layers, 8 heads × d=8 hidden (ELU), single-head output layer.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F

from repro_torch import resolve_device
from repro_torch.models.gnn.common import (GraphData, ParamTree, gather, scatter_sum,
                                           segment_softmax)
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2


def init_params(cfg: GATConfig, generator: torch.Generator, device=None) -> ParamTree:
    dev = resolve_device(device)
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        H = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append({
            "w": dense_init(generator, d_in, H * d_out, device=dev).reshape(d_in, H, d_out),
            "a_src": torch.randn((H, d_out), generator=generator, device=dev) * 0.1,
            "a_dst": torch.randn((H, d_out), generator=generator, device=dev) * 0.1,
        })
        d_in = d_out if last else H * d_out
    return ParamTree({"layers": layers}, dev)


def from_jax_params(cfg: GATConfig, tree: dict, device=None) -> ParamTree:
    """``repro.models.gnn.gat.init_params``' tree (numpy leaves)."""
    return ParamTree(tree, resolve_device(device))


def forward(params, g: GraphData, cfg: GATConfig) -> torch.Tensor:
    h = g.x
    N = g.n_nodes
    for i, lp in enumerate(params.layers):
        last = i == cfg.n_layers - 1
        w = lp.w                                               # [F, H, d]
        hp = (h @ w.reshape(w.shape[0], -1)).view(N, *w.shape[1:])   # [N, H, d]
        # SDDMM-style edge scores from source/dest attention vectors
        s_src = (hp * lp.a_src[None]).sum(-1)                   # [N, H]
        s_dst = (hp * lp.a_dst[None]).sum(-1)
        e = gather(s_src, g.senders) + gather(s_dst, g.receivers)    # [E, H]
        e = F.leaky_relu(e, cfg.negative_slope)
        alpha = segment_softmax(e, g.receivers, g.edge_mask, N)      # [E, H]
        msgs = gather(hp, g.senders) * alpha[..., None]         # [E, H, d]
        agg = scatter_sum(
            torch.where(g.edge_mask[:, None, None], msgs, 0.0), g.receivers, N
        )                                                       # [N, H, d]
        if last:
            h = agg.mean(1)                                     # head average
        else:
            h = F.elu(agg).reshape(N, -1)                       # head concat
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h
