"""GatedGCN (Bresson & Laurent 2018; Dwivedi et al. benchmark config)
(``repro.models.gnn.gatedgcn``).

16 layers, d=70, gated edge aggregation with residuals. The benchmark's
BatchNorm is replaced by LayerNorm, as in JAX.

  e'_ij = e_ij + ReLU(LN(A h_i + B h_j + C e_ij))
  h'_i  = h_i + ReLU(LN(U h_i + Σ_j σ(e'_ij) ⊙ (V h_j) / (Σ_j σ(e'_ij)+ε)))
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models.gnn.common import GraphData, ParamTree, gather, scatter_sum
from repro_torch.models.layers import dense, dense_init, layernorm


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_in: int = 64
    d_edge_in: int = 8
    d_hidden: int = 70
    n_classes: int = 10


def _layernorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def init_params(cfg: GatedGCNConfig, generator: torch.Generator, device=None
                ) -> ParamTree:
    dev = resolve_device(device)
    d = cfg.d_hidden

    def lin(a, b):
        return dense_init(generator, a, b, device=dev)

    layers = [{"A": lin(d, d), "B": lin(d, d), "C": lin(d, d), "U": lin(d, d),
               "V": lin(d, d), "ln_h": _layernorm_init(d, dev),
               "ln_e": _layernorm_init(d, dev)} for _ in range(cfg.n_layers)]
    return ParamTree({"embed_h": lin(cfg.d_in, d), "embed_e": lin(cfg.d_edge_in, d),
                      "out": lin(d, cfg.n_classes), "layers": layers}, dev)


def from_jax_params(cfg: GatedGCNConfig, tree: dict, device=None) -> ParamTree:
    """``repro.models.gnn.gatedgcn.init_params``' tree (numpy leaves)."""
    return ParamTree(tree, resolve_device(device))


def forward(params, g: GraphData, cfg: GatedGCNConfig) -> torch.Tensor:
    N = g.n_nodes
    h = dense(params.embed_h, g.x)
    e = dense(params.embed_e, g.edge_attr)
    for lp in params.layers:
        hi, hj = gather(h, g.senders), gather(h, g.receivers)
        e_new = dense(lp.A, hi) + dense(lp.B, hj) + dense(lp.C, e)
        e = e + torch.relu(layernorm(lp.ln_e.scale, lp.ln_e.bias, e_new))
        gate = torch.sigmoid(e)
        gate = torch.where(g.edge_mask[:, None], gate, 0.0)
        num = scatter_sum(gate * dense(lp.V, hi), g.receivers, N)
        den = scatter_sum(gate, g.receivers, N)
        agg = num / (den + 1e-6)
        h = h + torch.relu(layernorm(lp.ln_h.scale, lp.ln_h.bias, dense(lp.U, h) + agg))
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return dense(params.out, h)
