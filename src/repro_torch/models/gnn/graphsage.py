"""GraphSAGE (Hamilton et al. 2017) — mean aggregator, full-graph + sampled
(``repro.models.gnn.graphsage``).

Full-graph: h'_i = act(W_self·h_i + W_nbr·mean_{j∈N(i)} h_j), the
neighbour sums taken over edge chunks (``common.neighbour_sum``).
Minibatch: layered fanout blocks from the neighbor sampler
(data/graph_sampler.py) — hop-h features aggregated with a masked fixed-
fanout mean over ``[B, fanout, F]`` tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models.gnn.common import GraphData, ParamTree, degree, neighbour_sum
from repro_torch.models.layers import dense, dense_init


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    sample_sizes: tuple[int, ...] = (25, 10)


def init_params(cfg: SAGEConfig, generator: torch.Generator, device=None) -> ParamTree:
    """Truncated-normal weights at fan-in scale, as JAX draws them, from
    ``generator`` (which lives on ``device``)."""
    dev = resolve_device(device)
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    layers = [{"w_self": dense_init(generator, dims[i], dims[i + 1], device=dev),
               "w_nbr": dense_init(generator, dims[i], dims[i + 1], device=dev)}
              for i in range(cfg.n_layers)]
    return ParamTree({"layers": layers}, dev)


def from_jax_params(cfg: SAGEConfig, tree: dict, device=None) -> ParamTree:
    """``repro.models.gnn.graphsage.init_params``' tree (numpy leaves)."""
    return ParamTree(tree, resolve_device(device))


def forward(params, g: GraphData, cfg: SAGEConfig) -> torch.Tensor:
    """Full-graph forward → logits [N, n_classes]."""
    h = g.x
    cnt = torch.clamp(degree(g.receivers, g.edge_mask, g.n_nodes), min=1.0)[:, None]
    for i, lp in enumerate(params.layers):
        agg = neighbour_sum(h, g.senders, g.receivers, g.edge_mask, g.n_nodes) / cnt
        h = dense(lp.w_self, h) + dense(lp.w_nbr, agg)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h


def forward_sampled(params, blocks: dict, cfg: SAGEConfig) -> torch.Tensor:
    """Sampled minibatch forward.

    blocks = {
      "feats":  [f32[B·Π(f_1..f_h), d_in] for h = n_layers .. 0]   hop feats
      "masks":  [bool[...] matching]                                validity
    }
    hop ordering: feats[0] = deepest hop (B·f1·f2 nodes), feats[-1] = targets.
    Aggregation folds the innermost fanout axis per layer.
    """
    hs, masks = list(blocks["feats"]), list(blocks["masks"])
    fans = list(cfg.sample_sizes)
    for li, lp in enumerate(params.layers):
        new_hs, new_masks = [], []
        D = len(hs) - 1
        for depth in range(D):
            # transition hop (D-depth) → (D-depth-1) uses fanout[D-depth-1]
            fan = fans[D - depth - 1]
            tgt, nbr = hs[depth + 1], hs[depth]
            m = masks[depth].reshape(tgt.shape[0], fan)
            nbrs = nbr.reshape(tgt.shape[0], fan, -1)
            cnt = torch.clamp(m.sum(1, keepdim=True).float(), min=1.0)
            agg = torch.where(m[..., None], nbrs, 0.0).sum(1) / cnt
            h = dense(lp.w_self, tgt) + dense(lp.w_nbr, agg)
            if li < cfg.n_layers - 1:
                h = torch.relu(h)
            new_hs.append(h)
            new_masks.append(masks[depth + 1])
        hs, masks = new_hs, new_masks
    return hs[0]  # [B, n_classes]
