"""Shared GNN-family shape cells + input-spec builders
(``repro.configs.gnn_common``).

Four shape regimes:
  full_graph_sm  — cora-scale full batch  (N=2,708  E=10,556  F=1,433)
  minibatch_lg   — reddit-scale sampled   (N=232,965 E=114,615,892;
                   batch_nodes=1,024 fanout 15-10 → sampled block sizes)
  ogb_products   — products full batch    (N=2,449,029 E=61,859,140 F=100)
  molecule       — 128 merged small graphs (30 nodes / 64 edges each)

All cells are STATIC shapes; the sampled cell sizes are the padded block
sizes produced by data/graph_sampler.py.
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeCell, sds
from repro_torch.models.gnn.common import GraphData

# arch id → the arch name the GNN step builders take
GNN_ARCH = {"graphsage-reddit": "graphsage", "gat-cora": "gat",
            "gatedgcn": "gatedgcn", "dimenet": "dimenet"}
D_EDGE = 8
FANOUT = (15, 10)
BATCH_NODES = 1024

GNN_SIZES = {
    "full_graph_sm": dict(
        n_nodes=2_708, n_edges=10_556, d_feat=1_433, n_classes=7, n_graphs=1,
    ),
    "minibatch_lg": dict(
        # sampled subgraph: 1024 targets + 1024·15 hop-1 + 1024·150 hop-2
        n_nodes=BATCH_NODES * (1 + FANOUT[0] + FANOUT[0] * FANOUT[1]),
        n_edges=BATCH_NODES * FANOUT[0] * (1 + FANOUT[1]),
        d_feat=602, n_classes=41, n_graphs=1,
        batch_nodes=BATCH_NODES, fanout=FANOUT,
        full_nodes=232_965, full_edges=114_615_892,
    ),
    "ogb_products": dict(
        n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47,
        n_graphs=1,
    ),
    "molecule": dict(
        n_nodes=30 * 128, n_edges=64 * 128, d_feat=16, n_classes=1,
        n_graphs=128,
    ),
}


def gnn_shapes() -> dict[str, ShapeCell]:
    return {
        name: ShapeCell(name, "train", dict(sizes))
        for name, sizes in GNN_SIZES.items()
    }


def _pad512(n: int) -> int:
    """Graph dims are padded to 512 multiples (divisible by every mesh) —
    the logical sizes stay exact; masks carry validity."""
    return -(-n // 512) * 512


def graph_specs(sizes: dict) -> GraphData:
    N, E, F = _pad512(sizes["n_nodes"]), _pad512(sizes["n_edges"]), sizes["d_feat"]
    G = sizes["n_graphs"]
    return GraphData(
        x=sds((N, F), torch.float32),
        senders=sds((E,), torch.int32),
        receivers=sds((E,), torch.int32),
        node_mask=sds((N,), torch.bool),
        edge_mask=sds((E,), torch.bool),
        labels=sds((N,), torch.int32),
        label_mask=sds((N,), torch.bool),
        positions=sds((N, 3), torch.float32),
        edge_attr=sds((E, D_EDGE), torch.float32),
        graph_ids=sds((N,), torch.int32),
        targets=sds((G,), torch.float32),
    )


def gnn_input_specs(arch: str, cfg, shape: str) -> dict:
    sizes = GNN_SIZES[shape]
    if arch == "graphsage" and shape == "minibatch_lg":
        B, (f1, f2) = sizes["batch_nodes"], sizes["fanout"]
        F = sizes["d_feat"]
        return {
            "graph": graph_specs(dict(sizes, n_nodes=8, n_edges=8)),  # unused stub
            "blocks": {
                "feats": [
                    sds((B * f1 * f2, F), torch.float32),
                    sds((B * f1, F), torch.float32),
                    sds((B, F), torch.float32),
                ],
                "masks": [
                    sds((B * f1 * f2,), torch.bool),
                    sds((B * f1,), torch.bool),
                    sds((B,), torch.bool),
                ],
            },
            "block_labels": sds((B,), torch.int32),
            "block_label_mask": sds((B,), torch.bool),
        }
    batch = {"graph": graph_specs(sizes)}
    if arch == "dimenet":
        T = _pad512(max_triplets(shape))
        batch["triplets"] = {
            "edge_kj": sds((T,), torch.int32),
            "edge_ji": sds((T,), torch.int32),
            "mask": sds((T,), torch.bool),
        }
    return batch


def max_triplets(shape: str) -> int:
    """Capped triplet budget (Σ deg² is unbounded on power-law graphs)."""
    return {
        "full_graph_sm": 65_536,
        "minibatch_lg": 2 * GNN_SIZES["minibatch_lg"]["n_edges"],
        "ogb_products": 2 * GNN_SIZES["ogb_products"]["n_edges"],
        "molecule": 32_768,
    }[shape]
