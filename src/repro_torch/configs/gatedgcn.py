"""gatedgcn — 16 layers d_hidden=70 gated aggregator.  [arXiv:2003.00982]"""
from __future__ import annotations

from repro_torch.configs.gnn_common import D_EDGE, GNN_SIZES, gnn_input_specs, gnn_shapes
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig

ARCH_ID = "gatedgcn"


def config_for_shape(shape: str) -> GatedGCNConfig:
    s = GNN_SIZES[shape]
    return GatedGCNConfig(
        name=ARCH_ID, n_layers=16, d_in=s["d_feat"], d_edge_in=D_EDGE,
        d_hidden=70, n_classes=max(s["n_classes"], 2),
    )


def smoke_config() -> GatedGCNConfig:
    return GatedGCNConfig(name=ARCH_ID, n_layers=3, d_in=12, d_edge_in=D_EDGE,
                          d_hidden=16, n_classes=3)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    config_for_shape=config_for_shape,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("gatedgcn", cfg, shape),
    notes="edge-featured MPNN; benchmark BatchNorm → LayerNorm (DESIGN.md)",
))
