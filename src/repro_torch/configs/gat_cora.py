"""gat-cora — 2 layers d_hidden=8 n_heads=8 attention aggregator.
[arXiv:1710.10903]"""
from __future__ import annotations

from repro_torch.configs.gnn_common import GNN_SIZES, gnn_input_specs, gnn_shapes
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.gnn.gat import GATConfig

ARCH_ID = "gat-cora"


def config_for_shape(shape: str) -> GATConfig:
    s = GNN_SIZES[shape]
    return GATConfig(
        name=ARCH_ID, n_layers=2, d_in=s["d_feat"], d_hidden=8, n_heads=8,
        n_classes=max(s["n_classes"], 2),
    )


def smoke_config() -> GATConfig:
    return GATConfig(name=ARCH_ID, n_layers=2, d_in=12, d_hidden=4,
                     n_heads=2, n_classes=3)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    config_for_shape=config_for_shape,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("gat", cfg, shape),
    notes="SDDMM edge scores → segment softmax → SpMM",
))
