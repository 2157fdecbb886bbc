"""graphsage-reddit — 2 layers d_hidden=128 mean aggregator, sample 25-10.
[arXiv:1706.02216]"""
from __future__ import annotations

from repro_torch.configs.gnn_common import GNN_SIZES, gnn_input_specs, gnn_shapes
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.gnn.graphsage import SAGEConfig

ARCH_ID = "graphsage-reddit"


def config_for_shape(shape: str) -> SAGEConfig:
    s = GNN_SIZES[shape]
    fan = s.get("fanout", (25, 10))
    return SAGEConfig(
        name=ARCH_ID, n_layers=2, d_in=s["d_feat"], d_hidden=128,
        n_classes=max(s["n_classes"], 2), sample_sizes=tuple(fan),
    )


def smoke_config() -> SAGEConfig:
    return SAGEConfig(name=ARCH_ID, n_layers=2, d_in=16, d_hidden=8,
                      n_classes=4, sample_sizes=(3, 2))


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    config_for_shape=config_for_shape,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("graphsage", cfg, shape),
    notes="paper sampler 25-10; the minibatch_lg cell uses the assignment's "
          "15-10 fanout via its own block sizes",
))
