"""dimenet — 6 blocks d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6.
[arXiv:2003.03123]

Triplet budgets are capped per shape (gnn_common.max_triplets) — Σ deg²
explodes on power-law graphs; non-molecular shapes get surrogate 3D
positions from the pipeline (DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

from repro_torch.configs.gnn_common import GNN_SIZES, gnn_input_specs, gnn_shapes
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.gnn.dimenet import DimeNetConfig

ARCH_ID = "dimenet"


def config_for_shape(shape: str) -> DimeNetConfig:
    s = GNN_SIZES[shape]
    return DimeNetConfig(
        name=ARCH_ID, n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
        n_radial=6, d_in=s["d_feat"], n_targets=1,
    )


def smoke_config() -> DimeNetConfig:
    return DimeNetConfig(name=ARCH_ID, n_blocks=2, d_hidden=16, n_bilinear=2,
                         n_spherical=3, n_radial=4, d_in=8, n_targets=1)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="gnn",
    config_for_shape=config_for_shape,
    smoke_config=smoke_config,
    shapes=gnn_shapes(),
    input_specs=lambda cfg, shape: gnn_input_specs("dimenet", cfg, shape),
    notes="directional (triplet) message passing; graph-level regression",
))
