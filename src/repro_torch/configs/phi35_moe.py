"""phi3.5-moe-42b-a6.6b — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""
from __future__ import annotations

from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, smoke_lm
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=6400,
        vocab=32064,
        rope_theta=10_000.0,
        moe=MoEConfig(n_experts=16, top_k=2, d_model=4096, d_ff=6400,
                      capacity_factor=1.25, gated=True),
    )


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    config_for_shape=lambda shape: config(),
    smoke_config=lambda: smoke_lm(config()),
    shapes=lm_shapes(
        long_skip="pure full attention at 524k ctx (no sub-quadratic path); "
                  "see DESIGN.md §Arch-applicability",
    ),
    input_specs=lambda cfg, shape: lm_input_specs(
        cfg, lm_shapes()[shape]
    ),
    notes="16-expert top-2 MoE; 42B total / 6.6B active params",
))
