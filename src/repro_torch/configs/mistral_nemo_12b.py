"""mistral-nemo-12b — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407]"""
from __future__ import annotations

from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, smoke_lm
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "mistral-nemo-12b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=131_072,
        rope_theta=1_000_000.0,
    )


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    config_for_shape=lambda shape: config(),
    smoke_config=lambda: smoke_lm(config()),
    shapes=lm_shapes(
        long_skip="pure full attention at 524k ctx (no sub-quadratic path)",
    ),
    input_specs=lambda cfg, shape: lm_input_specs(cfg, lm_shapes()[shape]),
    notes="dense GQA, 128k-context rope_theta=1e6, decoupled head_dim",
))
