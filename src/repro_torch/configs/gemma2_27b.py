"""gemma2-27b — 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000,
alternating local(4096)+global attention, attn/final logit softcaps,
sandwich norms, sqrt(d) embed scaling.  [arXiv:2408.00118]"""
from __future__ import annotations

from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, smoke_lm
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "gemma2-27b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=36864,
        vocab=256_000,
        rope_theta=10_000.0,
        window=4096,
        layer_pattern=("local", "global"),
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        embed_scale=True,
        attn_scale=(4608 // 32) ** -0.5,   # query_pre_attn_scalar = d_model/H
    )


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    config_for_shape=lambda shape: config(),
    smoke_config=lambda: smoke_lm(config()),
    shapes=lm_shapes(long_skip=None),  # local+global alternating → run 500k
    input_specs=lambda cfg, shape: lm_input_specs(cfg, lm_shapes()[shape]),
    notes="local+global alternating, logit softcaps, GQA kv=16",
))
