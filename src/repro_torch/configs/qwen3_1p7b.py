"""qwen3-1.7b — 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-1.7B]"""
from __future__ import annotations

from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, smoke_lm
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "qwen3-1.7b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_head=128,
        d_ff=6144,
        vocab=151_936,
        rope_theta=1_000_000.0,
        qk_norm=True,
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
    notes="dense GQA with per-head qk RMSNorm",
))
