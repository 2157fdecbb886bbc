"""llama4-scout-17b-a16e — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, chunked-local attention
with NoPE global layers every 4th (iRoPE).  [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from __future__ import annotations

from repro_torch.configs.lm_common import lm_input_specs, lm_shapes, smoke_lm
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202_048,
        rope_theta=500_000.0,
        window=8192,                                   # chunked local attn
        layer_pattern=("local", "local", "local", "global"),
        rope_on_global=False,                          # iRoPE: NoPE on global
        moe=MoEConfig(n_experts=16, top_k=1, d_model=5120, d_ff=8192,
                      capacity_factor=1.25, n_shared=1, gated=True),
    )


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="lm",
    config_for_shape=lambda shape: config(),
    smoke_config=lambda: smoke_lm(config()),
    shapes=lm_shapes(long_skip=None),  # local/chunked path → run long_500k
    input_specs=lambda cfg, shape: lm_input_specs(cfg, lm_shapes()[shape]),
    notes="MoE top-1 + shared expert, early-fusion backbone; 3:1 local:global"
          " chunked attention enables 500k decode",
))
