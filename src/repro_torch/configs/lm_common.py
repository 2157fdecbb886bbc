"""Shared LM-family shape cells and spec builders."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.registry import ShapeCell, TensorSpec, sds
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import MoEConfig


def lm_shapes(*, long_skip: str | None = None) -> dict[str, ShapeCell]:
    return {
        "train_4k": ShapeCell("train_4k", "train",
                              {"seq": 4096, "batch": 256}),
        "prefill_32k": ShapeCell("prefill_32k", "prefill",
                                 {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeCell("decode_32k", "decode",
                                {"seq": 32768, "batch": 128}),
        "long_500k": ShapeCell("long_500k", "decode",
                               {"seq": 524288, "batch": 1}, skip=long_skip),
    }


def lm_input_specs(cfg: tfm.TransformerConfig, cell: ShapeCell) -> dict:
    B, S = cell.sizes["batch"], cell.sizes["seq"]
    if cell.kind == "train":
        return {
            "tokens": sds((B, S), torch.int32),
            "labels": sds((B, S), torch.int32),
            "mask": sds((B, S), torch.bool),
        }
    if cell.kind == "prefill":
        return {"tokens": sds((B, S), torch.int32)}
    if cell.kind == "decode":
        return {"tokens": sds((B, 1), torch.int32)}
    raise ValueError(cell.kind)


def lm_cache_specs(cfg: tfm.TransformerConfig, cell: ShapeCell) -> dict:
    """The decode KV cache of a decode cell, in the port's layout: one
    ``(k, v)`` pair of ``[B, S, Hkv, dh]`` per layer."""
    B, S = cell.sizes["batch"], cell.sizes["seq"]
    kv: TensorSpec = sds((B, S, cfg.n_kv_heads, cfg.d_head), cfg.compute_dtype)
    return {"kv": [(kv, kv) for _ in range(cfg.n_layers)],
            "len": sds((B,), torch.int32)}


def smoke_lm(cfg: tfm.TransformerConfig) -> tfm.TransformerConfig:
    """Family-preserving reduction for CPU tests."""
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            n_experts=4, top_k=cfg.moe.top_k, d_model=64, d_ff=96,
            capacity_factor=2.0, n_shared=cfg.moe.n_shared, gated=cfg.moe.gated,
        )
    return dataclasses.replace(
        cfg,
        n_layers=2 * cfg.period, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=96, vocab=128, moe=moe,
        window=8 if cfg.window else None,
        compute_dtype=torch.float32, block_q=16, block_kv=16, xent_chunk=16,
    )
