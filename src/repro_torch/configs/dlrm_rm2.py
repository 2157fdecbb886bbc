"""dlrm-rm2 — n_dense=13 n_sparse=26 embed_dim=64 bot 13-512-256-64
top 512-512-256-1 dot interaction.  [arXiv:1906.00091]"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ArchSpec, ShapeCell, register, sds
from repro_torch.models.dlrm import DLRMConfig

ARCH_ID = "dlrm-rm2"
NNZ = 4  # multi-hot ids per sparse field (padded; mask carries true counts)


def config() -> DLRMConfig:
    return DLRMConfig(
        name=ARCH_ID, n_dense=13, n_sparse=26, embed_dim=64,
        n_rows=1_048_576,  # 2^20 ≈ the paper's 1e6, divisible by 512 shards
        nnz=NNZ,
        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
    )


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name=ARCH_ID, n_dense=13, n_sparse=26, embed_dim=8, n_rows=512,
        nnz=NNZ, bot_mlp=(32, 16, 8), top_mlp=(32, 16, 1),
    )


SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", {"batch": 65_536}),
    "serve_p99": ShapeCell("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeCell("serve_bulk", "serve", {"batch": 262_144}),
    "retrieval_cand": ShapeCell(
        "retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}
    ),
}


def input_specs(cfg: DLRMConfig, shape: str) -> dict:
    cell = SHAPES[shape]
    B = cell.sizes["batch"]
    if cell.kind == "retrieval":
        return {
            "dense": sds((B, cfg.n_dense), torch.float32),
            "candidates": sds(
                (cell.sizes["n_candidates"], cfg.bot_mlp[-1]), torch.float32
            ),
        }
    specs = {
        "dense": sds((B, cfg.n_dense), torch.float32),
        "sparse_ids": sds((B, cfg.n_sparse, cfg.nnz), torch.int32),
        "sparse_mask": sds((B, cfg.n_sparse, cfg.nnz), torch.bool),
    }
    if cell.kind == "train":
        specs["labels"] = sds((B,), torch.int32)
    return specs


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="recsys",
    config_for_shape=lambda shape: config(),
    smoke_config=smoke_config,
    shapes=SHAPES,
    input_specs=input_specs,
    notes="embedding bag = clamped gather + masked mean; retrieval_cand "
          "scores via the score_topk CUDA kernel",
))
