"""ipgm-online — the paper's own system as an architecture of the registry.

Shapes cover the three op classes of GRAPH-MAINTENANCE (Alg 3): sharded
query fan-out/merge, routed insert, GLOBAL-repair delete. Per-shard
capacities of 8,192 (d = 128, SIFT-like) and 2,048 (d = 960, GIST-like).
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ArchSpec, ShapeCell, register, sds
from repro_torch.core.params import IndexParams, SearchParams

ARCH_ID = "ipgm-online"

SHAPES = {
    "serve_d128": ShapeCell(
        "serve_d128", "ipgm_query",
        {"q_batch": 4096, "cap_local": 8192, "dim": 128},
    ),
    "serve_d960": ShapeCell(
        "serve_d960", "ipgm_query",
        {"q_batch": 1024, "cap_local": 2048, "dim": 960},
    ),
    "update_global": ShapeCell(
        "update_global", "ipgm_delete",
        {"batch": 512, "cap_local": 8192, "dim": 128},
    ),
    "insert_stream": ShapeCell(
        "insert_stream", "ipgm_insert",
        {"batch": 64, "cap_local": 8192, "dim": 128},
    ),
}


def config_for_shape(shape: str) -> IndexParams:
    cell = SHAPES[shape]
    return IndexParams(
        capacity=cell.sizes["cap_local"],
        dim=cell.sizes["dim"],
        d_out=32,
        search=SearchParams(pool_size=64, max_steps=128, num_starts=2),
    )


def smoke_config() -> IndexParams:
    return IndexParams(
        capacity=128, dim=16, d_out=8,
        search=SearchParams(pool_size=16, max_steps=32, num_starts=2),
    )


def input_specs(cfg: IndexParams, shape: str) -> dict:
    cell = SHAPES[shape]
    if cell.kind == "ipgm_query":
        return {"queries": sds((cell.sizes["q_batch"], cfg.dim), torch.float32)}
    if cell.kind == "ipgm_delete":
        return {"gids": sds((cell.sizes["batch"],), torch.int32)}
    if cell.kind == "ipgm_insert":
        return {
            "vecs": sds((cell.sizes["batch"], cfg.dim), torch.float32),
            "route": sds((cell.sizes["batch"],), torch.int32),
        }
    raise ValueError(cell.kind)


SPEC = register(ArchSpec(
    arch_id=ARCH_ID,
    family="ipgm",
    config_for_shape=config_for_shape,
    smoke_config=smoke_config,
    shapes=SHAPES,
    input_specs=input_specs,
    notes="shard-local subgraphs; GLOBAL delete repair = batched "
          "shard-local searches (DESIGN.md §5)",
))
