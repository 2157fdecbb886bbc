"""Architecture registry of the port: arch-id → (configs, shapes, input specs).

A copy of ``repro.configs.registry``: the decoder LMs, the GNN family,
DLRM-RM2 and the index itself, every arch JAX's registry names.
``input_specs`` returns :class:`TensorSpec` objects, shape and torch
dtype, and allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

f32 = torch.float32
i32 = torch.int32
bf16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(n) for n in shape), dtype)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                    # train | prefill | decode | serve | retrieval | forward
    sizes: dict[str, int]
    skip: str | None = None      # reason when this (arch, shape) is skipped


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | gnn | recsys | ipgm
    config_for_shape: Callable[[str], Any]
    smoke_config: Callable[[], Any]
    shapes: dict[str, ShapeCell]
    input_specs: Callable[[Any, str], dict]   # (cfg, shape) → batch spec tree
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchSpec]:
    _ensure_loaded()
    return dict(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    # import side-effect registration
    from repro_torch.configs import (  # noqa: F401
        dimenet as _a,
        dlrm_rm2 as _b,
        gat_cora as _c,
        gatedgcn as _d,
        gemma2_27b as _e,
        graphsage_reddit as _f,
        ipgm_ann as _k,
        llama4_scout as _g,
        mistral_nemo_12b as _h,
        phi35_moe as _i,
        qwen3_1p7b as _j,
    )
    _LOADED = True
