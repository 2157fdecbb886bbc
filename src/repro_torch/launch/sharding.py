"""Sharding rules per family (``repro.launch.sharding``): FSDP over
``data`` × TP over ``model`` (+ DP over ``pod``).

A :class:`Spec` is JAX's ``PartitionSpec`` for one tensor of the port:
one entry per dimension, each an axis name, a tuple of axis names or
``None``. The rules match the port's parameter names (``named_parameters()``
of ``Transformer`` and ``DLRM``, a GNN ``ParamTree``), whose last part names
the tensor itself: ``layers.3.wq``, ``layers.0.moe.w_in``. JAX stacks each
layer position on a leading group axis and names the dense weight ``w``
under ``wq``; the port keeps one tensor per layer, so its spec is JAX's
without the leading ``None``. A spec tree mirrors the tree of tensors it
describes: a dict name → spec for a module, lists for lists, a dict of
fields for a dataclass. Optimizer moments shard as their parameter.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.registry import TensorSpec
from repro_torch.launch.mesh import ShardMesh, all_axes, batch_axes

FSDP, TP = "data", "model"


class Spec(tuple):
    """``Spec("data", None)``: how each dimension of one tensor splits over
    the mesh axes (``None``: replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


def replicated(ndim: int) -> Spec:
    return Spec(*([None] * ndim))


def flatten(tree) -> list:
    """The tensors (or :class:`TensorSpec` shapes, or specs) of a tree in
    order: a module's ``parameters()``, dict values, list items, a
    dataclass's tensor fields."""
    if isinstance(tree, (Spec, torch.Tensor, TensorSpec)):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in flatten(getattr(tree, f.name))]
    return []                                   # ints, strings, None


def map_specs(tree, rule) -> object:
    """The spec tree of ``tree``: ``rule(name, tensor)`` per tensor, with a
    module's parameters by their ``named_parameters()`` names."""
    if isinstance(tree, (torch.Tensor, TensorSpec)):
        return rule("", tree)
    if isinstance(tree, nn.Module):
        return {n: rule(n, p) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: map_specs(v, rule) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(v, rule) for v in tree]
    if dataclasses.is_dataclass(tree):
        return {f.name: map_specs(getattr(tree, f.name), rule)
                for f in dataclasses.fields(tree)
                if flatten(getattr(tree, f.name))}
    raise TypeError(f"no spec for a {type(tree).__name__}")


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

# per last name: the spec of the port's tensor (JAX's without its group axis)
_LM_TRAIN = {
    "embed": (FSDP, TP),
    **dict.fromkeys(("wq", "wk", "wv", "w_gate", "w_up"), (FSDP, TP)),
    **dict.fromkeys(("wo", "w_down"), (TP, FSDP)),
    "router": (FSDP, None),             # [d, E]
    "w_in": (FSDP, None, TP),           # [E, d, n_in]
    "w_out": (FSDP, TP, None),          # [E, f, d]
    "shared_in": (FSDP, TP),            # [d, n_in]
    "shared_out": (TP, FSDP),           # [f*, d]
}

# serving (§Perf hillclimb B): params replicated over 'data' (no per-step
# FSDP all-gather), TP over 'model'; MoE experts stay EP over 'data'
# (stationary weights, token a2a)
_LM_INFERENCE = {
    "embed": (TP, None),
    **dict.fromkeys(("wq", "wk", "wv", "w_gate", "w_up"), (None, TP)),
    **dict.fromkeys(("wo", "w_down"), (TP, None)),
    "w_in": (FSDP, None, TP),
    "w_out": (FSDP, TP, None),
    "shared_in": (None, TP),
    "shared_out": (TP, None),
}


def _by_last_name(table: dict):
    def rule(name, t) -> Spec:
        parts = table.get(_last(name))
        return Spec(*parts) if parts else replicated(len(t.shape))  # norms
    return rule


def lm_param_specs(model) -> dict:
    return map_specs(model, _by_last_name(_LM_TRAIN))


def lm_param_specs_inference(model) -> dict:
    return map_specs(model, _by_last_name(_LM_INFERENCE))


def lm_batch_specs(cell_kind: str, mesh: ShardMesh, specs: dict) -> dict:
    ba = batch_axes(mesh)
    if cell_kind == "train":
        return {k: Spec(ba, None) for k in specs}
    if cell_kind in ("prefill", "decode"):
        return {"tokens": Spec(ba, None)}
    raise ValueError(cell_kind)


def lm_cache_specs_sharding(cell, mesh: ShardMesh) -> dict:
    """KV cache ``[B, S, Hkv, dh]`` per layer: batch over the data axes,
    seq over model — except long_500k (B = 1), where seq shards over
    everything."""
    ba = batch_axes(mesh)
    if cell.sizes["batch"] == 1:
        return {"kv_spec": Spec(None, all_axes(mesh), None, None),
                "len_spec": Spec(None), "tok_spec": Spec(None, None)}
    return {"kv_spec": Spec(ba, TP, None, None), "len_spec": Spec(ba),
            "tok_spec": Spec(ba, None)}


# ---------------------------------------------------------------------------
# GNN family: small params replicated; graph data sharded over all axes
# ---------------------------------------------------------------------------

def gnn_param_specs(model) -> dict:
    return map_specs(model, lambda name, t: replicated(len(t.shape)))


def gnn_batch_specs(batch, mesh: ShardMesh):
    ax = all_axes(mesh)

    def rule(name, t) -> Spec:
        # the leading (node/edge/triplet/block) dim over all axes; small
        # leaves (graph targets, odd block sizes) stay replicated
        n = len(t.shape)
        if n >= 1 and t.shape[0] % 512 == 0 and t.shape[0] > 0:
            return Spec(ax, *([None] * (n - 1)))
        return replicated(n)

    return map_specs(batch, rule)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def dlrm_param_specs(model) -> dict:
    def rule(name, t) -> Spec:
        if "tables" in name:            # [F, R, D]: rows over everything
            return Spec(None, ("data", "model"), None)
        return replicated(len(t.shape))
    return map_specs(model, rule)


def dlrm_batch_specs(cell_kind: str, specs: dict, mesh: ShardMesh) -> dict:
    ba = batch_axes(mesh)
    out = {}
    for k, v in specs.items():
        rest = [None] * (len(v.shape) - 1)
        if k == "candidates":           # [M, D] candidate store (M = exactly
            out[k] = Spec(ba, None)     # 1e6, divisible by data, not model)
        elif v.shape[0] == 1:           # retrieval query batch B = 1
            out[k] = replicated(len(v.shape))
        else:
            out[k] = Spec(ba, *rest)
    return out


# ---------------------------------------------------------------------------
# optimizer state, sizes
# ---------------------------------------------------------------------------

def opt_specs(param_specs: dict) -> dict:
    """The AdamW state's specs (``adamw_init``'s ``m`` and ``v`` lists in
    the parameters' order, and the step counter)."""
    leaves = flatten(param_specs)
    return {"m": leaves, "v": list(leaves), "step": Spec()}


def sharded_bytes_per_dev(tree, spec_tree, mesh: ShardMesh) -> float:
    """Per-device bytes of a sharded tree — the roofline's HBM-IO term."""
    axes = mesh.axis_sizes
    leaves, specs = flatten(tree), flatten(spec_tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} tensors against {len(specs)} specs")
    total = 0.0
    for leaf, sp in zip(leaves, specs):
        n = 1.0
        for s in leaf.shape:
            n *= float(s)
        div = 1
        for part in sp:
            if part is None:
                continue
            for nm in ((part,) if isinstance(part, str) else part):
                div *= axes.get(nm, 1)
        total += n * leaf.dtype.itemsize / div
    return total
