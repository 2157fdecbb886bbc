"""Analytic per-device collective bytes of one step, per family
(``repro.launch.collectives``).

The port runs one process, so no collective is ever traced: the bytes come
from the sharding rules, as JAX's do (GSPMD inserts its collectives after
the jaxpr). Pure arithmetic on the config, the cell's sizes and the mesh's
axis sizes; every formula is JAX's.

Conventions: ring algorithms — all-gather of a tensor sharded G ways
delivers (G-1)/G·size ≈ size bytes per device; reduce-scatter the same;
all-reduce = 2×. Params/grads fp32, activations compute-dtype (bf16).
"""
from __future__ import annotations

import math

from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import flatten


def _spec_axes(sp) -> list[str]:
    out = []
    for part in sp:
        if part is None:
            continue
        if isinstance(part, str):
            out.append(part)
        else:
            out.extend(part)
    return out


def _numel(t) -> float:
    return float(math.prod(t.shape))


def lm_collectives(cfg, cell, mesh: ShardMesh, model, p_specs: dict
                   ) -> dict[str, float]:
    """Per-device collective bytes for one LM step.

    Reflects the §Perf hillclimbs: A1 — params cross the wire in bf16 (cast
    before the FSDP all-gather; grads reduce-scatter in bf16); A2 — MoE
    expert weights (w_in/w_out) are EP-stationary: tokens a2a to the expert
    shard instead of gathering weights; B — inference specs carry no 'data'
    placement on non-expert params, so their AG term vanishes naturally.
    """
    axes = mesh.axis_sizes
    n_data, n_model, n_pod = (axes.get(k, 1) for k in ("data", "model", "pod"))
    B, S = cell.sizes["batch"], cell.sizes["seq"]
    cdt = 2  # bf16 wire dtype for weights & activations (A1)

    total_pb = 0.0
    fsdp_wire = 0.0   # non-expert params all-gathered per step (bf16 wire)
    expert_pb = 0.0   # EP-stationary expert weights — never gathered
    named = list(model.named_parameters())
    specs = flatten(p_specs)
    if len(named) != len(specs):
        raise ValueError(f"{len(named)} parameters against {len(specs)} specs")
    for (name, leaf), sp in zip(named, specs):
        nbytes_w = _numel(leaf) * cdt
        total_pb += _numel(leaf) * 4
        is_expert = name.endswith("w_in") or name.endswith("w_out")
        # JAX's MoE pins its expert buffers to ``ep_axis`` ("data" in every
        # config of the registry): a MoE model's experts are EP-stationary
        if is_expert and cfg.moe is not None:
            expert_pb += nbytes_w
        elif "data" in _spec_axes(sp):
            fsdp_wire += nbytes_w

    tokens_local = B * S / max(n_data * n_pod, 1)
    d = cfg.d_model
    moe_a2a = 0.0
    if cfg.moe is not None:
        trips = 3.0 if cell.kind == "train" else 1.0  # in+out fwd (+bwd grads)
        tl = tokens_local if cell.kind != "decode" else B / max(n_data * n_pod, 1)
        moe_a2a = (cfg.n_layers * trips * max(tl, 1)
                   * cfg.moe.top_k * d * cdt * cfg.moe.capacity_factor)

    if cell.kind == "train":
        ag = 2.0 * fsdp_wire               # FSDP param AG (bf16), fwd + bwd
        rs = 1.0 * fsdp_wire               # grad reduce-scatter (bf16)
        ar_pod = (
            2.0 * total_pb / (n_data * n_model) * (n_pod - 1) / n_pod
            if n_pod > 1 else 0.0
        )                                  # DP grad sync across pods
        # TP psums: 2 contractions/layer (attn-out, ffn-out), fwd + bwd
        tp = cfg.n_layers * 2 * 2 * 2.0 * tokens_local * d * cdt
        return {"all_gather": ag, "reduce_scatter": rs,
                "all_reduce": ar_pod, "tp_psum": tp, "moe_a2a": moe_a2a}

    # inference: single forward — TP psums fwd only
    tokens_local = (B * 1 if cell.kind == "decode" else B * S) / max(
        n_data * n_pod, 1
    )
    ag = 1.0 * fsdp_wire
    tp = cfg.n_layers * 2 * 2.0 * max(tokens_local, 1) * d * cdt
    return {"all_gather": ag, "reduce_scatter": 0.0, "all_reduce": 0.0,
            "tp_psum": tp, "moe_a2a": moe_a2a}


def gnn_collectives(cfg, cell, mesh: ShardMesh, model) -> dict[str, float]:
    """Replicated params → grad all-reduce; cross-shard message scatter ≈
    all-to-all of edge messages + gathered sender rows."""
    n_chips = mesh.n_devices
    dt = 4
    pbytes = sum(_numel(x) * dt for x in flatten(model))
    E = cell.sizes.get("n_edges", 0)
    d_hidden = getattr(cfg, "d_hidden", 64)
    n_layers = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", 2))
    a2a = 2.0 * 2.0 * n_layers * (E / n_chips) * d_hidden * dt  # fwd+bwd, in+out
    ar = 2.0 * pbytes
    return {"all_reduce": ar, "all_to_all": a2a, "all_gather": 0.0,
            "reduce_scatter": 0.0}


def dlrm_collectives(cfg, cell, mesh: ShardMesh) -> dict[str, float]:
    n_chips = mesh.n_devices
    dt = 4
    B = cell.sizes["batch"]
    if cell.kind == "retrieval":
        k = 100
        return {"all_gather": float(k * 8 * n_chips), "all_reduce": 0.0,
                "all_to_all": 0.0, "reduce_scatter": 0.0}
    F, D, nnz = cfg.n_sparse, cfg.embed_dim, cfg.nnz
    rows = B / n_chips * F * nnz * D * dt
    a2a = (3.0 if cell.kind == "train" else 1.0) * rows  # fwd rows + bwd grads
    mlp_params = sum(
        a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp, cfg.bot_mlp)
    ) + sum(a * b for a, b in zip(
        (cfg.n_interact + cfg.bot_mlp[-1],) + cfg.top_mlp, cfg.top_mlp))
    ar = (2.0 * mlp_params * dt) if cell.kind == "train" else 0.0
    return {"all_to_all": a2a, "all_reduce": ar, "all_gather": 0.0,
            "reduce_scatter": 0.0}


def ipgm_collectives(cfg, cell, mesh: ShardMesh) -> dict[str, float]:
    axes = mesh.axis_sizes
    if cell.kind == "ipgm_query":
        B, k = cell.sizes["q_batch"], cfg.search.pool_size
        # hierarchical two-stage merge (§Perf C): AG within 'model' (m×B×k)
        # then across 'data' (n×B×k) — vs the flat P×B×k fan-in
        m, n = axes.get("model", 1), axes.get("data", 1) * axes.get("pod", 1)
        return {"all_gather": float((m + n) * B * k * 8), "all_reduce": 0.0,
                "all_to_all": 0.0, "reduce_scatter": 0.0}
    if cell.kind == "ipgm_insert":
        B = cell.sizes["batch"]
        return {"all_reduce": float(2 * B * 4), "all_gather": 0.0,
                "all_to_all": 0.0, "reduce_scatter": 0.0}
    return {"all_gather": 0.0, "all_reduce": 0.0, "all_to_all": 0.0,
            "reduce_scatter": 0.0}


def collectives_for(family: str, cfg, cell, mesh: ShardMesh, model=None,
                    p_specs=None) -> dict[str, float]:
    if family == "lm":
        return lm_collectives(cfg, cell, mesh, model, p_specs)
    if family == "gnn":
        return gnn_collectives(cfg, cell, mesh, model)
    if family == "recsys":
        return dlrm_collectives(cfg, cell, mesh)
    if family == "ipgm":
        return ipgm_collectives(cfg, cell, mesh)
    raise ValueError(family)
