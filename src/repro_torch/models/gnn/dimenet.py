"""DimeNet (Gasteiger et al. 2020) — directional message passing
(``repro.models.gnn.dimenet``).

Messages live on *edges*; each interaction block aggregates over triplets
(k→j→i) with a radial-Bessel × angular basis and a bilinear contraction,
then scatter-sums back to edges. Triplet lists come from the host-side
``build_triplets`` with a ``max_triplets`` cap; angles are computed in-model
from node positions.

Faithful simplifications, as in JAX: radial basis = spherical Bessel
sin(nπd/c)/d as in the paper; angular basis = Chebyshev cos(lθ) instead of
full spherical harmonics (same triplet compute pattern / FLOP structure).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch import resolve_device
from repro_torch.models.gnn.common import GraphData, ParamTree, gather, scatter_sum
from repro_torch.models.layers import dense, dense_init


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_in: int = 16          # node (atom-type) feature dim
    cutoff: float = 5.0
    n_targets: int = 1


def init_params(cfg: DimeNetConfig, generator: torch.Generator, device=None
                ) -> ParamTree:
    """The pair ``(params, {"blocks": [...]})`` as JAX's ``init_params``
    returns it, as one tree whose ``leaves()`` list ``params`` first."""
    dev = resolve_device(device)
    d, nr, ns, nb = cfg.d_hidden, cfg.n_radial, cfg.n_spherical, cfg.n_bilinear

    def lin(a, b):
        return dense_init(generator, a, b, device=dev)

    params = {"embed_node": lin(cfg.d_in, d), "embed_edge": lin(2 * d + nr, d),
              "out_rbf": lin(nr, d), "out1": lin(d, d), "out2": lin(d, cfg.n_targets)}
    blocks = [{
        "w_msg": lin(d, d), "w_rbf": lin(nr, d), "w_sbf": lin(ns * nr, nb),
        "bilinear": torch.randn((nb, d, d), generator=generator, device=dev) * (1.0 / d),
        "w_out1": lin(d, d), "w_out2": lin(d, d),
    } for _ in range(cfg.n_blocks)]
    return ParamTree((params, {"blocks": blocks}), dev)


def from_jax_params(cfg: DimeNetConfig, pair, device=None) -> ParamTree:
    """JAX's pair ``(params, {"blocks": ...})`` (numpy leaves)."""
    params, blocks = pair
    return ParamTree((params, blocks), resolve_device(device))


def _bessel_rbf(dist, n_radial, cutoff):
    """sin(nπ d/c) / d — the paper's radial basis."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=dist.device)
    d = torch.clamp(dist, min=1e-6)[:, None]
    env = (2.0 / cutoff) ** 0.5
    return env * torch.sin(n * math.pi * d / cutoff) / d


def _angular_basis(cos_angle, n_spherical):
    """Chebyshev cos(lθ) basis via recurrence (surrogate for SH)."""
    out = [torch.ones_like(cos_angle), cos_angle]
    for _ in range(n_spherical - 2):
        out.append(2.0 * cos_angle * out[-1] - out[-2])
    return torch.stack(out[:n_spherical], dim=-1)             # [T, ns]


def _bilinear(a, w, m_kj):
    """``einsum("tb,bde,td->te", a, w, m_kj)`` through ``[T, nb, d]``
    (``m_kj`` against every ``w_b`` at once), never ``[T, nb, d, d]``."""
    nb, d, e = w.shape
    y = (m_kj @ w.permute(1, 0, 2).reshape(d, nb * e)).view(-1, nb, e)
    return torch.bmm(a[:, None, :], y)[:, 0]


def forward(params_pair, g: GraphData, triplets: dict, cfg: DimeNetConfig
            ) -> torch.Tensor:
    """triplets = {"edge_kj": i32[T], "edge_ji": i32[T], "mask": bool[T]}
    → per-graph targets f32[G] (energy-style regression)."""
    params, blocks = params_pair
    N, E = g.n_nodes, g.n_edges
    pos = g.positions
    vec = gather(pos, g.senders) - gather(pos, g.receivers)   # edge j→i vector
    dist = torch.sqrt(torch.clamp((vec * vec).sum(-1), min=1e-12))
    rbf = _bessel_rbf(dist, cfg.n_radial, cfg.cutoff)        # [E, nr]
    rbf = torch.where(g.edge_mask[:, None], rbf, 0.0)

    # ---- triplet geometry: angle at j between (k→j) and (j→i) ----
    e_kj, e_ji, t_mask = triplets["edge_kj"], triplets["edge_ji"], triplets["mask"]
    v_kj = -gather(vec, e_kj)                                # k→j direction
    v_ji = gather(vec, e_ji)
    num = (v_kj * v_ji).sum(-1)
    den = torch.clamp(torch.linalg.vector_norm(v_kj, dim=-1)
                      * torch.linalg.vector_norm(v_ji, dim=-1), min=1e-9)
    cos_a = torch.clamp(num / den, -1.0, 1.0)
    sbf = _angular_basis(cos_a, cfg.n_spherical)             # [T, ns]
    sbf = sbf[:, :, None] * gather(rbf, e_kj)[:, None, :]    # [T, ns, nr]
    sbf = sbf.reshape(sbf.shape[0], -1)
    sbf = torch.where(t_mask[:, None], sbf, 0.0)

    # ---- embedding block ----
    hx = F.silu(dense(params.embed_node, g.x))               # [N, d]
    m = F.silu(dense(
        params.embed_edge,
        torch.cat([gather(hx, g.senders), gather(hx, g.receivers), rbf], dim=-1),
    ))                                                        # [E, d]

    node_out = scatter_sum(
        torch.where(g.edge_mask[:, None], m * dense(params.out_rbf, rbf), 0.0),
        g.receivers, N,
    )

    # ---- interaction blocks: directional triplet aggregation ----
    for bp in blocks.blocks:
        m_kj = gather(F.silu(dense(bp.w_msg, m)), e_kj)      # [T, d]
        a = dense(bp.w_sbf, sbf)                             # [T, nb]
        # bilinear: t_bd = Σ_b a[t,b] · (m_kj W_b)  (paper eq. 9)
        inter = _bilinear(a, bp.bilinear, m_kj)
        inter = torch.where(t_mask[:, None], inter, 0.0)
        agg = scatter_sum(inter, e_ji, E)                    # [E, d]
        m = m + F.silu(dense(bp.w_out1, m * dense(bp.w_rbf, rbf) + agg))
        node_out = node_out + scatter_sum(
            torch.where(g.edge_mask[:, None], F.silu(dense(bp.w_out2, m)), 0.0),
            g.receivers, N,
        )

    # ---- readout: per-graph sum ----
    h = F.silu(dense(params.out1, node_out))
    per_node = dense(params.out2, h)[:, 0]                   # [N]
    per_node = torch.where(g.node_mask, per_node, 0.0)
    return scatter_sum(per_node, g.graph_ids, g.targets.shape[0])


def build_triplets(senders, receivers, n_edges: int, max_triplets: int):
    """Host-side triplet builder: for each edge (j→i), pair with incoming
    edges (k→j), k ≠ i. Returns padded index arrays (numpy)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    in_edges: dict[int, list[int]] = {}
    for eid in range(len(senders)):
        in_edges.setdefault(int(receivers[eid]), []).append(eid)
    e_kj, e_ji = [], []
    for eid in range(len(senders)):
        j, i = int(senders[eid]), int(receivers[eid])
        for kj in in_edges.get(j, ()):
            if int(senders[kj]) != i:
                e_kj.append(kj)
                e_ji.append(eid)
                if len(e_kj) >= max_triplets:
                    break
        if len(e_kj) >= max_triplets:
            break
    T = len(e_kj)
    pad = max_triplets - T
    return {
        "edge_kj": np.asarray(e_kj + [0] * pad, np.int32),
        "edge_ji": np.asarray(e_ji + [0] * pad, np.int32),
        "mask": np.asarray([True] * T + [False] * pad, bool),
    }
