"""Elastic re-sharding — ``repro.distributed.elastic``.

A stacked index of P shards restarts as P' shards (a lost card, a larger
fleet). Vectors are re-routed by the same hash rule and each new shard is
re-bulk-linked by the exact-kNN constructor (``core.rebuild.bulk_knn_build``,
which runs on ``score_topk`` and ``score_matrix``): edges are shard-local,
so only graphs, not data, are recomputed. The work stays on the state's
device; only the id remap comes back to the host. Each new shard links on
its own, so ``shards=`` builds only some of them: a rank of a sharded
session links its own block, and every rank gets the same global remap.
With pods on their own ranks the block is pod-relative
(``ann.shard_block``), so each pod bulk-links its own replica, as each of
JAX's pods does on its devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rebuild
from repro_torch.core.graph import GraphState
from repro_torch.core.params import IndexParams
from repro_torch.distributed.ann import stack_states


def _stride_of(params: IndexParams, cap_live: int) -> int:
    """The gid stride of a sharded session under ``params``: pinned to
    ``max_capacity`` when growth is armed (gids survive tier moves), the
    live per-shard capacity otherwise. Mirrors ``DistParams.gid_stride``."""
    mp = params.maintenance
    return mp.max_capacity if mp.max_capacity is not None else cap_live


def _alive_rows(state_stacked: GraphState, stride: int | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(f32 rows, int64 gids) of every alive slot in stacked order, on the
    state's device."""
    P, cap, dim = state_stacked.vectors.shape
    stride = cap if stride is None else stride
    idx = torch.nonzero(state_stacked.alive.reshape(P * cap)).flatten()
    gids = torch.div(idx, cap, rounding_mode="floor") * stride + idx % cap
    return state_stacked.vectors.reshape(P * cap, dim)[idx].float(), gids


def gather_alive(state_stacked: GraphState, *, stride: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (vectors, global ids) of every alive vertex across shards.

    ``stride`` is the gid encoding stride (``gid = shard · stride + lid``),
    the live per-shard capacity by default; pass an armed session's stride
    (``max_capacity``) to get the ids it handed out. Vectors come back as
    f32 (a bf16 state's rows widened exactly: numpy has no bf16)."""
    vecs, gids = _alive_rows(state_stacked, stride)
    return vecs.cpu().numpy(), gids.cpu().numpy()


def reshard(state_stacked: GraphState, old_params: IndexParams,
            new_params: IndexParams, n_new_shards: int, *,
            route: str = "hash", shards: range | None = None
            ) -> tuple[GraphState, np.ndarray]:
    """Re-shard a stacked index to ``n_new_shards`` shards of
    ``new_params.capacity`` slots, on the state's device.

    Returns (new stacked state, host remap old_gid → new_gid, -1 where
    none). Old gids decode with the old config's stride, new ones encode
    with the new config's, so growth-armed sessions translate the ids they
    handed out. Each new shard is bulk-linked on its own (f32 rows).
    ``shards`` (a range of new shard indices, all by default) links only
    those: the state stacks just them, byte-equal to the same shards of
    the full call, and the remap is still the global one."""
    dev = state_stacked.device
    old_stride = _stride_of(old_params, int(state_stacked.vectors.shape[1]))
    new_stride = _stride_of(new_params, new_params.capacity)
    vecs, old_gids = _alive_rows(state_stacked, old_stride)
    n = vecs.shape[0]
    cap = new_params.capacity
    if route == "hash":
        owner = old_gids % n_new_shards
    else:  # round-robin balance
        owner = torch.arange(n, device=dev) % n_new_shards

    shard_states = []
    remap = np.full(int(old_gids.max()) + 1 if n else 1, -1, np.int64)
    old_host = old_gids.cpu().numpy()
    owner_host = owner.cpu().numpy()
    counts = np.bincount(owner_host, minlength=n_new_shards)
    if counts.max(initial=0) > cap:
        s = int(counts.argmax())
        raise ValueError(
            f"shard {s} would hold {int(counts[s])} > capacity {cap}; "
            f"raise capacity or shard count")
    for s in range(n_new_shards):
        remap[old_host[owner_host == s]] = s * new_stride + np.arange(counts[s])
    for s in range(n_new_shards) if shards is None else shards:
        mine = owner == s
        count = int(counts[s])
        padded = torch.zeros((cap, new_params.dim), dtype=torch.float32,
                             device=dev)
        padded[:count] = vecs[mine]
        valid = torch.arange(cap, device=dev) < count
        shard_states.append(
            rebuild.bulk_knn_build(padded, valid, new_params, device=dev))
    return stack_states(shard_states), remap
