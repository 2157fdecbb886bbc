"""Sharded online ANN index — ``repro.distributed.ann``, on one device or
one rank per card.

Layout: shard-per-device subgraphs, as in JAX. Each shard owns ``cap``
slots and an independent proximity graph over them; there are no
cross-shard edges, so the delete and repair algorithms run unmodified
inside every shard.

  query : every shard beam-searches its subgraph → the per-shard top-k
          lists merge into one (hierarchically: over 'model' first, then
          over 'data', each stage a ``topk_union``);
  insert: routed by ``route % S`` → every shard runs the batched insert on
          the *full* batch with only its own lanes valid; the owner
          announces each gid (a max over shards);
  delete: ``gid = shard · stride + local id`` → owner-masked
          ``delete_batch`` with the configured strategy.

How the mesh maps onto one device. :class:`ShardMesh`
(``launch/mesh.py``) holds axis sizes only. The S shards are stacked on a
leading axis of one ``GraphState`` (``init_sharded_state``): the layout
and dtypes of JAX's stacked state, so checkpoints and test arrays compare
directly. Position ``s`` on the stack is the row-major index over the
shard axes (JAX's ``_shard_index``), and every per-shard key is
``fold_in(key, s)``. The collectives become tensor
ops over the stacked axis: ``all_gather`` is the stack itself, ``pmax``
over gids a max over shards, the merge a reshape to the mesh shape. A
``pod`` axis holds replicas in JAX and splits the query batch; in one
process the port keeps one replica and runs the batch pod by pod, each
pod's lanes counting from 0 as the per-pod JAX program's do.

Writes loop over the shards: shard ``s`` runs the port's
``insert_batch_impl``, ``delete_batch`` or ``consolidate_chunk_impl`` on a
``GraphState`` of views ``x[s]`` into the stack. Those engines update in
place, so they write straight into the stack; a field an engine replaced
instead would be copied back. Every shard runs every op, also with no
lane of its own, as every shard of the JAX program does (an op with no
valid lane still advances the shard's ``tclock``).

Queries fold the shards into one ``beam_search`` call over ``S·B`` lanes
on a flat view of the stack (``flat_view``: ``adj`` offset by ``s·cap``,
every other field a free reshape), with each shard's entry points drawn
over its own ``cap`` slots and offset. The beam loop's lanes never
interact and the pool is the visited set, so the folded call gives the
per-shard calls' ids and scores bit for bit, for about one op's launches
instead of S ops'. ``make_query_step(..., fold=False)`` keeps the
per-shard loop as the plain version the tests hold the fold against.

One rank per card. Every step builder and ``ShardedSession`` take
``group``, a ``launch.mesh.CardGroup`` of W ranks. Without a pod axis
(W divides S) rank r holds the contiguous block of global shards
``[r·S/W, (r+1)·S/W)`` as its local stack; every per-shard key, owner
test and gid offset uses the global shard index, so each rank computes
the stack's bytes for its block. The collectives of JAX's ``shard_map``
programs become ``torch.distributed`` calls: the query ``all_gather``s the
per-shard top-k lists into ``[S, B, K]`` in rank order before the same
merge, the insert takes an ``all_reduce(MAX)`` over the announced gids,
delete and consolidate need none. Inputs and results are replicated on
every rank, as JAX's ``P()``. Every host decision (growth, consolidation
passes, the counts behind them) reads gathered per-shard counts, so every
rank takes it alike and enters the same collectives. ``group=None`` is the
stacked layout above, the plain version the rank path is held against.

Pods on their own ranks. With a ``pod`` axis of size P (P divides W; a
one-rank group keeps the pod loop) each pod is a replica of all S shards
on G = W/P ranks, row-major as JAX orders the devices: rank r is in pod
``r // G`` and holds the pod-relative block ``[g·S/G, (g+1)·S/G)``, g =
``r % G`` (G divides S). ``CardGroup.split`` gives it two subgroups: the
replica group (its pod's ranks) and the pod-peer group (the ranks holding
the same block in every pod). A query op takes its pod's slice of the
batch, runs the pod loop's body over the replica group, and the pods'
answers meet in an ``all_gather`` over the pod-peer group (JAX's
``out_specs=P(pod)``): every rank returns the whole ``[B, k]``. Writes
run in full on every replica (JAX's ``P()`` inputs), the insert's max
over the replica group only (JAX's ``pmax`` over the shard axes). Host
decisions gather the per-shard counts over the replica group and compare
them across pods over the pod-peer group: replicas that disagree raise
:class:`ReplicaMismatch` on every rank.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.core import consolidate as consolidate_mod
from repro_torch.core import delete as delete_mod
from repro_torch.core import insert as insert_mod
from repro_torch.core import maint, prng
from repro_torch.core import search as search_mod
from repro_torch.core.distances import sqnorm
from repro_torch.core.graph import (
    DATA_FIELDS,
    NULL,
    GraphState,
    grow_state,
    init_graph,
    mask_to_slots,
    next_capacity_tier,
)
from repro_torch.core.params import IndexParams
from repro_torch.core.quantize import quantize_rows
from repro_torch.core.session import PhaseTimers, consolidate_gate_crossed
from repro_torch.core.stable import top_k
from repro_torch.launch.mesh import CardGroup, ShardMesh
from repro_torch.testing import faults

_VEC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DistParams:
    """Distribution config for the sharded index."""
    index: IndexParams           # per-shard params (capacity = cap_local)
    shard_axes: tuple[str, ...] = ("data", "model")
    pod_axis: str | None = None  # set for multi-pod meshes
    hierarchical_merge: bool = True  # two-stage top-k fan-in: merge within
                                     # 'model' first, then across 'data'
    vec_dtype: str = "float32"       # "bfloat16" halves gather traffic

    @property
    def axes(self) -> tuple[str, ...]:
        return self.shard_axes

    @property
    def torch_vec_dtype(self) -> torch.dtype:
        return _VEC_DTYPES[self.vec_dtype]

    def gid_stride(self) -> int:
        """Global-id stride: ``gid = shard · stride + local id``. Pinned to
        ``maintenance.max_capacity`` when capacity growth is armed, so gids
        handed out at one tier stay valid after every shard grows; the
        (then fixed) per-shard capacity otherwise."""
        mp = self.index.maintenance
        return (mp.max_capacity if mp.max_capacity is not None
                else self.index.capacity)


def num_shards(dp: DistParams, mesh: ShardMesh) -> int:
    return math.prod(mesh.size(a) for a in dp.shard_axes)


class ReplicaMismatch(RuntimeError):
    """The pods' replicas of the shards hold different counts."""


def _rank_pods(dp: DistParams, mesh: ShardMesh,
               group: CardGroup | None) -> int:
    """The pods laid over the group's ranks: the pod axis's size with a
    group of two ranks or more, else 1 (no group, a one-rank group or no
    pod axis: one replica in this process). Raises where they do not
    split the ranks."""
    if group is None or group.world == 1 or not dp.pod_axis:
        return 1
    pods = mesh.size(dp.pod_axis)
    if group.world % pods:
        raise ValueError(f"{group.world} ranks do not split over {pods} pods")
    return pods


def pod_of(dp: DistParams, mesh: ShardMesh,
           group: CardGroup | None = None) -> int:
    """The pod whose replica this rank holds (0 with one replica)."""
    pods = _rank_pods(dp, mesh, group)
    return 0 if pods == 1 else group.rank // (group.world // pods)


def pod_groups(dp: DistParams, mesh: ShardMesh, group: CardGroup | None
               ) -> tuple[CardGroup | None, CardGroup | None]:
    """(replica group, pod-peer group) of this rank: the group and None
    with one replica over the group, ``group.split(pods)`` with pods on
    their own ranks, (None, None) without a group."""
    pods = _rank_pods(dp, mesh, group)
    return (group, None) if pods == 1 else group.split(pods)


def shard_block(dp: DistParams, mesh: ShardMesh,
                group: CardGroup | None = None) -> range:
    """The global shards this process holds: all S without a group, the
    rank's contiguous block of S/G with one, G the ranks of its pod (the
    whole group without pods on their own ranks; G must divide S)."""
    S = num_shards(dp, mesh)
    if group is None:
        return range(S)
    pods = _rank_pods(dp, mesh, group)
    G = group.world // pods
    if S % G:
        what = f"{G} ranks a pod" if pods > 1 else f"{G} ranks"
        raise ValueError(f"{what} do not divide {S} shards")
    n = S // G
    g = group.rank % G
    return range(g * n, (g + 1) * n)


def init_sharded_state(dp: DistParams, mesh: ShardMesh, *,
                       device=None, group: CardGroup | None = None
                       ) -> GraphState:
    """The stacked per-shard states ``[S, cap_local, ...]`` (``size``,
    ``clock`` and ``tclock`` become ``[S]``), on the card unless ``device``
    says otherwise; with a group, the rank's block ``[S/W, ...]`` on its
    device."""
    dev = group.device if group is not None else resolve_device(device)
    one = init_graph(
        dp.index.capacity, dp.index.dim, d_out=dp.index.d_out,
        d_in=dp.index.eff_d_in, metric=dp.index.metric,
        dtype=dp.torch_vec_dtype, device=dev)
    n = len(shard_block(dp, mesh, group))
    return dataclasses.replace(one, **{
        f: getattr(one, f)[None].expand(n, *getattr(one, f).shape).clone()
        for f in DATA_FIELDS})


def gather_state(state: GraphState, group: CardGroup | None) -> GraphState:
    """Every rank's block of ``group`` concatenated in rank order, on every
    rank (the stack itself without a group): over the replica group
    (``pod_groups``; the whole group without pods on their own ranks) the
    global stack ``[S, ...]`` of one replica, checkpoints in JAX's layout,
    and the checks."""
    if group is None:
        return state
    return dataclasses.replace(state, **{
        f: group.all_gather(getattr(state, f)) for f in DATA_FIELDS})


def shard_count(state_stacked: GraphState) -> int:
    return int(state_stacked.vectors.shape[0])


def shard_view(state_stacked: GraphState, s: int) -> GraphState:
    """Shard ``s`` as a ``GraphState`` of views into the stack (JAX's
    ``_local``): in-place updates of the view land in the stack."""
    return dataclasses.replace(
        state_stacked, **{f: getattr(state_stacked, f)[s] for f in DATA_FIELDS})


def _write_back(state_stacked: GraphState, s: int, view: GraphState,
                out: GraphState) -> None:
    """Copy into the stack every field an engine replaced rather than
    updated in place (JAX's ``_restack``)."""
    for f in DATA_FIELDS:
        t = getattr(out, f)
        if t is not getattr(view, f):
            getattr(state_stacked, f)[s].copy_(t)


def stack_states(states: list[GraphState]) -> GraphState:
    """One stacked state from per-shard states of one shape."""
    return dataclasses.replace(states[0], **{
        f: torch.stack([getattr(st, f) for st in states]) for f in DATA_FIELDS})


def bf16_rows(state: GraphState) -> GraphState:
    """The state with its rows kept in bf16, as the sharded config stores
    them (``DistParams(vec_dtype="bfloat16")``): each present row cast to
    bf16, its sqnorm and int8 codes taken from the cast row — the bytes the
    insert path writes for a bf16 row; the graph stays the one built over
    the f32 rows (``reshard`` and the bulk build make f32 states, as JAX's
    do)."""
    vb = state.vectors.bfloat16()
    p = state.present
    codes, scales = quantize_rows(vb)
    return dataclasses.replace(
        state, vectors=vb, sqnorms=torch.where(p, sqnorm(vb), 0.0),
        codes=torch.where(p[..., None], codes, 0),
        scales=torch.where(p, scales, 0.0))


@tracing.spanned("sharded.flat_view")
def flat_view(state_stacked: GraphState) -> GraphState:
    """The stack as one ``S·cap``-slot graph for the beam engine: ``adj``
    entries of shard s offset by ``s·cap`` (a new tensor), every other
    per-slot field a free reshape. For searching only: ``radj`` is not
    offset, and the scalars are the sums over shards."""
    S, cap = state_stacked.vectors.shape[:2]
    off = (torch.arange(S, device=state_stacked.device, dtype=torch.int32)
           * cap)[:, None, None]
    adj = state_stacked.adj
    flat = {f: getattr(state_stacked, f).reshape(
        S * cap, *getattr(state_stacked, f).shape[2:])
        for f in DATA_FIELDS if f not in ("size", "clock", "tclock")}
    flat["adj"] = torch.where(adj != NULL, adj + off, NULL).reshape(S * cap, -1)
    for f in ("size", "clock", "tclock"):
        flat[f] = getattr(state_stacked, f).sum(dtype=torch.int32)
    return dataclasses.replace(state_stacked, **flat, capacity=S * cap)


def topk_union(flat_scores: torch.Tensor, flat_ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge concatenated partial top-k lists into one top-k per row.

    ``flat_scores``/``flat_ids``: [B, m·k] candidates from m sources
    (higher score = better; invalid lanes carry -inf / NULL). ``lax.top_k``'s
    order: the IEEE total order (+0.0 above -0.0), ties to the lower
    column. The fan-in of the sharded query merge and of the two-tier
    index's ``ground_truth``."""
    top_s, idx = top_k(flat_scores, k)
    return top_s, torch.gather(flat_ids, 1, idx)


@tracing.spanned("sharded.merge")
def _merge(scores: torch.Tensor, gids: torch.Tensor, dp: DistParams,
           mesh: ShardMesh, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard lists ``[S, B, K]`` → the fan-in ``[B, k]``. Two-stage as
    JAX's: a union over the last shard axis within each group of the
    others, then one over the groups, each in row-major shard order."""
    S, B, K = scores.shape

    def union(s, i, m):                          # [n, m, B, K] → [n, B, k]
        n = s.shape[0]
        fs = s.permute(0, 2, 1, 3).reshape(n * B, m * K)
        fi = i.permute(0, 2, 1, 3).reshape(n * B, m * K)
        ts, ti = topk_union(fs, fi, k)
        return ts.reshape(n, B, k), ti.reshape(n, B, k)

    axes = dp.shard_axes
    if dp.hierarchical_merge and len(axes) > 1:
        m = mesh.size(axes[-1])
        s1, i1 = union(scores.reshape(S // m, m, B, K),
                       gids.reshape(S // m, m, B, K), m)
        ts, ti = union(s1[None], i1[None], S // m)
    else:
        ts, ti = union(scores[None], gids[None], S)
    return ts[0], ti[0]


def _shard_starts(state_stacked: GraphState, key: torch.Tensor, B: int,
                  num_starts: int, s0: int = 0) -> torch.Tensor:
    """Entry points ``[S, B, starts]`` of each shard over its own slots,
    lane i of global shard s from ``fold_in(fold_in(key, s), i)``, the
    stack's first shard being global shard ``s0``; local ids."""
    return torch.stack([
        search_mod.batch_entry_points(shard_view(state_stacked, j),
                                      prng.fold_in(key, s0 + j), B, num_starts)
        for j in range(shard_count(state_stacked))])


def fanout_search(state_stacked: GraphState, queries: torch.Tensor,
                  key: torch.Tensor, params: IndexParams, *, fold: bool = True,
                  flat: GraphState | None = None, s0: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every shard's search of every query: (local ids, scores), each
    ``[S, B, pool]``. ``fold=True`` runs one ``beam_search`` over the S·B
    lanes on ``flat`` (``flat_view(state_stacked)`` unless given); the
    plain version runs one per shard. ``s0`` is the global index of the
    stack's first shard (a rank's block)."""
    sp = params.search
    S, cap = state_stacked.vectors.shape[:2]
    B = queries.shape[0]
    starts = _shard_starts(state_stacked, key, B, sp.num_starts, s0)
    if not fold:
        res = [search_mod.beam_search(shard_view(state_stacked, s), queries,
                                      starts[s], sp) for s in range(S)]
        return (torch.stack([r.ids for r in res]),
                torch.stack([r.scores for r in res]))
    off = (torch.arange(S, device=starts.device, dtype=torch.int32)
           * cap)[:, None, None]
    flat = flat_view(state_stacked) if flat is None else flat
    res = search_mod.beam_search(
        flat, queries.repeat(S, 1),
        torch.where(starts != NULL, starts + off, NULL).reshape(S * B, -1), sp)
    ids = res.ids.reshape(S, B, -1)
    return (torch.where(ids != NULL, ids - off, NULL),
            res.scores.reshape(S, B, -1))


def _check_shards(state_stacked: GraphState, dp: DistParams,
                  mesh: ShardMesh, group: CardGroup | None) -> tuple[int, int]:
    """(S, global index of the stack's first shard)."""
    block = shard_block(dp, mesh, group)
    if shard_count(state_stacked) != len(block):
        raise ValueError(f"state has {shard_count(state_stacked)} shards, "
                         f"this process holds {len(block)}")
    return num_shards(dp, mesh), block.start


def make_query_step(dp: DistParams, mesh: ShardMesh, *, fold: bool = True,
                    group: CardGroup | None = None):
    """The fan-out query step: ``step(state, queries f32[B, dim], key,
    flat=None) → (gids i32[B, k], scores f32[B, k])``, k the pool size.
    With a pod axis the batch splits into equal pod slices, each run as
    its own program. ``flat`` is a cached ``flat_view`` of the state. With
    a group each rank searches its block and the per-shard lists are
    ``all_gather``ed over the replica group before the merge; with pods on
    their own ranks each pod runs its slice and the slices' answers are
    ``all_gather``ed over the pod-peer group. Every rank returns the
    answer."""
    stride = dp.gid_stride()
    pods = mesh.size(dp.pod_axis) if dp.pod_axis else 1
    replica, peers = pod_groups(dp, mesh, group)
    pod = pod_of(dp, mesh, group)

    def step(state_stacked: GraphState, queries, key: torch.Tensor, *,
             flat: GraphState | None = None):
        _, s0 = _check_shards(state_stacked, dp, mesh, group)
        n = shard_count(state_stacked)
        dev = state_stacked.device
        q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        key = key.to(dev)
        if fold and flat is None:
            flat = flat_view(state_stacked)
        if q.shape[0] % pods:
            raise ValueError(f"batch {q.shape[0]} does not split over "
                             f"{pods} pods")
        shard_off = (torch.arange(s0, s0 + n, device=dev, dtype=torch.int32)
                     * stride)[:, None, None]
        slices = q.chunk(pods) if pods > 1 else (q,)
        out_i, out_s = [], []
        for qp in slices if peers is None else (slices[pod],):
            lids, scores = fanout_search(state_stacked, qp, key, dp.index,
                                         fold=fold, flat=flat, s0=s0)
            gids = torch.where(lids != NULL, lids + shard_off, NULL)
            if replica is not None:  # JAX's all_gather of the per-shard lists
                scores, gids = replica.all_gather(scores), replica.all_gather(gids)
            top_s, top_i = _merge(scores, gids, dp, mesh, dp.index.search.pool_size)
            out_i.append(top_i)
            out_s.append(top_s)
        top_i, top_s = torch.cat(out_i), torch.cat(out_s)
        if peers is not None:       # JAX's out_specs=P(pod): pods in order
            top_i, top_s = peers.all_gather(top_i), peers.all_gather(top_s)
        return top_i, top_s

    return step


def make_insert_step(dp: DistParams, mesh: ShardMesh, *,
                     group: CardGroup | None = None):
    """Routed batch insert: ``step(state, vectors f32[B, dim], route i32[B],
    key) → (state, gids i32[B])``, in place; NULL where the owner was
    full. With a group the ranks' announcements meet in an
    ``all_reduce(MAX)`` over the replica group; every pod inserts the
    whole batch into its replica."""
    stride = dp.gid_stride()
    replica, _ = pod_groups(dp, mesh, group)

    def step(state_stacked: GraphState, vecs, route, key: torch.Tensor):
        S, s0 = _check_shards(state_stacked, dp, mesh, group)
        dev = state_stacked.device
        vecs = torch.as_tensor(vecs, dtype=torch.float32).to(dev)
        route = torch.as_tensor(route).to(dev, torch.int64)
        key = key.to(dev)
        gids = torch.full((vecs.shape[0],), NULL, dtype=torch.int32, device=dev)
        for j in range(shard_count(state_stacked)):
            s = s0 + j
            mine = (route % S) == s
            view = shard_view(state_stacked, j)
            out, ids = insert_mod.insert_batch_impl(
                view, vecs, mine, prng.fold_in(key, s), dp.index)
            _write_back(state_stacked, j, view, out)
            g = torch.where(ids != NULL, ids + s * stride, NULL)
            # the owner announces its gid, everyone else NULL: the max is
            # exact since real gids are >= 0 (JAX's pmax)
            gids = torch.maximum(gids, torch.where(mine, g, NULL)
                                 .to(torch.int32))
        if replica is not None:
            replica.all_reduce(gids, "max")
        return state_stacked, gids

    return step


def make_delete_step(dp: DistParams, mesh: ShardMesh, strategy: str, *,
                     group: CardGroup | None = None):
    """Owner-masked delete of global ids: ``step(state, gids i32[B], key) →
    state``, in place. Each rank repairs its own block (every pod its
    replica); no collective."""
    stride = dp.gid_stride()

    def step(state_stacked: GraphState, gids, key: torch.Tensor):
        _, s0 = _check_shards(state_stacked, dp, mesh, group)
        dev = state_stacked.device
        gids = torch.as_tensor(gids).to(dev, torch.int64)
        key = key.to(dev)
        owner = torch.div(gids, stride, rounding_mode="floor")
        lids = torch.remainder(gids, stride).to(torch.int32)
        for j in range(shard_count(state_stacked)):
            s = s0 + j
            # with growth armed the stride exceeds the live tier: local ids
            # are valid only below the current per-shard capacity
            valid = (gids != NULL) & (owner == s) & (lids < dp.index.capacity)
            view = shard_view(state_stacked, j)
            out = delete_mod.delete_batch(view, lids, valid,
                                          prng.fold_in(key, s), strategy,
                                          dp.index)
            _write_back(state_stacked, j, view, out)
        return state_stacked

    return step


def make_consolidate_step(dp: DistParams, mesh: ShardMesh, *,
                          group: CardGroup | None = None):
    """One per-shard compaction pass: ``step(state, key) → state``, in
    place. Every shard compacts its ``consolidate_chunk`` lowest-id
    tombstones (a partly valid or empty frame where it has fewer); the
    host loops passes until the most loaded shard is drained. Each rank
    compacts its own block (every pod its replica); no collective."""
    mp = dp.index.maintenance
    chunk = mp.consolidate_chunk or mp.delete_chunk

    def step(state_stacked: GraphState, key: torch.Tensor):
        _, s0 = _check_shards(state_stacked, dp, mesh, group)
        key = key.to(state_stacked.device)
        for j in range(shard_count(state_stacked)):
            view = shard_view(state_stacked, j)
            tomb, tv = mask_to_slots(view.masked, chunk)
            out, _ = consolidate_mod.consolidate_chunk_impl(
                view, tomb, tv, prng.fold_in(key, s0 + j), dp.index)
            _write_back(state_stacked, j, view, out)
        return state_stacked

    return step


def init_specs_tree(dp: DistParams) -> GraphState:
    """A ``GraphState``-shaped tree of one shard's stacked shapes
    ``[1, ...]`` and dtypes, on the meta device (structure only)."""
    one = init_graph(dp.index.capacity, dp.index.dim, d_out=dp.index.d_out,
                     d_in=dp.index.eff_d_in, metric=dp.index.metric,
                     dtype=dp.torch_vec_dtype, device="meta")
    return dataclasses.replace(one, **{f: getattr(one, f)[None]
                                       for f in DATA_FIELDS})


# convenience host-level wrappers -------------------------------------------

def distributed_query(state, queries, key, dp, mesh):
    return make_query_step(dp, mesh)(state, queries, key)


def distributed_insert(state, vecs, route, key, dp, mesh):
    return make_insert_step(dp, mesh)(state, vecs, route, key)


def distributed_delete(state, gids, key, dp, mesh, strategy="global"):
    return make_delete_step(dp, mesh, strategy)(state, gids, key)


class ShardedSession:
    """Session-style driver over the sharded index (``repro``'s
    ``ShardedSession``): owns the stacked state (updated in place), builds
    the four steps once per capacity tier (with ``maintenance.max_capacity``
    armed the insert gate grows every shard in lockstep; gids stay valid
    because their stride is ``max_capacity``), derives op keys from one seed
    chain, and keeps the folded query's flat view of the state until the
    next write. Refused inserts come back as NULL gids and are counted into
    ``timers.n_refused`` at the next ``flush``. ``state`` starts the session
    from a stacked state of the mesh's shard count and ``dp``'s capacity
    (for example one ``elastic.reshard`` placed).

    With ``group`` (one rank per card) every rank runs the same calls on
    replicated inputs and holds its block of shards in ``state`` (with
    pods on their own ranks, its block of its pod's replica); a given
    ``state`` is either the global stack, of which the rank keeps its block,
    or the block itself (``elastic.reshard(..., shards=...)``).
    ``gather_state()`` returns the global stack of the rank's replica. The
    timers are the rank's own: every rank counts each op once, with its
    whole batch. ``op_counters`` resumes the op and consolidation key
    chains (a restored checkpoint's ``op_counters``)."""

    def __init__(self, dp: DistParams, mesh: ShardMesh, *,
                 strategy: str | None = None, seed: int = 0, device=None,
                 state: GraphState | None = None,
                 group: CardGroup | None = None,
                 op_counters: tuple[int, int] = (0, 0)):
        self.dp = dp
        self.mesh = mesh
        self.group = group
        self.replica, self.peers = pod_groups(dp, mesh, group)
        self._strategy = (strategy if strategy is not None
                          else dp.index.maintenance.strategy)
        self._build_steps()
        block = shard_block(dp, mesh, group)
        fresh = state is None
        if fresh:
            state = init_sharded_state(dp, mesh, device=device, group=group)
        elif state.capacity != dp.index.capacity:
            raise ValueError("state does not match the capacity")
        elif shard_count(state) == num_shards(dp, mesh) != len(block):
            state = dataclasses.replace(state, **{
                f: getattr(state, f)[block.start:block.stop].clone()
                for f in DATA_FIELDS})
        elif shard_count(state) != len(block):
            raise ValueError("state does not match the mesh")
        if group is not None and state.device != group.device:
            raise ValueError(f"state on {state.device}, the rank's card is "
                             f"{group.device}")
        self.state = state
        self._base_key = prng.prng_key(seed, device=self.state.device)
        self._op_counter, self._consolidate_counter = map(int, op_counters)
        self._flat: GraphState | None = None    # the query's view, per version
        self._insert_results: list[torch.Tensor] = []  # gid tensors → n_refused
        self._window_t0: float | None = None
        self.timers = PhaseTimers()
        # consolidation bookkeeping, the core session's host gate: an
        # overestimated tombstone count against an underestimated present
        # count; the device-exact check runs only on crossing
        self._in_consolidate = False
        self._masked_hint = 0
        self._present_floor = 0
        # growth bookkeeping: ``_free_floor`` underestimates the free slots
        # of the most loaded shard (each insert op subtracts its whole
        # batch — the router could land it all on one shard); a given
        # state is measured at the first insert
        self._free_floor = dp.index.capacity if fresh else 0
        if not fresh:
            self._masked_hint = int(self._per_shard_masked().sum())
            self._present_floor = int(self._per_shard_present().sum())

    def _build_steps(self) -> None:
        """(Re)build the four steps for the current capacity tier."""
        g = self.group
        self._query_step = make_query_step(self.dp, self.mesh, group=g)
        self._insert_step = make_insert_step(self.dp, self.mesh, group=g)
        self._delete_step = make_delete_step(self.dp, self.mesh,
                                             self._strategy, group=g)
        self._consolidate_step = make_consolidate_step(self.dp, self.mesh,
                                                       group=g)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def op_counters(self) -> tuple[int, int]:
        """(ops, consolidation passes) keyed so far: with the seed and the
        gathered state, what a restart needs to resume the key chains."""
        return self._op_counter, self._consolidate_counter

    @property
    def strategy(self) -> str:
        return self._strategy

    @strategy.setter
    def strategy(self, value: str) -> None:
        # the delete step bakes the strategy in: rebuild it, so that
        # reassignment behaves like the core session's per-op strategy
        self._strategy = value
        self._delete_step = make_delete_step(self.dp, self.mesh, value,
                                             group=self.group)

    def _op_key(self) -> torch.Tensor:
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        key = prng.fold_in(self._base_key, self._op_counter)
        self._op_counter += 1
        return key

    def _on_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.asarray(x)
        return torch.as_tensor(x).to(self.device, dtype)

    def search_view(self) -> GraphState:
        """The folded query's flat view of the current state (built once per
        state version)."""
        if self._flat is None:
            self._flat = flat_view(self.state)
        return self._flat

    def query(self, queries) -> tuple[torch.Tensor, torch.Tensor]:
        """Fan-out query → (global ids i32[B, k], scores f32[B, k])."""
        t0 = time.perf_counter()
        q = self._on_device(queries, torch.float32)
        gids, scores = self._query_step(self.state, q, self._op_key(),
                                        flat=self.search_view())
        self.timers.query_s += time.perf_counter() - t0
        self.timers.n_queries += int(q.shape[0])
        self.timers.n_ops += 1
        return gids, scores

    def insert(self, vecs, route) -> torch.Tensor:
        """Routed insert; returns the assigned global ids. The insert
        boundary is the growth trigger point: ``_ensure_room`` grows every
        shard in lockstep (and/or drains tombstones) before the batch
        lands."""
        v = self._on_device(vecs, torch.float32)
        n = int(v.shape[0])
        if n:  # outside the insert stopwatch: gate work bills to its phase
            self._ensure_room(n)
        faults.crash_point("sharded-pre-dispatch")
        t0 = time.perf_counter()
        self._flat = None
        self.state, gids = self._insert_step(
            self.state, v, self._on_device(route, torch.int64),
            self._op_key())
        self._free_floor = max(self._free_floor - n, 0)
        self._insert_results.append(gids)
        self.timers.insert_s += time.perf_counter() - t0
        self.timers.n_inserts += n
        self.timers.n_ops += 1
        faults.crash_point("sharded-post-dispatch")
        return gids

    def delete(self, gids) -> None:
        """Owner-masked delete of global ids."""
        faults.crash_point("sharded-pre-dispatch")
        t0 = time.perf_counter()
        g = self._on_device(gids, torch.int32)
        n = int(g.shape[0])
        self._flat = None
        self.state = self._delete_step(self.state, g, self._op_key())
        self.timers.delete_s += time.perf_counter() - t0
        self.timers.n_deletes += n
        self.timers.n_ops += 1
        if self._strategy == "mask":
            self._masked_hint += n
            self._maybe_consolidate()
        else:
            self._present_floor = max(self._present_floor - n, 0)
        faults.crash_point("sharded-post-dispatch")

    # -- capacity growth (lockstep over shards) ----------------------------
    def _per_shard(self, mask: torch.Tensor) -> np.ndarray:
        """Per-shard counts of ``mask`` over every global shard, gathered
        from every rank of the replica (synchronises): the only counts host
        decisions read, so every rank decides alike. With pods on their own
        ranks the pods' counts are compared too: replicas that disagree
        raise :class:`ReplicaMismatch` on every rank."""
        counts = mask.sum(dim=1)
        if self.replica is not None:
            counts = self.replica.all_gather(counts)
        if self.peers is not None:
            per_pod = self.peers.all_gather(counts[None]).cpu().numpy()
            for p in range(1, per_pod.shape[0]):
                if not np.array_equal(per_pod[p], per_pod[0]):
                    s = int(np.flatnonzero(per_pod[p] != per_pod[0])[0])
                    raise ReplicaMismatch(
                        f"the replicas of pod 0 and pod {p} disagree: shard "
                        f"{s} counts {int(per_pod[0, s])} against "
                        f"{int(per_pod[p, s])}")
            return per_pod[0]
        return counts.cpu().numpy()

    def _per_shard_present(self) -> np.ndarray:
        return self._per_shard(self.state.present)

    def _per_shard_masked(self) -> np.ndarray:
        return self._per_shard(self.state.masked)

    def gather_state(self) -> GraphState:
        """The global stacked state of this rank's replica, on every rank
        (the state itself without a group)."""
        return gather_state(self.state, self.replica)

    def _ensure_room(self, n: int) -> None:
        """Per-shard grow/consolidate gate at the insert boundary: drain
        tombstones inside the tier first, grow all shards to the next tier
        only when compaction cannot make room. Worst-case routing drives
        the host hint; the exact per-shard count runs only when the most
        loaded shard could refuse."""
        if self._free_floor >= n:
            return
        mp = self.dp.index.maintenance
        cap = self.dp.index.capacity
        present = self._per_shard_present()
        masked = self._per_shard_masked()
        self._masked_hint = int(masked.sum())
        self._present_floor = int(present.sum())
        free = cap - present
        min_free = int(free.min())
        if min_free < n and masked.sum() > 0 and (
                mp.consolidate_threshold is not None
                or mp.max_capacity is not None):
            self.consolidate(_per_shard=masked)
            min_free = int((free + masked).min())
        if min_free < n and mp.max_capacity is not None:
            target = next_capacity_tier(
                cap, cap - min_free + n, mp.growth_factor, mp.max_capacity)
            if target > cap:
                self.grow(target)
                min_free += target - cap
        self._free_floor = min_free

    def grow(self, new_capacity: int) -> None:
        """Grow every shard to ``new_capacity`` slots in lockstep (one
        ``grow_state`` pad over the stacked slot axis). Requires
        ``maintenance.max_capacity``: the gid stride is pinned to it, which
        keeps gids handed out at smaller tiers decodable."""
        mp = self.dp.index.maintenance
        if mp.max_capacity is None:
            raise ValueError(
                "ShardedSession growth requires maintenance.max_capacity: "
                "the global-id stride is pinned to it so existing gids "
                "survive the tier move")
        if new_capacity > mp.max_capacity:
            raise ValueError(
                f"new_capacity {new_capacity} exceeds max_capacity "
                f"{mp.max_capacity}")
        if new_capacity == self.dp.index.capacity:
            return
        faults.crash_point("sharded-pre-grow")
        t0 = time.perf_counter()
        if self._window_t0 is None:
            self._window_t0 = t0
        delta = new_capacity - self.dp.index.capacity
        self._flat = None
        self.state = grow_state(self.state, new_capacity, axis=1)
        self.dp = dataclasses.replace(
            self.dp,
            index=dataclasses.replace(self.dp.index, capacity=new_capacity))
        self._build_steps()
        self._free_floor += delta
        self.timers.n_grows += 1
        self.timers.grow_s += time.perf_counter() - t0
        faults.crash_point("sharded-post-grow")

    # -- consolidation (per shard) -----------------------------------------
    def consolidate(self, *, _per_shard=None) -> int:
        """Drain every shard's tombstones: ``ceil(max_shard_tombstones /
        chunk)`` passes of the per-shard compaction step (drained shards
        run empty frames). Returns the number of consolidated vertices."""
        t0 = time.perf_counter()
        per_shard = (self._per_shard_masked() if _per_shard is None
                     else _per_shard)
        total = int(per_shard.sum())
        if total == 0:
            self._masked_hint = 0
            self.timers.consolidate_s += time.perf_counter() - t0
            return 0
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        mp = self.dp.index.maintenance
        chunk = mp.consolidate_chunk or mp.delete_chunk
        base = prng.fold_in(self._base_key, maint.CONSOLIDATE_KEY_STREAM)
        self._flat = None
        for _ in range(-(-int(per_shard.max()) // chunk)):
            # a kill between passes leaves some shards drained further than
            # others: the torn state recovery must replay
            faults.crash_point("sharded-consolidate-pass")
            key = prng.fold_in(base, self._consolidate_counter)
            self._consolidate_counter += 1
            self.state = self._consolidate_step(self.state, key)
        self.timers.consolidate_s += time.perf_counter() - t0
        self.timers.n_consolidations += 1
        self.timers.n_consolidated += total
        self.timers.n_ops += 1
        self._masked_hint = 0
        self._present_floor = max(self._present_floor - total, 0)
        return total

    def _maybe_consolidate(self) -> int:
        thr = self.dp.index.maintenance.consolidate_threshold
        if self._in_consolidate or not consolidate_gate_crossed(
                thr, self._masked_hint, self._present_floor):
            return 0
        # exact check (synchronises), then fire if the share really crossed
        per_shard = self._per_shard_masked()
        self._masked_hint = int(per_shard.sum())
        self._present_floor = int(self._per_shard_present().sum())
        if not consolidate_gate_crossed(
                thr, self._masked_hint, self._present_floor):
            return 0
        self._in_consolidate = True
        try:
            return self.consolidate(_per_shard=per_shard)
        finally:
            self._in_consolidate = False

    def flush(self) -> PhaseTimers:
        """Wait for every dispatched op and settle the timers; count the
        refused inserts (NULL gids). Also a consolidation trigger point."""
        self._maybe_consolidate()
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for gids in self._insert_results:
            self.timers.n_refused += int((gids == NULL).sum())
        self._insert_results.clear()
        self.timers.flush_s += time.perf_counter() - t0
        if self._window_t0 is not None:
            self.timers.wall_s += time.perf_counter() - self._window_t0
            self._window_t0 = None
        return self.timers

    def n_alive(self) -> int:
        return int(self._per_shard(self.state.alive).sum())

    def n_masked(self) -> int:
        return int(self._per_shard_masked().sum())
