"""Proximity-graph state — dense fixed-degree tensors, as in ``repro``.

``GraphState`` holds the same 13 data fields, dtypes and static metadata as
``repro.core.graph.GraphState`` (``vectors`` f32, or bf16 when the state is
made with ``dtype=torch.bfloat16`` as the sharded index's config does); the
scalars ``size``/``clock``/``tclock`` are 0-d int32 tensors on the state's
device, so updates never wait for the host. The sharded index stacks the
same fields on a leading shard axis (``repro_torch.distributed.ann``).
JAX donates the state to its jitted steps; the port instead updates the
state's tensors **in place** — every mutator below says so — and returns
the same object.

Invariants (checked by :func:`repro_torch.core.health.check_health`):

  I1  edge (u→v) is in ``adj[u]`` iff u is in ``radj[v]``;
  I2  adjacency entries are -1 or the id of a present slot;
  I3  alive ⇒ present;
  I4  no self-edges, no duplicate entries within a row;
  I5  present slots hold ``quantize_rows(vectors)``; freed slots zero codes;
  I6  present slots carry an insertion stamp < clock, others -1;
  I7  ``touch`` < tclock, and -1 on every non-present slot.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.core.stable import argmax_first, scatter_max_, set_drop

NULL = -1

DATA_FIELDS = ("vectors", "sqnorms", "codes", "scales", "adj", "radj",
               "alive", "present", "size", "stamps", "clock", "touch",
               "tclock")
_DTYPES = {
    "vectors": torch.float32, "sqnorms": torch.float32, "codes": torch.int8,
    "scales": torch.float32, "adj": torch.int32, "radj": torch.int32,
    "alive": torch.bool, "present": torch.bool, "size": torch.int32,
    "stamps": torch.int32, "clock": torch.int32, "touch": torch.int32,
    "tclock": torch.int32,
}


@dataclasses.dataclass
class GraphState:
    """The full index on one device."""

    vectors: torch.Tensor   # f32 or bf16[capacity, dim]
    sqnorms: torch.Tensor   # f32[capacity]
    codes: torch.Tensor     # i8[capacity, dim]
    scales: torch.Tensor    # f32[capacity]
    adj: torch.Tensor       # i32[capacity, d_out]
    radj: torch.Tensor      # i32[capacity, d_in]
    alive: torch.Tensor     # bool[capacity]
    present: torch.Tensor   # bool[capacity]
    size: torch.Tensor      # i32[]
    stamps: torch.Tensor    # i32[capacity]
    clock: torch.Tensor     # i32[]
    touch: torch.Tensor     # i32[capacity]
    tclock: torch.Tensor    # i32[]
    capacity: int
    dim: int
    d_out: int
    d_in: int
    metric: str

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def masked(self) -> torch.Tensor:
        """MASK-tombstoned slots: traversable but not reportable."""
        return self.present & ~self.alive


VECTOR_DTYPES = (torch.float32, torch.bfloat16)


def init_graph(capacity: int, dim: int, *, d_out: int = 16,
               d_in: int | None = None, metric: str = "l2",
               dtype: torch.dtype = torch.float32, device=None) -> GraphState:
    """An empty state; ``dtype`` is the dtype of ``vectors`` (f32 or bf16).
    Inserts cast each row to it before its sqnorm and codes are taken, as
    JAX does, so a bf16 state holds the norms and codes of its bf16 rows."""
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"unknown metric {metric!r}")
    if dtype not in VECTOR_DTYPES:
        raise ValueError(f"vectors must be f32 or bf16, got {dtype}")
    dev = resolve_device(device)
    d_in = 2 * d_out if d_in is None else d_in

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return GraphState(
        vectors=full((capacity, dim), 0.0, dtype),
        sqnorms=full((capacity,), 0.0, torch.float32),
        codes=full((capacity, dim), 0, torch.int8),
        scales=full((capacity,), 0.0, torch.float32),
        adj=full((capacity, d_out), NULL, torch.int32),
        radj=full((capacity, d_in), NULL, torch.int32),
        alive=full((capacity,), False, torch.bool),
        present=full((capacity,), False, torch.bool),
        size=full((), 0, torch.int32),
        stamps=full((capacity,), -1, torch.int32),
        clock=full((), 0, torch.int32),
        touch=full((capacity,), -1, torch.int32),
        tclock=full((), 0, torch.int32),
        capacity=capacity, dim=dim, d_out=d_out, d_in=d_in, metric=metric,
    )


def is_bf16_array(a) -> bool:
    """Whether a numpy array holds bf16 words: ``ml_dtypes.bfloat16`` (what
    ``np.asarray`` gives for a JAX bf16 array) or the 2-byte void dtype
    ``np.load`` gives for it without ``ml_dtypes``."""
    dt = np.asarray(a).dtype
    return dt.itemsize == 2 and (dt.name == "bfloat16" or dt.kind == "V")


def tensor_from_numpy(a, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor of ``dtype`` from a numpy array; bf16 words (see
    :func:`is_bf16_array`) are reinterpreted, not converted."""
    if dtype == torch.bfloat16 and is_bf16_array(a):
        words = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.as_tensor(np.array(a), dtype=dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy array (a view of a CPU tensor, which later in-place
    updates change); a bf16 tensor becomes its 16-bit words as the 2-byte
    void dtype, which is how ``np.save`` writes a JAX bf16 array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def graph_state_from_numpy(arrays: dict, *, capacity: int, dim: int,
                           d_out: int, d_in: int, metric: str,
                           device=None) -> GraphState:
    """Build a state from numpy arrays keyed by field name (for example
    ``np.asarray`` of each field of a ``repro`` GraphState). ``vectors``
    stay bf16 when they are bf16 words, else become f32. Any leading axes
    before the per-slot axis are kept (the stacked sharded layout)."""
    dev = resolve_device(device)
    dtypes = dict(_DTYPES)
    if is_bf16_array(arrays["vectors"]):
        dtypes["vectors"] = torch.bfloat16
    fields = {f: tensor_from_numpy(arrays[f], dtypes[f]).to(dev)
              for f in DATA_FIELDS}
    state = GraphState(**fields, capacity=capacity, dim=dim, d_out=d_out,
                       d_in=d_in, metric=metric)
    if state.vectors.shape[-2:] != (capacity, dim) or state.adj.shape[-2:] != (
            capacity, d_out) or state.radj.shape[-2:] != (capacity, d_in):
        raise ValueError("array shapes do not match the static metadata")
    return state


def graph_state_to_numpy(state: GraphState) -> dict:
    """Field name → host numpy array (as :func:`tensor_to_numpy`)."""
    return {f: tensor_to_numpy(getattr(state, f)) for f in DATA_FIELDS}


# ---------------------------------------------------------------------------
# Capacity growth — the move between capacity tiers (``repro.core.graph``)
# ---------------------------------------------------------------------------

_FILL = {"vectors": 0.0, "sqnorms": 0.0, "codes": 0, "scales": 0.0,
         "adj": NULL, "radj": NULL, "alive": False, "present": False,
         "stamps": -1, "touch": -1}


def grow_state(state: GraphState, new_capacity: int, *, axis: int = 0
               ) -> GraphState:
    """A new state of ``new_capacity`` slots: existing slots keep their ids
    and bytes, new slots are empty (zero rows, NULL adjacency, not alive,
    not present), so the allocator sees them free and traversals never
    reach them. ``size``/``clock``/``tclock`` are shared, not copied.
    ``axis`` is the slot axis: 0 for one state, 1 for the stacked per-shard
    layout, where every shard grows in lockstep."""
    cap = state.capacity
    if new_capacity < cap:
        raise ValueError(f"grow_state cannot shrink: {cap} -> {new_capacity}")
    if new_capacity == cap:
        return state
    extra = new_capacity - cap
    grown = {}
    for name, fill in _FILL.items():
        t = getattr(state, name)
        shape = list(t.shape)
        shape[axis] = extra
        pad = torch.full(shape, fill, dtype=t.dtype, device=t.device)
        grown[name] = torch.cat([t, pad], dim=axis)
    return dataclasses.replace(state, **grown, capacity=new_capacity)


def next_capacity_tier(capacity: int, needed: int, growth_factor: float,
                       max_capacity: int | None) -> int:
    """Smallest geometric tier ``capacity · growth_factor^k`` (ceil) that
    holds ``needed`` slots, clipped to ``max_capacity``; the current
    capacity when it already does or growth is capped out."""
    new = capacity
    while new < needed and (max_capacity is None or new < max_capacity):
        new = max(math.ceil(new * growth_factor), new + 1)
    if max_capacity is not None:
        new = min(new, max_capacity)
    return max(new, capacity)


# ---------------------------------------------------------------------------
# Scalar edge surgery — the sequential reference paths' primitives. Rows may
# hold NULL holes anywhere; every consumer masks on ``entry != NULL``. The
# mutators work in place, and ``u``/``v`` may be ints or 0-d tensors.
# ---------------------------------------------------------------------------

def row_insert(row: torch.Tensor, value) -> tuple[torch.Tensor, torch.Tensor]:
    """``value`` written into the first NULL hole of ``row``: (new_row,
    inserted?). Refuses when the row is full; a value already in the row
    counts as inserted and leaves the row as it is."""
    already = torch.any(row == value)
    holes = row == NULL
    do = torch.any(holes) & ~already
    pos = argmax_first(holes, 0)
    at = torch.arange(row.shape[0], device=row.device) == pos
    return torch.where(do & at, value, row).to(row.dtype), do | already


def row_remove(row: torch.Tensor, value) -> torch.Tensor:
    """Every occurrence of ``value`` in ``row`` → NULL."""
    return torch.where(row == value, NULL, row)


def add_edge(state: GraphState, u, v) -> GraphState:
    """Add u→v and its reverse entry, or neither (I1): refused when either
    row is full, on a self edge or on a NULL end — in place."""
    new_adj_row, ok_a = row_insert(state.adj[u], v)
    new_radj_row, ok_r = row_insert(state.radj[v], u)
    ok = ok_a & ok_r & (u != v) & (u != NULL) & (v != NULL)
    state.adj[u] = torch.where(ok, new_adj_row, state.adj[u])
    state.radj[v] = torch.where(ok, new_radj_row, state.radj[v])
    return state


def remove_edge(state: GraphState, u, v) -> GraphState:
    """Drop u→v and its reverse entry — in place."""
    state.adj[u] = row_remove(state.adj[u], v)
    state.radj[v] = row_remove(state.radj[v], u)
    return state


def set_out_edges(state: GraphState, u, targets: torch.Tensor) -> GraphState:
    """Replace u's out-row by ``targets`` (NULL padded): remove every old
    edge, then ``add_edge`` each target in order, so a target whose reverse
    row is full is refused (I1). ``touch`` is left as it is — in place."""
    for i in range(state.d_out):
        old = int(state.adj[u, i])
        if old != NULL:
            remove_edge(state, u, old)
    for tgt in targets[: state.d_out].tolist():
        if tgt != NULL:
            add_edge(state, u, tgt)
    return state


def rebuild_radj_rows(state: GraphState, touched: torch.Tensor) -> GraphState:
    """Recompute ``radj[v]`` from ``adj`` for every v in ``touched`` — in
    place. Each row keeps its first ``d_in`` in-edges in flat ``adj`` order
    ((source id, slot) order); in-edges ranked ``d_in`` or above are dropped
    from ``adj`` too, so I1 holds exactly. Untouched rows are unchanged."""
    cap, d_out, d_in = state.capacity, state.d_out, state.d_in
    dev = state.device
    src = torch.arange(cap, device=dev).repeat_interleave(d_out)
    dst = state.adj.reshape(-1).long()
    ok = (dst != NULL) & touched[dst.clamp(min=0)]
    order, rank_sorted = _segment_rank(torch.where(ok, dst, cap))
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = ok & (rank < d_in)
    rows = torch.full((cap, d_in), NULL, dtype=torch.int32, device=dev)
    rows[dst[keep], rank[keep]] = src[keep].to(torch.int32)
    state.radj[touched] = rows[touched]
    state.adj.masked_fill_((ok & (rank >= d_in)).reshape(cap, d_out), NULL)
    return state


def next_free_slot(state: GraphState) -> torch.Tensor:
    """The first non-present slot; 0 on a full graph (the caller checks
    ``~present[slot]``)."""
    return argmax_first(~state.present, 0)


# ---------------------------------------------------------------------------
# Bulk edge primitives — rows are computed whole, scattered once, and the
# reverse rows are patched from the forward change.
# ---------------------------------------------------------------------------

def _segment_rank(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of ``key``; returns (order, rank of each sorted lane
    within its run of equal keys)."""
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first = torch.searchsorted(sk, sk, side="left")
    rank = torch.arange(sk.shape[0], device=key.device) - first
    return order, rank


def apply_row_updates(state: GraphState, us: torch.Tensor,
                      new_rows: torch.Tensor, valid: torch.Tensor
                      ) -> GraphState:
    """Replace out-rows ``adj[us]`` with sanitized ``new_rows`` and patch
    ``radj`` to match — ``repro.core.graph.apply_row_updates``, in place.

    Removals: a reverse entry u of row v dies iff u's row was rewritten and
    v is no longer in it. Additions are grouped by destination in flat lane
    order and fill the holes left after removals; additions past a row's
    holes are refused and dropped from the forward row too (I1 exact).
    Touched rows take the current ``tclock``, which then advances by one.
    Valid ``us`` must be unique.
    """
    cap, d_out, d_in = state.capacity, state.d_out, state.d_in
    dev = state.device
    R = us.shape[0]
    us = us.long()
    valid = valid & (us != NULL)
    su = torch.where(valid, us, 0)
    old_rows = torch.where(valid[:, None], state.adj[su], NULL)
    new_rows = torch.where(valid[:, None], new_rows.to(torch.int32), NULL)

    # ---- removals: scan every reverse entry against the rewritten rows
    row_of = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    set_drop(row_of, su, torch.arange(R, device=dev), valid)
    rv = state.radj
    r_idx = torch.where(rv != NULL, row_of[rv.clamp(min=0).long()], -1)
    vs, slots = torch.nonzero(r_idx >= 0, as_tuple=True)
    lanes = r_idx[vs, slots]
    still = torch.any(new_rows[lanes] == vs[:, None].to(torch.int32), dim=1)
    gone = ~still
    state.radj[vs[gone], slots[gone]] = NULL

    # ---- additions: edges in new_rows but not old_rows, grouped by
    # destination in flat lane order (the rank order)
    add_m = (new_rows != NULL) & ~torch.any(
        new_rows[:, :, None] == old_rows[:, None, :], dim=2)
    src = su[:, None].expand(R, d_out).reshape(-1)
    dst = new_rows.reshape(-1).long()
    add_flat = add_m.reshape(-1)
    key_dst = torch.where(add_flat, dst, cap)
    order, rank_sorted = _segment_rank(key_dst)
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted                     # lane → rank in its group
    holes = d_in - torch.sum(state.radj != NULL, dim=1)        # [cap]
    admit = add_flat & (rank < holes[dst.clamp(0, cap - 1)])
    refused = add_flat & ~admit
    final_rows = torch.where(refused.reshape(R, d_out), NULL, new_rows)
    set_drop(state.adj, su, final_rows, valid)

    # admitted lane of rank h goes into the h-th hole of its reverse row
    a_dst, a_src, a_rank = dst[admit], src[admit], rank[admit]
    isnull = state.radj[a_dst] == NULL                         # [A, d_in]
    hole_rank = torch.cumsum(isnull.to(torch.int64), dim=1) - 1
    pos = argmax_first(isnull & (hole_rank == a_rank[:, None]), dim=1)
    state.radj[a_dst, pos] = a_src.to(torch.int32)

    set_drop(state.touch, su, state.tclock, valid)
    state.tclock += 1
    return state


@tracing.spanned("graph.apply")
def set_out_edges_batch(state: GraphState, us: torch.Tensor,
                        targets: torch.Tensor, valid: torch.Tensor
                        ) -> GraphState:
    """Sanitize (self edges, in-row duplicates, non-present targets → NULL)
    and apply through :func:`apply_row_updates` — in place."""
    us = us.long()
    valid = valid & (us != NULL)
    su = torch.where(valid, us, 0)
    tg = targets[:, : state.d_out].to(torch.int32)
    if tg.shape[1] < state.d_out:
        pad = torch.full((tg.shape[0], state.d_out - tg.shape[1]), NULL,
                         dtype=torch.int32, device=tg.device)
        tg = torch.cat([tg, pad], dim=1)
    tv = (tg != NULL) & valid[:, None]
    tv = tv & state.present[torch.where(tv, tg, 0).long()]
    tg = torch.where(tv & (tg != su[:, None]), tg, NULL)
    eq = (tg[:, :, None] == tg[:, None, :]) & (tg != NULL)[:, :, None]
    first = argmax_first(eq, dim=2) == torch.arange(
        tg.shape[1], device=tg.device)[None, :]
    tg = torch.where(first, tg, NULL)
    return apply_row_updates(state, us, tg, valid)


def pack_rows(rows: torch.Tensor) -> torch.Tensor:
    """Compact non-NULL entries of each row to the left, preserving order."""
    order = torch.argsort((rows == NULL).to(torch.int32), dim=1, stable=True)
    return torch.gather(rows, 1, order)


def group_by_destination(src: torch.Tensor, dst: torch.Tensor,
                         valid: torch.Tensor, capacity: int,
                         max_per_row: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge list → per-destination rows ``i32[capacity, max_per_row]`` (NULL
    padded, first ``max_per_row`` edges per destination in input order) and
    ``touched bool[capacity]``."""
    dev = dst.device
    dst = dst.long()
    key = torch.where(valid, dst, capacity)
    order, rank_sorted = _segment_rank(key)
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    rows = torch.full((capacity, max_per_row), NULL, dtype=torch.int32,
                      device=dev)
    take = valid & (rank < max_per_row)
    rows[dst[take], rank[take]] = src[take].to(torch.int32)
    touched = torch.zeros(capacity, dtype=torch.bool, device=dev)
    touched[dst[valid]] = True
    return rows, touched


def scrub_edges_to(state: GraphState, dead: torch.Tensor) -> GraphState:
    """NULL every adjacency entry pointing into ``dead`` and the dead rows
    themselves, both directions (I1 kept) — in place."""
    for name in ("adj", "radj"):
        t = getattr(state, name)
        hit = (t != NULL) & dead[t.clamp(min=0).long()]
        t.masked_fill_(hit | dead[:, None], NULL)
    return state


def free_slots(state: GraphState, ids: torch.Tensor, valid: torch.Tensor
               ) -> GraphState:
    """Mark slots fully removed (not present, not alive), scrub their codes
    and stamps, and drop ``size`` by the valid lanes that hit an alive slot
    (per lane, as JAX counts) — in place."""
    safe = torch.where(valid, ids, 0).long()
    n_freed = (valid & state.alive[safe]).sum(dtype=torch.int32)
    freed = scatter_max_(torch.zeros((state.capacity,), dtype=torch.bool,
                                      device=state.device), safe, valid)
    state.alive &= ~freed
    state.present &= ~freed
    state.codes.masked_fill_(freed[:, None], 0)
    state.scales.masked_fill_(freed, 0.0)
    state.stamps.masked_fill_(freed, -1)
    state.touch.masked_fill_(freed, -1)
    state.size -= n_freed
    return state


def mask_to_slots(mask: torch.Tensor, n: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ≤ n lowest set positions of ``mask``, ascending, in a fixed
    frame: (ids i32[n] NULL padded, valid bool[n]). JAX takes a top-k over
    negated ids; a running count of the set positions gives the same frame
    without a sort or a host sync."""
    dev = mask.device
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    take = mask & (rank < n)
    # lanes that do not take write to a spare last entry, dropped below
    buf = torch.full((n + 1,), NULL, dtype=torch.int32, device=dev)
    buf.scatter_(0, torch.where(take, rank, n),
                 torch.arange(mask.shape[0], dtype=torch.int32, device=dev))
    valid = torch.arange(n, device=dev) < take.sum()
    return torch.where(valid, buf[:n], NULL), valid


def graph_stats(state: GraphState) -> dict[str, torch.Tensor]:
    out_deg = torch.sum(state.adj != NULL, dim=1)
    in_deg = torch.sum(state.radj != NULL, dim=1)
    p = state.present
    n_p = torch.clamp(torch.sum(p), min=1)
    return {
        "n_alive": torch.sum(state.alive),
        "n_present": torch.sum(p),
        "n_masked": torch.sum(state.masked),
        "avg_out_degree": torch.sum(torch.where(p, out_deg, 0)) / n_p,
        "avg_in_degree": torch.sum(torch.where(p, in_deg, 0)) / n_p,
        "max_in_degree": torch.max(torch.where(p, in_deg, 0)),
    }
