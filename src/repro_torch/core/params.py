"""Static hyper-parameters of the index — a copy of ``repro.core.params``.

Same fields, defaults and asserts, so ``params_fingerprint`` gives the same
string in both packages. ``use_pallas`` is kept only because the fingerprint
hashes it: in the port the device of the tensors alone decides whether a
kernel runs (CUDA) or its plain version (CPU).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Parameters of GREEDY-SEARCH (Alg 1) and its execution."""

    pool_size: int = 32      # paper's k: candidate priority-queue length (ef)
    max_steps: int = 96      # hard cap on beam-loop trips; with
                             # beam_width=W each trip expands ≤ W entries
    num_starts: int = 2      # random entry points seeding the pool
    beam_width: int = 1      # W: unexpanded pool entries expanded per query
                             # per step ([B, W·d_out] candidate block);
                             # W=1 reproduces the classic best-first walk
    use_pallas: bool | None = None  # hashed by the fingerprint only; the
                                    # port routes by tensor device
    quantized: bool = False  # walk the beam on int8 codes (asymmetric
                             # distance, DESIGN.md §10); fp32 rows are then
                             # only touched by the exact re-rank below.
                             # False (default) = the exact fp32 engine,
                             # which stays the parity oracle.
    rerank_depth: int = 0    # with quantized=True: exact fp32 re-rank of
                             # the top-r pool entries; the final top-k is
                             # reported from those r candidates ONLY, so
                             # keep r ≥ the k you consume. 0 = report
                             # compressed scores directly (no exact pass).

    def __post_init__(self):
        assert self.pool_size >= 1 and self.max_steps >= 1
        assert 1 <= self.num_starts <= self.pool_size
        assert 1 <= self.beam_width <= self.pool_size
        assert 0 <= self.rerank_depth <= self.pool_size


@dataclasses.dataclass(frozen=True)
class MaintenanceParams:
    """Update-path knobs of the online index (DESIGN.md §7/§8).

    ``strategy`` is the delete strategy (Alg 4–6 / §5.2); the chunk sizes are
    the op-IR micro-batch widths: every insert/delete stream is chopped into
    fixed-shape ``OpBatch``es of this many lanes (ragged tails padded with
    masked lanes), so one compiled ``apply_ops`` program serves any stream
    length. Keeping ``insert_chunk == delete_chunk`` lets a mixed stream run
    through a single compiled switch program (one shape family).

    Consolidation (DESIGN.md §8) is what makes MASK's tombstones sustainable
    on an unbounded stream: ``consolidate_threshold`` arms the session's
    auto-trigger (fires when masked/present crosses it; ``None`` disables),
    ``consolidate_strategy`` picks the repair used by the jitted compaction
    pass ("pure" = scrub only, "local"/"global" = Alg 5/6 repair of the
    survivors' rows, "rwalk" = random-walk replacement wiring), and
    ``consolidate_chunk`` is the tombstones-per-
    micro-batch width (``None`` → ``delete_chunk``, keeping the stream in
    one compiled shape family).

    Capacity growth (DESIGN.md §9) is what makes *net-growing* streams
    sustainable: ``max_capacity`` arms the session's auto-grow gate at
    insert-dispatch boundaries (``None`` keeps the legacy fixed-capacity
    contract — a full index refuses further inserts, now counted in
    ``PhaseTimers.n_refused``), and ``growth_factor`` is the geometric tier
    step (default ×2), so growing from capacity C to C' recompiles the op
    step at most ``ceil(log_factor(C'/C))`` times.
    """

    strategy: str = "global"   # "pure" | "mask" | "local" | "global" |
                               # "rwalk" (+ _reference)
    insert_chunk: int = 64
    delete_chunk: int = 64
    consolidate_threshold: float | None = None  # masked/present auto-trigger
    consolidate_strategy: str = "global"  # "pure"|"local"|"global"|"rwalk"
    consolidate_chunk: int | None = None        # None → delete_chunk
    # RWALK repair budget (core/delete.py): each surviving in-neighbor of a
    # deleted vertex runs a short beam-engine walk (beam_width=1, ``rwalk_
    # steps`` loop trips, ``rwalk_pool``-entry pool) seeded at ``rwalk_
    # starts`` random members of the deleted vertex's out-neighborhood and
    # splices ONE replacement edge from the walk pool. The defaults keep the
    # walk an order of magnitude cheaper than a GLOBAL re-search.
    rwalk_steps: int = 8
    rwalk_starts: int = 4
    rwalk_pool: int = 8
    growth_factor: float = 2.0                  # geometric capacity tier step
    max_capacity: int | None = None             # auto-grow ceiling; None = fixed
    # streaming-merge trigger gate (TieredSession, DESIGN.md §12): a merge
    # starts when the fresh tier's alive count crosses
    # ``merge_fresh_threshold`` × fresh capacity, or the main tier's
    # tombstone count crosses ``merge_tombstone_threshold`` × present count.
    # ``None`` disables that arm of the gate; ``merge_chunk`` is the items-
    # per-step drain/compact width (None → insert_chunk — one shape family).
    merge_fresh_threshold: float | None = None
    merge_tombstone_threshold: float | None = None
    merge_chunk: int | None = None
    # background refinement trigger gate (OP_REFINE, DESIGN.md §15): a
    # refine pass fires opportunistically at flush() boundaries once
    # ``refine_threshold`` update rows (insert + delete lanes) have been
    # dispatched since the last pass — "wear" is a pure function of the op
    # stream, so replay re-derives auto passes deterministically. ``None``
    # disables. ``refine_chunk`` is the slots-per-micro-batch width of one
    # pass (None → insert_chunk — one shape family with the stream).
    refine_threshold: int | None = None
    refine_chunk: int | None = None

    def __post_init__(self):
        assert self.insert_chunk >= 1 and self.delete_chunk >= 1
        assert self.consolidate_strategy in ("pure", "local", "global", "rwalk")
        assert self.rwalk_steps >= 1 and self.rwalk_starts >= 1
        assert self.rwalk_pool >= self.rwalk_starts
        assert (self.consolidate_threshold is None
                or 0.0 < self.consolidate_threshold <= 1.0)
        assert self.consolidate_chunk is None or self.consolidate_chunk >= 1
        assert self.growth_factor > 1.0
        assert self.max_capacity is None or self.max_capacity >= 1
        assert (self.merge_fresh_threshold is None
                or 0.0 < self.merge_fresh_threshold <= 1.0)
        assert (self.merge_tombstone_threshold is None
                or 0.0 < self.merge_tombstone_threshold <= 1.0)
        assert self.merge_chunk is None or self.merge_chunk >= 1
        assert self.refine_threshold is None or self.refine_threshold >= 1
        assert self.refine_chunk is None or self.refine_chunk >= 1


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Full index configuration (graph + search + maintenance).

    ``capacity`` is the *initial* capacity tier; with
    ``maintenance.max_capacity`` armed the live state may grow past it
    (DESIGN.md §9 — read the live tier off ``state.capacity``).
    """

    capacity: int
    dim: int
    d_out: int = 16            # paper's d: out-degree threshold
    d_in: int | None = None    # bounded in-degree (DESIGN.md §2); None → 2*d_out
    metric: str = "l2"
    search: SearchParams = dataclasses.field(default_factory=SearchParams)
    insert_search: SearchParams | None = None  # ef_construction; None → search
    bidirectional_insert: bool = True  # NSW/HNSW practice; strict-paper = False
    query_chunk: int = 256     # queries per batched-engine call on the
                               # legacy per-op facade (bounds the
                               # [chunk, pool+block] working set & compile
                               # shapes); streaming sessions chunk queries at
                               # the op-IR width instead (DESIGN.md §7)
    maintenance: MaintenanceParams = dataclasses.field(
        default_factory=MaintenanceParams
    )

    def __post_init__(self):
        # the growth ceiling must cover the initial tier: a ceiling below it
        # would also corrupt the sharded gid encoding, which strides global
        # ids by max_capacity when growth is armed (DESIGN.md §9)
        mc = self.maintenance.max_capacity
        assert mc is None or mc >= self.capacity, (
            f"maintenance.max_capacity ({mc}) must be >= the initial "
            f"capacity ({self.capacity})")

    @property
    def eff_d_in(self) -> int:
        if self.d_in is not None:
            return self.d_in
        # MIPS concentrates in-edges on large-norm hubs (the ip-NSW hub
        # problem) — give inner-product graphs more reverse headroom
        return (4 if self.metric in ("ip", "cos") else 2) * self.d_out

    @property
    def eff_insert_search(self) -> SearchParams:
        return self.insert_search if self.insert_search is not None else self.search
