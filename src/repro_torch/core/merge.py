"""Streaming merge — the fresh→main drain of the two-tier index
(``repro.core.merge``).

A :class:`~repro_torch.core.tiered.TieredSession` writes to a small fresh
tier and tombstones deletes of main-resident points in the main tier's MASK
bitmap. :class:`StreamingMerge` moves a *snapshot* of the fresh tier into
main in bounded chunks while both tiers keep serving; each ``step()`` is one
chunk of work (the tiered session pumps one step per insert/delete):

  1. **compact** — ``ceil(n0/chunk)`` OP_CONSOLIDATE micro-batches on main,
     ``n0`` its tombstone count at merge start (lowest-id tombstones first);
  2. **drain** — snapshot items, oldest stamp first (I6), go into main
     through the batched insert; main grows when armed, and when it is
     capped the undrained suffix stays fresh. A drained item lives in both
     tiers until its swap; queries dedupe it by external id;
  3. **swap** — the drained items' fresh slots are freed through the fresh
     tier's delete, chunk by chunk, so each item is in at least one tier at
     every instant.

Every device call draws from the merge key chain, never a tier's op-key
chain, and progress is a pure function of the mutation stream, so replay
lands bit-exactly mid-merge. The merge's key stream, journal code, dedup
counter and crash points are its entry in ``core/maint.py``. The work is
host numpy plus the sessions' ops.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import ops as ops_mod
from repro_torch.core.graph import NULL, next_capacity_tier
from repro_torch.core.session import OpHandle
from repro_torch.testing import faults

# phase tags, in execution order
COMPACT, DRAIN, SWAP, DONE = "compact", "drain", "swap", "done"


class StreamingMerge:
    """One in-flight fresh→main merge over a start-of-merge snapshot.

    Owned and driven by a ``TieredSession``. The constructor takes the
    snapshot (reading the fresh tier's arrays); each ``step()`` does one
    chunk of compact/drain/swap work and returns whether the merge is done.
    """

    def __init__(self, owner) -> None:
        faults.crash_point("merge-begin")
        self.owner = owner
        fresh, main = owner._fresh, owner._main
        fm, mm = owner._fm, owner._mm
        self.chunk = owner._merge_chunk
        # snapshot: every fresh-resident item, oldest first (I6)
        slots = np.flatnonzero(fm.present).astype(np.int32)
        idx = torch.as_tensor(slots.astype(np.int64), device=fresh.device)
        stamps = fresh.state.stamps[idx].cpu().numpy()
        order = np.argsort(stamps, kind="stable")
        self.slots = slots[order]                     # fresh slot per item
        self.exts = fm.ext[self.slots].copy()         # external id per item
        self.vecs = fresh.state.vectors[idx].cpu().numpy()[order]
        # compact plan fixed at merge start: a chunk count, not a slot set —
        # each chunk sweeps whatever the lowest-id tombstones are then
        n0 = int(np.sum(mm.masked))
        self._compact_left = -(-n0 // self.chunk) if n0 else 0
        self._consolidate_batch = ops_mod.make_op(
            ops_mod.OP_CONSOLIDATE, self.chunk, main.params.dim,
            device=main.device)
        self.phase = COMPACT if self._compact_left else DRAIN
        self._ptr = 0                  # next snapshot item to consider
        self._swap_ptr = 0             # next drained item to swap out
        self.cancelled: set[int] = set()   # exts deleted before their drain
        self.drained: list[tuple[int, int]] = []  # (ext, fresh_slot)
        self.capped = False            # main filled up; suffix stays fresh
        self.n_drained = 0

    @property
    def done(self) -> bool:
        return self.phase == DONE

    def step(self) -> bool:
        """Perform one bounded chunk of merge work. Returns ``done``."""
        if self.phase == DONE:
            return True
        t0 = time.perf_counter()
        if self.phase == COMPACT:
            self._compact_step()
        elif self.phase == DRAIN:
            self._drain_step()
        elif self.phase == SWAP:
            self._swap_step()
        self.owner.timers.merge_s += time.perf_counter() - t0
        return self.phase == DONE

    def run(self) -> None:
        """Drive the merge to completion (the save and catch-up barrier)."""
        while not self.step():
            pass

    # -- phase 1: main-tier tombstone compaction ---------------------------
    def _compact_step(self) -> None:
        owner, main, mm = self.owner, self.owner._main, self.owner._mm
        key = owner._merge_key()
        main._state, ids, scores = ops_mod.apply_ops(
            main._state, self._consolidate_batch, key, main.params,
            main.strategy)
        # mirror the device's pick exactly: the chunk's lowest-id tombstones
        freed = np.flatnonzero(mm.masked)[: self.chunk]
        mm.masked[freed] = False
        mm.present[freed] = False
        n = len(freed)
        main._pending.append(OpHandle(
            "consolidate", n, main.params.search.pool_size,
            [(ids, scores, n)], on_done=main._handle_done))
        self._compact_left -= 1
        if self._compact_left == 0:
            self.phase = DRAIN
        faults.crash_point("merge-compact-step")

    # -- phase 2: fresh→main drain -----------------------------------------
    def _next_drain_batch(self) -> np.ndarray:
        """Indices of the next ≤chunk snapshot items still worth draining."""
        sel = []
        while self._ptr < len(self.slots) and len(sel) < self.chunk:
            if int(self.exts[self._ptr]) not in self.cancelled:
                sel.append(self._ptr)
            self._ptr += 1
        return np.asarray(sel, np.int64)

    def _drain_step(self) -> None:
        owner, main, mm = self.owner, self.owner._main, self.owner._mm
        sel = self._next_drain_batch()
        n = len(sel)
        if n == 0:
            self._enter_swap()
            return
        # room in main: compaction already ran, so grow the tier when armed
        free = int(mm.capacity - np.sum(mm.present))
        if free < n:
            mp = owner.params.maintenance
            cap = main.state.capacity
            target = next_capacity_tier(
                cap, cap - free + n, mp.growth_factor, mp.max_capacity)
            if target > cap:
                main.grow(target, _auto=True)
                mm.grow(target)
                free += target - cap
        if free < n:
            if free == 0:
                # main is capped out: the undrained suffix stays fresh
                self.capped = True
                self._ptr = len(self.slots)
                self._enter_swap()
                return
            self._ptr = int(sel[free])  # re-consider the overflow next step
            sel = sel[:free]
            n = free
        batch = ops_mod.make_op(
            ops_mod.OP_INSERT, self.chunk, main.params.dim,
            payload=self.vecs[sel], device=main.device)
        key = owner._merge_key()
        main._state, ids, scores = ops_mod.apply_ops(
            main._state, batch, key, main.params, main.strategy)
        # host mirror of the batched allocator: the i-th valid row takes the
        # i-th lowest free slot; room was ensured above, no refusals
        mslots = np.flatnonzero(~mm.present)[:n]
        exts = self.exts[sel]
        mm.present[mslots] = True
        mm.ext[mslots] = exts
        owner._ext_snap_dirty()
        for i, (e, ms) in enumerate(zip(exts, mslots)):
            fs = int(self.slots[sel[i]])
            owner._loc[int(e)] = ("both", fs, int(ms))
            owner._both_set.add(int(e))
            self.drained.append((int(e), fs))
        main._pending.append(OpHandle(
            "insert", n, main.params.search.pool_size, [(ids, scores, n)],
            on_done=main._handle_done))
        self.n_drained += n
        owner.timers.n_merged += n
        faults.crash_point("merge-drain-step")

    # -- phase 3: per-item tier swap ---------------------------------------
    def _enter_swap(self) -> None:
        self.phase = SWAP
        faults.crash_point("pre-merge-swap")

    def _swap_step(self) -> None:
        owner, fresh, fm = self.owner, self.owner._fresh, self.owner._fm
        # items deleted while in both tiers have already left both
        sel = []
        while self._swap_ptr < len(self.drained) and len(sel) < self.chunk:
            ext, fslot = self.drained[self._swap_ptr]
            self._swap_ptr += 1
            loc = owner._loc.get(ext)
            if loc is not None and loc[0] == "both" and loc[1] == fslot:
                sel.append((ext, fslot, loc[2]))
        if sel:
            fslots = np.asarray([s[1] for s in sel], np.int32)
            batch = ops_mod.make_op(
                ops_mod.OP_DELETE, self.chunk, fresh.params.dim, ids=fslots,
                device=fresh.device)
            key = owner._merge_key()
            fresh._state, ids, scores = ops_mod.apply_ops(
                fresh._state, batch, key, fresh.params, fresh.strategy)
            fm.present[fslots] = False
            owner._fbias[fslots] = -np.inf
            fm.ext[fslots] = NULL
            owner._ext_snap_dirty()
            for ext, _, mslot in sel:
                owner._loc[ext] = ("main", mslot)
                owner._both_set.discard(ext)
            fresh._pending.append(OpHandle(
                "delete", len(sel), fresh.params.search.pool_size,
                [(ids, scores, len(sel))], on_done=fresh._handle_done))
        if self._swap_ptr >= len(self.drained):
            self.phase = DONE
            owner._merges_done += 1
            owner.timers.n_merges += 1
            faults.crash_point("post-merge-swap")

