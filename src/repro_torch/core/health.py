"""Vectorised graph health check — the port of ``assert_graph_healthy``
(``tests/test_graph_invariants.py``) that runs on a 10^6-slot state.

Checks I1–I7 plus the reverse-adjacency oracle: because I1 is tested in
both directions as equality of the sorted (target, source) pair lists of
``adj`` and ``radj``, and rows hold no duplicates, ``radj[v]`` equals the
set that a full recompute from ``adj`` would give, with no forward edge
dropped for in-degree overflow.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import NULL, GraphState
from repro_torch.core.quantize import quantize_rows


def _row_has_dup(rows: torch.Tensor) -> torch.Tensor:
    s, _ = torch.sort(rows, dim=1)
    return ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] != NULL)).any(dim=1)


def _pairs(rows: torch.Tensor, forward: bool) -> torch.Tensor:
    """Sorted int64 keys target·cap + source of every non-NULL entry."""
    cap = rows.shape[0]
    owner = torch.arange(cap, device=rows.device)[:, None].expand_as(rows)
    m = rows != NULL
    other = rows[m].long()
    own = owner[m]
    key = other * cap + own if forward else own * cap + other
    return torch.sort(key).values


def check_health(state: GraphState, *, row_block: int = 1 << 16) -> list[str]:
    """Violated invariants (empty = healthy)."""
    errs: list[str] = []
    adj, radj = state.adj, state.radj
    present, alive = state.present, state.alive
    cap = state.capacity
    ids = torch.arange(cap, device=adj.device)

    if (alive & ~present).any():
        errs.append("I3: alive slot not present")
    if int(state.size) != int(alive.sum()):
        errs.append("size != number of alive slots")
    if (adj == ids[:, None].to(adj.dtype)).any():
        errs.append("I4: self-edge")
    if _row_has_dup(adj).any():
        errs.append("I4: duplicate out-edge")
    if _row_has_dup(radj).any():
        errs.append("I4: duplicate in-edge")
    for name, rows in (("adj", adj), ("radj", radj)):
        m = rows != NULL
        if (m & ~present[:, None]).any():
            errs.append(f"I2: {name} row of a non-present slot has edges")
        if (m & ~present[rows.clamp(min=0).long()]).any():
            errs.append(f"I2: {name} entry points at a non-present slot")
    fwd, rev = _pairs(adj, True), _pairs(radj, False)
    if fwd.shape != rev.shape or not torch.equal(fwd, rev):
        errs.append("I1: adj and radj disagree (reverse-adjacency oracle)")

    # I5: codes re-check bit-exactly for present slots, zero elsewhere
    for lo in range(0, cap, row_block):
        sl = slice(lo, lo + row_block)
        codes, scales = quantize_rows(state.vectors[sl])
        p = present[sl]
        if not (torch.equal(state.codes[sl][p], codes[p])
                and torch.equal(state.scales[sl][p], scales[p])):
            errs.append("I5: codes/scales out of sync with vectors")
            break
    if (state.codes[~present] != 0).any() or (state.scales[~present] != 0).any():
        errs.append("I5: freed slot keeps codes")
    # I6 / I7: stamps
    st = state.stamps
    if ((st[present] < 0) | (st[present] >= state.clock)).any() or (
            st[~present] != -1).any():
        errs.append("I6: insertion stamps")
    if (state.touch[~present] != -1).any() or (state.touch >= state.tclock).any():
        errs.append("I7: touch stamps")
    return errs
