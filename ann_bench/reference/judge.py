"""What decides ``correct``: the program's answers and state, held to the
stream the benchmark made.

The program's outputs are read here only to be judged. The record of a
run is a list of events, one per op, in stream order (host arrays):

  query   ``t``, ``n`` lanes asked, ``ids`` [m, k'] answered, and for the
          sampled lanes ``sample``, their queries ``q`` and scores ``s``;
  insert  ``t``, the ``rows`` inserted, their content ``x``, the ``ids``
          the program acknowledged;
  delete  ``t``, the ``rows`` deleted and the ``ids`` sent for them.

``replay`` walks the events with a book of which row each id holds and
counts every answer lane that is missing, short, repeats a row, or names
an id that holds no row at that point (``bad_answers``), and every write
the program did not acknowledge as a fresh id (``lost_writes``). Then, for
the sampled lanes, ``answer_checks`` compares each returned score with
the reference's score of the row that id held (``score_gap``, against the
scale ``2|q||x| + |x|²``) and the rows returned with the exact top-k among
the rows alive at that time (``recall_at_10``). ``state_faults`` reads an
index's state back after the window: every acknowledged row alive with
its bytes, nothing else alive, and the graph's invariants (no self or
repeated edge, edges only between present slots, the reverse lists the
exact transpose of the forward ones). ``build_gap`` holds the bulk
build's edges to the exact nearest neighbours of their rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ann_bench.reference.exact import NULL_ROW, Rows, cast_rows, pair_scores, recall, topk_alive

NEVER = np.int64(1) << 62


@dataclasses.dataclass
class Replay:
    slot_row: np.ndarray          # id → row it holds at the end (-1 none)
    t_in: np.ndarray              # row → stream position it went in
    t_out: np.ndarray             # row → stream position it went out
    bad_answers: int = 0
    lost_writes: int = 0
    samples: list = dataclasses.field(default_factory=list)


def replay(events: list[dict], base_ids: np.ndarray, id_space: int, n_rows: int,
           k: int) -> Replay:
    """Walk ``events``; the base's row r starts at id ``base_ids[r]``."""
    n_base = base_ids.size
    slot_row = np.full(id_space, NULL_ROW, np.int64)
    rep = Replay(slot_row, np.full(n_rows, NEVER, np.int64),
                 np.full(n_rows, NEVER, np.int64))
    ok = (base_ids >= 0) & (base_ids < id_space)
    rep.lost_writes += int((~ok).sum())
    slot_row[base_ids[ok]] = np.flatnonzero(ok)
    rep.t_in[:n_base] = -1
    for e in events:
        t = e["t"]
        if e["kind"] == "insert":
            ids, rows = np.asarray(e["ids"], np.int64), e["rows"]
            good = (ids >= 0) & (ids < id_space)
            good[good] &= slot_row[ids[good]] == NULL_ROW
            _, first = np.unique(ids, return_index=True)
            once = np.zeros(ids.size, bool)
            once[first] = True
            good &= once
            rep.lost_writes += int((~good).sum())
            slot_row[ids[good]] = rows[good]
            rep.t_in[rows[good]] = t
        elif e["kind"] == "delete":
            ids, rows = np.asarray(e["ids"], np.int64), e["rows"]
            good = (ids >= 0) & (ids < id_space)
            good[good] &= slot_row[ids[good]] == rows[good]
            rep.lost_writes += int((~good).sum())
            slot_row[ids[good]] = NULL_ROW
            rep.t_out[rows] = t
        else:
            found = _check_answers(rep, e, k)
            if e["sample"].size:
                rep.samples.append((t, e["q"], found[e["sample"]],
                                    e["s"][:, :k].astype(np.float64)))
    return rep


def _check_answers(rep: Replay, e: dict, k: int) -> np.ndarray:
    """Rows ``[n, k]`` the answers name (-1 where an id holds none); every
    lane that is missing, short, names an id that holds no row, or repeats
    a row counts as a bad answer."""
    n = e["n"]
    ids = np.asarray(e["ids"], np.int64)
    found = np.full((n, k), NULL_ROW, np.int64)
    m = min(ids.shape[0], n) if ids.ndim == 2 else 0
    if m == 0 or ids.shape[1] < k:
        rep.bad_answers += n
        return found
    ids = ids[:m, :k]
    valid = (ids >= 0) & (ids < rep.slot_row.size)
    rows = np.where(valid, rep.slot_row[np.where(valid, ids, 0)], NULL_ROW)
    srt = np.sort(rows, axis=1)
    repeat = (srt[:, 1:] == srt[:, :-1]).any(1)
    bad = (rows == NULL_ROW).any(1) | repeat
    rep.bad_answers += int(bad.sum()) + (n - m)
    found[:m] = rows
    return found


def answer_checks(rep: Replay, rows: Rows, k: int, device, *, row_dtype: str
                  ) -> dict:
    """``score_gap`` (largest, over the sampled lanes' answers) and
    ``recall_at_10`` (mean) of the sampled lanes."""
    if not rep.samples:
        return {"score_gap": float("inf"), "recall_at_10": 0.0, "sampled": 0}
    t_q = np.concatenate([np.full(len(s[1]), s[0], np.int64) for s in rep.samples])
    q = torch.from_numpy(np.concatenate([s[1] for s in rep.samples]).astype(np.float32))
    found = np.concatenate([s[2] for s in rep.samples])
    got = np.concatenate([s[3] for s in rep.samples])
    gap = 0.0
    named = found != NULL_ROW
    if named.any():
        x = rows.take(np.where(named, found, 0).reshape(-1)).reshape(*found.shape, -1)
        x = cast_rows(x, row_dtype, "float64")
        want, scale = pair_scores(q.double(), x)
        diff = (torch.from_numpy(got) - want).abs() / scale
        gap = float(torch.where(torch.from_numpy(named), diff, 0.0).max())
    if not bool(np.isfinite(got[named]).all()):
        gap = float("inf")
    _, true = topk_alive(rows, rep.t_in, rep.t_out, q, t_q, k, device,
                         row_dtype=row_dtype)
    return {"score_gap": gap,
            "recall_at_10": float(recall(found, true.cpu().numpy()).mean()),
            "sampled": int(found.shape[0])}


def _row_dup(rows: torch.Tensor, null: int) -> torch.Tensor:
    s = torch.sort(rows, dim=1).values
    return ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] != null)).any(1)


def _pairs(rows: torch.Tensor, forward: bool, null: int) -> torch.Tensor:
    n = rows.shape[0]
    owner = torch.arange(n, device=rows.device)[:, None].expand_as(rows)
    m = rows != null
    other, own = rows[m].long(), owner[m]
    return torch.sort(other * n + own if forward else own * n + other).values


def graph_faults(alive, present, adj, radj, size, null: int = -1) -> int:
    """How many of the graph's invariants one index (a shard) breaks: an
    alive slot not present, ``size`` not the alive count, a self edge, a
    repeated out- or in-edge, an edge from or to a slot not present, the
    reverse lists not the transpose of the forward lists."""
    ids = torch.arange(adj.shape[0], device=adj.device)
    faults = [bool((alive & ~present).any()), int(size) != int(alive.sum()),
              bool((adj == ids[:, None]).any()),
              bool(_row_dup(adj, null).any()), bool(_row_dup(radj, null).any())]
    for lists in (adj, radj):
        m = lists != null
        faults.append(bool((m & ~present[:, None]).any()))
        faults.append(bool((m & ~present[lists.clamp(min=0).long()]).any()))
    fwd, rev = _pairs(adj, True, null), _pairs(radj, False, null)
    faults.append(fwd.shape != rev.shape or not torch.equal(fwd, rev))
    return int(sum(faults))


def state_faults(alive, vectors, expected: np.ndarray, rows: Rows, *,
                 row_dtype: str, block: int = 1 << 16) -> int:
    """Slots whose alive flag or row bytes differ from the book:
    ``expected[i]`` is the row slot i should hold (-1: none)."""
    dev = alive.device
    want = torch.as_tensor(expected >= 0, device=dev)
    bad = int((alive != want).sum())
    full = np.flatnonzero(expected >= 0)
    for lo in range(0, full.size, block):
        slots = full[lo:lo + block]
        x = cast_rows(rows.take(expected[slots]), row_dtype, "float32").to(dev)
        got = vectors[torch.as_tensor(slots, device=dev)].float()
        bad += int((got != x).any(1).sum())
    return bad


def base_only(rows: Rows, n_base: int) -> tuple[np.ndarray, np.ndarray]:
    """(t_in, t_out) under which exactly the base is alive at time 0."""
    t_in = np.full(rows.n, NEVER, np.int64)
    t_in[:n_base] = -1
    return t_in, np.full(rows.n, NEVER, np.int64)


def knn_rows(rows: Rows, sample_rows: np.ndarray, n_base: int, k_nn: int, device, *,
             groups: np.ndarray | None = None, precision: str = "float64"
             ) -> tuple[torch.Tensor, np.ndarray]:
    """(scores, rows) of the ``k_nn`` nearest base rows of each sampled row,
    itself left out (within its shard with ``groups``)."""
    grp = None if groups is None else (groups, groups[sample_rows])
    s, r = topk_alive(rows, *base_only(rows, n_base), rows.take(sample_rows),
                      np.zeros(len(sample_rows), np.int64), k_nn, device,
                      precision=precision, groups=grp, exclude=sample_rows)
    return s, r.cpu().numpy()


def build_gap(sample_rows: np.ndarray, edge_rows: np.ndarray, rows: Rows,
              n_base: int, k_nn: int, device, groups: np.ndarray | None = None) -> float:
    """How far the bulk build's edges of the sampled rows fall below each
    row's ``k_nn``-th exact neighbour among the base (within its shard
    with ``groups``), against the score's scale; an edge to a row outside
    the base counts as infinitely far. ``edge_rows [Q, d_out]``, -1 where
    a row has fewer edges. The build links float32 rows in every
    configuration."""
    best, _ = knn_rows(rows, sample_rows, n_base, k_nn, device, groups=groups)
    kth = best[:, -1].cpu()
    named = edge_rows != NULL_ROW
    if (named & ((edge_rows >= n_base) | (edge_rows < 0))).any():
        return float("inf")
    safe = np.where(named, edge_rows, 0)
    x = rows.take(safe.reshape(-1)).double().reshape(*edge_rows.shape, -1)
    s, scale = pair_scores(rows.take(sample_rows).double(), x)
    gap = ((kth.double()[:, None] - s).clamp(min=0) / scale)
    return float(torch.where(torch.from_numpy(named), gap, 0.0).max())


def rows_of(base: torch.Tensor, events: list[dict]) -> Rows:
    """The run's rows: the base (host), then every inserted row in row
    order."""
    ins = [e for e in events if e["kind"] == "insert"]
    if not ins:
        return Rows([base])
    order = np.argsort([int(e["rows"][0]) for e in ins], kind="stable")
    x = np.concatenate([ins[i]["x"] for i in order]).astype(np.float32)
    return Rows([base, torch.from_numpy(x)])
