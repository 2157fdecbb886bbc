"""The one generator of op streams: a traffic file's parameters in, ops out.

A traffic mix (``traffic/<name>.json``) gives a ``pattern`` and a
``round``: a list of ``{"op": "query" | "insert" | "delete", "n": lanes,
"repeat": times}``. A stream is the warm-up (one op of every kind and
width the round uses), then rounds, each the round's ops in order, for
as long as the window lasts. Every op is a pure function of the seed and
its place in the stream.

Rows are numbered in the order they enter the index: the base is rows
``[0, n_base)``, and each insert op takes the next ``n``. The two update
patterns of the paper's §6 (the port's ``data/workload.py``):

  random     inserts are fresh draws of the law; a delete op takes ``n``
             rows drawn uniformly from the rows alive at that point;
  clustered  the base and every row to be inserted are drawn up front,
             split into ``clusters`` by k-means and laid out cluster by
             cluster; inserts take the next rows of that order and a
             delete op takes the ``n`` oldest rows alive, so a vector and
             its neighbours expire together (§6.1.2). ``max_rounds``
             bounds the rows made up front; a stream that runs past it
             raises ``StreamExhausted``.

Each query op also names the lanes whose answers the reference scores
(``recall_lanes`` of them, drawn from the seed).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ann_bench.data.surrogate import Law, generator, subseed

KINDS = ("query", "insert", "delete")
KMEANS_BLOCK = 1 << 18


class StreamExhausted(RuntimeError):
    """The window outran the rows the traffic made up front."""


@dataclasses.dataclass
class Op:
    index: int                    # place in the stream, warm-up included
    kind: str
    n: int
    seq: int                      # place among the stream's ops of this kind
    rows: np.ndarray | None = None    # insert: new rows; delete: rows removed
    sample: np.ndarray | None = None  # query: lanes the reference scores


def kmeans_labels(x: torch.Tensor, k: int, iters: int, g: torch.Generator
                  ) -> torch.Tensor:
    """int64 labels of ``x`` under ``iters`` Lloyd steps from ``k`` rows
    drawn by ``g``; centres summed in float64 per cluster (no atomics), so
    the labels repeat bit for bit."""
    n = x.shape[0]
    centers = x[torch.randperm(n, generator=g, device=x.device)[:k]].double()
    labels = torch.empty(n, dtype=torch.int64, device=x.device)
    for _ in range(iters):
        c32 = centers.float()
        cn = (c32 * c32).sum(1)
        for lo in range(0, n, KMEANS_BLOCK):
            blk = x[lo:lo + KMEANS_BLOCK]
            d2 = cn[None, :] - 2.0 * (blk @ c32.T)
            labels[lo:lo + KMEANS_BLOCK] = d2.argmin(1)
        for j in range(k):
            members = x[labels == j]
            if members.shape[0]:
                centers[j] = members.double().mean(0)
    return labels


class Plan:
    """The op stream of one run."""

    def __init__(self, traffic: dict, law: Law, n_base: int, seed: int):
        self.pattern = traffic["pattern"]
        if self.pattern not in ("random", "clustered"):
            raise ValueError(f"unknown pattern {self.pattern!r}")
        self.k = int(traffic["k"])
        self.recall_lanes = int(traffic["recall_lanes"])
        self.round_spec = [(e["op"], int(e["n"]))
                           for e in traffic["round"]
                           for _ in range(int(e.get("repeat", 1)))]
        for kind, _ in self.round_spec:
            if kind not in KINDS:
                raise ValueError(f"unknown op {kind!r}")
        self.law, self.seed, self.n_base = law, int(seed), int(n_base)
        self._index = 0
        self._seq = dict.fromkeys(KINDS, 0)
        self._next_row = self.n_base
        self._rng = np.random.default_rng(subseed(seed, "deletes"))
        # rows alive, for the random pattern's draws; the clustered
        # pattern deletes the oldest, so a cursor is enough
        self._alive = np.arange(self.n_base, dtype=np.int64)
        self._n_alive = self.n_base
        self._oldest = 0
        if self.pattern == "clustered":
            per_round = sum(n for kind, n in self.round_spec if kind == "insert")
            warm = sum(n for kind, n in self._warmup_spec() if kind == "insert")
            total = self.n_base + warm + int(traffic["max_rounds"]) * per_round
            corpus = law.draw(total, "corpus")
            labels = kmeans_labels(corpus, int(traffic["clusters"]),
                                   int(traffic["kmeans_iters"]),
                                   generator(law.device, seed, "kmeans"))
            order = torch.argsort(labels, stable=True)
            self._corpus = corpus[order]
            del corpus
            self._base = self._corpus[:self.n_base]
        else:
            self._corpus = None
            self._base = law.draw(self.n_base, "base")

    def _warmup_spec(self) -> list:
        seen = []
        for entry in self.round_spec:
            if entry not in seen:
                seen.append(entry)
        return seen

    # -- data ---------------------------------------------------------------
    def base(self) -> torch.Tensor:
        """f32 ``[n_base, dim]`` on the law's device; once released, the
        same rows again (drawn anew, or read from the clustered corpus)."""
        if self._base is not None:
            return self._base
        if self._corpus is not None:
            return self._corpus[:self.n_base]
        return self.law.draw(self.n_base, "base")

    def release_base(self) -> None:
        """Drop the plan's hold on the base (the clustered corpus keeps the
        rows still to be inserted)."""
        self._base = None

    def insert_rows(self, op: Op) -> torch.Tensor:
        if self._corpus is None:
            return self.law.draw(op.n, "insert", op.seq)
        lo = int(op.rows[0])
        if lo + op.n > self._corpus.shape[0]:
            raise StreamExhausted(f"row {lo + op.n} is past the "
                                  f"{self._corpus.shape[0]} rows made up front")
        return self._corpus[lo:lo + op.n]

    def queries(self, op: Op) -> torch.Tensor:
        return self.law.draw(op.n, "query", op.seq)

    # -- ops ----------------------------------------------------------------
    def _op(self, kind: str, n: int) -> Op:
        op = Op(self._index, kind, n, self._seq[kind])
        self._index += 1
        self._seq[kind] += 1
        if kind == "insert":
            op.rows = np.arange(self._next_row, self._next_row + n, dtype=np.int64)
            self._next_row += n
            self._grow_alive(op.rows)
        elif kind == "delete":
            op.rows = self._pick_deletes(n)
        else:
            rng = np.random.default_rng(subseed(self.seed, "sample", op.index))
            m = min(self.recall_lanes, n)
            op.sample = np.sort(rng.choice(n, size=m, replace=False)).astype(np.int64)
        return op

    def _grow_alive(self, rows: np.ndarray) -> None:
        need = self._n_alive + rows.size
        if need > self._alive.size:
            self._alive = np.concatenate(
                [self._alive, np.empty(max(need, 2 * self._alive.size) - self._alive.size,
                                       np.int64)])
        self._alive[self._n_alive:need] = rows
        self._n_alive = need

    def _pick_deletes(self, n: int) -> np.ndarray:
        if n > self._n_alive:
            raise StreamExhausted("a delete op asks for more rows than are alive")
        if self.pattern == "clustered":
            rows = np.arange(self._oldest, self._oldest + n, dtype=np.int64)
            self._oldest += n
            return rows
        pos = self._rng.choice(self._n_alive, size=n, replace=False)
        rows = self._alive[pos].copy()
        for p in np.sort(pos)[::-1]:          # swap-remove, last first
            self._n_alive -= 1
            self._alive[p] = self._alive[self._n_alive]
        return rows

    def warmup(self) -> list[Op]:
        """One op of every (kind, width) the round uses, in round order."""
        return [self._op(kind, n) for kind, n in self._warmup_spec()]

    def next_round(self) -> list[Op]:
        return [self._op(kind, n) for kind, n in self.round_spec]
