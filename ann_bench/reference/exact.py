"""Exact answers in plain PyTorch: scores, top-k over the rows alive at a
query's time, recall.

The score is the index's l2 similarity, ``2<q, x> − |x|²`` (higher is
nearer; ``−|x − q|²`` up to the query's own norm). The reference scores
in float64 unless told to score as the control does (``precision``):

  ``"float64"``  the reference;
  ``"tf32"``     rows and queries rounded to TF32 (10 mantissa bits, as
                 the tensor cores read float32 with TF32 on), float32
                 products (the control of a float32 configuration; the
                 rounding is done here, so it reads alike on every device);
  ``"fp8"``      rows rounded to float8 e4m3, float32 products with TF32
                 off (the control of a bfloat16-row configuration).

``row_dtype="bfloat16"`` rounds every row to bfloat16 first, as a
configuration that stores its rows in bfloat16 does. The rows live on the
host as segments (the base, then the inserted rows) and move to the
device a block at a time.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

ROW_BLOCK = 1 << 16
NULL_ROW = -1


@contextlib.contextmanager
def tf32_off():
    """float32 products in float32 (TF32 off), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def cast_rows(x: torch.Tensor, row_dtype: str, precision: str) -> torch.Tensor:
    """Rows as the configuration stores them, then as ``precision`` reads
    them: float64 for the reference, float32 for the controls."""
    x = x.float()
    if row_dtype == "bfloat16":
        x = x.bfloat16().float()
    if precision == "fp8":
        x = x.to(torch.float8_e4m3fn).float()
    if precision == "tf32":
        x = round_tf32(x)
    return x.double() if precision == "float64" else x


def cast_queries(q: torch.Tensor, precision: str) -> torch.Tensor:
    q = q.float()
    return q.double() if precision == "float64" else (
        round_tf32(q) if precision == "tf32" else q)


def scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[Q, R]`` scores of queries ``q [Q, d]`` against rows ``x [R, d]``
    in their common dtype."""
    return 2.0 * (q @ x.T) - (x * x).sum(1)[None, :]


def pair_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[Q, k]`` scores of each query ``q [Q, d]`` against its own rows
    ``x [Q, k, d]``, with the scale ``2|q||x| + |x|²`` that bounds the
    terms (gaps are measured against it)."""
    dot = (x * q[:, None, :]).sum(-1)
    xx = (x * x).sum(-1)
    scale = 2.0 * q.norm(dim=-1)[:, None] * xx.sqrt() + xx
    return 2.0 * dot - xx, scale


class Rows:
    """The rows of a run by row number: ``segments`` of host tensors laid
    end to end (the base, then the inserted rows in row order)."""

    def __init__(self, segments: list[torch.Tensor]):
        self.segments = [s for s in segments if s.shape[0]]
        self.starts = np.cumsum([0] + [s.shape[0] for s in self.segments])
        self.n = int(self.starts[-1])

    def take(self, rows: np.ndarray) -> torch.Tensor:
        """f32 ``[len(rows), d]`` on the host."""
        rows = np.asarray(rows, np.int64)
        out = torch.empty((rows.size, self.segments[0].shape[1]), dtype=torch.float32)
        seg = np.searchsorted(self.starts, rows, side="right") - 1
        for i, s in enumerate(self.segments):
            m = seg == i
            if m.any():
                out[torch.from_numpy(np.flatnonzero(m))] = s[
                    torch.from_numpy(rows[m] - self.starts[i])].float()
        return out

    def blocks(self, block: int = ROW_BLOCK):
        """(first row, f32 host block) over every row in order."""
        for i, s in enumerate(self.segments):
            for lo in range(0, s.shape[0], block):
                yield int(self.starts[i]) + lo, s[lo:lo + block]


def topk_alive(rows: Rows, t_in: np.ndarray, t_out: np.ndarray,
               queries: torch.Tensor, t_q: np.ndarray, k: int, device, *,
               row_dtype: str = "float32", precision: str = "float64",
               groups: tuple | None = None, exclude: np.ndarray | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores ``[Q, k]``, rows i64 ``[Q, k]``) of the ``k`` best rows for
    each query among the rows alive at its time: row r is alive for a
    query at stream position t when ``t_in[r] < t < t_out[r]``.
    ``groups = (row_group, query_group)`` keeps, for each query, only the
    rows of its group (a shard); ``exclude`` drops one row per query
    (itself). Missing entries are (-inf, -1); ties go to the lower row."""
    dev = torch.device(device)
    Q = queries.shape[0]
    dt = torch.float64 if precision == "float64" else torch.float32
    q = cast_queries(queries.to(dev), precision)
    tq = torch.as_tensor(np.asarray(t_q, np.int64), device=dev)[:, None]
    t_in_d = torch.as_tensor(t_in, device=dev)
    t_out_d = torch.as_tensor(t_out, device=dev)
    if groups is not None:
        row_group = torch.as_tensor(np.asarray(groups[0], np.int64), device=dev)
        q_group = torch.as_tensor(np.asarray(groups[1], np.int64), device=dev)[:, None]
    if exclude is not None:
        excl = torch.as_tensor(np.asarray(exclude, np.int64), device=dev)[:, None]
    best_s = torch.full((Q, k), float("-inf"), dtype=dt, device=dev)
    best_r = torch.full((Q, k), NULL_ROW, dtype=torch.int64, device=dev)
    with tf32_off():
        for lo, blk in rows.blocks():
            x = cast_rows(blk.to(dev), row_dtype, precision)
            hi = lo + x.shape[0]
            s = scores(q, x)
            alive = (t_in_d[lo:hi][None, :] < tq) & (t_out_d[lo:hi][None, :] > tq)
            ids = torch.arange(lo, hi, device=dev)[None, :].expand(Q, -1)
            if groups is not None:
                alive &= row_group[None, lo:hi] == q_group
            if exclude is not None:
                alive &= ids != excl
            s = torch.where(alive, s, float("-inf"))
            all_s = torch.cat([best_s, s], 1)
            all_r = torch.cat([best_r, ids], 1)
            # stable: on equal scores the earlier column (lower row) wins
            order = torch.sort(all_s, dim=1, descending=True, stable=True).indices[:, :k]
            best_s = torch.gather(all_s, 1, order)
            best_r = torch.gather(all_r, 1, order)
    best_r = torch.where(best_s > float("-inf"), best_r, NULL_ROW)
    return best_s, best_r


def recall(found: np.ndarray, true: np.ndarray) -> np.ndarray:
    """Per query, the share of its true rows (not -1) that ``found``
    holds."""
    found, true = np.asarray(found), np.asarray(true)
    hit = (found[:, :, None] == true[:, None, :]) & (true[:, None, :] != NULL_ROW)
    n_true = np.maximum((true != NULL_ROW).sum(1), 1)
    return hit.any(1).sum(1) / n_true
