"""Request batching and quorum degradation — ``repro.serving.batcher``.

  · adaptive batching: requests accumulate until ``max_batch`` or
    ``max_wait_s``, and every device step runs at the pad-stable
    ``max_batch`` shape, whatever the number of requests in it;
  · quorum degradation: ``quorum_merge`` merges only the shards that
    answered in time, so recall degrades by at most the missing share
    instead of stalling on a straggler;
  · graceful degradation under overload and recovery: a bounded queue that
    sheds with a typed error past ``max_queue``, a per-request deadline
    checked when the queue is drained, and a readiness gate that holds
    traffic while the session replays its journal after a crash.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.core.graph import NULL
from repro_torch.core.maintenance import IPGMIndex
from repro_torch.core.session import Session


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 64
    max_wait_s: float = 0.005
    k: int = 10
    quorum: float = 1.0        # fraction of shards required (sharded mode)
    max_queue: int | None = None   # bound on queued requests (None = ∞)
    deadline_s: float | None = None  # per-request age limit at drain time


class ServerOverloadError(RuntimeError):
    """submit() refused: the bounded queue is full (load shed)."""


class ServerNotReadyError(RuntimeError):
    """submit() refused: the server is holding traffic (e.g. recovery)."""


class BatchedServer:
    """Pad-stable batched front end over a :class:`Session` (or the session
    of an :class:`IPGMIndex`). Every step is one query op of ``max_batch``
    rows, zero-padded; ``step()`` hands back host arrays once the card has
    finished the op. ``clock``/``sleep`` are injectable for deterministic
    tests of the batching window."""

    _POLL_S = 0.0005  # wait slice: bounds drain latency jitter, not a spin

    def __init__(self, index: IPGMIndex | Session,
                 cfg: ServeConfig = ServeConfig(), *,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        # `index` is kept for caller introspection; every step goes through
        # `self.session`
        self.index = index
        self.session = index.session if isinstance(index, IPGMIndex) else index
        self.cfg = cfg
        self._clock = clock
        self._sleep = sleep
        # queue entries carry their submit time for the deadline check
        self._queue: deque[tuple[int, np.ndarray, float]] = deque()
        self._next_id = 0
        self._ready = True
        self.stats = {"batches": 0, "requests": 0, "pad_waste": 0.0,
                      "shed_overload": 0, "shed_deadline": 0}
        # rid → reason for every request shed after admission (deadline)
        self.failed: dict[int, str] = {}

    @property
    def ready(self) -> bool:
        """False while traffic is held: ``set_ready(False)``, or the session
        replaying its journal (``session.recovering``)."""
        return self._ready and not getattr(self.session, "recovering", False)

    def set_ready(self, ready: bool) -> None:
        self._ready = bool(ready)

    def submit(self, query: np.ndarray) -> int:
        if not self.ready:
            raise ServerNotReadyError(
                "server is not accepting traffic (recovery in progress?)")
        if (self.cfg.max_queue is not None
                and len(self._queue) >= self.cfg.max_queue):
            self.stats["shed_overload"] += 1
            raise ServerOverloadError(
                f"queue full ({self.cfg.max_queue} pending); load shed")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, np.asarray(query, np.float32), self._clock()))
        return rid

    def _expire(self) -> None:
        """Fail queued requests older than ``deadline_s`` before they take a
        device step. Submit times are monotone, so the expired entries are
        a prefix of the queue."""
        if self.cfg.deadline_s is None:
            return
        now = self._clock()
        while self._queue and now - self._queue[0][2] > self.cfg.deadline_s:
            rid, _, _ = self._queue.popleft()
            self.failed[rid] = "deadline"
            self.stats["shed_deadline"] += 1

    def _drain(self) -> list[tuple[int, np.ndarray]]:
        """Up to ``max_batch`` requests for one step. Once one request is in
        hand the drain waits out ``max_wait_s`` from its start, sleeping in
        short slices, so requests that arrive meanwhile join the batch; an
        idle queue returns at once."""
        out: list[tuple[int, np.ndarray]] = []
        deadline = self._clock() + self.cfg.max_wait_s
        while len(out) < self.cfg.max_batch:
            self._expire()
            if self._queue:
                rid, q, _ = self._queue.popleft()
                out.append((rid, q))
                continue
            if not out:
                break  # idle server: nothing to wait for
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            self._sleep(min(remaining, self._POLL_S))
        return out

    def step(self) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """Serve one batch; returns {request_id: (ids, scores)}."""
        batch = self._drain()
        if not batch:
            return {}
        B = self.cfg.max_batch
        dim = batch[0][1].shape[-1]
        padded = np.zeros((B, dim), np.float32)
        for i, (_, q) in enumerate(batch):
            padded[i] = q
        # one query op at the pad-stable max_batch shape; result() copies
        # to the host, so it returns after the card has finished
        ids, scores = self.session.query(padded, k=self.cfg.k, chunk=B).result()
        self.stats["batches"] += 1
        self.stats["requests"] += len(batch)
        self.stats["pad_waste"] += 1.0 - len(batch) / B
        return {rid: (ids[i], scores[i]) for i, (rid, _) in enumerate(batch)}


def quorum_merge(shard_ids: np.ndarray, shard_scores: np.ndarray,
                 arrived: np.ndarray, k: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Merge the per-shard top-k (``[P, B, k]`` global ids and scores) of
    the shards that ``arrived`` in time: the straggler-tolerant fan-in.
    Ties rank as numpy's default (unstable) argsort ranks them, as in JAX."""
    P, B, kk = shard_ids.shape
    s = np.where(arrived[:, None, None], shard_scores, -np.inf)
    flat_s = np.transpose(s, (1, 0, 2)).reshape(B, P * kk)
    flat_i = np.transpose(shard_ids, (1, 0, 2)).reshape(B, P * kk)
    order = np.argsort(-flat_s, axis=1)[:, :k]
    top_s = np.take_along_axis(flat_s, order, axis=1)
    top_i = np.take_along_axis(flat_i, order, axis=1)
    top_i = np.where(np.isfinite(top_s), top_i, NULL)
    return top_i, top_s
