"""Deterministic fault injection — ``repro.testing.faults``.

Production code marks the places where a deployment can die (after a
journal append, mid-checkpoint-save, between merge steps) with
``crash_point("name")``; with no plan active the call returns at once. A
test activates a :class:`FaultPlan` with :func:`inject`, naming which hit
of which point dies; that site raises :class:`SimulatedCrash`, the test
drops the session as a crash would drop the process, and recovery runs from
what is on disk.

Plans are data (point → 1-based hit, or a seeded draw from
:func:`random_plan`), so a failing cell replays exactly. The registry is
closed: ``crash_point`` rejects a name that is not in :data:`CRASH_POINTS`,
and the tuples below equal the JAX package's element for element. The
maintenance ops' points come from the registry in ``core/maint.py``; the
sharded points fire in ``repro_torch.distributed.ann.ShardedSession`` at
JAX's sites. ``transient_point(site)`` raises :class:`TransientDispatchError` for
the first ``k`` hits of a site, which ``Session.flush`` absorbs with
bounded retries.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
from typing import Iterator

from repro_torch.core import maint as _maint

SESSION_CRASH_POINTS = (
    "post-journal-append",    # record durable, device never saw the op
    "pre-flush",              # flush requested, nothing synced yet
    "post-flush",             # host/device synced, timers not yet settled
    *_maint.crash_points("session"),
    "mid-checkpoint-save",    # shards written, manifest/publish pending
    "post-checkpoint-save",   # checkpoint published, journal not truncated
)
SHARDED_CRASH_POINTS = (
    "sharded-pre-dispatch",
    "sharded-post-dispatch",
    *_maint.sharded_crash_points(),
)
TIERED_CRASH_POINTS = _maint.crash_points("tiered")
CRASH_POINTS = (SESSION_CRASH_POINTS + SHARDED_CRASH_POINTS
                + TIERED_CRASH_POINTS)
_CRASH_POINT_SET = frozenset(CRASH_POINTS)


class SimulatedCrash(RuntimeError):
    """Raised at an armed crash point. The caller must treat the session as
    dead (device state lost) and recover from disk; unlike a real kill the
    exception unwinds, so no site keeps durable work in a ``finally``."""


class TransientDispatchError(RuntimeError):
    """A retryable dispatch failure (a simulated runtime hiccup)."""


@dataclasses.dataclass
class FaultPlan:
    """``crashes``: point → 1-based hit at which it raises; ``transients``:
    site → number of first hits that fail with TransientDispatchError."""

    crashes: dict[str, int] = dataclasses.field(default_factory=dict)
    transients: dict[str, int] = dataclasses.field(default_factory=dict)
    hits: dict[str, int] = dataclasses.field(default_factory=dict)
    log: list[str] = dataclasses.field(default_factory=list)

    def _bump(self, name: str) -> int:
        n = self.hits.get(name, 0) + 1
        self.hits[name] = n
        return n


_lock = threading.Lock()
_active: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    return _active


def crash_point(name: str) -> None:
    """Mark a named kill site. No-op unless an armed plan targets it."""
    if name not in _CRASH_POINT_SET:
        raise ValueError(f"unregistered crash point {name!r}")
    plan = _active
    if plan is None:
        return
    with _lock:
        n = plan._bump(name)
        armed = plan.crashes.get(name)
    if armed is not None and n == armed:
        plan.log.append(f"crash:{name}#{n}")
        raise SimulatedCrash(f"simulated crash at {name} (hit {n})")


def transient_point(site: str) -> None:
    """Mark a retryable-failure site (e.g. ``"flush"``)."""
    plan = _active
    if plan is None:
        return
    with _lock:
        remaining = plan.transients.get(site, 0)
        if remaining <= 0:
            return
        plan.transients[site] = remaining - 1
    plan.log.append(f"transient:{site}")
    raise TransientDispatchError(f"simulated transient failure at {site}")


@contextlib.contextmanager
def inject(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Activate ``plan`` for the block. Plans do not nest."""
    global _active
    with _lock:
        if _active is not None:
            raise RuntimeError("a fault plan is already active")
        plan.hits = {}
        plan.log = []
        _active = plan
    try:
        yield plan
    finally:
        with _lock:
            _active = None


def crash_once(point: str, hit: int = 1) -> FaultPlan:
    """Plan that kills the process at the ``hit``-th arrival at ``point``."""
    if point not in _CRASH_POINT_SET:
        raise ValueError(f"unregistered crash point {point!r}")
    return FaultPlan(crashes={point: hit})


def transient(site: str, count: int = 1) -> FaultPlan:
    """Plan whose first ``count`` hits of ``site`` fail transiently."""
    return FaultPlan(transients={site: count})


def random_plan(seed: int, points: tuple[str, ...] = SESSION_CRASH_POINTS,
                max_hit: int = 4) -> FaultPlan:
    """One crash at a (point, hit) drawn from ``random.Random(seed)`` — the
    same draw as the JAX package's for the same seed."""
    rng = random.Random(seed)
    point = points[rng.randrange(len(points))]
    return FaultPlan(crashes={point: rng.randrange(1, max_hit + 1)})
