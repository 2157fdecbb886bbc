"""Maintenance-op registry — ``repro.core.maint``.

Every background maintenance pass (consolidate, grow, refine, and the
two-tier merge) declares once: its isolated PRNG key stream (so firing it
never shifts the op-key chain), its journal record code and replay hook,
the host counter that dedups it on replay and the checkpoint extras that
persist it, its crash points, and its ``PhaseTimers`` fields. The session
and the two-tier index journal, checkpoint and replay through these
entries, and ``repro_torch.testing.faults`` builds its closed crash-point
registry from them. The codes, stream ids, extras keys and point names are
frozen at the JAX package's values, so journals and checkpoints cross
between the packages. The sharded tier is not ported; its point names
stay so that the registry equals JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import prng

OP_CONSOLIDATE = 4
OP_REFINE = 5

JR_CONSOLIDATE = 18
JR_GROW = 19
JR_MERGE = 20
JR_REFINE = 21

CONSOLIDATE_KEY_STREAM = 0x7FFFFFFF
MERGE_KEY_STREAM = 0x7FFFFFFE
REFINE_KEY_STREAM = 0x7FFFFFFD


@dataclasses.dataclass(frozen=True)
class MaintOp:
    """Declarative record of one maintenance op's cross-layer obligations;
    ``replay(session, record) -> bool`` re-executes a journaled call (False
    when the restored counters already cover it)."""

    name: str
    tier: str  # "session" | "tiered"
    journal_code: int
    replay: Callable[[Any, Any], bool]
    op_code: int | None = None
    key_stream: int | None = None
    counter_attr: str | None = None  # host counter; snapshot as cseq
    extra_key: str | None = None     # checkpoint-extras key of counter_attr
    # (attr, extras key) pairs persisted and restored beside the counter
    state_attrs: tuple[tuple[str, str], ...] = ()
    crash_points: tuple[str, ...] = ()
    sharded_crash_points: tuple[str, ...] = ()
    time_field: str | None = None
    count_field: str | None = None


def maint_key(base_key: torch.Tensor, op: MaintOp, counter: int
              ) -> torch.Tensor:
    """``fold_in(fold_in(base, op.key_stream), counter)`` — isolated from
    the op-key chain, which folds the op counter directly."""
    if op.key_stream is None:
        raise ValueError(f"maintenance op {op.name!r} declares no key stream")
    return prng.fold_in(prng.fold_in(base_key, op.key_stream), counter)


def _replay_consolidate(sess: Any, rec: Any) -> bool:
    if rec.cseq < sess._consolidate_counter:
        return False
    sess.consolidate(strategy=rec.aux.get("strategy"), chunk=rec.aux.get("chunk"))
    return True


def _replay_grow(sess: Any, rec: Any) -> bool:
    target = int(rec.aux["new_capacity"])
    if target <= sess.state.capacity:
        return False
    sess.grow(target)
    return True


def _replay_refine(sess: Any, rec: Any) -> bool:
    if rec.cseq < sess._refine_counter:
        return False
    sess.refine(n=rec.aux.get("n"), chunk=rec.aux.get("chunk"))
    return True


def _replay_merge(sess: Any, rec: Any) -> bool:
    if rec.cseq < sess._merges_done:
        return False
    sess.merge()
    return True


CONSOLIDATE = MaintOp(
    name="consolidate", tier="session", journal_code=JR_CONSOLIDATE,
    replay=_replay_consolidate, op_code=OP_CONSOLIDATE,
    key_stream=CONSOLIDATE_KEY_STREAM, counter_attr="_consolidate_counter",
    extra_key="consolidate_counter",
    crash_points=("pre-consolidate", "post-consolidate"),
    sharded_crash_points=("sharded-consolidate-pass",),
    time_field="consolidate_s", count_field="n_consolidations")

GROW = MaintOp(
    name="grow", tier="session", journal_code=JR_GROW, replay=_replay_grow,
    crash_points=("pre-grow", "post-grow"),
    sharded_crash_points=("sharded-pre-grow", "sharded-post-grow"),
    time_field="grow_s", count_field="n_grows")

REFINE = MaintOp(
    name="refine", tier="session", journal_code=JR_REFINE,
    replay=_replay_refine, op_code=OP_REFINE, key_stream=REFINE_KEY_STREAM,
    counter_attr="_refine_counter", extra_key="refine_counter",
    # the wear odometer gates auto-refine, so it survives checkpoints
    state_attrs=(("_refine_wear", "refine_wear"),),
    crash_points=("refine-begin", "refine-step"),
    time_field="refine_s", count_field="n_refines")

MERGE = MaintOp(
    name="merge", tier="tiered", journal_code=JR_MERGE, replay=_replay_merge,
    key_stream=MERGE_KEY_STREAM, counter_attr="_merges_done",
    extra_key="merges_done",
    crash_points=("merge-begin", "merge-compact-step", "merge-drain-step",
                  "pre-merge-swap", "post-merge-swap"),
    time_field="merge_s", count_field="n_merges")

REGISTRY: tuple[MaintOp, ...] = (CONSOLIDATE, GROW, REFINE, MERGE)
SESSION_OPS: tuple[MaintOp, ...] = tuple(o for o in REGISTRY if o.tier == "session")

_BY_JOURNAL_CODE = {o.journal_code: o for o in REGISTRY}


def by_journal_code(code: int) -> MaintOp | None:
    """The registered op that journals under ``code``, or None."""
    return _BY_JOURNAL_CODE.get(code)


def crash_points(tier: str) -> tuple[str, ...]:
    """All crash points declared by ``tier``'s ops, in registry order."""
    return tuple(p for op in REGISTRY if op.tier == tier
                 for p in op.crash_points)


def sharded_crash_points() -> tuple[str, ...]:
    """Crash points declared for per-shard variants, in registry order."""
    return tuple(p for op in REGISTRY for p in op.sharded_crash_points)
