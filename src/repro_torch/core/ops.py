"""Op IR — fixed-shape micro-batches of the session stream (``repro.core.ops``).

A mixed stream is chopped into :class:`OpBatch` micro-batches of one shape;
:func:`apply_ops` runs one. The op codes are frozen at the JAX package's
values. JAX compiles one ``lax.switch`` program over the branches; eager
PyTorch needs no switch, so the branch is chosen on the host from the
batch's op code. Update branches modify the state in place where the JAX
step takes it donated. The maintenance branches (OP_CONSOLIDATE,
OP_REFINE) are operand-free: each picks its own slots at its stream
position, and their codes come from the registry in ``core/maint.py``.
The journal's record codes (stream ops under their OP_* code, plus the
JR_* codes below) are frozen the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import consolidate as consolidate_mod
from repro_torch.core import delete as delete_mod
from repro_torch.core import insert as insert_mod
from repro_torch.core import maint, search
from repro_torch.core import refine as refine_mod
from repro_torch.core.graph import NULL, GraphState, mask_to_slots
from repro_torch.core.maint import (  # noqa: F401  (re-exported codes)
    JR_CONSOLIDATE,
    JR_GROW,
    JR_MERGE,
    JR_REFINE,
    OP_CONSOLIDATE,
    OP_REFINE,
)
from repro_torch.core.params import IndexParams

OP_QUERY = 0
OP_INSERT = 1
OP_DELETE = 2
OP_NOOP = 3

OP_NAMES = {OP_QUERY: "query", OP_INSERT: "insert", OP_DELETE: "delete",
            OP_NOOP: "noop", OP_CONSOLIDATE: "consolidate",
            OP_REFINE: "refine"}

# journal-only record codes (``checkpoint/journal.py``): the journal header,
# flush points (a maintenance trigger site) and explicit maintenance calls
JR_META = 16
JR_FLUSH = 17

JR_NAMES = {JR_META: "meta", JR_FLUSH: "flush",
            **{op.journal_code: f"{op.name}!" for op in maint.REGISTRY}}


@dataclasses.dataclass(frozen=True)
class OpBatch:
    """One fixed-shape micro-batch of the op stream."""

    op_code: int           # OP_* discriminator
    payload: torch.Tensor  # f32[B, dim] query/insert vectors (zeros for delete)
    ids: torch.Tensor      # i32[B]      delete targets (NULL elsewhere)
    valid: torch.Tensor    # bool[B]     real (non-padding) lanes
    offset: int            # global item offset within the op


def make_op(op_code: int, chunk: int, dim: int, *,
            payload: np.ndarray | None = None, ids: np.ndarray | None = None,
            offset: int = 0, device=None) -> OpBatch:
    """Host-side encoder: pad one op slice up to the ``chunk`` shape."""
    n = payload.shape[0] if payload is not None else (
        ids.shape[0] if ids is not None else 0)
    if n > chunk:
        raise ValueError(f"op slice of {n} items exceeds chunk {chunk}")
    p = np.zeros((chunk, dim), np.float32)
    if payload is not None:
        p[:n] = payload
    i = np.full((chunk,), NULL, np.int32)
    if ids is not None:
        i[:n] = ids
    valid = np.arange(chunk) < n
    return OpBatch(op_code=int(op_code),
                   payload=torch.from_numpy(p).to(device),
                   ids=torch.from_numpy(i).to(device),
                   valid=torch.from_numpy(valid).to(device),
                   offset=int(offset))


def apply_ops(state: GraphState, batch: OpBatch, key: torch.Tensor,
              params: IndexParams, strategy: str
              ) -> tuple[GraphState, torch.Tensor, torch.Tensor]:
    """Apply one micro-batch. Returns (state, ids i32[B, K], scores f32[B, K]).

    ``key`` is the op-level key, shared by every micro-batch of one op;
    ``batch.offset`` folds per lane (chunking-invariant results)."""
    dev = state.device
    B = batch.payload.shape[0]
    K = params.search.pool_size
    sp = params.search
    ids = torch.full((B, K), NULL, dtype=torch.int32, device=dev)
    scores = torch.full((B, K), float("-inf"), dtype=torch.float32, device=dev)
    code = batch.op_code
    if code == OP_QUERY:
        starts = search.batch_entry_points(state, key, B, sp.num_starts,
                                           offset=batch.offset,
                                           active=batch.valid)
        res = search.beam_search(state, batch.payload, starts, sp)
        ids = torch.where(batch.valid[:, None], res.ids, NULL)
        scores = torch.where(batch.valid[:, None], res.scores, float("-inf"))
    elif code == OP_INSERT:
        state, slots = insert_mod.insert_batch_impl(
            state, batch.payload, batch.valid, key, params,
            key_offset=batch.offset)
        ids[:, 0] = slots
    elif code == OP_DELETE:
        delete_mod.delete_batch(state, batch.ids, batch.valid, key, strategy,
                                params)
    elif code == OP_CONSOLIDATE:
        # the B lowest-id tombstones at this stream position
        tomb, tv = mask_to_slots(state.masked, B)
        consolidate_mod.consolidate_chunk_impl(state, tomb, tv, key, params)
        ids[:, 0] = tomb
    elif code == OP_REFINE:
        # the B stalest alive slots at this stream position
        tgt, tv = refine_mod.stalest_slots(state, B)
        refine_mod.refine_chunk_impl(state, tgt, tv, key, params)
        ids[:, 0] = tgt
    elif code != OP_NOOP:
        raise ValueError(f"unknown op code {code}")
    return state, ids, scores
