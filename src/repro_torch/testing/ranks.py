"""Streams for the sharded index's rank path, run on every rank.

Each function takes the ``launch.mesh.CardGroup`` first (``None``: the
stacked layout in this process) and returns host arrays, so
``launch.mesh.run_on_ranks`` can start it in spawned processes and the
caller can hold every layout's bytes against the others'.

- :func:`parity_stream`: the stream that ``tests/test_torch_distributed.py``
  holds against JAX's 8-device programs (steps on a (4, 2) mesh, deletes
  of every strategy, consolidation, a session that grows and consolidates,
  bf16 rows, a pod mesh), with the global state after every step.
- :func:`rank_checks`: a growing MASK session with its counters, a
  ``gather_state`` round trip, every sharded crash point, and one
  ``compressed_psum`` member a rank.
- :func:`raise_on_rank`: a rank that fails while the others wait in a
  collective.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.graph import DATA_FIELDS, tensor_to_numpy
from repro_torch.core.params import IndexParams, MaintenanceParams, SearchParams
from repro_torch.distributed.ann import (
    DistParams,
    ShardedSession,
    ShardMesh,
    gather_state,
    init_sharded_state,
    make_consolidate_step,
    make_delete_step,
    make_insert_step,
    make_query_step,
)
from repro_torch.distributed.compression import compressed_psum
from repro_torch.testing import faults

MESH = ShardMesh((4, 2), ("data", "model"))


def small_params(cap: int, dim: int, **maintenance) -> IndexParams:
    return IndexParams(capacity=cap, dim=dim, d_out=8,
                       search=SearchParams(pool_size=16, max_steps=32,
                                           num_starts=2),
                       maintenance=MaintenanceParams(**maintenance))


def growing_params(dim: int) -> IndexParams:
    """MASK with a consolidation threshold and growth armed from 16 slots
    a shard up to 128."""
    return small_params(16, dim, strategy="mask", insert_chunk=32,
                        delete_chunk=32, consolidate_threshold=0.25,
                        consolidate_chunk=16, max_capacity=128)


def pick(g: np.ndarray, idx) -> np.ndarray:
    """The gids at ``idx``, plus a NULL and an id past every live slot."""
    d = g[idx].astype(np.int32)
    return np.concatenate([d, np.asarray([-1, 7 * 64 + 60], np.int32)])


def state_arrays(state, group) -> dict:
    """Host copies of the global state's fields (bf16 rows as uint16)."""
    st = gather_state(state, group)
    out = {}
    for f in DATA_FIELDS:
        a = tensor_to_numpy(getattr(st, f)).copy()
        out[f] = a.view(np.uint16) if a.dtype.itemsize == 2 else a
    return out


def parity_stream(group, inp: dict, device="cpu") -> dict:
    """The JAX test script's sharded stream on the port: ``tag/field`` of
    the global state after each step, ``tag/gids`` and ``tag/ids``,
    ``tag/scores`` of the queries."""
    X, Q, route = inp["X"], inp["Q"], inp["route"]
    dim = X.shape[1]
    res = {}
    K = prng.prng_key

    def dump(tag, st):
        for f, a in state_arrays(st, group).items():
            res[f"{tag}/{f}"] = a

    def query(tag, out):
        res[tag + "/ids"], res[tag + "/scores"] = (t.cpu().numpy() for t in out)

    def init(dp, mesh):
        return init_sharded_state(dp, mesh, device=device, group=group)

    dp = DistParams(index=small_params(64, dim, delete_chunk=16,
                                       consolidate_chunk=16))
    ins = make_insert_step(dp, MESH, group=group)
    qry = make_query_step(dp, MESH, group=group)
    st, g1 = ins(init(dp, MESH), X[:96], route[:96], K(0))
    dump("ins1", st)
    res["ins1/gids"] = g1.cpu().numpy()
    query("q1", qry(st, Q, K(1)))
    st, g2 = ins(st, X[96:192], route[96:192], K(2))
    dump("ins2", st)
    res["ins2/gids"] = g2.cpu().numpy()
    g = np.concatenate([res["ins1/gids"], res["ins2/gids"]])
    for i, strategy in enumerate(("global", "local", "mask")):
        st = make_delete_step(dp, MESH, strategy, group=group)(
            st, pick(g, np.arange(i, 84 + i, 6)), K(3 + i))
        dump(f"del_{strategy}", st)
    cons = make_consolidate_step(dp, MESH, group=group)
    st = cons(st, K(6))
    st = cons(st, K(7))
    dump("cons", st)
    query("q2", qry(st, Q, K(8)))

    sess = ShardedSession(DistParams(index=growing_params(dim)), MESH,
                          strategy="mask", seed=3, device=device, group=group)
    h1 = sess.insert(X[:96], route[:96]).cpu().numpy()
    h2 = sess.insert(X[96:192], route[96:192]).cpu().numpy()
    sess.delete(pick(np.concatenate([h1, h2]), np.arange(0, 120, 2)))
    sess.flush()
    query("growq", sess.query(Q))
    dump("grow", sess.state)
    res["grow/gids"] = np.concatenate([h1, h2])
    res["grow/counters"] = np.asarray([
        sess.dp.index.capacity, sess.timers.n_grows,
        sess.timers.n_consolidations, sess.timers.n_consolidated,
        sess.timers.n_refused])

    dpb = DistParams(index=small_params(64, dim), vec_dtype="bfloat16")
    st, gb = make_insert_step(dpb, MESH, group=group)(
        init(dpb, MESH), X[:96], route[:96], K(0))
    dump("bf16", st)
    res["bf16/gids"] = gb.cpu().numpy()
    query("bf16q", make_query_step(dpb, MESH, group=group)(st, Q, K(1)))

    mesh3 = ShardMesh((2, 2, 2), ("pod", "data", "model"))
    dp3 = DistParams(index=small_params(64, dim), pod_axis="pod")
    st, g3 = make_insert_step(dp3, mesh3, group=group)(
        init(dp3, mesh3), X[:80], route[:80], K(0))
    dump("pod", st)
    res["pod/gids"] = g3.cpu().numpy()
    query("podq", make_query_step(dp3, mesh3, group=group)(st, Q, K(1)))
    return res


def _growing_session(group, X, device):
    sess = ShardedSession(DistParams(index=growing_params(X.shape[1])), MESH,
                          strategy="mask", seed=3, device=device, group=group)
    g1 = sess.insert(X[:100], np.arange(100)).cpu().numpy()
    g2 = sess.insert(X[100:200], np.arange(100, 200)).cpu().numpy()
    return sess, np.concatenate([g1, g2])


def session_checks(group, X, Q, device="cpu") -> dict:
    """A MASK session that grows in lockstep and consolidates (by its
    threshold and by a call): gids, counters, answers and the global
    state; then a session started from the gathered state."""
    sess, g = _growing_session(group, X, device)
    sess.delete(g[:60])
    sess.flush()
    sess.delete(g[60:80])
    n_cons = sess.consolidate()
    sess.flush()
    ids, scores = sess.query(Q)
    t = sess.timers
    out = {"gids": g, "ids": ids.cpu().numpy(), "scores": scores.cpu().numpy(),
           "counters": np.asarray([sess.dp.index.capacity, t.n_grows,
                                   t.n_consolidations, t.n_consolidated,
                                   t.n_refused, n_cons, sess.n_alive(),
                                   sess.n_masked()]),
           "state": state_arrays(sess.state, group)}
    glob = sess.gather_state()
    again = ShardedSession(sess.dp, MESH, strategy="mask", state=glob,
                           group=group)
    out["roundtrip_block"] = all(
        torch.equal(getattr(again.state, f), getattr(sess.state, f))
        for f in DATA_FIELDS)
    out["roundtrip_state"] = state_arrays(again.state, group)
    return out


def crash_checks(group, X, device="cpu") -> dict:
    """For each sharded crash point: the op of a fixed stream at which its
    second hit (the first for the grow points) raised, and the hits."""
    out = {}
    for point in faults.SHARDED_CRASH_POINTS:
        plan = faults.crash_once(point, hit=1 if "grow" in point else 2)
        ops = []
        with faults.inject(plan):
            try:
                sess, g = _growing_session(group, X, device)
                ops.append("insert")
                # 20 tombstones a shard: two consolidation passes
                sess.delete(g[:160])
                ops.append("delete")
                sess.consolidate()
                ops.append("consolidate")
                sess.flush()
            except faults.SimulatedCrash:
                ops.append("crash")
        out[point] = {"ops": ops, "hits": dict(plan.hits)}
    return out


def rank_checks(group, X, Q, members: dict, device="cpu") -> dict:
    """``session_checks``, ``crash_checks`` and this rank's member of an
    int8-compressed mean (``members``: leaf → ``[world, ...]`` array)."""
    mine = {k: torch.from_numpy(v[group.rank]) for k, v in members.items()}
    psum = compressed_psum(mine, prng.prng_key(11), group=group)
    return {"session": session_checks(group, X, Q, device),
            "crash": crash_checks(group, X, device),
            "psum": {k: v.numpy() for k, v in psum.items()}}


def raise_on_rank(group, bad: int) -> int:
    """Rank ``bad`` raises; the others wait for it in a collective."""
    if group.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    group.all_gather(torch.zeros(1, device=group.device))
    return group.rank
