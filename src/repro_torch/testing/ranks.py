"""Streams for the sharded index's rank path, run on every rank.

Each function takes the ``launch.mesh.CardGroup`` first (``None``: the
stacked layout in this process) and returns host arrays, so
``launch.mesh.run_on_ranks`` can start it in spawned processes and the
caller can hold every layout's bytes against the others'.

- :func:`parity_stream`: the stream that ``tests/test_torch_distributed.py``
  holds against JAX's 8-device programs (steps on a (4, 2) mesh, deletes
  of every strategy, consolidation, a session that grows and consolidates,
  bf16 rows, a (2, 2, 2) pod mesh whose pods lie on their own ranks), with
  the global state after every step.
- :func:`rank_checks`: a growing MASK session with its counters, a
  ``gather_state`` round trip, every sharded crash point, one
  ``compressed_psum`` member a rank, and (given a checkpoint of
  :func:`pod_checks`) a pod session resumed on this rank count.
- :func:`pod_checks`: the same session and crash points on a (2, 4, 2)
  pod mesh, the pods on their own ranks; one ``compressed_psum`` member a
  pod over the pod-peer group; a checkpoint of the session saved by rank
  0 and the ops that follow it; replicas made to disagree.
- :func:`raise_on_rank`: a rank that fails while the others wait in a
  collective.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import prng
from repro_torch.core.graph import (
    DATA_FIELDS,
    graph_state_from_numpy,
    tensor_to_numpy,
)
from repro_torch.core.params import IndexParams, MaintenanceParams, SearchParams
from repro_torch.distributed.ann import (
    DistParams,
    ReplicaMismatch,
    ShardedSession,
    ShardMesh,
    gather_state,
    init_sharded_state,
    init_specs_tree,
    make_consolidate_step,
    make_delete_step,
    make_insert_step,
    make_query_step,
    pod_groups,
    pod_of,
)
from repro_torch.distributed.compression import compressed_psum
from repro_torch.testing import faults

MESH = ShardMesh((4, 2), ("data", "model"))
POD_MESH = ShardMesh((2, 4, 2), ("pod", "data", "model"))


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
    """Host copies of the fields of every block of ``group`` (bf16 rows as
    uint16): over the replica group, one replica's global state."""
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

    def dump(tag, st, over=group):
        for f, a in state_arrays(st, over).items():
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
    dump("pod", st, pod_groups(dp3, mesh3, group)[0])
    res["pod/gids"] = g3.cpu().numpy()
    query("podq", make_query_step(dp3, mesh3, group=group)(st, Q, K(1)))
    return res


def growing_dist_params(dim: int, mesh: ShardMesh) -> DistParams:
    """``growing_params`` over ``mesh``, its pod axis set where it has one."""
    return DistParams(index=growing_params(dim),
                      pod_axis="pod" if "pod" in mesh.axis_names else None)


def _growing_session(group, X, device, mesh=MESH):
    sess = ShardedSession(growing_dist_params(X.shape[1], mesh), mesh,
                          strategy="mask", seed=3, device=device, group=group)
    g1 = sess.insert(X[:100], np.arange(100)).cpu().numpy()
    g2 = sess.insert(X[100:200], np.arange(100, 200)).cpu().numpy()
    return sess, np.concatenate([g1, g2])


def session_checks(group, X, Q, device="cpu", mesh=MESH) -> dict:
    """A MASK session that grows in lockstep and consolidates (by its
    threshold and by a call): gids, counters, answers and the global
    state of the rank's replica; then a session started from the gathered
    state."""
    sess, g = _growing_session(group, X, device, mesh)
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
           "state": state_arrays(sess.state, sess.replica)}
    glob = sess.gather_state()
    again = ShardedSession(sess.dp, mesh, strategy="mask", state=glob,
                           group=group)
    out["roundtrip_block"] = all(
        torch.equal(getattr(again.state, f), getattr(sess.state, f))
        for f in DATA_FIELDS)
    out["roundtrip_state"] = state_arrays(again.state, again.replica)
    return out


def crash_checks(group, X, device="cpu", mesh=MESH) -> dict:
    """For each sharded crash point: the op of a fixed stream at which its
    second hit (the first for the grow points) raised, and the hits."""
    out = {}
    for point in faults.SHARDED_CRASH_POINTS:
        plan = faults.crash_once(point, hit=1 if "grow" in point else 2)
        ops = []
        with faults.inject(plan):
            try:
                sess, g = _growing_session(group, X, device, mesh)
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


def rank_checks(group, X, Q, members: dict, resume_dir=None,
                device="cpu") -> dict:
    """``session_checks``, ``crash_checks`` and this rank's member of an
    int8-compressed mean (``members``: leaf → ``[world, ...]`` array);
    with ``resume_dir``, ``resume_checks`` of :func:`pod_checks`'s
    checkpoint on this group."""
    mine = {k: torch.from_numpy(v[group.rank]) for k, v in members.items()}
    psum = compressed_psum(mine, prng.prng_key(11), group=group)
    out = {"session": session_checks(group, X, Q, device),
           "crash": crash_checks(group, X, device),
           "psum": {k: v.numpy() for k, v in psum.items()}}
    if resume_dir is not None:
        out["resume"] = resume_checks(group, resume_dir, X, Q, device)
    return out


def _next_ops(sess, X, Q) -> dict:
    """The ops after the checkpoint: a query op, an insert op and the
    rank's replica's state after them."""
    ids, scores = sess.query(Q)
    gids = sess.insert(X[150:166], 1000 + np.arange(16))
    return {"ids": ids.cpu().numpy(), "scores": scores.cpu().numpy(),
            "gids": gids.cpu().numpy(),
            "state": state_arrays(sess.state, sess.replica)}


def resume_source(group, X, Q, directory, device="cpu") -> dict:
    """A growing MASK session on ``POD_MESH`` after deletes and a flush,
    checkpointed by rank 0 (the replica's gathered state, the key
    counters, the capacity), then the ops that follow the checkpoint."""
    sess, g = _growing_session(group, X, device, POD_MESH)
    sess.delete(g[:60])
    sess.flush()
    tree = {"graph": sess.gather_state(),
            "op_counters": np.asarray(sess.op_counters, np.int64)}
    if group is None or group.rank == 0:
        CheckpointManager(directory).save(
            1, tree, extra={"capacity": sess.dp.index.capacity})
    return _next_ops(sess, X, Q)


def resume_checks(group, directory, X, Q, device="cpu") -> dict:
    """:func:`resume_source`'s checkpoint restored onto this group's rank
    count (each rank keeps its block of its pod's replica), then the same
    ops."""
    dp = growing_dist_params(X.shape[1], POD_MESH)
    tree, extra = CheckpointManager(directory).restore(
        None, {"graph": init_specs_tree(dp), "op_counters": np.zeros(2)})
    ip = dataclasses.replace(dp.index, capacity=int(extra["capacity"]))
    dp = dataclasses.replace(dp, index=ip)
    state = graph_state_from_numpy(
        tree["graph"], capacity=ip.capacity, dim=ip.dim, d_out=ip.d_out,
        d_in=ip.eff_d_in, metric=ip.metric,
        device=device if group is None else group.device)
    sess = ShardedSession(dp, POD_MESH, strategy="mask", seed=3, state=state,
                          group=group,
                          op_counters=tuple(int(c) for c in tree["op_counters"]))
    return _next_ops(sess, X, Q)


def disagree_checks(group, X, device="cpu") -> str:
    """A pod session whose pod-1 replica gains one alive slot behind the
    session's back: the message of the :class:`ReplicaMismatch` that the
    next count raises (on every rank), or "" if none did."""
    sess, _ = _growing_session(group, X, device, POD_MESH)
    if pod_of(sess.dp, sess.mesh, group) == 1:
        free = torch.nonzero(~sess.state.present[0]).flatten()
        sess.state.alive[0, free[0]] = True
    try:
        sess.n_alive()
    except ReplicaMismatch as e:
        return str(e)
    return ""


def pod_checks(group, X, Q, members: dict, directory, device="cpu") -> dict:
    """On ``POD_MESH``, the pods on their own ranks: ``session_checks``,
    ``crash_checks``, this pod's member of an int8-compressed mean over
    the pod-peer group (``members``: leaf → ``[pods, ...]`` array),
    ``resume_source`` (rank 0 saves to ``directory``) and
    ``disagree_checks``."""
    dp = growing_dist_params(X.shape[1], POD_MESH)
    _, peers = pod_groups(dp, POD_MESH, group)
    pod = pod_of(dp, POD_MESH, group)
    mine = {k: torch.from_numpy(v[pod]) for k, v in members.items()}
    psum = compressed_psum(mine, prng.prng_key(11), group=peers)
    return {"pod": pod,
            "session": session_checks(group, X, Q, device, POD_MESH),
            "crash": crash_checks(group, X, device, POD_MESH),
            "psum": {k: v.numpy() for k, v in psum.items()},
            "resume": resume_source(group, X, Q, directory, device),
            "disagree": disagree_checks(group, X, device)}


def raise_on_rank(group, bad: int) -> int:
    """Rank ``bad`` raises; the others wait for it in a collective."""
    if group.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    group.all_gather(torch.zeros(1, device=group.device))
    return group.rank
