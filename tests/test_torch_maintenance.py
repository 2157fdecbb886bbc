"""The maintenance path of the port against ``repro.core`` on the CPU:
consolidation for every repair strategy, refinement, capacity growth and
the slot-frame helpers, the incremental constructor, an armed Session
stream (consolidate + refine + growth triggers), ``run_workload`` on a
Session and on the ``IPGMIndex`` facade, and the §6 workload builder.

Graph state is compared byte for byte on integer-valued vectors, where
every fp32 dot product is exact in any summation order. The workload
builder draws Gaussian data; its arrays are compared as drawn, and the
driven streams use them rounded to integers for the same reason."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexParams, MaintenanceParams, SearchParams
from repro.core import IPGMIndex as JIndex
from repro.core import Session as JSession
from repro.core import consolidate as jconsolidate
from repro.core import delete as jdelete
from repro.core import graph as jgraph
from repro.core import rebuild as jrebuild
from repro.core import refine as jrefine
from repro.core import run_workload as jrun_workload
from repro.data import synthetic as jsynthetic
from repro.data import workload as jworkload
from repro_torch.core import Session as TSession
from repro_torch.core import consolidate as tconsolidate
from repro_torch.core import graph as tgraph
from repro_torch.core import maint, prng
from repro_torch.core import rebuild as trebuild
from repro_torch.core import refine as trefine
from repro_torch.core.health import check_health
from repro_torch.core.maintenance import IPGMIndex as TIndex
from repro_torch.core.maintenance import run_workload as trun_workload
from repro_torch.data import synthetic as tsynthetic
from repro_torch.data import workload as tworkload
from torch_parity import INT_FIELDS, int_vectors, state_diff, torch_params, torch_state

UPDATE_FIELDS = INT_FIELDS + ("vectors", "sqnorms")


def _params(cap, d, d_out=6, **mkw):
    return IndexParams(capacity=cap, dim=d, d_out=d_out,
                       search=SearchParams(pool_size=16, max_steps=48,
                                           num_starts=2),
                       maintenance=MaintenanceParams(**mkw))


@pytest.fixture(scope="module")
def masked():
    """A bulk-built state with 40 MASK tombstones and a row-touch history."""
    rng = np.random.default_rng(0)
    X = int_vectors(rng, 220, 10)
    valid = np.ones(220, bool)
    valid[::11] = False
    p = _params(256, 10)
    js = jrebuild.bulk_knn_build(jnp.asarray(X), jnp.asarray(valid), p, k_nn=12)
    alive = np.flatnonzero(np.asarray(js.alive))
    g = rng.choice(alive, 16, replace=False).astype(np.int32)
    js = jdelete.delete_batch(js, jnp.asarray(g), jnp.ones(16, bool),
                              jax.random.PRNGKey(1), "global", p)
    alive = np.flatnonzero(np.asarray(js.alive))
    m = rng.choice(alive, 40, replace=False).astype(np.int32)
    js = jdelete.delete_batch(js, jnp.asarray(m), jnp.ones(40, bool),
                              jax.random.PRNGKey(2), "mask", p)
    return js, p


@pytest.mark.parametrize("strategy", ["pure", "local", "global", "rwalk"])
def test_consolidate_chunk_byte_equal(masked, strategy):
    """One OP_CONSOLIDATE chunk: the 32 lowest tombstones repaired with each
    ``consolidate_strategy``, scrubbed and freed."""
    js, p = masked
    p = dataclasses.replace(p, maintenance=MaintenanceParams(
        consolidate_strategy=strategy))
    key = jax.random.PRNGKey(5)

    def step(s, k):
        tomb, tv = jgraph.mask_to_slots(s.masked, 32)
        s2, n = jconsolidate.consolidate_chunk_impl(s, tomb, tv, k, p)
        return s2, n, tomb

    js2, jn, jtomb = jax.jit(step)(js, key)
    ts = torch_state(js)
    tomb, tv = tgraph.mask_to_slots(ts.masked, 32)
    ts, tn = tconsolidate.consolidate_chunk_impl(ts, tomb, tv,
                                                 prng.prng_key(5), torch_params(p))
    assert np.array_equal(tomb.numpy(), np.asarray(jtomb))
    assert int(tn) == int(jn) == 32
    assert state_diff(js2, ts, UPDATE_FIELDS) == []
    assert check_health(ts) == []


def test_refine_chunk_and_stalest_slots_byte_equal(masked):
    js, p = masked
    key = jax.random.PRNGKey(6)

    def step(s, k):
        ids, valid = jrefine.stalest_slots(s, 24)
        s2, n = jrefine.refine_chunk_impl(s, ids, valid, k, p)
        return s2, n, ids, valid

    js2, jn, jids, jvalid = jax.jit(step)(js, key)
    ts = torch_state(js)
    ids, valid = trefine.stalest_slots(ts, 24)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    ts, tn = trefine.refine_chunk_impl(ts, ids, valid, prng.prng_key(6),
                                       torch_params(p))
    assert int(tn) == int(jn)
    assert state_diff(js2, ts, UPDATE_FIELDS) == []
    # n past the capacity pads the frame with NULL lanes
    big_ids, big_valid = trefine.stalest_slots(ts, ts.capacity + 5)
    jb_ids, jb_valid = jrefine.stalest_slots(js2, js2.capacity + 5)
    assert np.array_equal(big_ids.numpy(), np.asarray(jb_ids))
    assert np.array_equal(big_valid.numpy(), np.asarray(jb_valid))


def test_growth_and_slot_primitives_match(masked):
    js, _ = masked
    for cap, need, f, mc in ((1024, 1025, 2.0, None), (1024, 9000, 2.0, 8192),
                             (10, 11, 1.5, None), (16, 100, 2.0, 16),
                             (16, 8, 2.0, None), (3, 40, 1.1, None)):
        assert (tgraph.next_capacity_tier(cap, need, f, mc)
                == jgraph.next_capacity_tier(cap, need, f, mc))
    ts = tgraph.grow_state(torch_state(js), 300)
    jg = jgraph.grow_state(js, 300)
    assert ts.capacity == jg.capacity == 300
    assert state_diff(jg, ts) == []
    with pytest.raises(ValueError, match="shrink"):
        tgraph.grow_state(ts, 100)
    rng = np.random.default_rng(3)
    for n in (1, 7, 64, 300):
        mask = rng.random(256) < 0.1
        tids, tv = tgraph.mask_to_slots(torch.from_numpy(mask), n)
        jids, jv = jgraph.mask_to_slots(jnp.asarray(mask), n)
        assert np.array_equal(tids.numpy(), np.asarray(jids))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    ids = rng.choice(256, 20, replace=False).astype(np.int32)
    valid = rng.random(20) < 0.7
    jf = jgraph.free_slots(js, jnp.asarray(ids), jnp.asarray(valid))
    tf = tgraph.free_slots(torch_state(js), torch.from_numpy(ids),
                           torch.from_numpy(valid))
    assert state_diff(jf, tf, INT_FIELDS) == []


def test_build_graph_byte_equal():
    """The paper's incremental constructor: chunked batch inserts."""
    rng = np.random.default_rng(4)
    X = int_vectors(rng, 150, 8)
    p = _params(192, 8)
    js = jrebuild.build_graph(jnp.asarray(X), jax.random.PRNGKey(7), p,
                              chunk=32)
    ts = trebuild.build_graph(X, prng.prng_key(7), torch_params(p), chunk=32,
                              device="cpu")
    assert state_diff(js, ts) == []


def _armed(strategy, **mkw):
    kw = dict(strategy=strategy, insert_chunk=16, delete_chunk=16,
              consolidate_threshold=0.2, refine_threshold=40,
              max_capacity=256)
    kw.update(mkw)
    return _params(32, 8, **kw)


def _drive_armed(sess, rng):
    """Net-growing churn: inserts that outgrow the tier, MASK deletes past
    the tombstone threshold, flushes that fire refinement."""
    out, alive = {}, []
    for rnd in range(4):
        ids = sess.insert(int_vectors(rng, 30, 8)).result()
        out[f"ins{rnd}"] = ids
        alive += ids[ids >= 0].tolist()
        dels = rng.choice(alive, 12, replace=False).astype(np.int32)
        sess.delete(dels)
        alive = [a for a in alive if a not in set(dels.tolist())]
        sess.flush()
        out[f"q{rnd}"] = sess.query(int_vectors(rng, 8, 8), k=5).result()
    out["counters"] = np.array([sess.timers.n_grows, sess.timers.n_consolidations,
                                sess.timers.n_refines, sess.timers.n_refused,
                                sess.state.capacity, sess._op_counter])
    return out


def test_armed_session_stream_matches_jax():
    """Acked ids, query results, trigger counts and the final state of a
    MASK session with every maintenance trigger armed match the JAX
    Session (consolidation by GLOBAL repair; the other repairs are held to
    JAX chunk by chunk above)."""
    p = _armed("mask")
    js = JSession(p, seed=2)
    ts = TSession(torch_params(p), seed=2, device="cpu")
    want = _drive_armed(js, np.random.default_rng(11))
    got = _drive_armed(ts, np.random.default_rng(11))
    for name, w in want.items():
        g = got[name]
        if isinstance(w, tuple):
            assert all(np.array_equal(a, b) for a, b in zip(w, g)), name
        else:
            assert np.array_equal(np.asarray(w), g), name
    assert got["counters"][0] >= 1 and got["counters"][1] >= 1
    assert got["counters"][2] >= 1
    js.flush()
    assert state_diff(js.state, ts.state) == []
    assert check_health(ts.state) == []


def test_maintenance_timing_does_not_shift_op_keys():
    """Sessions that grow, consolidate and refine at different points run
    the same op-key chain: acked ids and the alive set are identical (the
    maintenance passes draw from their own chains, and growth only appends
    free slots)."""
    rng = np.random.default_rng(8)
    batches = [int_vectors(rng, n, 8) for n in (30, 40, 50)]
    sessions = [
        TSession(torch_params(_params(32, 8, max_capacity=512)), seed=5,
                 device="cpu"),
        TSession(torch_params(_params(256, 8, max_capacity=512)), seed=5,
                 device="cpu"),
        TSession(torch_params(_params(256, 8, max_capacity=512,
                                      refine_threshold=10)), seed=5,
                 device="cpu"),
    ]
    acked = [[] for _ in sessions]
    for b in batches:
        for s, a in zip(sessions, acked):
            a.append(s.insert(b).result())
            s.flush()
    sessions[1].refine(n=20)
    for s, a in zip(sessions, acked):
        a.append(s.insert(batches[0]).result())
    for a in acked[1:]:
        assert all(np.array_equal(x, y) for x, y in zip(acked[0], a))
    assert sessions[0].timers.n_grows >= 1 and sessions[1].timers.n_grows == 0
    assert sessions[2].timers.n_refines >= 1
    assert len({s._op_counter for s in sessions}) == 1
    n = min(s.state.capacity for s in sessions)
    alive = [s.state.alive[:n].numpy() for s in sessions]
    assert all(np.array_equal(alive[0], a) for a in alive[1:])


def test_session_maintenance_surface():
    """Explicit consolidate / grow / refine calls and their books."""
    p = torch_params(_params(32, 8, strategy="mask", insert_chunk=16,
                             delete_chunk=16))
    s = TSession(p, seed=0, device="cpu")
    ids = s.insert(int_vectors(np.random.default_rng(0), 32, 8)).result()
    s.delete(ids[:10])
    assert s.consolidate() == 10
    assert np.array_equal(np.sort(s.last_consolidate_handle.result()),
                          np.sort(ids[:10]))
    assert s.consolidate() == 0
    assert int(s.state.masked.sum()) == 0 and int(s.state.size) == 22
    s.grow(48)
    assert s.state.capacity == 48
    with pytest.raises(ValueError, match="shrink"):
        s.grow(16)
    assert s.refine(n=20) == 20
    assert s.last_refine_handle.result().shape == (20,)
    st = s.stats()
    assert (st["n_consolidations"], st["n_grows"], st["n_refines"]) == (1, 1, 1)
    assert check_health(s.state) == []
    with pytest.raises(ValueError, match="not a stream op"):
        s._dispatch(maint.OP_CONSOLIDATE, np.zeros((1, 8), np.float32), 16)


def test_registry_keys_and_host_drivers_match_jax():
    """The maintenance key chains and frozen codes equal the JAX registry's;
    ``maybe_consolidate`` fires on the tombstone share like JAX's."""
    from repro.core import maint as jmaint
    for name in ("CONSOLIDATE", "GROW", "REFINE", "MERGE"):
        t, j = getattr(maint, name), getattr(jmaint, name)
        assert (t.op_code, t.journal_code, t.key_stream, t.counter_attr,
                t.time_field, t.count_field) == (
            j.op_code, j.journal_code, j.key_stream, j.counter_attr,
            j.time_field, j.count_field)
        if t.key_stream is not None:
            for counter in (0, 5):
                want = jax.random.key_data(jmaint.maint_key(
                    jax.random.PRNGKey(3), j, counter))
                got = maint.maint_key(prng.prng_key(3), t, counter)
                assert np.array_equal(got.numpy(), np.asarray(want))
    p = _params(64, 8, strategy="mask", insert_chunk=16, delete_chunk=16)
    rng = np.random.default_rng(1)
    X = int_vectors(rng, 40, 8)
    idx = {"jax": JIndex(p, seed=0), "torch": TIndex(torch_params(p), seed=0,
                                                     device="cpu")}
    got = {}
    for name, index in idx.items():
        ids = index.insert(X)
        index.delete(ids[:4])
        mod = jconsolidate if name == "jax" else tconsolidate
        frac = mod.masked_fraction(index.state)
        got[name] = (frac, mod.maybe_consolidate(index, threshold=0.5),
                     mod.maybe_consolidate(index, threshold=0.05),
                     mod.masked_fraction(index.state))
    assert got["jax"] == got["torch"] == (0.1, 0, 4, 0.0)
    assert state_diff(idx["jax"].state, idx["torch"].state) == []


def _int_workload(wl):
    r = lambda a: np.round(2.0 * a).astype(np.float32)  # noqa: E731
    return (r(wl.base), [r(x) for x in wl.step_inserts], r(wl.queries))


def _workload_stream(wl, capacity):
    """The §6 stream as (op, payload): base insert, then per step a MASK
    delete, a consolidation, the step's inserts and a query; a final
    rebuild and query. Pool positions map to graph ids by replaying the
    lowest-free-first allocator."""
    base, inserts, queries = _int_workload(wl)
    free = np.ones(capacity, bool)
    id_map = list(range(base.shape[0]))
    free[: base.shape[0]] = False
    ops = [("insert", base)]
    for step in range(wl.n_steps):
        gids = np.asarray([id_map[p] for p in wl.step_deletes[step]], np.int32)
        ops += [("delete", gids), ("consolidate", None)]
        free[gids] = True
        new = np.flatnonzero(free)[: inserts[step].shape[0]]
        free[new] = False
        id_map += new.tolist()
        ops += [("insert", inserts[step]), ("query", queries)]
    ops += [("rebuild", None), ("query", queries)]
    return ops


@pytest.mark.parametrize("pattern", ["random", "clustered"])
@pytest.mark.parametrize("driver", ["session", "facade"])
def test_run_workload_records_match(pattern, driver):
    wl = jworkload.make_workload("sift", n_base=120, n_steps=2, batch_size=24,
                                 n_queries=16, pattern=pattern, dim=8)
    p = _params(200, 8, strategy="mask", insert_chunk=32, delete_chunk=32)
    ops = _workload_stream(wl, 200)
    if driver == "session":
        want = jrun_workload(JSession(p, seed=1), ops, k=5)
        got = trun_workload(TSession(torch_params(p), seed=1, device="cpu"),
                            ops, k=5)
    else:
        want = jrun_workload(JIndex(p, seed=1), ops, k=5)
        got = trun_workload(TIndex(torch_params(p), seed=1, device="cpu"),
                            ops, k=5)
    assert [(r["op"], r["n"]) for r in want] == [(r["op"], r["n"]) for r in got]
    for w, g in zip(want, got):
        if "recall" in w:
            assert abs(w["recall"] - g["recall"]) <= 1e-6   # ROADMAP Queue C 4
    if driver == "session":
        assert got[-1]["timers"]["n_consolidations"] == wl.n_steps


def test_stream_ground_truth_is_taken_at_the_query():
    """The port updates the state in place: a delete of a query's true
    neighbours, dispatched right behind the query, must not change that
    query's recall record."""
    rng = np.random.default_rng(12)
    p = torch_params(_params(128, 8, strategy="global"))
    X, Q = int_vectors(rng, 100, 8), int_vectors(rng, 6, 8)
    plain = trun_workload(TSession(p, seed=3, device="cpu"),
                          [("insert", X), ("query", Q)], k=5)
    probe = TSession(p, seed=3, device="cpu")
    probe.insert(X).result()
    _, true_ids = probe.ground_truth(Q, 5)
    doomed = np.unique(true_ids.numpy()[:, :3]).astype(np.int32)
    after = trun_workload(TSession(p, seed=3, device="cpu"),
                          [("insert", X), ("query", Q), ("delete", doomed)], k=5)
    assert after[1]["recall"] == plain[1]["recall"]
    probe.delete(doomed)
    assert not np.array_equal(probe.ground_truth(Q, 5)[1].numpy(),
                              true_ids.numpy())


@pytest.mark.parametrize("pattern", ["random", "clustered"])
def test_make_workload_matches(pattern):
    kw = dict(n_base=300, n_steps=3, batch_size=40, n_queries=25,
              pattern=pattern, seed=4)
    w, g = jworkload.make_workload("glove200", **kw), tworkload.make_workload(
        "glove200", **kw)
    assert w.n_steps == g.n_steps == 3 and w.pattern == g.pattern
    for a, b in [(w.base, g.base), (w.queries, g.queries),
                 *zip(w.step_inserts, g.step_inserts),
                 *zip(w.step_deletes, g.step_deletes)]:
        assert np.array_equal(a, b)
    x = jsynthetic.make_dataset("sift", 500, seed=2)
    assert np.array_equal(jsynthetic.kmeans(x, 7, seed=3),
                          tsynthetic.kmeans(x, 7, seed=3))
