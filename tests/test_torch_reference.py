"""The port's sequential oracles and scalar edge primitives against
``repro.core`` on the CPU: ``row_insert``/``row_remove``/``add_edge``/
``remove_edge``/``set_out_edges``/``rebuild_radj_rows``/``next_free_slot``,
the per-query reference engine (JAX's and the port's batched engine at
W = 1, at the tests/test_beam_parity.py shapes), ``insert_batch_reference``,
the three ``delete_*_reference`` strategies and ``consolidate_reference``.

Graph state is compared byte for byte on integer-valued vectors, where every
fp32 dot product is exact in any summation order; on Gaussian data scores
agree within the Pallas kernels' tolerance (rtol 1e-4, atol 1e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexParams, SearchParams
from repro.core import IPGMIndex as JIndex
from repro.core import consolidate as jconsolidate
from repro.core import delete as jdelete
from repro.core import graph as jgraph
from repro.core import insert as jinsert
from repro.core import rebuild as jrebuild
from repro.core import search as jsearch
from repro_torch.core import consolidate as tconsolidate
from repro_torch.core import delete as tdelete
from repro_torch.core import graph as tgraph
from repro_torch.core import insert as tinsert
from repro_torch.core import prng
from repro_torch.core import search as tsearch
from repro_torch.core.health import check_health
from repro_torch.core.maintenance import IPGMIndex as TIndex
from torch_parity import INT_FIELDS, int_vectors, state_diff, torch_params, torch_state

UPDATE_FIELDS = INT_FIELDS + ("vectors", "sqnorms")


def _params(cap, d, d_out=6, d_in=None, metric="l2", pool=16):
    return IndexParams(capacity=cap, dim=d, d_out=d_out, d_in=d_in,
                       metric=metric,
                       search=SearchParams(pool_size=pool,
                                           max_steps=3 * pool, num_starts=2))


def _copy(js):
    return jax.tree.map(jnp.copy, js)


def _built(rng, n, cap, d, d_out=6, d_in=None, metric="l2", holes=0,
           k_nn=12, gaussian=False):
    X = (rng.normal(size=(n, d)).astype(np.float32) if gaussian
         else int_vectors(rng, n, d))
    valid = np.ones(n, bool)
    if holes:
        valid[::holes] = False          # free slots inside the used range
    p = _params(cap, d, d_out=d_out, d_in=d_in, metric=metric)
    return jrebuild.bulk_knn_build(jnp.asarray(X), jnp.asarray(valid), p,
                                   k_nn=k_nn), p


# ---------------------------------------------------------------------------
# scalar edge primitives
# ---------------------------------------------------------------------------

ROWS = {  # (row, values fed to row_insert and row_remove)
    "holes": ([3, -1, 5, -1, 8, -1], [7, 5, -1]),
    "full": ([3, 4, 5, 6, 7, 8], [9, 4]),
    "duplicates": ([4, -1, 4, 2, -1, 2], [4, 2, 6]),
    "self": ([1, -1, 2, 3, -1, -1], [1, 0]),
}


@pytest.fixture(scope="module")
def small_graph():
    """A bulk-built graph with a tight in-degree bound (full reverse rows)
    and free slots."""
    js, p = _built(np.random.default_rng(0), 40, 48, 4, d_out=4, d_in=5,
                   holes=7, k_nn=8)
    return js, p


def _edge_ops(case, js):
    """The (op, u, v) edits each case applies on top of the built graph."""
    adj, radj = np.asarray(js.adj), np.asarray(js.radj)
    present = np.asarray(js.present)
    u_full = int(np.flatnonzero((adj != -1).all(1) & present)[0])
    v_full = int(np.flatnonzero((radj != -1).all(1))[0])
    u_room = int(np.flatnonzero((adj == -1).any(1) & present)[0])
    has = np.flatnonzero((adj[u_room] != -1))
    if case == "holes":      # edges into rows with room, then removals
        return [("add", u_room, 20), ("add", u_room, 21),
                ("remove", u_room, int(adj[u_room, has[0]])),
                ("add", u_room, 22)]
    if case == "full":       # a full out-row, a full reverse row
        return [("add", u_full, 17), ("add", u_room, v_full),
                ("remove", u_full, int(adj[u_full, 0])),
                ("add", u_full, 17)]
    if case == "duplicates":  # an edge already there, a removal of a non-edge
        v = int(adj[u_room, has[0]])
        return [("add", u_room, v), ("add", u_room, v),
                ("remove", u_room, 30), ("remove", u_room, v),
                ("remove", u_room, v)]
    return [("add", u_room, u_room), ("remove", u_room, u_room),
            ("add", -1, 3), ("add", 3, -1)]          # self, NULL ends


@pytest.mark.parametrize("case", list(ROWS))
def test_scalar_primitives(case, small_graph):
    row, values = ROWS[case]
    for value in values:
        wr, wok = jgraph.row_insert(jnp.asarray(row, jnp.int32),
                                    jnp.int32(value))
        gr, gok = tgraph.row_insert(torch.tensor(row, dtype=torch.int32),
                                    value)
        assert gr.numpy().tolist() == np.asarray(wr).tolist(), value
        assert bool(gok) == bool(wok), value
        assert tgraph.row_remove(torch.tensor(row, dtype=torch.int32),
                                 value).numpy().tolist() == np.asarray(
            jgraph.row_remove(jnp.asarray(row, jnp.int32), value)).tolist()

    js, _ = small_graph
    ts = torch_state(js)
    for op, u, v in _edge_ops(case, js):
        fn_j = jgraph.add_edge if op == "add" else jgraph.remove_edge
        fn_t = tgraph.add_edge if op == "add" else tgraph.remove_edge
        js = fn_j(js, jnp.int32(u), jnp.int32(v))
        fn_t(ts, u, v)
        assert state_diff(js, ts, ("adj", "radj")) == [], (op, u, v)
    # a whole row replaced: old edges out, targets in order, a duplicate
    # target, a self edge, NULL padding, one target whose reverse row is full
    radj = np.asarray(js.radj)
    v_full = int(np.flatnonzero((radj != -1).all(1))[0])
    u = int(np.flatnonzero(np.asarray(js.present))[1])
    targets = np.array([v_full, u, 9, 9, -1, 11], np.int32)[: js.d_out]
    js = jax.jit(jgraph.set_out_edges)(js, jnp.int32(u), jnp.asarray(targets))
    tgraph.set_out_edges(ts, u, torch.from_numpy(targets))
    assert state_diff(js, ts, ("adj", "radj", "touch", "tclock")) == []


def test_rebuild_radj_rows_and_next_free_slot(small_graph):
    """A recompute of touched reverse rows under in-degree pressure (the
    in-edges ranked d_in or above leave adj too); the first free slot, and
    0 on a full graph."""
    js, _ = small_graph
    adj = np.asarray(js.adj).copy()
    adj[:, -1] = 2                      # hub 2: far more than d_in in-edges
    adj[2, -1] = -1
    js = dataclasses.replace(js, adj=jnp.asarray(adj))
    touched = np.zeros(js.capacity, bool)
    touched[[2, 5, 9, 13, 40]] = True
    want = jax.jit(jgraph.rebuild_radj_rows)(js, jnp.asarray(touched))
    got = tgraph.rebuild_radj_rows(torch_state(js), torch.from_numpy(touched))
    assert state_diff(want, got, ("adj", "radj")) == []
    assert int(tgraph.next_free_slot(got)) == int(jgraph.next_free_slot(want))
    full = torch_state(js)
    full.present.fill_(True)
    assert int(tgraph.next_free_slot(full)) == 0


# ---------------------------------------------------------------------------
# the reference engine
# ---------------------------------------------------------------------------

def _sp(W=1):
    return SearchParams(pool_size=16, max_steps=48, num_starts=2,
                        beam_width=W)


def _beam_parity_index(metric, gaussian, seed=0):
    """tests/test_beam_parity.py shapes (n 260, dim 12, d_out 6, pool 16,
    capacity 320) with never-present holes and 35 MASK tombstones."""
    rng = np.random.default_rng(seed)
    js, _ = _built(rng, 260, 320, 12, d_out=6, metric=metric, holes=17,
                   k_nn=16, gaussian=gaussian)
    alive = np.asarray(js.alive).copy()
    alive[5:40] = False
    Q = (rng.normal(size=(24, 12)).astype(np.float32) if gaussian
         else int_vectors(rng, 24, 12))
    return dataclasses.replace(js, alive=jnp.asarray(alive)), Q


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_reference_engine_integer_data(metric, raw):
    """Ids, scores and hop counts equal JAX's reference engine and the
    port's batched engine at W = 1, filtered and raw."""
    js, Q = _beam_parity_index(metric, gaussian=False)
    sp = _sp()
    jfn = (jsearch.search_batch_reference_raw if raw
           else jsearch.search_batch_reference)
    want = jfn(js, jnp.asarray(Q), jax.random.PRNGKey(7), sp)
    ts = torch_state(js)
    tfn = (tsearch.search_batch_reference_raw if raw
           else tsearch.search_batch_reference)
    got = tfn(ts, Q, prng.prng_key(7), torch_params(sp))
    batched = (tsearch.search_batch_raw if raw else tsearch.search_batch)(
        ts, Q, prng.prng_key(7), torch_params(sp))
    for res in (got, batched):
        assert (res.ids.numpy() == np.asarray(want.ids)).all()
        assert (res.scores.numpy() == np.asarray(want.scores)).all()
        assert (res.n_expanded.numpy() == np.asarray(want.n_expanded)).all()
    if not raw:
        ids = got.ids.numpy()
        assert not np.isin(ids[ids != -1], np.arange(5, 40)).any()


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_reference_engine_gaussian(metric):
    """On Gaussian data the port's reference engine equals its batched
    engine at W = 1 exactly (one CPU product for both), and JAX's reference
    in ids and hop counts with scores inside the tolerance."""
    js, Q = _beam_parity_index(metric, gaussian=True, seed=1)
    sp = _sp()
    ts = torch_state(js)
    for raw in (False, True):
        jfn = (jsearch.search_batch_reference_raw if raw
               else jsearch.search_batch_reference)
        want = jfn(js, jnp.asarray(Q), jax.random.PRNGKey(42), sp)
        tfn = (tsearch.search_batch_reference_raw if raw
               else tsearch.search_batch_reference)
        got = tfn(ts, Q, prng.prng_key(42), torch_params(sp))
        batched = (tsearch.search_batch_raw if raw else tsearch.search_batch)(
            ts, Q, prng.prng_key(42), torch_params(sp))
        for name in ("ids", "scores", "n_expanded"):
            assert torch.equal(getattr(got, name), getattr(batched, name))
        w, g = np.asarray(want.scores), got.scores.numpy()
        assert ((g == -np.inf) == (w == -np.inf)).all()
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)],
                                   rtol=1e-4, atol=1e-3)
        assert (got.ids.numpy() == np.asarray(want.ids)).all()
        assert (got.n_expanded.numpy() == np.asarray(want.n_expanded)).all()


def test_search_one_views():
    """The B = 1 views: ``search_one``/``search_one_raw`` of the batched
    engine and ``search_one_reference``/``_raw``, against JAX, from
    hand-picked starts (one of them a tombstone)."""
    js, Q = _beam_parity_index("l2", gaussian=False)
    ts = torch_state(js)
    sp, tsp = _sp(), torch_params(_sp())
    starts = np.array([3, 17], np.int32)
    for name in ("search_one", "search_one_raw", "search_one_reference",
                 "search_one_reference_raw"):
        want = getattr(jsearch, name)(js, jnp.asarray(Q[0]),
                                      jnp.asarray(starts), sp)
        got = getattr(tsearch, name)(ts, torch.from_numpy(Q[0]),
                                     torch.from_numpy(starts), tsp)
        assert (got.ids.numpy() == np.asarray(want.ids)).all(), name
        assert (got.scores.numpy() == np.asarray(want.scores)).all(), name
        assert int(got.n_expanded) == int(want.n_expanded), name


# ---------------------------------------------------------------------------
# sequential insert and delete
# ---------------------------------------------------------------------------

INSERT_CASES = {  # name → (capacity, d_in, rows, bidirectional)
    "holes": (72, None, 12, True),
    "in_degree_pressure": (72, 4, 12, True),   # shrinks and refusals
    "full": (44, None, 12, True),              # more rows than free slots
    "forward_only": (72, None, 8, False),
}


@pytest.mark.parametrize("case", list(INSERT_CASES))
def test_insert_batch_reference_byte_equal(case):
    """Slots (the allocator order), adj, radj, alive, present, size, stamps,
    touch, codes and vectors equal JAX's sequential insert."""
    cap, d_in, rows, bidir = INSERT_CASES[case]
    rng = np.random.default_rng(3)
    js, p = _built(rng, 44, cap, 6, d_out=4, d_in=d_in, holes=5, k_nn=8)
    p = IndexParams(capacity=p.capacity, dim=p.dim, d_out=p.d_out,
                    d_in=p.d_in, search=p.search, bidirectional_insert=bidir)
    V = int_vectors(rng, rows, 6)
    valid = np.ones(rows, bool)
    valid[2] = False
    js2, jids = jinsert.insert_batch_reference(
        js, jnp.asarray(V), jnp.asarray(valid), jax.random.PRNGKey(4), p)
    ts, tids = tinsert.insert_batch_reference(
        torch_state(js), V, valid, prng.prng_key(4), torch_params(p))
    assert (tids.numpy() == np.asarray(jids)).all()
    assert state_diff(js2, ts, UPDATE_FIELDS) == []
    if case == "full":
        assert (tids.numpy() == -1).sum() > 1
    assert check_health(ts) == []


@pytest.mark.parametrize("strategy", ["local", "global", "rwalk"])
def test_delete_reference_under_pressure(strategy):
    """A tight in-degree bound: the sequential applier refuses where the
    batched one truncates by rank. The reference stays byte-equal to JAX's
    reference, and both port paths stay healthy inside the degree bounds."""
    js, p = _built(np.random.default_rng(5), 90, 104, 6, d_out=5, d_in=5,
                   k_nn=10)
    ids = np.random.default_rng(6).choice(90, 24, replace=False).astype(
        np.int32)
    valid = np.ones(24, bool)
    key = jax.random.PRNGKey(9)
    name = strategy + "_reference"
    want = jdelete.delete_batch(_copy(js), jnp.asarray(ids),
                                jnp.asarray(valid), key, name, p)
    got = tdelete.delete_batch(torch_state(js), ids, valid, prng.prng_key(9),
                               name, torch_params(p))
    assert state_diff(want, got, UPDATE_FIELDS) == []
    batched = tdelete.delete_batch(torch_state(js), ids, valid,
                                   prng.prng_key(9), strategy, torch_params(p))
    for st in (got, batched):
        assert check_health(st) == []
        assert int((st.radj != -1).sum(1).max()) <= p.eff_d_in
    assert state_diff(want, batched, ("alive", "present", "size", "stamps")
                      ) == []


def _row_sets(t):
    return [frozenset(v for v in row if v != -1) for row in t.tolist()]


@pytest.mark.parametrize("strategy", ["local", "global", "rwalk"])
def test_delete_reference_equals_batched_at_b1(strategy):
    """B = 1 with in-degree headroom (tests/test_update_parity.py): the
    port's reference and batched appliers give the same edge set in every
    row and the same alive, present, size, stamps, codes and scales."""
    js, p = _built(np.random.default_rng(7), 40, 64, 8, d_out=6, d_in=64,
                   k_nn=10)
    tp = torch_params(p)
    for victim in (3, 17, 31):
        key = prng.prng_key(100 + victim)
        ids, valid = np.array([victim], np.int32), np.array([True])
        ref = tdelete.delete_batch(torch_state(js), ids, valid, key,
                                   strategy + "_reference", tp)
        new = tdelete.delete_batch(torch_state(js), ids, valid, key,
                                   strategy, tp)
        assert _row_sets(ref.adj) == _row_sets(new.adj)
        assert _row_sets(ref.radj) == _row_sets(new.radj)
        for f in ("alive", "present", "size", "stamps", "codes", "scales"):
            assert torch.equal(getattr(ref, f), getattr(new, f)), f


# ---------------------------------------------------------------------------
# consolidate_reference
# ---------------------------------------------------------------------------

def _masked_pair(seed=8, n=90, n_del=25):
    """The same MASK index built by each package (integer rows)."""
    rng = np.random.default_rng(seed)
    X = int_vectors(rng, n, 8)
    p = _params(144, 8)
    j, t = JIndex(p, strategy="mask", seed=0), TIndex(
        torch_params(p), strategy="mask", seed=0, device="cpu")
    dels = rng.choice(n, size=n_del, replace=False)
    for idx in (j, t):
        idx.insert(X)
        idx.delete(dels)
    return j, t


@pytest.mark.parametrize("strategy", ["global", "local"])
def test_consolidate_reference_byte_equal(strategy):
    j, t = _masked_pair()
    assert jconsolidate.consolidate_reference(j, strategy=strategy) == 25
    assert tconsolidate.consolidate_reference(t, strategy=strategy) == 25
    assert t.strategy == "mask"
    assert state_diff(j.state, t.state) == []
    assert tconsolidate.masked_fraction(t.state) == 0.0
    assert check_health(t.state) == []
    assert tconsolidate.consolidate_reference(t) == 0


def test_consolidate_reference_rolls_back():
    """A repair that raises midway leaves the state and strategy as they
    were: the snapshot owns its memory although the delete path works in
    place. The index then consolidates normally."""
    _, t = _masked_pair()
    before = {f: getattr(t.state, f).clone() for f in INT_FIELDS}
    real_delete = t.session.delete

    def half_then_boom(ids, **kw):
        real_delete(ids[: len(ids) // 2], **kw)      # mutates in place
        t.session.flush()
        raise RuntimeError("injected repair failure")

    t.session.delete = half_then_boom
    with pytest.raises(RuntimeError, match="injected"):
        tconsolidate.consolidate_reference(t, strategy="global")
    t.session.delete = real_delete
    assert t.strategy == "mask"
    for f, v in before.items():
        assert torch.equal(getattr(t.state, f), v), f
    assert check_health(t.state) == []
    assert tconsolidate.consolidate(t, strategy="global") == 25
    assert tconsolidate.masked_fraction(t.state) == 0.0
