"""Update paths against ``repro.core`` on integer-valued data, byte for
byte: batched insert at B=1 and B=64, all eight delete strategies, the bulk
edge primitives, and the tie-order helpers that stand in for
``lax.top_k`` and ``.at[].set(mode="drop")`` / ``.min`` / ``.max``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexParams, SearchParams
from repro.core import delete as jdelete
from repro.core import graph as jgraph
from repro.core import insert as jinsert
from repro.core import rebuild as jrebuild
from repro_torch.core import delete as tdelete
from repro_torch.core import graph as tgraph
from repro_torch.core import insert as tinsert
from repro_torch.core import prng, stable
from torch_parity import INT_FIELDS, int_vectors, state_diff, torch_params, torch_state

UPDATE_FIELDS = INT_FIELDS + ("vectors", "sqnorms")


def _params(cap, d, d_out=6, d_in=None):
    return IndexParams(capacity=cap, dim=d, d_out=d_out, d_in=d_in,
                       search=SearchParams(pool_size=16, max_steps=48,
                                           num_starts=2))


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(0)
    X = int_vectors(rng, 200, 10)
    valid = np.ones(200, bool)
    valid[::9] = False                  # free slots inside the used range
    p = _params(300, 10)
    js = jrebuild.bulk_knn_build(jnp.asarray(X), jnp.asarray(valid), p, k_nn=12)
    return js, p, rng


@pytest.mark.parametrize("B", [1, 64])
def test_insert_batch_impl_byte_equal(base, B):
    js, p, rng = base
    V = int_vectors(np.random.default_rng(B), B, 10)
    valid = np.ones(B, bool)
    if B > 1:
        valid[[3, 17]] = False          # padded lanes
    key = jax.random.PRNGKey(B)
    run = jax.jit(lambda s, v, m, k: jinsert.insert_batch_impl(
        s, v, m, k, p, key_offset=5))
    js2, jslots = run(js, jnp.asarray(V), jnp.asarray(valid), key)
    ts, tslots = tinsert.insert_batch_impl(
        torch_state(js), torch.from_numpy(V), torch.from_numpy(valid),
        prng.prng_key(B), torch_params(p), key_offset=5)
    assert (tslots.numpy() == np.asarray(jslots)).all()
    assert state_diff(js2, ts, UPDATE_FIELDS) == []


def test_insert_refuses_when_full():
    """More rows than free slots: the lowest free slots fill in lane order,
    the rest come back NULL — as in JAX."""
    rng = np.random.default_rng(1)
    p = _params(40, 6, d_out=4)
    X = int_vectors(rng, 36, 6)
    js = jrebuild.bulk_knn_build(jnp.asarray(X), jnp.ones(36, bool), p, k_nn=8)
    V = int_vectors(rng, 8, 6)
    key = jax.random.PRNGKey(2)
    js2, jslots = jax.jit(lambda s, v, m, k: jinsert.insert_batch_impl(
        s, v, m, k, p))(js, jnp.asarray(V), jnp.ones(8, bool), key)
    ts, tslots = tinsert.insert_batch_impl(
        torch_state(js), torch.from_numpy(V), torch.ones(8, dtype=torch.bool),
        prng.prng_key(2), torch_params(p))
    assert (tslots.numpy() == np.asarray(jslots)).all()
    assert (tslots.numpy()[4:] == -1).all()
    assert state_diff(js2, ts, UPDATE_FIELDS) == []


def _delete_byte_equal(base, strategy):
    js, p, _ = base
    rng = np.random.default_rng(7)
    ids = rng.choice(np.flatnonzero(np.asarray(js.alive)), 20,
                     replace=False).astype(np.int32)
    ids = np.concatenate([ids, [ids[0], ids[1], -1, 9]]).astype(np.int32)
    valid = np.ones(ids.shape[0], bool)
    valid[2] = False                    # a padded lane
    key = jax.random.PRNGKey(3)
    js2 = jdelete.delete_batch(jax.tree.map(jnp.copy, js), jnp.asarray(ids),
                               jnp.asarray(valid), key, strategy, p)
    ts = tdelete.delete_batch(torch_state(js), ids, valid, prng.prng_key(3),
                              strategy, torch_params(p))
    assert state_diff(js2, ts, UPDATE_FIELDS) == []


@pytest.mark.parametrize("strategy", ["pure", "mask", "local", "global", "rwalk"])
def test_delete_byte_equal(base, strategy):
    """Duplicate, NULL and padded lanes in one batch."""
    _delete_byte_equal(base, strategy)


@pytest.mark.parametrize("strategy", ["local_reference", "global_reference",
                                      "rwalk_reference"])
def test_unported_strategies_raise(base, strategy):
    """Every delete strategy is ported: each sequential reference applier
    leaves the state byte-equal to JAX's on the same batch."""
    _delete_byte_equal(base, strategy)


def test_set_out_edges_batch_under_in_degree_pressure():
    """Many rows rewritten towards the same hubs: removals, hole filling in
    group-rank order and refusals past the holes match JAX exactly."""
    rng = np.random.default_rng(4)
    p = _params(64, 4, d_out=5, d_in=3)
    X = int_vectors(rng, 60, 4)
    js = jrebuild.bulk_knn_build(jnp.asarray(X), jnp.ones(60, bool), p, k_nn=8)
    us = np.array([3, 8, 9, 20, 21, 22, 40, -1, 50, 51], np.int32)
    hubs = np.array([1, 2, 5, 6, 7], np.int32)
    targets = np.stack([rng.permutation(np.concatenate([hubs, [u, 61]]))[:5]
                        for u in us]).astype(np.int32)
    targets[0, :2] = targets[0, 0]      # in-row duplicate
    valid = np.ones(len(us), bool)
    valid[-1] = False
    js2 = jax.jit(jgraph.set_out_edges_batch)(
        js, jnp.asarray(us), jnp.asarray(targets), jnp.asarray(valid))
    ts = tgraph.set_out_edges_batch(torch_state(js), torch.from_numpy(us),
                                    torch.from_numpy(targets),
                                    torch.from_numpy(valid))
    assert state_diff(js2, ts, ("adj", "radj", "touch", "tclock")) == []


def test_graph_primitives_match():
    rng = np.random.default_rng(5)
    rows = rng.integers(-1, 6, (30, 7)).astype(np.int32)
    assert (tgraph.pack_rows(torch.from_numpy(rows)).numpy()
            == np.asarray(jgraph.pack_rows(jnp.asarray(rows)))).all()
    src = rng.integers(0, 50, 80).astype(np.int32)
    dst = rng.integers(-1, 12, 80).astype(np.int32)
    jr, jt = jgraph.group_by_destination(jnp.asarray(src), jnp.asarray(dst),
                                         jnp.asarray(dst >= 0), 16, 4)
    tr, tt = tgraph.group_by_destination(torch.from_numpy(src),
                                         torch.from_numpy(dst),
                                         torch.from_numpy(dst >= 0), 16, 4)
    assert (tr.numpy() == np.asarray(jr)).all()
    assert (tt.numpy() == np.asarray(jt)).all()


def test_scrub_edges_to_matches(base):
    js, _, _ = base
    dead = np.zeros(js.capacity, bool)
    dead[[4, 10, 11, 57]] = True
    js2 = jgraph.scrub_edges_to(js, jnp.asarray(dead))
    ts = tgraph.scrub_edges_to(torch_state(js), torch.from_numpy(dead))
    assert state_diff(js2, ts, ("adj", "radj")) == []


# ---------------------------------------------------------------------------
# tie-order regressions: the helpers that stand in for JAX primitives
# ---------------------------------------------------------------------------

TIE_FLOATS = np.array([0.0, -0.0, 1.0, 1.0, -np.inf, 0.0, -np.inf, -0.0,
                       2.5, 1.0, -1.0, 2.5], np.float32)


@pytest.mark.parametrize("k", [1, 3, 7, 12])
def test_top_k_matches_lax_on_ties(k):
    """Ties go to the lower index, and +0.0 ranks above -0.0 (the IEEE
    total order lax.top_k uses)."""
    rng = np.random.default_rng(k)
    x = np.stack([TIE_FLOATS, rng.permutation(TIE_FLOATS),
                  rng.integers(-2, 3, 12).astype(np.float32)])
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = stable.top_k(torch.from_numpy(x), k)
    assert (gi.numpy() == np.asarray(wi)).all()
    assert (gv.numpy().view(np.int32) == np.asarray(wv).view(np.int32)).all()
    ints = rng.integers(0, 2, (4, 40)).astype(np.int32)
    _, wi = jax.lax.top_k(jnp.asarray(ints), k)
    _, gi = stable.top_k(torch.from_numpy(ints), k)
    assert (gi.numpy() == np.asarray(wi)).all()


def test_argmax_first_matches_jnp():
    rng = np.random.default_rng(2)
    m = rng.random((20, 9)) < 0.3
    m[0] = False
    assert (stable.argmax_first(torch.from_numpy(m), 1).numpy()
            == np.asarray(jnp.argmax(jnp.asarray(m), axis=1))).all()


def test_scatter_helpers_match_at_drop_min_max():
    rng = np.random.default_rng(3)
    n, R = 16, 40
    idx = rng.integers(0, n, R).astype(np.int32)      # many repeats
    keep = rng.random(R) < 0.6
    # set(mode="drop"): live lanes write unique slots (the callers'
    # guarantee); dropped lanes park out of bounds
    uniq = rng.permutation(n)[:10].astype(np.int32)
    keep_u = np.ones(10, bool)
    keep_u[[2, 5]] = False
    vals = rng.integers(0, 100, 10).astype(np.int32)
    want = jnp.zeros(n, jnp.int32).at[jnp.where(keep_u, uniq, n)].set(
        jnp.asarray(vals), mode="drop")
    got = stable.set_drop(torch.zeros(n, dtype=torch.int32),
                          torch.from_numpy(uniq), torch.from_numpy(vals),
                          torch.from_numpy(keep_u))
    assert (got.numpy() == np.asarray(want)).all()
    lane = np.where(keep, np.arange(R), R).astype(np.int32)
    want = jnp.full(n, R, jnp.int32).at[jnp.asarray(idx)].min(jnp.asarray(lane))
    got = stable.scatter_min_(torch.full((n,), R, dtype=torch.int32),
                              torch.from_numpy(idx), torch.from_numpy(lane))
    assert (got.numpy() == np.asarray(want)).all()
    base = rng.random(n) < 0.5
    want = jnp.asarray(base).at[jnp.asarray(idx)].max(jnp.asarray(keep))
    got = stable.scatter_max_(torch.from_numpy(base.copy()),
                              torch.from_numpy(idx), torch.from_numpy(keep))
    assert (got.numpy() == np.asarray(want)).all()
    want = jnp.asarray(base).at[jnp.asarray(idx)].min(jnp.asarray(~keep))
    got = stable.scatter_min_(torch.from_numpy(base.copy()),
                              torch.from_numpy(idx), torch.from_numpy(~keep))
    assert (got.numpy() == np.asarray(want)).all()
