"""The port's beam engine and bulk build against ``repro.core`` on the CPU.

An index built by the JAX ``bulk_knn_build`` is carried across; both
engines then walk it from the same starts. On integer-valued data ids,
scores and hop counts must be equal; on Gaussian data (the shapes of
tests/test_beam_parity.py) scores must agree within rtol 1e-4 / atol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexParams, SearchParams
from repro.core import distances as jdist
from repro.core import rebuild as jrebuild
from repro.core import search as jsearch
from repro_torch.core import distances as tdist
from repro_torch.core import prng
from repro_torch.core.quantize import quantize_rows as tquantize
from repro_torch.core import rebuild as trebuild
from repro_torch.core import search as tsearch
from torch_parity import int_vectors, state_diff, torch_params, torch_state

MODES = {  # name → (quantized, rerank_depth, raw)
    "fp32": (False, 0, False),
    "q8_rerank": (True, 8, False),
    "raw": (False, 0, True),
}


def _build(X, metric="l2", d_out=6, capacity=None, valid=None, k_nn=16):
    n, d = X.shape
    p = IndexParams(capacity=capacity or n + 40, dim=d, d_out=d_out,
                    metric=metric,
                    search=SearchParams(pool_size=16, max_steps=48, num_starts=2))
    valid = np.ones(n, bool) if valid is None else valid
    return jrebuild.bulk_knn_build(jnp.asarray(X), jnp.asarray(valid), p,
                                   k_nn=k_nn), p


@pytest.fixture(scope="module")
def int_index():
    rng = np.random.default_rng(0)
    X = int_vectors(rng, 260, 12)
    valid = np.ones(260, bool)
    valid[::17] = False                       # never-present holes
    js, p = _build(X, capacity=320, valid=valid)
    # MASK tombstones: traversable, never reported
    alive = np.asarray(js.alive).copy()
    alive[5:40] = False
    js = js.__class__(**{**{f: getattr(js, f) for f in (
        "vectors", "sqnorms", "codes", "scales", "adj", "radj", "present",
        "size", "stamps", "clock", "touch", "tclock")},
        "alive": jnp.asarray(alive), "capacity": js.capacity, "dim": js.dim,
        "d_out": js.d_out, "d_in": js.d_in, "metric": js.metric})
    Q = int_vectors(rng, 24, 12)
    return js, p, Q


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_beam_search_integer_data_equal(int_index, W, mode):
    js, p, Q = int_index
    quantized, rr, raw = MODES[mode]
    sp = SearchParams(pool_size=16, max_steps=48, num_starts=2, beam_width=W,
                      quantized=quantized, rerank_depth=rr)
    starts = jsearch.batch_entry_points(js, jax.random.PRNGKey(W), 24, 2)
    want = jax.jit(lambda s, q, st: jsearch.beam_search(s, q, st, sp, raw=raw))(
        js, jnp.asarray(Q), starts)
    got = tsearch.beam_search(torch_state(js), torch.from_numpy(Q),
                              torch.from_numpy(np.array(starts)),
                              torch_params(sp), raw=raw)
    assert (got.ids.numpy() == np.asarray(want.ids)).all()
    assert (got.scores.numpy() == np.asarray(want.scores)).all()
    assert (got.n_expanded.numpy() == np.asarray(want.n_expanded)).all()


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_search_batch_gaussian_beam_parity_shapes(metric):
    """tests/test_beam_parity.py shapes (n=260, dim=12, d_out=6, pool 16,
    capacity 320), Gaussian data, entry points drawn by each package."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(260, 12)).astype(np.float32)
    if metric == "ip":
        X *= rng.uniform(0.5, 2.0, size=(260, 1)).astype(np.float32)
    js, p = _build(X, metric=metric, capacity=320)
    Q = rng.normal(size=(24, 12)).astype(np.float32)
    for W in (1, 4):
        sp = SearchParams(pool_size=16, max_steps=48, num_starts=2, beam_width=W)
        want = jsearch.search_batch(js, jnp.asarray(Q), jax.random.PRNGKey(42), sp)
        got = tsearch.search_batch(torch_state(js), Q, prng.prng_key(42),
                                   torch_params(sp))
        w = np.asarray(want.scores)
        g = got.scores.numpy()
        assert ((g == -np.inf) == (w == -np.inf)).all()
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)],
                                   rtol=1e-4, atol=1e-3)
        assert (got.ids.numpy() == np.asarray(want.ids)).all()
        assert (got.n_expanded.numpy() == np.asarray(want.n_expanded)).all()


def test_quantized_walk_gaussian_with_rerank():
    """Quantized walk + exact rerank on Gaussian data: scores within the
    tolerance, ids equal except swaps of entries whose JAX scores lie
    within that tolerance of each other (XLA may round the q8 epilogue
    differently, which can reorder near-equal candidates)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(260, 12)).astype(np.float32)
    js, p = _build(X, capacity=320)
    Q = rng.normal(size=(24, 12)).astype(np.float32)
    sp = SearchParams(pool_size=16, max_steps=48, num_starts=2, quantized=True,
                      rerank_depth=16)
    want = jsearch.search_batch(js, jnp.asarray(Q), jax.random.PRNGKey(3), sp)
    got = tsearch.search_batch(torch_state(js), Q, prng.prng_key(3),
                               torch_params(sp))
    w, g = np.asarray(want.scores), got.scores.numpy()
    np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)],
                               rtol=1e-4, atol=1e-3)
    wi, gi = np.asarray(want.ids), got.ids.numpy()
    for r, c in zip(*np.nonzero(wi != gi)):
        j = np.flatnonzero(wi[r] == gi[r, c])
        assert j.size and abs(w[r, j[0]] - w[r, c]) <= 1e-3 + 1e-4 * abs(w[r, c])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bulk_knn_build_byte_equal(metric):
    """The row-blocked score_topk kNN (k_nn+1, self dropped) gives the JAX
    build's graph byte for byte: adj, radj, stamps, touch and the rest."""
    rng = np.random.default_rng(4)
    X = int_vectors(rng, 150, 8)
    X[10] = X[11] = X[12]                     # exact duplicates: ties at self
    valid = rng.random(150) > 0.1
    js, p = _build(X, metric=metric, d_out=5, capacity=200, valid=valid,
                   k_nn=10)
    ts = trebuild.bulk_knn_build(X, valid, torch_params(p), k_nn=10,
                                 device="cpu")
    assert state_diff(js, ts) == []


def test_bulk_knn_build_in_degree_pressure(monkeypatch):
    """Hubs overflow d_in: the first d_in in-edges per target survive, the
    rest drop from adj too; small row blocks exercise the blocking."""
    monkeypatch.setattr(trebuild, "KNN_ROW_BLOCK", 7)
    monkeypatch.setattr(trebuild, "SELECT_ROW_BLOCK", 5)
    rng = np.random.default_rng(5)
    X = int_vectors(rng, 90, 4) // 2
    p = IndexParams(capacity=96, dim=4, d_out=6, d_in=3,
                    search=SearchParams(pool_size=8, num_starts=2))
    js = jrebuild.bulk_knn_build(jnp.asarray(X), jnp.ones(90, bool), p, k_nn=12)
    ts = trebuild.bulk_knn_build(X, np.ones(90, bool), torch_params(p),
                                 k_nn=12, device="cpu")
    assert state_diff(js, ts) == []


def test_bulk_knn_build_cos_keeps_code_invariant():
    """cos normalises the rows, so the data stop being integer-valued and
    norms and neighbour order may round differently. The integer state
    matches exactly. ``vectors`` and ``scales`` are held within 4 ulp, not
    bit for bit: XLA's CPU code for ``x / sqrt(sum x^2)`` depends on the
    host CPU, and JAX's eager ``normalize`` and its jitted build already
    differ from each other in the last bits (2 ulp measured between the
    packages). The port's codes equal ``quantize_rows(vectors)`` exactly
    (invariant I5). The JAX build's do not always: inside its jitted
    program XLA fuses the normalisation with the quantizer's division and
    rounds some ``x / scale`` near .5 the other way."""
    rng = np.random.default_rng(4)
    X = int_vectors(rng, 150, 8)
    valid = rng.random(150) > 0.1
    js, p = _build(X, metric="cos", d_out=5, capacity=200, valid=valid,
                   k_nn=10)
    ts = trebuild.bulk_knn_build(X, valid, torch_params(p), k_nn=10,
                                 device="cpu")
    assert state_diff(js, ts, ("alive", "present", "stamps", "touch", "size",
                               "clock")) == []
    for f in ("vectors", "scales"):
        np.testing.assert_array_max_ulp(getattr(ts, f).numpy(),
                                        np.asarray(getattr(js, f)), maxulp=4)
    codes, scales = tquantize(ts.vectors)
    present = ts.present
    assert torch.equal(ts.codes, codes)
    assert torch.equal(ts.scales[present], scales[present])  # free: scrubbed 0
    same_rows = (ts.adj.numpy() == np.asarray(js.adj)).all(1)[:150][valid]
    assert same_rows.mean() > 0.9


def test_distances_match():
    rng = np.random.default_rng(6)
    x = int_vectors(rng, 30, 8)
    q = int_vectors(rng, 5, 8)
    xsq = (x * x).sum(1)
    tx, tq, tsq = torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(xsq)
    assert (tdist.sqnorm(tx).numpy() == np.asarray(jdist.sqnorm(jnp.asarray(x)))).all()
    # XLA's CPU division by the root depends on the host: 4 ulp, as in the
    # cos bulk build above
    np.testing.assert_array_max_ulp(tdist.normalize(tx).numpy(),
                                    np.asarray(jdist.normalize(jnp.asarray(x))),
                                    maxulp=4)
    for metric in ("l2", "ip", "cos"):
        want = jdist.score_matrix(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(q),
                                  metric)
        got = tdist.score_matrix(tx, tsq, tq, metric)
        assert (got.numpy() == np.asarray(want)).all()
        assert (tdist.pair_score(tx[:5], tq, metric).numpy() == np.asarray(
            jdist.pair_score(jnp.asarray(x[:5]), jnp.asarray(q), metric))).all()
        assert (tdist.scores_vs_rows(tx, tsq, tq[0], metric).numpy() == np.asarray(
            jdist.scores_vs_rows(jnp.asarray(x), jnp.asarray(xsq),
                                 jnp.asarray(q[0]), metric))).all()
    qsq = torch.from_numpy((q * q).sum(1))
    assert (tdist.true_l2(got[:, 0], qsq).numpy() == np.asarray(
        jdist.true_l2(jnp.asarray(got[:, 0].numpy()), jnp.asarray(qsq.numpy())))).all()
