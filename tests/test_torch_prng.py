"""The port's threefry generator against ``jax.random`` (bit-exact), and the
entry points it drives against ``repro.core.search`` on a JAX-built graph."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexParams, SearchParams
from repro.core import rebuild as jrebuild
from repro.core import search as jsearch
from repro_torch.core import prng
from repro_torch.core import search as tsearch
from torch_parity import int_vectors, torch_state

SEEDS = [0, 1, 42, 2**31 - 1]


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_fold_in_check_value():
    key = prng.fold_in(prng.prng_key(0), 3)
    assert key.tolist() == [2467461003, 3840466878]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_and_fold_in_chains(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert (_kd(jk) == tk.numpy()).all()
    for data in [0, 3, 7, 2**31 - 1, 0x7FFFFFFD, 123456789]:
        jk = jax.random.fold_in(jk, data)
        tk = prng.fold_in(tk, data)
        assert (_kd(jk) == tk.numpy()).all(), data
    # vectorised folds: one key per lane, as batch_entry_points uses them
    lanes = np.arange(37) + 1000
    want = np.stack([_kd(jax.random.fold_in(jk, int(i))) for i in lanes])
    assert (prng.fold_in(tk, torch.as_tensor(lanes)).numpy() == want).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 1001, 4096])
def test_random_bits_and_uniform(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    bits = np.asarray(jax.random.bits(jk, (n,))).astype(np.int64)
    assert (prng.random_bits(tk, n).numpy() == bits).all()
    u = np.asarray(jax.random.uniform(jk, (n,)))
    assert (prng.uniform(tk, n).numpy() == u).all()
    tiny = float(np.finfo(np.float32).tiny)
    u2 = np.asarray(jax.random.uniform(jk, (n,), minval=tiny, maxval=1.0))
    assert (prng.uniform(tk, n, tiny, 1.0).numpy() == u2).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_draws(seed):
    """Gumbel draws agree to float32 rounding (XLA's and torch's float32
    logs differ in the last bits), and their ranking — all that entry
    points use — is the ranking of the bit-exact uniform mantissa."""
    n = 20000
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    g = np.asarray(jax.random.gumbel(jk, (n,)))
    np.testing.assert_allclose(prng.gumbel(tk, n).numpy(), g, rtol=2e-6,
                               atol=2e-6)
    _, want = jax.lax.top_k(jnp.asarray(g), 16)
    m = prng.uniform_mantissa(tk, n)
    comp = (m.long() << 32) | (0xFFFFFFFF - torch.arange(n))
    got = torch.topk(comp, 16).indices
    assert (got.numpy() == np.asarray(want)).all()


@pytest.fixture(scope="module")
def jax_graph():
    rng = np.random.default_rng(3)
    n, cap = 150, 200
    X = int_vectors(rng, n, 8)
    valid = rng.random(n) > 0.2          # holes: some slots never present
    p = IndexParams(capacity=cap, dim=8, d_out=4,
                    search=SearchParams(pool_size=8, num_starts=2))
    return jrebuild.bulk_knn_build(jnp.asarray(X), jnp.asarray(valid), p,
                                   k_nn=8)


@pytest.mark.parametrize("seed,offset,starts", [(0, 0, 2), (5, 64, 3),
                                                (9, 1000, 1)])
def test_batch_entry_points_equal(jax_graph, seed, offset, starts):
    jk = jax.random.PRNGKey(seed)
    want = jsearch.batch_entry_points(jax_graph, jk, 40, starts, offset=offset)
    got = tsearch.batch_entry_points(torch_state(jax_graph), prng.prng_key(seed),
                                     40, starts, offset=offset)
    assert (got.numpy() == np.asarray(want)).all()


def test_entry_points_fewer_present_than_starts():
    """With fewer present slots than starts the extra picks are NULL."""
    p = IndexParams(capacity=16, dim=4, d_out=2,
                    search=SearchParams(pool_size=8, num_starts=4))
    X = np.ones((2, 4), np.float32)
    js = jrebuild.bulk_knn_build(jnp.asarray(X), jnp.ones(2, bool), p, k_nn=2)
    jk = jax.random.PRNGKey(11)
    want = jsearch.entry_points(js, jk, 4)
    got = tsearch.entry_points(torch_state(js), prng.prng_key(11), 4)
    assert (got.numpy() == np.asarray(want)).all()
    assert (got.numpy()[2:] == -1).all()
