"""The port's threefry generator against ``jax.random`` (bit-exact), and the
entry points it drives against ``repro.core.search`` on a JAX-built graph."""
import os
import subprocess
import sys
import types

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
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
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


def _gumbel_mismatch_report(tk, n, got, want, bad) -> str:
    """Names the worst draws: index, u, the inner log(u), the outer
    log(-log(u)) as the port computes them, the port's and JAX's values and
    a float64 value from the same u; and the worker's thread count."""
    u = prng.uniform(tk, n, float(np.finfo(np.float32).tiny), 1.0)
    inner = torch.log(u)
    outer = torch.log(-inner)
    ref64 = -np.log(-np.log(u.numpy().astype(np.float64)))
    err = np.abs(got - want)
    worst = np.argsort(-err)[:5]
    lines = [f"{int(bad.sum())} of {n} draws beyond the bound; "
             f"torch.get_num_threads()={torch.get_num_threads()} "
             f"worker={os.environ.get('PYTEST_XDIST_WORKER', 'main')}"]
    for i in worst:
        lines.append(
            f"i={i} u={u[i].item()!r} log(u)={inner[i].item()!r} "
            f"log(-log(u))={outer[i].item()!r} port={float(got[i])!r} "
            f"jax={float(want[i])!r} float64={float(ref64[i])!r}")
    return "\n".join(lines)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_draws(seed):
    """Gumbel draws agree to float32 rounding (XLA's and torch's float32
    logs differ in the last bits), and their ranking — all that entry
    points use — is the ranking of the bit-exact uniform mantissa."""
    n = 20000
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    g = np.asarray(jax.random.gumbel(jk, (n,)))
    got = prng.gumbel(tk, n).numpy()
    # np.testing.assert_allclose's rule, with a report of the worst draws
    bad = ~(np.abs(got - g) <= 2e-6 + 2e-6 * np.abs(g))
    assert not bad.any(), _gumbel_mismatch_report(tk, n, got, g, bad)
    _, want = jax.lax.top_k(jnp.asarray(g), 16)
    m = prng.uniform_mantissa(tk, n)
    comp = (m.long() << 32) | (0xFFFFFFFF - torch.arange(n))
    got = torch.topk(comp, 16).indices
    assert (got.numpy() == np.asarray(want)).all()


_VML_PROBE = """
import ctypes, os, sys
import torch
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
before = lib.vmlGetMode()
import repro_torch
print(before, lib.vmlGetMode())
"""


@pytest.mark.skipif(not torch.backends.mkl.is_available(),
                    reason="torch without MKL computes log with no VML")
def test_import_settles_the_mkl_vml_dispatch():
    """Importing the port makes the process's first MKL VML call on the
    importing thread (``repro_torch/__init__.py``), so that no op split over
    intra-op threads makes it: VML's lazy CPU-type detection would let a
    second thread dispatch on a half-written type (the ``test_gumbel_draws``
    flake). A thread's VML mode gains the FTZ/DAZ-off bits that torch passes
    at its first VML call."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", _VML_PROBE], env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    before, after = map(int, out.stdout.split())
    ftzdaz_off = 0x140000
    assert not before & ftzdaz_off, "a VML call ran before the port's import"
    assert after & ftzdaz_off, "importing the port made no VML call"


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


# (L, capacity, starts, offset, share of lanes active, share of slots present, fold)
ENTRY_DRAW_CASES = {
    "inactive_lanes": (40, 300, 2, 64, 0.6, 0.9, True),
    "fewer_present_than_starts": (6, 16, 4, 0, 1.0, 0.15, True),
    "capacity_off_the_tile": (9, 1000, 3, 2**31 - 4, 1.0, 0.8, True),
    "one_lane": (1, 777, 2, 1000, 1.0, 0.5, True),
    "fold_off": (3, 500, 2, 0, 1.0, 0.7, False),
}


@pytest.mark.parametrize("case", sorted(ENTRY_DRAW_CASES))
def test_entry_draw_cpu_route_equals_rank_starts_and_jax(case, monkeypatch):
    """``kernels.ops.entry_draw`` on the CPU (the plain version, in lane
    groups of three here) equals the whole ``_rank_starts`` expression on
    every lane key and JAX's ``batch_entry_points`` (``entry_points`` when
    the key is not folded), with NULL rows for inactive lanes."""
    L, cap, S, offset, p_active, p_present, fold = ENTRY_DRAW_CASES[case]
    rng = np.random.default_rng(cap + S)
    present = rng.random(cap) < p_present
    present[rng.integers(cap)] = True
    active = rng.random(L) < p_active
    active[-1] = True
    seed = 2**31 - 1 - cap
    monkeypatch.setattr(kref, "ENTRY_ELEMS", 3 * cap)
    got = kops.entry_draw(torch.from_numpy(present), prng.prng_key(seed), L, S,
                          offset=offset, active=torch.from_numpy(active), fold=fold).numpy()
    tk = prng.prng_key(seed)
    keys = (prng.fold_in(tk, torch.arange(L) + offset) if fold else tk.expand(L, 2))
    whole = kref._rank_starts(torch.from_numpy(present), keys, S).numpy()
    jstate = types.SimpleNamespace(present=jnp.asarray(present), capacity=cap)
    jk = jax.random.PRNGKey(seed)
    if fold:
        jax_rows = np.asarray(jsearch.batch_entry_points(jstate, jk, L, S, offset=offset))
    else:
        jax_rows = np.repeat(np.asarray(jsearch.entry_points(jstate, jk, S))[None], L, 0)
    assert (whole == jax_rows).all()
    assert (got[active] == jax_rows[active]).all()
    assert (got[~active] == -1).all()
    if case == "fewer_present_than_starts":
        assert (got[:, int(present.sum()):] == -1).all()
