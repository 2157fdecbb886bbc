"""int8 compression (``repro_torch.distributed.compression``): the tests of
``tests/test_compression.py`` on the port, and ``quantize_int8`` bit-equal
to JAX's for the same key. ``compressed_psum`` over a stacked member axis
is held against JAX's 8-device ``shard_map`` in ``test_torch_distributed.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.core import prng
from repro_torch.distributed.compression import (
    compressed_psum,
    dequantize,
    dequantize_rows,
    quantize_int8,
    quantize_rows,
    wire_bytes_saved,
)


@pytest.mark.parametrize("seed,shape", [(0, (1000,)), (5, (32, 8)),
                                        (9, (3, 5, 7)), (2, (1,))])
def test_quantize_int8_bit_equal_to_jax(seed, shape):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x), jax.random.PRNGKey(seed))
    tq, ts = quantize_int8(torch.from_numpy(x), prng.prng_key(seed))
    assert tq.dtype == torch.int8 and tq.shape == shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_quantize_roundtrip_error():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,))
                         .astype(np.float32))
    q, s = quantize_int8(x, prng.prng_key(0))
    err = (dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 1.01     # ≤ one quantization bin


def test_stochastic_rounding_unbiased():
    q, s = quantize_int8(torch.full((20000,), 0.3), prng.prng_key(1))
    assert abs(float(dequantize(q, s).mean()) - 0.3) < 2e-3


def test_stochastic_rounding_unbiased_over_keys():
    """The mean over many keys of a fixed vector converges to the vector."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1.0, 1.0, size=(64,))
                         .astype(np.float32))
    n_keys = 4000
    base = prng.prng_key(7)
    acc = torch.zeros(64, dtype=torch.float64)
    for i in range(n_keys):                      # jax.random.split(base, n)[i]
        acc += dequantize(*quantize_int8(x, prng.fold_in(base, i))).double()
    mean = (acc / n_keys).numpy()
    scale = float(x.abs().max()) / 127.0
    tol = 5.0 * scale / (2.0 * np.sqrt(n_keys))  # a ~5σ band
    np.testing.assert_allclose(mean, x.numpy(), atol=tol)


@pytest.mark.parametrize("members", [1, 4])
def test_compressed_psum_vs_fp32_mean_small_trees(members):
    """The compressed mean equals the fp32 mean up to the local quantization
    error (the int32 reduction is exact), on a multi-leaf tree. With several
    members the bound holds where they share one scale (each holds the
    leaf's max-abs once): the mean scale is then every member's own."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(members, 32, 8)).astype(np.float32),
            "b": (rng.normal(size=(members, 16)) * 1e-3).astype(np.float32)}
    for leaf in tree.values():
        top = np.abs(leaf).max()
        leaf.reshape(members, -1)[:, 0] = top
    tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    comp = compressed_psum(tree, prng.prng_key(0))
    for name, leaf in tree.items():
        scale = float(leaf.abs().max()) / 127.0
        np.testing.assert_allclose(comp[name].numpy(), leaf.mean(0).numpy(),
                                   atol=1.01 * scale)


def test_compressed_psum_one_member_is_identity():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(1, 64))
                               .astype(np.float32))}
    out = compressed_psum(g, prng.prng_key(0))
    scale = float(g["w"].abs().max()) / 127.0
    np.testing.assert_allclose(out["w"].numpy(), g["w"][0].numpy(),
                               atol=1.01 * scale)


def test_compressed_psum_keeps_tree_structure():
    g = {"a": [torch.ones(2, 3), (torch.zeros(2, 4),)], "b": torch.ones(2, 1)}
    out = compressed_psum(g, prng.prng_key(1))
    assert sorted(out) == ["a", "b"] and isinstance(out["a"][1], tuple)
    assert out["a"][0].shape == (3,) and out["a"][1][0].shape == (4,)


def test_quantize_rows_roundtrip_and_determinism():
    """The deterministic row quantizer, re-exported here: error ≤ scale/2,
    no key, zero rows → (zero codes, the positive sentinel scale), stacked
    leading dims quantize identically."""
    from repro_torch.core.quantize import ZERO_ROW_SCALE

    x = np.random.default_rng(4).normal(size=(50, 24)).astype(np.float32)
    x[7] = 0.0
    xt = torch.from_numpy(x)
    c1, s1 = quantize_rows(xt)
    c2, s2 = quantize_rows(xt)
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    err = (dequantize_rows(c1, s1) - xt).abs()
    assert bool((err <= s1[:, None] * 0.5 + 1e-7).all())
    assert bool((c1[7] == 0).all())
    assert float(s1[7]) == ZERO_ROW_SCALE > 0.0
    cs, ss = quantize_rows(xt.reshape(2, 25, 24))
    assert torch.equal(cs.reshape(50, 24), c1) and torch.equal(ss.reshape(50), s1)
    jd = jcomp.dequantize_rows(*jcomp.quantize_rows(jnp.asarray(x)))
    np.testing.assert_array_equal(dequantize_rows(c1, s1).numpy(), np.asarray(jd))


def test_wire_bytes():
    g = {"a": torch.zeros(100), "b": torch.zeros(50)}
    fp32, int8 = wire_bytes_saved(g)
    assert (fp32, int8) == jcomp.wire_bytes_saved(
        {"a": jnp.zeros(100), "b": jnp.zeros(50)})
    assert fp32 == 600 and int8 < fp32 / 3


def test_scheme_name_is_jax_s():
    from repro_torch.distributed.compression import VECTOR_CODE_SCHEME
    assert VECTOR_CODE_SCHEME == jcomp.VECTOR_CODE_SCHEME
