"""The kernels' plain PyTorch versions against the JAX package's Pallas
wrappers (interpret mode on the CPU), at the sweeps of tests/test_kernels.py:
its shapes, the grown-tier table sizes {2^k, 2^k+1, 3·2^k}, the edge ids
-1, N-1 and N, and the three metrics. Scores within rtol 1e-4 / atol 1e-3
on Gaussian data with the -inf mask exact (``score_matrix``: rtol 2e-4 /
atol 2e-4·d in fp32, 2e-2 / 2e-2·d in bf16, the Pallas test's own);
byte-equal scores and identical top-k ids on integer-valued data."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core.quantize import quantize_rows as jquantize
from repro.kernels import ops as jops
from repro_torch.core import prng
from repro_torch.core.quantize import quantize_rows as tquantize
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_parity import int_vectors

SHAPES = [  # (M, B, d, k) — tests/test_kernels.py
    (300, 50, 200, 10),
    (512, 128, 128, 32),
    (1000, 17, 960, 5),
    (64, 8, 32, 4),
    (257, 33, 100, 16),
]
GROWN_TIERS = [2**5, 2**5 + 1, 3 * 2**5, 2**8 + 1]
METRICS = ["l2", "ip"]          # cos scores as ip inside every kernel


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_scores(got, want):
    g, w = got.numpy(), np.asarray(want)
    assert ((g == -np.inf) == (w == -np.inf)).all()
    m = np.isfinite(w)
    np.testing.assert_allclose(g[m], w[m], rtol=1e-4, atol=1e-3)


def _edge_ids(rng, M, B, C):
    ids = rng.integers(0, M, size=(B, C)).astype(np.int32)
    ids[0, :3] = [M - 1, M, -1]
    return ids


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("metric", METRICS)
def test_gather_scores_matches_pallas(shape, metric):
    M, B, d, _ = shape
    rng = np.random.default_rng(M + B)
    x = rng.normal(size=(M, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    xsq = (x * x).sum(1)
    ids = _edge_ids(rng, M, B, 24)
    want = jops.gather_scores(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(ids),
                              jnp.asarray(q), metric=metric)
    got = tops.gather_scores(_t(x), _t(xsq), _t(ids), _t(q), metric=metric)
    _assert_scores(got, want)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]])
@pytest.mark.parametrize("metric", METRICS)
def test_gather_scores_q8_matches_pallas(shape, metric):
    M, B, d, _ = shape
    rng = np.random.default_rng(M + B + 1)
    x = rng.normal(size=(M, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    codes, scales = jquantize(jnp.asarray(x))
    ids = _edge_ids(rng, M, B, 24)
    want = jops.gather_scores_q8(codes, scales, jnp.asarray(ids), jnp.asarray(q),
                                 metric=metric)
    got = tops.gather_scores_q8(_t(codes), _t(scales), _t(ids), _t(q),
                                metric=metric)
    _assert_scores(got, want)


@pytest.mark.parametrize("shape,metric", [(s, "l2") for s in SHAPES]
                         + [(s, "ip") for s in SHAPES[:2]])
def test_score_topk_matches_pallas(shape, metric):
    M, B, d, k = shape
    rng = np.random.default_rng(M * 7 + B)
    x = rng.normal(size=(M, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    xsq = (x * x).sum(1)
    ws, wi = jops.score_topk(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(q), k,
                             metric=metric)
    gs, gi = tops.score_topk(_t(x), _t(xsq), _t(q), k, metric=metric)
    _assert_scores(gs, ws)
    assert (gi.numpy() == np.asarray(wi)).all()


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_integer_data_byte_equal(metric):
    """Integer-valued data: every dot product is exact, so scores are
    byte-equal and the tie-heavy top-k ids identical (ties → lowest id)."""
    rng = np.random.default_rng(17)
    M, B, d, k = 300, 40, 16, 24
    x = int_vectors(rng, M, d)
    q = int_vectors(rng, B, d)
    xsq = (x * x).sum(1)
    ids = _edge_ids(rng, M, B, 20)
    want = jops.gather_scores(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(ids),
                              jnp.asarray(q), metric=metric)
    got = tops.gather_scores(_t(x), _t(xsq), _t(ids), _t(q), metric=metric)
    assert (got.numpy() == np.asarray(want)).all()
    ws, wi = jops.score_topk(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(q), k,
                             metric=metric)
    gs, gi = tops.score_topk(_t(x), _t(xsq), _t(q), k, metric=metric)
    assert (gs.numpy() == np.asarray(ws)).all()
    assert (gi.numpy() == np.asarray(wi)).all()


def test_topk_all_negative_ip_padding():
    """Padded rows must not displace negative true scores (regression)."""
    rng = np.random.default_rng(3)
    M, B, d, k = 123, 9, 64, 7
    x = -np.abs(rng.normal(size=(M, d))).astype(np.float32)
    q = np.abs(rng.normal(size=(B, d))).astype(np.float32)
    xsq = (x * x).sum(1)
    _, wi = jops.score_topk(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(q), k,
                            metric="ip")
    _, gi = tops.score_topk(_t(x), _t(xsq), _t(q), k, metric="ip")
    assert (gi.numpy() == np.asarray(wi)).all()


@pytest.mark.parametrize("M", GROWN_TIERS)
def test_capacity_tier_sweep(M):
    """Non-power-of-two table sizes: no row past M leaks into any kernel's
    output, ids M-1 / M / -1 resolve as in the Pallas wrappers."""
    d, B, k, C = 48, 13, 9, 17
    rng = np.random.default_rng(M)
    x = rng.normal(size=(M, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    xsq = (x * x).sum(1)
    ws, wi = jops.score_topk(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(q), k)
    gs, gi = tops.score_topk(_t(x), _t(xsq), _t(q), k)
    _assert_scores(gs, ws)
    assert (gi.numpy() == np.asarray(wi)).all() and (gi.numpy() < M).all()
    ids = _edge_ids(rng, M, B, C)
    want = jops.gather_scores(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(ids),
                              jnp.asarray(q))
    _assert_scores(tops.gather_scores(_t(x), _t(xsq), _t(ids), _t(q)), want)
    codes, scales = jquantize(jnp.asarray(x))
    want = jops.gather_scores_q8(codes, scales, jnp.asarray(ids), jnp.asarray(q))
    _assert_scores(tops.gather_scores_q8(_t(codes), _t(scales), _t(ids), _t(q)),
                   want)


def test_score_topk_n_valid_and_short_tables():
    """Rows >= n_valid never win; k beyond the valid rows pads (-inf, -1)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    xsq = (x * x).sum(1)
    s, i = tops.score_topk(_t(x), _t(xsq), _t(q), 12, n_valid=9)
    assert (i.numpy()[:, :9] < 9).all() and (i.numpy()[:, 9:] == -1).all()
    assert np.isneginf(s.numpy()[:, 9:]).all()
    ws, wi = jops.score_topk(jnp.asarray(x[:9]), jnp.asarray(xsq[:9]),
                             jnp.asarray(q), 9)
    assert (i.numpy()[:, :9] == np.asarray(wi)).all()
    with pytest.raises(ValueError):
        tops.score_topk(_t(x), _t(xsq), _t(q), tops.TOPK_MAX_K + 1)


def _sm_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-4


def _sm_inputs(rng, M, B, d, dtype):
    x = rng.normal(size=(M, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    jx, jq = jnp.asarray(x, dtype), jnp.asarray(q, dtype)
    xsq = jnp.sum(jx.astype(jnp.float32) ** 2, 1)
    tdt = getattr(torch, dtype)
    tx = _t(jx.astype(jnp.float32)).to(tdt)
    tq = _t(jq.astype(jnp.float32)).to(tdt)
    return (jx, xsq, jq), (tx, _t(xsq), tq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,metric", [(s, "l2") for s in SHAPES if s[0] != 64]
                         + [(SHAPES[1], "ip")])
def test_score_matrix_matches_pallas(shape, metric, dtype):
    M, B, d, _ = shape
    rng = np.random.default_rng(M + 3 * B)
    (jx, jsq, jq), (tx, tsq, tq) = _sm_inputs(rng, M, B, d, dtype)
    want = jops.score_matrix(jx, jsq, jq, metric=metric)
    got = tops.score_matrix(tx, tsq, tq, metric=metric)
    assert got.dtype == torch.float32 and got.shape == (B, M)
    tol = _sm_tol(dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * d)


@pytest.mark.parametrize("M", GROWN_TIERS)
def test_score_matrix_tier_sweep(M):
    """Grown-tier row counts at B = 13: the Pallas wrapper pads to its
    blocks and crops; the port's output is exactly [B, M]."""
    rng = np.random.default_rng(M + 1)
    (jx, jsq, jq), (tx, tsq, tq) = _sm_inputs(rng, M, 13, 48, "float32")
    want = jops.score_matrix(jx, jsq, jq)
    got = tops.score_matrix(tx, tsq, tq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4 * 48)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_score_matrix_batched_rows_and_integer_data(metric):
    """The 3-D form (one matrix per leading row r, as SELECT-NEIGHBORS calls
    it) equals per-row 2-D calls, and integer-valued data is byte-equal to
    the Pallas wrapper."""
    rng = np.random.default_rng(5)
    R, n, d = 6, 37, 20
    x = int_vectors(rng, R * n, d).reshape(R, n, d)
    xsq = (x * x).sum(-1)
    got = tops.score_matrix(_t(x), _t(xsq), _t(x), metric=metric)
    assert got.shape == (R, n, n)
    for r in range(R):
        row = tops.score_matrix(_t(x[r]), _t(xsq[r]), _t(x[r]), metric=metric)
        assert torch.equal(got[r], row)
        want = jops.score_matrix(jnp.asarray(x[r]), jnp.asarray(xsq[r]),
                                 jnp.asarray(x[r]), metric=metric)
        assert (row.numpy() == np.asarray(want)).all()
    with pytest.raises(ValueError):
        tops.score_matrix(_t(x), _t(xsq), _t(x[0]))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_quantize_rows_byte_equal(shape):
    M, _, d, _ = shape
    rng = np.random.default_rng(d)
    x = rng.normal(size=(M, d)).astype(np.float32) * rng.uniform(
        0.01, 10, size=(M, 1)).astype(np.float32)
    x[0] = 0.0                              # zero row → ZERO_ROW_SCALE
    x[1, :] = 0.5                           # exact .5 codes: round half even
    jc, js = jquantize(jnp.asarray(x))
    tc, ts = tquantize(_t(x))
    assert (tc.numpy() == np.asarray(jc)).all()
    assert (ts.numpy() == np.asarray(js)).all()


def test_cpu_tensors_take_the_plain_version():
    """The device alone routes: CPU tensors never launch (or build) a
    kernel and never count a launch."""
    tops.reset_launches()
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(30, 8)).astype(np.float32))
    ids = _t(rng.integers(0, 30, (4, 5)).astype(np.int32))
    q = _t(rng.normal(size=(4, 8)).astype(np.float32))
    tops.gather_scores(x, (x * x).sum(1), ids, q)
    tops.gather_scores(x.bfloat16(), (x * x).sum(1), ids, q)
    tops.score_topk(x, (x * x).sum(1), q, 3)
    tops.score_matrix(x, (x * x).sum(1), q)
    tops.entry_draw(torch.ones(30, dtype=torch.bool), prng.prng_key(0), 4, 2)
    assert set(tops.launches) == {"gather_scores", "gather_scores_bf16",
                                  "gather_scores_q8", "score_topk",
                                  "score_matrix", "entry_draw"}
    assert all(v == 0 for v in tops.launches.values())
    assert set(tops.launches_by_shape) == set(tops.launches)
    assert not any(tops.launches_by_shape.values())


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device(None)
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_cuda_sources_declare_the_bound_entry_points():
    """The C symbols the wrappers bind exist in the sources (nvcc is only
    on the card's machine; chip_smoke.py builds and checks them there)."""
    csrc = Path(tops.build.CSRC)
    for (lib, fn), argtypes in tops._SIGNATURES.items():
        src = (csrc / f"{lib}.cu").read_text()
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert m, f"{fn} missing from {lib}.cu"
        assert len(m.group(1).split(",")) == len(argtypes), fn


@pytest.mark.parametrize("k", [1, 10, 65, 80, 81, 128])
def test_topk_splits_follow_the_tiling(k):
    """One split once the query tiles alone cover the SMs four times; at
    small B enough splits to do so; never more splits than row tiles (and
    at least ``TOPK_MIN_TILES_PER_SPLIT`` row tiles per split)."""
    sms = 132
    qt = tops.topk_query_tile(k)
    assert qt == (128 if k <= tops.TOPK_WIDE_MAX_K else 64)
    M = 1 << 20
    assert tops.topk_splits(qt * 4 * sms, M, sms, k) == 1
    assert tops.topk_splits(qt * 4 * sms - qt, M, sms, k) == 2
    qtiles = -(-1000 // qt)
    want = -(-4 * sms // qtiles)
    assert want <= tops.topk_splits(1000, M, sms, k) <= 2 * want
    for B in (1, 13, 1000, 16384):
        for m in (1, 127, 1024, 5000, M):
            s = tops.topk_splits(B, m, sms, k)
            tiles = -(-m // tops.TOPK_ROWS_PER_TILE)
            assert 1 <= s <= max(1, tiles // tops.TOPK_MIN_TILES_PER_SPLIT)


def test_topk_constants_match_the_kernel_source():
    """The wrapper's tiling constants are the ones the CUDA source uses."""
    topk = (Path(tops.build.CSRC) / "score_topk.cu").read_text()
    matrix = (Path(tops.build.CSRC) / "score_matrix.cu").read_text()

    def const(src, name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);", src).group(1))

    assert const(topk, "kWideMaxK") == tops.TOPK_WIDE_MAX_K
    assert const(topk, "RT") == tops.TOPK_ROWS_PER_TILE
    assert const(topk, "KMAX") == tops.TOPK_MAX_K
    assert re.search(r"n > " + str(tops.SELF_MAX_N) + r" \|\|", matrix)


@pytest.mark.parametrize("case,want", [
    ("same", True), ("same_2d", True), ("copy", False), ("offset_view", False),
    ("bf16", False), ("too_many_rows", False), ("d_not_multiple_of_4", False),
    ("other_shape", False),
])
def test_score_matrix_self_path_detection(case, want):
    """The self path is taken only when q is x: the same storage, offset,
    shape and strides, fp32, within the kernel's n and d limits."""
    x = torch.randn(4, 16, 32)
    if case == "same":
        a, b = x, x
    elif case == "same_2d":
        a = b = x[1]
    elif case == "copy":
        a, b = x, x.clone()
    elif case == "offset_view":
        flat = torch.randn(2 * 16 * 32 + 32)
        a = flat[32:].view(2, 16, 32)
        b = flat[:-32].view(2, 16, 32)
    elif case == "bf16":
        a = b = x.to(torch.bfloat16)
    elif case == "too_many_rows":
        a = b = torch.randn(2, tops.SELF_MAX_N + 1, 32)
    elif case == "d_not_multiple_of_4":
        a = b = torch.randn(2, 16, 30)
    else:
        a, b = x, x[:, :8]
    assert tops.is_self_pair(a, b) is want


@pytest.mark.parametrize("n", [1, 8, 31, 33, 96])
def test_score_matrix_self_call_equals_a_copy_and_pallas(n):
    """On the CPU both routes give the plain version: a self call (q is x)
    equals the call with a copy of x and, on integer data, each row's
    Pallas matrix."""
    rng = np.random.default_rng(n)
    R, d = 3, 16
    x = int_vectors(rng, R * n, d).reshape(R, n, d)
    xsq = (x * x).sum(-1)
    tx = _t(x)
    got = tops.score_matrix(tx, _t(xsq), tx)
    assert torch.equal(got, tops.score_matrix(tx, _t(xsq), tx.clone()))
    for r in range(R):
        want = jops.score_matrix(jnp.asarray(x[r]), jnp.asarray(xsq[r]),
                                 jnp.asarray(x[r]))
        assert (got[r].numpy() == np.asarray(want)).all()


# ---- the gathers' launch planner (csrc/gather_scores.cu) ----

GATHER_PLAN_SHAPES = [(64, 32), (4096, 32), (1000, 64), (1000, 32), (64, 2),
                      (13, 17), (1, 1)]


def _gather_tiles(B, C, sms, q8):
    """(rows each lane group reads, rows the writing lanes store), as the
    kernels map blocks, warps and lanes onto the flat [B*C] range."""
    total = B * C
    rpw = tops.gather_rows_per_warp(total, sms, q8=q8)
    groups = 32 // tops.GATHER_Q8_LANES_PER_ROW if q8 else 1
    per_group = rpw // groups
    read, written = [], []
    for blk in range(tops.gather_blocks(total, rpw)):
        for w in range(tops.GATHER_WARPS):
            r0 = (blk * tops.GATHER_WARPS + w) * rpw
            for g in range(groups):
                read += [r for r in range(r0 + g * per_group, r0 + (g + 1) * per_group)
                         if r < total]
            written += [r0 + lane for lane in range(32) if lane < rpw and r0 + lane < total]
    return rpw, read, written


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("B,C", GATHER_PLAN_SHAPES)
def test_gather_plan_covers_every_pair_once(B, C, q8):
    """Every (b, c) is read by exactly one lane group and stored by exactly
    one lane; the tile is one of the kernel's instantiations."""
    rpw, read, written = _gather_tiles(B, C, 132, q8)
    assert rpw in (tops.GATHER_Q8_ROWS_PER_WARP if q8 else tops.GATHER_ROWS_PER_WARP)
    assert sorted(read) == list(range(B * C))
    assert sorted(written) == list(range(B * C))


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_gather_plan_fills_the_card(q8):
    """At the beam trip's B = 64, C = 32 every one of 132 SMs gets a block
    and all blocks are resident at once (one wave); at B = 4,096 the
    resident warps keep >= 40 KB of rows in flight per SM."""
    sms = 132
    rpw = tops.gather_rows_per_warp(64 * 32, sms, q8=q8)
    blocks = tops.gather_blocks(64 * 32, rpw)
    assert sms <= blocks <= sms * tops.GATHER_MIN_BLOCKS_PER_SM
    rpw = tops.gather_rows_per_warp(4096 * 32, sms, q8=q8)
    assert rpw == max(tops.GATHER_Q8_ROWS_PER_WARP if q8 else tops.GATHER_ROWS_PER_WARP)
    warps_per_sm = tops.GATHER_MIN_BLOCKS_PER_SM * tops.GATHER_WARPS
    row_bytes = 128 if q8 else 4 * 128
    assert warps_per_sm * rpw * row_bytes >= 40 << 10


def test_gather_constants_match_the_kernel_source():
    """The planner's constants are the ones the CUDA source uses, and each
    tile the planner can pick has a case in the source's dispatch."""
    src = (Path(tops.build.CSRC) / "gather_scores.cu").read_text()

    def const(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);", src).group(1))

    lanes = const("kQ8LanesPerRow")
    assert const("kWarps") == tops.GATHER_WARPS
    assert const("kMinBlocksPerSM") == tops.GATHER_MIN_BLOCKS_PER_SM
    assert lanes == tops.GATHER_Q8_LANES_PER_ROW
    assert max(tops.GATHER_ROWS_PER_WARP) == const("kMaxRowsPerWarp")
    assert max(tops.GATHER_Q8_ROWS_PER_WARP) == (32 // lanes) * const("kQ8MaxRowsPerGroup")
    for r in tops.GATHER_ROWS_PER_WARP[:-1]:
        assert re.search(rf"case {r}: gather_rows_kernel<Piece, {r}>", src)
    for r in tops.GATHER_Q8_ROWS_PER_WARP[:-1]:
        rg = r // (32 // lanes)
        assert re.search(rf"case {rg}: gather_q8_kernel<VEC, {rg}>", src)


@pytest.mark.parametrize("entry", sorted(tops._SIGNATURES), ids=lambda e: e[1])
def test_cuda_entry_point_argument_types(entry):
    """Each ctypes argument type matches its C parameter: a pointer for a
    pointer (and the stream), a 32-bit int for an int."""
    lib, fn = entry
    src = (Path(tops.build.CSRC) / f"{lib}.cu").read_text()
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src).group(1).split(",")
    kinds = [tops._P if "*" in p else tops._I for p in params]
    assert all("*" in p or re.fullmatch(r"\s*int \w+\s*", p) for p in params), params
    assert kinds == tops._SIGNATURES[entry]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [128, 8])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_gathers_match_pallas_at_the_beam_trip(q8, d, metric):
    """The beam trip's shape (B 64, C 32) at d = 128 and at d = 8: the plain
    versions against the Pallas kernels, with edge ids."""
    M, B, C = 1500, 64, 32
    rng = np.random.default_rng(d + 7 * q8)
    x = rng.normal(size=(M, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    ids = _edge_ids(rng, M, B, C)
    ids[1, 5], ids[B - 1, C - 1] = -7, M + 5
    if q8:
        codes, scales = jquantize(jnp.asarray(x))
        want = jops.gather_scores_q8(codes, scales, jnp.asarray(ids), jnp.asarray(q),
                                     metric=metric)
        got = tops.gather_scores_q8(_t(codes), _t(scales), _t(ids), _t(q), metric=metric)
    else:
        xsq = (x * x).sum(1)
        want = jops.gather_scores(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(ids),
                                  jnp.asarray(q), metric=metric)
        got = tops.gather_scores(_t(x), _t(xsq), _t(ids), _t(q), metric=metric)
    assert got.shape == (B, C)
    _assert_scores(got, want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [128, 100, 8])
def test_gather_bf16_rows_equal_the_widened_f32_table(d, metric):
    """The bf16-row gather's plain version gives the f32 plain version's
    bits on the f32 table of the widened rows (bf16 -> f32 is exact), at the
    beam trip's B 64 x C 32 with edge ids; and it meets the Pallas kernel
    run on the bf16 table itself."""
    M, B, C = 1500, 64, 32
    rng = np.random.default_rng(d)
    xb = torch.from_numpy(rng.normal(size=(M, d)).astype(np.float32)).bfloat16()
    xw = xb.float()
    xsq = (xw * xw).sum(1)
    q = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    ids = torch.from_numpy(_edge_ids(rng, M, B, C))
    got = tops.gather_scores(xb, xsq, ids, q, metric=metric)
    want = tops.gather_scores(xw, xsq, ids, q, metric=metric)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    jx = jnp.asarray(xw.numpy()).astype(jnp.bfloat16)
    pallas = jops.gather_scores(jx, jnp.asarray(xsq.numpy()), jnp.asarray(ids.numpy()),
                                jnp.asarray(q.numpy()), metric=metric)
    _assert_scores(got, pallas)


def test_gather_rejects_other_row_types():
    ids = torch.zeros((2, 3), dtype=torch.int32)
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="table"):
        tops.gather_scores(torch.zeros((4, 8), dtype=torch.float16),
                           torch.zeros(4), ids, q)


# ---- the entry draw's plan (csrc/entry_draw.cu) ----

def _insert(v, key):
    """csrc/entry_draw.cu ``insert``: into a list sorted descending (0 is
    empty), dropping the smallest."""
    if key <= v[-1]:
        return
    for i in range(len(v) - 1, 0, -1):
        v[i] = v[i - 1] if key > v[i - 1] else (key if key > v[i] else v[i])
    v[0] = max(key, v[0])


def _butterfly(lists, first):
    """The xor-shuffle merge at offsets ``first``, 2·first, .. 16: each
    thread inserts its partner's list of the step before."""
    off = first
    while off < 32:
        new = []
        for x in range(32):
            v = list(lists[x])
            for key in lists[x ^ off]:
                _insert(v, key)
            new.append(v)
        lists, off = new, 2 * off
    return lists


def _emulate_entry_draw(m, present, active, S, sms):
    """The kernel's plan in Python, with mantissas ``m [L, capacity]`` given:
    lane groups compacted over the active lanes, tiles split over the
    block's warps, each thread's slots by phase and its running list with
    its threshold, the warp's xor merge, the block's merge through shared
    memory, S keys a lane a tile, and pass 2's merge of a lane's tiles.
    Returns (starts [L, S], how often each (lane, slot) was drawn)."""
    L, cap = m.shape
    wl, tile = tops.entry_plan(L, cap, sms)
    ns = 1 << (S - 1).bit_length()
    pw, span = 32 // wl, tile // tops.ENTRY_WARPS
    tiles = -(-cap // tile)
    order = [int(r) for r in np.flatnonzero(active)]
    draws = np.zeros((L, cap), np.int64)
    partial = {}
    for g in range(-(-L // wl)):
        lanes = [order[p] if p < len(order) else -1 for p in range(g * wl, (g + 1) * wl)]
        if lanes[0] < 0:
            continue
        for t in range(tiles):
            shared = {}
            for w in range(tops.ENTRY_WARPS):
                w0 = t * tile + w * span
                w1 = min(cap, w0 + span)
                lists = []
                for x in range(32):
                    r, phase = lanes[x % wl], x // wl
                    best, thr = [0] * ns, 0
                    for j0 in range(w0, w1, 32) if r >= 0 else ():
                        for j in range(j0 + phase, min(j0 + 32, w1), pw):
                            if present[j]:
                                draws[r, j] += 1
                                if m[r, j] >= thr:
                                    _insert(best, (int(m[r, j]) << 32) | (~j & 0xFFFFFFFF))
                                    thr = best[-1] >> 32
                    lists.append(best)
                lists = _butterfly(lists, wl)
                for x in range(wl):
                    shared[w, x] = lists[x]
            for x in range(wl):
                if lanes[x] >= 0:
                    best = list(shared[0, x])
                    for w in range(1, tops.ENTRY_WARPS):
                        for key in shared[w, x]:
                            _insert(best, key)
                    partial[g * wl + x, t] = best[:S]
    starts = np.full((L, S), -1, np.int64)
    for r in map(int, np.flatnonzero(active)):
        p = order.index(r)
        cands = [key for t in range(tiles) for key in partial[p, t]]
        lists = []
        for x in range(32):
            v = [0] * ns
            for key in cands[x::32]:
                _insert(v, key)
            lists.append(v)
        best = _butterfly(lists, 1)[0]
        starts[r] = [(~k & 0xFFFFFFFF) if k else -1 for k in best[:S]]
    return starts, draws


# (L, capacity, S, share of lanes active, share of slots present, SMs)
ENTRY_PLAN_CASES = [
    (40, 1000, 2, 0.75, 0.9, 132),    # capacity not a multiple of the tile
    (1, 3000, 3, 1.0, 0.95, 132),     # one lane: 32 threads split its slots
    (5, 700, 4, 0.8, 0.7, 1),         # 8 lanes a warp, 4 phases each
    (64, 1 << 13, 2, 1.0, 0.97, 1),   # two lane groups, the tile doubled
    (3, 20, 16, 1.0, 0.4, 132),       # fewer present than starts
    (33, 600, 1, 1.0, 1.0, 132),      # a second group of one lane
]


@pytest.mark.parametrize("draw", ["threefry", "ties"])
@pytest.mark.parametrize("case", ENTRY_PLAN_CASES, ids=lambda c: f"L{c[0]}-cap{c[1]}-S{c[2]}")
def test_entry_draw_plan_covers_every_pair_once(case, draw):
    """Every (active lane, present slot) is drawn by exactly one thread and
    nothing else is; the merges keep each lane's top S by (m desc, slot
    asc), so ties go to the lowest slot (``ties``: mantissas in {0, 1, 2})."""
    L, cap, S, p_active, p_present, sms = case
    rng = np.random.default_rng(L * cap + S)
    active = rng.random(L) < p_active
    active[0] = True
    present = rng.random(cap) < p_present
    if draw == "ties":
        m = rng.integers(0, 3, (L, cap))
    else:
        keys = prng.fold_in(prng.prng_key(L), torch.arange(L) + 7)
        m = prng.uniform_mantissa(keys, cap).numpy()
    starts, draws = _emulate_entry_draw(m, present, active, S, sms)
    assert (draws == active[:, None] & present[None, :]).all()
    for r in range(L):
        want = sorted(np.flatnonzero(present), key=lambda j: (-m[r, j], j))[:S]
        want = want + [-1] * (S - len(want)) if active[r] else [-1] * S
        assert starts[r].tolist() == want, r


def test_entry_draw_plan_fills_the_card():
    """One lane at a shard's 2^17 slots still gives every one of 132 SMs a
    block; the search's 512 and the repair's 4,096 lanes at 2^20 give each
    SM 16; every tile is a whole number of the block's ballots, and the
    scratch stays far below lanes × capacity."""
    sms = 132
    for L, cap in ((1, 1 << 17), (512, 1 << 17), (512, 1 << 20), (4096, 1 << 20), (64, 1 << 20)):
        wl, tile = tops.entry_plan(L, cap, sms)
        blocks = -(-L // wl) * -(-cap // tile)
        assert wl == min(32, 1 << (L - 1).bit_length())
        assert tile >= tops.ENTRY_MIN_TILE and tile % (32 * tops.ENTRY_WARPS) == 0
        assert blocks >= sms
        if L * cap >= 512 << 17:
            assert blocks >= tops.ENTRY_MIN_BLOCKS_PER_SM * sms
            assert tops.entry_scratch(L, cap, 2, tile) * 8 <= L * cap // 8


def test_entry_draw_constants_match_the_kernel_source():
    src = (Path(tops.build.CSRC) / "entry_draw.cu").read_text()

    def const(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);", src).group(1))

    assert const("kMaxStarts") == tops.ENTRY_MAX_STARTS
    assert const("kWarps") == tops.ENTRY_WARPS
    assert const("kMinTile") == tops.ENTRY_MIN_TILE
    assert "entry_draw" in tops.build.SOURCES


def test_entry_draw_on_meta_checks_starts_and_reports_int32_work(monkeypatch):
    """The card's route (``meta`` here) refuses more starts than the kernel
    holds, returns shapes only and reports the kernel's int32 operations."""
    present = torch.ones(1 << 10, dtype=torch.bool, device="meta")
    key = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="num_starts"):
        tops.entry_draw(present, key, 8, tops.ENTRY_MAX_STARTS + 1)
    seen = []
    monkeypatch.setattr(tops, "observer", lambda *a: seen.append(a))
    out = tops.entry_draw(present, key, 8, 2, offset=5)
    assert out.shape == (8, 2) and out.dtype == torch.int32 and out.device.type == "meta"
    ops, nbytes = tops.entry_draw_work(8, 1 << 10, 2)
    assert seen == [("entry_draw", "meta", ops, nbytes, (8, 1 << 10, 2), "int32")]
    assert ops == 8 * ((1 << 10) + 1) * tops.ENTRY_OPS_PER_SLOT
    assert all(v == 0 for v in tops.launches.values())
    # the plain version has no such limit
    got = tops.entry_draw(torch.ones(40, dtype=torch.bool), prng.prng_key(1), 2, 17)
    assert got.shape == (2, 17) and (got[:, -1] >= 0).all()
    assert torch.equal(got, tref.entry_draw(torch.ones(40, dtype=torch.bool),
                                            prng.prng_key(1), 2, 17))


def test_entry_draw_bound_is_int32_operations():
    """The planner prices the entry draw's operations at the int32 peak, in
    its bound and in the roofline."""
    from repro_torch.launch import analysis as tan
    ops, nbytes = tops.entry_draw_work(512, 1 << 20, 2)
    ms, by = tan.bound_ms(ops, nbytes, "int32")
    assert by == "operations" and ms == pytest.approx(ops / tan.PEAK_INT32_OPS * 1e3)
    cost = tan.Cost(flops=ops, hbm_bytes=nbytes, matmul_flops={"int32": ops})
    assert tan.roofline(cost, 0.0)["compute_s"] == pytest.approx(ops / tan.PEAK_INT32_OPS)
