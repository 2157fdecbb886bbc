"""The decoder-LM family of ``repro_torch`` (layers, MoE, transformer,
configs, LM serving steps) against ``repro``'s, on the CPU.

Every case seeds numpy, feeds the same inputs to both packages and carries
JAX's parameters across with ``from_jax_params``. The five smoke configs
run in fp32, so prefill and decode are held to atol 1e-4 (summation order
only; no TF32 on either side).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the intra-op thread count)
from repro.configs import registry as jreg
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.train import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tL
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.train import steps as tsteps

LM_ARCHS = ["qwen3-1.7b", "mistral-nemo-12b", "gemma2-27b",
            "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
ATOL = 1e-4
DTYPES = {np.dtype(jnp.float32): torch.float32, np.dtype(jnp.int32): torch.int32,
          np.dtype(jnp.bool_): torch.bool, np.dtype(jnp.bfloat16): torch.bfloat16}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module", params=LM_ARCHS)
def lm_run(request):
    """One arch's smoke config through both packages: forward with a cache
    padded to S + 3, the prefill step, and four decode steps, the last one
    past the cache's end."""
    arch = request.param
    jcfg = jreg.get_arch(arch).smoke_config()
    tcfg = treg.get_arch(arch).smoke_config()
    jparams = jax.jit(jtfm.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = ttfm.from_jax_params(tcfg, _np_tree(jparams))
    rng = np.random.default_rng(1)
    B, S, pad = 2, 21, 24                      # S ragged against block 16
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, (4, B, 1)).astype(np.int32)
    h_j, aux_j, cj = jax.jit(lambda p, t: jtfm.forward(p, t, jcfg, return_cache_pad=pad))(
        jparams, tokens)
    jdec = jax.jit(jsteps.make_lm_decode_step(jcfg))
    r = {"jcfg": jcfg, "model": model, "S": S, "pad": pad,
         "h": (ttfm.forward(model, _t(tokens), tcfg)[:2], (h_j, aux_j)),
         "logits_all": (None, jtfm.logits_from_hidden(jparams, h_j, jcfg))}
    lt, ct = tsteps.make_lm_prefill_step(tcfg, pad)(model, {"tokens": _t(tokens)})
    r["logits"] = [(lt, r["logits_all"][1][:, -1])]
    r["caches"] = [(_snapshot(ct), cj)]
    tdec = tsteps.make_lm_decode_step(tcfg)
    for t in nxt:
        before = [tuple(x.clone() for x in kv) for kv in ct["kv"]]
        lj, cj = jdec(jparams, cj, {"tokens": t})
        lt, ct = tdec(model, ct, {"tokens": _t(t)})
        r["logits"].append((lt, lj))
        r["caches"].append((_snapshot(ct), cj))
    r["before_last"] = before
    return r


def _snapshot(cache):
    """A copy of a port cache (decode writes its k/v in place)."""
    return {"kv": [tuple(x.clone() for x in kv) for kv in cache["kv"]],
            "len": cache["len"].clone()}


def _jax_cache_layers(cache, cfg):
    """JAX's per-position stacked cache → one (k, v) per layer."""
    return [tuple(np.asarray(cache["kv"][l % cfg.period][j][l // cfg.period])
                  for j in (0, 1)) for l in range(cfg.n_layers)]


def _caches_close(ct, cj, cfg):
    assert np.array_equal(ct["len"].numpy(), np.asarray(cj["len"]))
    for (kt, vt), (kj, vj) in zip(ct["kv"], _jax_cache_layers(cj, cfg)):
        _close(kt, kj)
        _close(vt, vj)


def test_prefill_and_decode_match_jax(lm_run):
    """forward (hidden, aux, logits_from_hidden), the prefill step's logits
    and cache, and three decode steps' logits and caches."""
    r = lm_run
    (h_t, aux_t), (h_j, aux_j) = r["h"]
    _close(h_t, h_j)
    _close(aux_t, aux_j, atol=1e-5)
    _close(ttfm.logits_from_hidden(r["model"], h_t, r["model"].cfg), r["logits_all"][1])
    for (lt, lj), (ct, cj) in zip(r["logits"][:4], r["caches"][:4]):
        _close(lt, lj)
        _caches_close(ct, cj, r["jcfg"])


def test_decode_write_past_cache_end_is_dropped(lm_run):
    """The fourth decode step finds the cache full: it drops the token's
    k/v (JAX's scatter drops an out-of-range write) and attends over every
    position."""
    r = lm_run
    (lt, lj), (ct, cj) = r["logits"][4], r["caches"][4]
    assert ct["len"].tolist() == [r["pad"] + 1] * 2
    for (kt, vt), (kb, vb) in zip(ct["kv"], r["before_last"]):
        assert torch.equal(kt, kb) and torch.equal(vt, vb)
    _close(lt, lj)
    _caches_close(ct, cj, r["jcfg"])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama4-scout-17b-a16e"])
def test_decode_from_an_empty_cache_matches_jax(arch):
    """``init_cache`` and three decode steps from position 0."""
    jcfg = jreg.get_arch(arch).smoke_config()
    tcfg = treg.get_arch(arch).smoke_config()
    jparams = jax.jit(jtfm.init_params, static_argnums=1)(jax.random.PRNGKey(4), jcfg)
    model = ttfm.from_jax_params(tcfg, _np_tree(jparams))
    cj, ct = jtfm.init_cache(jcfg, 2, 6), ttfm.init_cache(tcfg, 2, 6)
    assert [tuple(k.shape) for k, _ in ct["kv"]] == [(2, 6, 2, 16)] * tcfg.n_layers
    jdec = jax.jit(jsteps.make_lm_decode_step(jcfg))
    rng = np.random.default_rng(5)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        lj, cj = jdec(jparams, cj, {"tokens": nxt})
        lt, ct = ttfm.decode_step(model, ct, _t(nxt), tcfg)
        _close(lt, lj)
    _caches_close(ct, cj, jcfg)


def test_cache_write_positions():
    """``_write_cache`` is ``.at[b, pos].set``: a position past the end is
    dropped and a negative one counts from the end, per sequence."""
    S = 5
    cache = torch.zeros((4, S, 1, 1))
    new = torch.arange(1.0, 5.0).reshape(4, 1, 1)
    pos = torch.tensor([0, S, -1, S + 3], dtype=torch.int32)
    ttfm._write_cache(cache, new, pos)
    want = jnp.zeros((4, S, 1, 1)).at[jnp.arange(4), jnp.asarray(pos.numpy())].set(
        jnp.asarray(new.numpy()))
    assert np.array_equal(cache.numpy(), np.asarray(want))


ATTN_CASES = [
    dict(causal=True, window=None, attn_softcap=None),
    dict(causal=True, window=8, attn_softcap=None),
    dict(causal=True, window=16, attn_softcap=50.0),
    dict(causal=True, window=5, attn_softcap=30.0),
    dict(causal=False, window=None, attn_softcap=None),
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("shape", [(2, 32, 4, 2, 16), (1, 41, 6, 3, 8)])
def test_blockwise_attention_matches_jax(case, shape):
    """Windows, softcaps, GQA and ragged q and kv tails (41 rows against
    blocks of 8) against JAX's block algorithm."""
    B, S, Hq, Hkv, dh = shape
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(B, S, h, dh)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    want = jL.blockwise_attention(q, k, v, block_q=8, block_kv=8, **case)
    got = tL.blockwise_attention(_t(q), _t(k), _t(v), block_q=8, block_kv=8, **case)
    _close(got, want, atol=2e-5)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_matches_jax(window):
    rng = np.random.default_rng(4)
    B, S, Hq, Hkv, dh = 3, 20, 4, 2, 8
    q = rng.normal(size=(B, 1, Hq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, dh)).astype(np.float32) for _ in range(2))
    lens = np.array([1, 9, 20], np.int32)
    want = jL.decode_attention(q, k, v, lens, window=window, attn_softcap=20.0)
    got = tL.decode_attention(_t(q), _t(k), _t(v), _t(lens), window=window,
                              attn_softcap=20.0)
    _close(got, want, atol=2e-5)


def test_norms_rope_and_softcap_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    _close(tL.rmsnorm(_t(scale), _t(x)), jL.rmsnorm({"scale": scale}, x), atol=1e-5)
    _close(tL.layernorm(_t(scale), _t(bias), _t(x)),
           jL.layernorm({"scale": scale, "bias": bias}, x), atol=1e-5)
    pos = np.arange(7)[None, :] + np.array([[0], [100]])
    _close(tL.apply_rope(_t(x), _t(pos), 1e6), jL.apply_rope(x, pos, 1e6), atol=1e-5)
    _close(tL.softcap(_t(x * 40), 30.0), jL.softcap(x * 40, 30.0), atol=1e-4)


def _moe_pair(cfg_kw, seed, zero_router=False):
    jcfg = jmoe.MoEConfig(**cfg_kw)
    tcfg = tmoe.MoEConfig(**cfg_kw)
    p = jax.jit(jmoe.init_moe, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    if zero_router:
        p = dict(p, router=jnp.zeros_like(p["router"]))
    return jcfg, tcfg, p, tmoe.from_jax_params(tcfg, _np_tree(p))


MOE_CASES = [
    # every prob equal: the ties go to the lowest experts, which overflow
    dict(kw=dict(n_experts=4, top_k=2, d_model=16, d_ff=24, capacity_factor=1.0),
         zero_router=True),
    dict(kw=dict(n_experts=4, top_k=1, d_model=16, d_ff=24, capacity_factor=1.0,
                 n_shared=1), zero_router=True),
    # random routing at a capacity that drops some tokens
    dict(kw=dict(n_experts=8, top_k=2, d_model=16, d_ff=24, capacity_factor=0.5),
         zero_router=False),
    dict(kw=dict(n_experts=4, top_k=1, d_model=16, d_ff=24, capacity_factor=1.25,
                 gated=False), zero_router=False),
]


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routing_and_drops_match_jax(case):
    jcfg, tcfg, p, mod = _moe_pair(case["kw"], 6, case["zero_router"])
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 11, jcfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, jcfg.d_model)
    N, E, K = xf.shape[0], jcfg.n_experts, jcfg.top_k
    # JAX's routing, step by step as moe_ffn takes it
    _, gate_e = jax.jit(lambda x, r: jax.lax.top_k(jax.nn.softmax(x @ r, axis=-1), K))(
        xf, p["router"])
    flat_e = np.asarray(gate_e).reshape(-1)
    onehot = np.eye(E, dtype=np.int64)[flat_e]
    slot = ((np.cumsum(onehot, 0) - onehot)[np.arange(N * K), flat_e])
    C = max(1, int(N * K * jcfg.capacity_factor) // E)
    _, _, t_e, t_slot, t_keep, t_C = tmoe.route(mod, _t(xf), tcfg)
    assert t_C == C
    assert np.array_equal(t_e.numpy(), np.asarray(gate_e))
    assert np.array_equal(t_slot.numpy(), slot)
    assert np.array_equal(t_keep.numpy(), slot < C)
    assert 0 < int((slot >= C).sum()) < N * K          # some, not all, dropped
    if case["zero_router"]:
        assert np.array_equal(np.asarray(gate_e), np.tile(np.arange(K), (N, 1)))
    y_j, aux_j = jax.jit(jmoe.moe_ffn, static_argnums=2)(p, x, jcfg)
    y_t, aux_t = mod(_t(x))
    _close(y_t, y_j, atol=1e-5)
    _close(aux_t, aux_j, atol=1e-6)


def test_registry_specs_match_jax():
    """Every (arch, shape) outside the GNN family, whose nested specs
    ``tests/test_torch_gnn.py`` compares: the same shapes and dtypes, and
    configs whose shared fields are equal; every JAX arch is ported."""
    t_archs = treg.all_archs()
    j_archs = jreg.all_archs()
    assert set(t_archs) == set(j_archs)
    for arch, tspec in t_archs.items():
        if tspec.family == "gnn":
            continue
        jspec = j_archs[arch]
        assert (tspec.family, set(tspec.shapes)) == (jspec.family, set(jspec.shapes))
        for shape, cell in tspec.shapes.items():
            assert dataclasses.asdict(cell) == dataclasses.asdict(jspec.shapes[shape])
            tcfg, jcfg = tspec.config_for_shape(shape), jspec.config_for_shape(shape)
            for f in dataclasses.fields(tcfg):
                tv, jv = getattr(tcfg, f.name), getattr(jcfg, f.name)
                if f.name == "compute_dtype":
                    assert tv == DTYPES[np.dtype(jv)]
                elif dataclasses.is_dataclass(tv):     # JAX's adds sharding hints
                    td = dataclasses.asdict(tv)
                    assert td == {k: getattr(jv, k) for k in td}
                else:
                    assert tv == jv, (arch, f.name)
            tin = tspec.input_specs(tcfg, shape)
            jin = jspec.input_specs(jcfg, shape)
            assert set(tin) == set(jin)
            for name, s in tin.items():
                assert s.shape == jin[name].shape
                assert s.dtype == DTYPES[np.dtype(jin[name].dtype)], (arch, shape, name)
    with pytest.raises(KeyError, match="gat-cora"):
        treg.get_arch("gcn-cora")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_and_param_counts_match_jax(arch):
    from repro.configs.lm_common import lm_cache_specs as j_cache_specs
    from repro_torch.configs.lm_common import lm_cache_specs as t_cache_specs
    tspec, jspec = treg.get_arch(arch), jreg.get_arch(arch)
    tcfg, jcfg = tspec.config_for_shape("decode_32k"), jspec.config_for_shape("decode_32k")
    assert (tcfg.n_params(), tcfg.n_active_params()) == (jcfg.n_params(),
                                                         jcfg.n_active_params())
    tc = t_cache_specs(tcfg, tspec.shapes["decode_32k"])
    jc = j_cache_specs(jcfg, jspec.shapes["decode_32k"])
    assert len(tc["kv"]) == jcfg.n_groups * len(jc["kv"]) == jcfg.n_layers
    G, *per_layer = jc["kv"][0][0].shape
    assert tc["kv"][0][0].shape == tuple(per_layer)
    assert tc["kv"][0][0].dtype == DTYPES[np.dtype(jc["kv"][0][0].dtype)]
    assert tc["len"].shape == jc["len"].shape
    # the smoke model has as many weights as JAX's tree
    tsm, jsm = tspec.smoke_config(), jspec.smoke_config()
    jp = jax.eval_shape(lambda k: jtfm.init_params(k, jsm), jax.random.PRNGKey(0))
    model = ttfm.init_params(tsm, torch.Generator().manual_seed(0))
    assert (sum(p.numel() for p in model.parameters())
            == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp)))


def test_init_params_draws_jax_scales():
    """Random init: truncated normals at fan-in scale, zero norm scales,
    the same generator giving the same weights."""
    cfg = treg.get_arch("qwen3-1.7b").smoke_config()
    a = ttfm.init_params(cfg, torch.Generator().manual_seed(3))
    b = ttfm.init_params(cfg, torch.Generator().manual_seed(3))
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    w = a.layers[0].wq
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 0.88) < 0.05
    assert float(a.layers[0].ln_attn.abs().max()) == 0.0


def test_cast_weights_keeps_norms_fp32():
    cfg = treg.get_arch("phi3.5-moe-42b-a6.6b").smoke_config()
    model = tL.cast_weights_(ttfm.init_params(cfg, torch.Generator().manual_seed(0)),
                             torch.bfloat16)
    for name, p in model.named_parameters():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), name
