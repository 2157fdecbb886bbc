"""The LM and DLRM training path of ``repro_torch`` (``chunked_xent``,
``bce_loss``, the trainable ``blockwise_attention``, ``_cast_params``, the
LM and DLRM train steps, the chunked AdamW update, ``launch/train.py``)
against ``repro``'s, on the CPU.

Every case seeds numpy, feeds the same inputs to both packages and carries
JAX's parameters and AdamW state across (``from_jax_params``,
``adamw_state_from_jax``). Tolerances: the losses within 1e-6 relative;
the attention's gradients within 1e-4 relative L2; over three train steps
loss, xent, aux and ``grad_norm`` within 1e-5 relative, ``lr`` within 5e-7
and the parameters after steps 1 and 3 within 1e-6 absolute (the GNN
steps' bounds, ``tests/test_torch_gnn.py``).

The train steps' AdamW runs at ``eps`` 1e-4, not the default 1e-8, so
that the parameters are a well-conditioned function of the gradients.
Step 1's update of an element is ``g / (|g| + eps)``, whose slope reaches
``1 / (4·eps)`` where ``|g|`` is near eps, so an fp32 summation-order
difference δ in a gradient moves its parameter by up to ``lr·δ / (4·eps)``.
The two packages' qwen3 gradients agree within 2.5e-7 absolute (1e-6 of
the largest); this test's largest parameter gap over the three steps was
5.4e-6 (qwen3) and 7.0e-6 (phi3.5) at eps 1e-8, 2.4e-6 and 1.1e-6 at 1e-6,
5.0e-7 and 2.4e-7 at 1e-5, and 1.9e-7 and 5.6e-8 at 1e-4: it falls as
1 / eps, the mark of conditioning, not of a fault.
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
from repro.models import dlrm as jdlrm
from repro.models import layers as jL
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.launch import train as tlaunch
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttfm
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

LM_ARCHS = ["qwen3-1.7b", "mistral-nemo-12b", "gemma2-27b",
            "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
LOSS_RTOL, STEP_RTOL, LR_RTOL, PARAM_ATOL, GRAD_TOL = 1e-6, 1e-5, 5e-7, 1e-6, 1e-4
OPT = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)
TOPT = topt.AdamWConfig(**dataclasses.asdict(OPT))
B, S = 2, 32                     # S: two xent chunks and two attention blocks


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _lm(arch: str, seed: int = 0, **over):
    jcfg = dataclasses.replace(jreg.get_arch(arch).smoke_config(), **over)
    tcfg = dataclasses.replace(treg.get_arch(arch).smoke_config(), **over)
    jparams = jax.jit(jtfm.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, ttfm.from_jax_params(tcfg, _np_tree(jparams))


def _lm_batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "mask": rng.random((B, S)) > 0.2}


def _assert_lm_params_close(tcfg, model, jparams):
    want = ttfm.from_jax_params(tcfg, _np_tree(jparams))
    for (name, got), w in zip(model.named_parameters(), want.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


def _assert_metrics_close(tm, jm, keys):
    for k in keys:
        assert _rel(tm[k], jm[k]) <= STEP_RTOL, (k, float(tm[k]), float(jm[k]))
    np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]), rtol=LR_RTOL)


# ---------------------------------------------------------------------------
# losses and the trainable attention
# ---------------------------------------------------------------------------

def test_chunked_xent_matches_jax():
    """Two chunks of 16, a partial mask, and its gradients (hidden and the
    tied embedding) through the recomputed chunks."""
    jcfg, tcfg, jparams, model = _lm("gemma2-27b")          # final softcap on
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    b = _lm_batch(jcfg, 2)
    jl, (jgh, jge) = jax.jit(jax.value_and_grad(
        lambda hh, e: jtfm.chunked_xent({**jparams, "embed": e}, hh, b["labels"], b["mask"],
                                        jcfg), argnums=(0, 1)))(h, jparams["embed"])
    th = _t(h).requires_grad_(True)
    model.embed.requires_grad_(True)
    tl = ttfm.chunked_xent(model, th, _t(b["labels"]), _t(b["mask"]), tcfg)
    tgh, tge = torch.autograd.grad(tl, [th, model.embed])
    assert _rel(tl, jl) <= LOSS_RTOL
    assert _rel(tgh, jgh) <= GRAD_TOL and _rel(tge, jge) <= GRAD_TOL
    with torch.no_grad():
        assert float(ttfm.chunked_xent(model, th, _t(b["labels"]), _t(b["mask"]), tcfg)) \
            == float(tl)
    with pytest.raises(ValueError, match="no multiple"):
        ttfm.chunked_xent(model, th[:, :24], _t(b["labels"][:, :24]), _t(b["mask"][:, :24]),
                          tcfg)


def test_bce_loss_matches_jax():
    """Logits of both signs and labels 0/1; ids past both table ends under
    true and false masks, whose table gradient JAX drops."""
    jcfg = jreg.get_arch("dlrm-rm2").smoke_config()
    tcfg = treg.get_arch("dlrm-rm2").smoke_config()
    jparams = jax.jit(jdlrm.init_params, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    model = tdlrm.from_jax_params(tcfg, _np_tree(jparams))
    b = _dlrm_batch(jcfg, 64, seed=4)
    jl, jg = jax.jit(jax.value_and_grad(jdlrm.bce_loss), static_argnums=2)(jparams, b, jcfg)
    for p in model.parameters():
        p.requires_grad_(True)
    tl = tdlrm.bce_loss(model, {k: _t(v) for k, v in b.items()}, tcfg)
    tg = torch.autograd.grad(tl, [model.tables, *model.bot, *model.top])
    assert _rel(tl, jl) <= LOSS_RTOL
    for got, want in zip(tg, [jg["tables"], *[w["w"] for w in jg["bot"]],
                              *[w["w"] for w in jg["top"]]]):
        assert _rel(got, want) <= GRAD_TOL


ATTN_CASES = [dict(window=None, attn_softcap=None), dict(window=8, attn_softcap=None),
              dict(window=None, attn_softcap=30.0), dict(window=5, attn_softcap=50.0)]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_blockwise_attention_grads_match_jax(case):
    """GQA with ragged tails (37 rows against blocks of 8): the output and
    the gradients of q, k and v against ``jax.grad`` of JAX's block
    algorithm, with each q block recomputed in the backward pass."""
    rng = np.random.default_rng(6)
    Bq, Sq, Hq, Hkv, dh = 2, 37, 4, 2, 8
    q, k, v = (rng.normal(size=(Bq, Sq, h, dh)).astype(np.float32) for h in (Hq, Hkv, Hkv))
    w = rng.normal(size=(Bq, Sq, Hq, dh)).astype(np.float32)
    kw = dict(block_q=8, block_kv=8, **case)
    jout, jg = jax.jit(jax.value_and_grad(
        lambda q, k, v: jnp.sum(jL.blockwise_attention(q, k, v, **kw) * w),
        argnums=(0, 1, 2)))(q, k, v)
    tin = [_t(a).requires_grad_(True) for a in (q, k, v)]
    tout = (tL.blockwise_attention(*tin, **kw) * _t(w)).sum()
    tg = torch.autograd.grad(tout, tin)
    assert _rel(tout, jout) <= GRAD_TOL
    for got, want in zip(tg, jg):
        assert bool(torch.isfinite(got).all()) and _rel(got, want) <= GRAD_TOL
    with torch.no_grad():
        assert torch.equal(tL.blockwise_attention(*tin, **kw) * _t(w),
                           tL.blockwise_attention(*tin, **kw).detach() * _t(w))


def test_cast_params_casts_what_jax_casts_but_the_stacked_norms():
    """Every fp32 leaf of two or more dimensions becomes bf16 (``embed`` and
    the MoE router too); norm scales stay fp32. JAX stacks each layer's
    norm scale into a ``[n_groups, d]`` leaf, which its ``_cast_params``
    casts; the port's per-layer scales are 1-D and stay fp32, as JAX's
    docstring intends (ROADMAP Queue C, Settled 9)."""
    jcfg, tcfg, jparams, model = _lm("phi3.5-moe-42b-a6.6b")
    jcfg16, tcfg16 = (dataclasses.replace(c, compute_dtype=d) for c, d in
                      ((jcfg, jnp.bfloat16), (tcfg, torch.bfloat16)))
    jc = jsteps._cast_params(jparams, jcfg16.compute_dtype)
    tc = tsteps._cast_params(model, tcfg16.compute_dtype)
    assert tc.embed.dtype == torch.bfloat16 and jc["embed"].dtype == jnp.bfloat16
    assert tc.ln_final.dtype == torch.float32 and jc["ln_final"]["scale"].dtype == jnp.float32
    for l, layer in enumerate(tc.layers):
        jl = jc["positions"][f"p{l % tcfg.period}"]
        pairs = [(layer.moe.router, jl["moe"]["router"])]
        pairs += [(getattr(layer, n), jl[n]["w"]) for n in ("wq", "wk", "wv", "wo")]
        pairs += [(getattr(layer.moe, n), jl["moe"][n]) for n in ("w_in", "w_out")]
        for t, j in pairs:
            assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        for name in ("ln_attn", "ln_ffn"):
            assert getattr(layer, name).dtype == torch.float32
            assert jl[name]["scale"].dtype == jnp.bfloat16        # stacked: 2-D
    # the masters are untouched and the cast is differentiable
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.layers[0].wq.requires_grad_(True)
    assert tsteps._cast_params(model, torch.bfloat16).layers[0].wq.grad_fn is not None


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_steps_match_jax(arch):
    """Three steps of ``make_lm_train_step`` against
    ``jax.jit(make_lm_train_step)`` from the same parameters and AdamW
    state: loss, xent, aux, grad_norm, lr, the parameters after steps 1
    and 3."""
    jcfg, tcfg, jparams, model = _lm(arch)
    jstate = jopt.adamw_init(jparams)
    tstate = topt.adamw_state_from_jax(
        _np_tree(jstate), lambda t: ttfm.from_jax_params(tcfg, t).parameters())
    jstep = jax.jit(jsteps.make_lm_train_step(jcfg, OPT))
    tstep = tsteps.make_lm_train_step(tcfg, TOPT, device="cpu")
    for i in range(3):
        b = _lm_batch(jcfg, 10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, b)
        model, tstate, tm = tstep(model, tstate, b)
        _assert_metrics_close(tm, jm, ("loss", "xent", "aux", "grad_norm"))
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        if i in (0, 2):
            _assert_lm_params_close(tcfg, model, jparams)
    if tcfg.moe is not None:
        assert float(tm["aux"]) > 0.0
    # the masters stay fp32 and serving's forward is unchanged by training
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())


def test_lm_train_step_in_bf16_matches_jax():
    """One qwen3 smoke step with ``compute_dtype=bfloat16``, the cast on as
    at full size: loss and grad_norm within 5e-3 relative. bf16 rounds each
    matmul input to 8 bits of mantissa (2^-9 relative); XLA's and torch's
    bf16 matmuls accumulate in fp32 in other orders, so the two losses
    differ by 1.4e-4 relative on this input and the grad norms by 3.2e-4;
    5e-3 holds both with room and is four times tighter than 2e-2. Parameters are not compared: an element whose bf16 gradient lies
    near zero may flip its sign, which moves it by 2·lr."""
    jcfg, tcfg, jparams, model = _lm("qwen3-1.7b")
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    b = _lm_batch(jcfg, 20)
    jparams, _, jm = jax.jit(jsteps.make_lm_train_step(jcfg, OPT))(
        jparams, jopt.adamw_init(jparams), b)
    model, _, tm = tsteps.make_lm_train_step(tcfg, TOPT, device="cpu")(
        model, topt.adamw_init(model.parameters()), b)
    assert _rel(tm["loss"], jm["loss"]) <= 5e-3
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 5e-3
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _dlrm_batch(cfg, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.n_rows, (n, cfg.n_sparse, cfg.nnz))
    mask = rng.random((n, cfg.n_sparse, cfg.nnz)) > 0.3
    # ids past both ends, read clamped by both packages
    ids[::7, :, -1] = rng.choice([-1, -2, cfg.n_rows, cfg.n_rows + 3, -cfg.n_rows - 2],
                                 ids[::7, :, -1].shape)
    return {"dense": rng.normal(size=(n, cfg.n_dense)).astype(np.float32),
            "sparse_ids": ids.astype(np.int32), "sparse_mask": mask,
            "labels": (rng.random(n) > 0.5).astype(np.int32)}


def test_dlrm_train_steps_match_jax():
    """Three steps of ``make_dlrm_train_step`` against JAX's: loss,
    grad_norm, lr, the parameters after steps 1 and 3 (the dense table
    gradient and weight decay move every row)."""
    jcfg = jreg.get_arch("dlrm-rm2").smoke_config()
    tcfg = treg.get_arch("dlrm-rm2").smoke_config()
    jparams = jax.jit(jdlrm.init_params, static_argnums=1)(jax.random.PRNGKey(5), jcfg)

    def to_port(tree):
        return tdlrm.from_jax_params(tcfg, tree)
    model = to_port(_np_tree(jparams))
    jstate = jopt.adamw_init(jparams)
    tstate = topt.adamw_state_from_jax(_np_tree(jstate), lambda t: to_port(t).parameters())
    jstep = jax.jit(jsteps.make_dlrm_train_step(jcfg, OPT))
    tstep = tsteps.make_dlrm_train_step(tcfg, TOPT, device="cpu")
    t0 = model.tables.detach().clone()
    for i in range(3):
        b = _dlrm_batch(jcfg, 128, seed=30 + i)
        jparams, jstate, jm = jstep(jparams, jstate, b)
        model, tstate, tm = tstep(model, tstate, b)
        _assert_metrics_close(tm, jm, ("loss", "grad_norm"))
        if i in (0, 2):
            want = to_port(_np_tree(jparams))
            for got, w in zip(model.parameters(), want.parameters()):
                np.testing.assert_allclose(got.detach().numpy(), w.numpy(), rtol=0,
                                           atol=PARAM_ATOL)
    assert bool((model.tables.detach() != t0).any(-1).all())     # every row moved


def test_adamw_update_in_small_groups_is_bit_equal(monkeypatch):
    """The chunked update (leaves split into flat slices and grouped) gives
    the bits of one group over every leaf, and leaves the grads alone."""
    rng = np.random.default_rng(8)
    shapes = [(7, 3), (5,), (2, 4, 3), (0,), (11, 2)]
    p0 = [torch.tensor(rng.normal(size=s).astype(np.float32)) for s in shapes]
    grads = [torch.tensor(rng.normal(size=s).astype(np.float32)) for s in shapes]
    g0 = [g.clone() for g in grads]
    out = []
    for chunk in (1 << 26, 5):
        monkeypatch.setattr(topt, "UPDATE_CHUNK", chunk)
        if chunk == 5:
            assert len(topt._update_groups(p0)) > len(shapes)
        params = [p.clone() for p in p0]
        state = topt.adamw_init(params)
        for _ in range(3):
            params, state, _ = topt.adamw_update(params, grads, state, TOPT)
        out.append((params, state))
    (pa, sa), (pb, sb) = out
    for i in range(len(shapes)):
        assert torch.equal(pa[i], pb[i])
        assert torch.equal(sa["m"][i], sb["m"][i]) and torch.equal(sa["v"][i], sb["v"][i])
        assert torch.equal(grads[i], g0[i])


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

def test_train_lm_resume_is_bitwise(tmp_path, capsys):
    """30 steps straight against 20 steps, a simulated preemption and a
    resume for the last 10: on the CPU every kernel is deterministic, so
    the losses and the final parameters are bit-equal."""
    kw = dict(smoke=True, steps=30, batch=2, seq=16, log_every=100, device="cpu")
    full = tlaunch.train_lm("qwen3-1.7b", **kw)
    ck = tmp_path / "ck"
    cut = tlaunch.train_lm("qwen3-1.7b", ckpt_dir=str(ck), ckpt_every=10, preempt_at=20, **kw)
    assert cut["preempted_at"] == 20 and cut["losses"] == full["losses"][:20]
    resumed = tlaunch.train_lm("qwen3-1.7b", ckpt_dir=str(ck), resume=True, **kw)
    assert "resumed from step 20" in capsys.readouterr().out
    assert resumed["losses"] == full["losses"][20:]
    for (name, a), b in zip(full["params"].named_parameters(), resumed["params"].parameters()):
        assert torch.equal(a, b), name
    assert full["losses"][-1] < full["losses"][0]


def test_train_cli_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "mistral-nemo-12b", "--steps", "3", "--batch", "2", "--seq",
                  "16", "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "final loss" in out and "step     2" in out
    assert (tmp_path / "LATEST").read_text().strip() == "step_000000000003"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = treg.get_arch("qwen3-1.7b").smoke_config()
    dl = treg.get_arch("dlrm-rm2").smoke_config()
    for build in (lambda: tsteps.make_lm_train_step(lm, TOPT),
                  lambda: tsteps.make_dlrm_train_step(dl, TOPT),
                  lambda: tlaunch.train_lm("qwen3-1.7b", steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # a model on another device than the step's is refused, not moved
    model = ttfm.init_params(lm, torch.Generator(), "cpu").to("meta")
    with pytest.raises(ValueError, match="not on cpu"):
        tsteps.make_lm_train_step(lm, TOPT, device="cpu")(
            model, {}, {k: torch.zeros((1, 16), dtype=torch.int32)
                        for k in ("tokens", "labels", "mask")})
