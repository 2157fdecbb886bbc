"""Decoder-only LM family (``repro.models.transformer``): the full-sequence
forward (training and prefill), the chunked LM loss and decode.

One config covers the five assigned transformers: GQA with a decoupled
d_head, RoPE with a per-arch theta (split halves), qk-norm (qwen3),
attention and final logit softcaps (gemma2), alternating local/global
layer patterns (gemma2's sliding window, llama4's chunked local layers
with NoPE global layers), the MoE FFN (phi3.5-moe top-2, llama4-scout
top-1 + shared expert), sandwich norms (gemma2) and tied embeddings.

JAX stacks the layers per pattern position and scans over period groups;
the port holds one ``nn.ModuleList`` entry per layer (layer ``l`` is group
``l // period``, position ``l % period``) and loops over them, and
``from_jax_params`` unstacks JAX's tree into it. The decode cache holds one
``(k, v)`` pair of ``[B, S_max, Hkv, dh]`` per layer. Under autograd the
attention recomputes each q block and ``chunked_xent`` each chunk's logits
in the backward pass, so neither ``[Sq, Sk]`` scores nor ``[B, S, V]``
logits are ever held.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # attention
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_scale: float | None = None                # None → d_head ** -0.5
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None                      # local attention width
    layer_pattern: tuple[str, ...] = ("global",)   # period pattern
    rope_on_global: bool = True                    # False → NoPE on global (iRoPE)
    sandwich_norm: bool = False                    # gemma2 post-norms
    embed_scale: bool = False                      # gemma scales by sqrt(d)
    # ffn
    moe: moe_mod.MoEConfig | None = None
    # execution
    compute_dtype: torch.dtype = torch.bfloat16
    block_q: int = 512
    block_kv: int = 512
    xent_chunk: int = 1024

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    def kind(self, layer: int) -> str:
        return self.layer_pattern[layer % self.period]

    def _attn_params(self) -> int:
        d, H, Hkv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        return d * H * dh + 2 * d * Hkv * dh + H * dh * d

    def _ffn_params(self, experts: int) -> int:
        d, f, m = self.d_model, self.d_ff, self.moe
        if m is None:
            return 3 * d * f  # SwiGLU
        n_in = 2 * f if m.gated else f
        ffn = d * m.n_experts + experts * (d * n_in + f * d)
        if m.n_shared:
            ffn += d * n_in * m.n_shared + f * m.n_shared * d
        return ffn

    def n_params(self) -> int:
        """Total parameter count (norm scales not counted)."""
        experts = self.moe.n_experts if self.moe is not None else 0
        return (self.n_layers * (self._attn_params() + self._ffn_params(experts))
                + self.vocab * self.d_model)

    def n_active_params(self) -> int:
        """Parameters a token activates (MoE top-k)."""
        experts = self.moe.top_k if self.moe is not None else 0
        return (self.n_layers * (self._attn_params() + self._ffn_params(experts))
                + self.vocab * self.d_model)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer's parameters: the norm scales, ``wq``/``wk``/
    ``wv``/``wo``, and ``w_gate``/``w_up``/``w_down`` or a ``moe``
    submodule."""

    def __init__(self, cfg: TransformerConfig, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            if name == "moe":
                self.moe = moe_mod.MoEFFN(cfg.moe, t)
            else:
                self.register_parameter(name, L.frozen(t))


class Transformer(nn.Module):
    """``embed [V, d]`` (tied with the LM head), ``layers``, ``ln_final``."""

    def __init__(self, cfg: TransformerConfig, embed, layers: list[dict],
                 ln_final):
        super().__init__()
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
        self.cfg = cfg
        self.embed = L.frozen(embed)
        self.layers = nn.ModuleList(Layer(cfg, t) for t in layers)
        self.ln_final = L.frozen(ln_final)

    def forward(self, tokens, *, return_cache_pad: int = 0):
        return forward(self, tokens, self.cfg, return_cache_pad=return_cache_pad)


def _init_layer(cfg: TransformerConfig, g: torch.Generator, device) -> dict:
    d, H, Hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                        cfg.d_ff)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    p = {"ln_attn": zeros(d),
         "wq": L.dense_init(g, d, H * dh, device=device),
         "wk": L.dense_init(g, d, Hkv * dh, device=device),
         "wv": L.dense_init(g, d, Hkv * dh, device=device),
         "wo": L.dense_init(g, H * dh, d, device=device),
         "ln_ffn": zeros(d)}
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(dh), zeros(dh)
    if cfg.sandwich_norm:
        p["ln_attn_post"], p["ln_ffn_post"] = zeros(d), zeros(d)
    if cfg.moe is not None:
        p["moe"] = {n: t.data for n, t in
                    moe_mod.init_moe(cfg.moe, g, device).named_parameters()}
    else:
        p["w_gate"] = L.dense_init(g, d, f, device=device)
        p["w_up"] = L.dense_init(g, d, f, device=device)
        p["w_down"] = L.dense_init(g, f, d, device=device)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random fp32 parameters drawn as JAX draws them (truncated normals
    at fan-in scale, zero norm scales), from ``generator`` on ``device``."""
    embed = L.truncated_normal(generator, (cfg.vocab, cfg.d_model), device)
    embed.mul_((1.0 / cfg.d_model) ** 0.5)
    layers = [_init_layer(cfg, generator, device) for _ in range(cfg.n_layers)]
    ln_final = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    return Transformer(cfg, embed, layers, ln_final)


def _unwrap(v, device):
    """A JAX parameter leaf: ``{"w": a}`` (dense) or ``{"scale": a}``
    (norm) → the tensor; the MoE dict → a dict of tensors."""
    if isinstance(v, dict) and set(v) in ({"w"}, {"scale"}):
        v = next(iter(v.values()))
    if isinstance(v, dict):
        return {k: _unwrap(a, device) for k, a in v.items()}
    return torch.from_numpy(np.array(v)).to(device)


def from_jax_params(cfg: TransformerConfig, tree: dict, device=None
                    ) -> Transformer:
    """``repro.models.transformer.init_params``'s tree (numpy leaves),
    its ``[n_groups, ...]`` stacks per pattern position unstacked into
    per-layer entries."""
    pos = tree["positions"]

    def layer(l):
        g, i = divmod(l, cfg.period)
        return {name: _unwrap(_index(v, g), device)
                for name, v in pos[f"p{i}"].items()}

    return Transformer(cfg, _unwrap(tree["embed"], device),
                       [layer(l) for l in range(cfg.n_layers)],
                       _unwrap(tree["ln_final"], device))


def _index(v, g):
    if isinstance(v, dict):
        return {k: _index(a, g) for k, a in v.items()}
    return np.asarray(v)[g]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _write_cache(cache: torch.Tensor, new: torch.Tensor, cache_len):
    """``cache.at[arange(B), cache_len].set(new)`` in place: a negative
    position counts from the end, and a position past the end is dropped,
    as JAX's scatter drops it."""
    B, S = cache.shape[:2]
    idx = torch.where(cache_len < 0, cache_len + S, cache_len)
    keep = (idx >= 0) & (idx < S)
    b = torch.arange(B, device=cache.device)
    slot = idx.clamp(0, S - 1).long()
    cache[b, slot] = torch.where(keep[:, None, None], new.to(cache.dtype),
                                 cache[b, slot])


def _attention(p, h, cfg: TransformerConfig, kind: str, *, kv_cache=None,
               cache_len=None):
    """Self-attention sublayer → (out, (k, v)): the prefill's k/v, or the
    layer's cache after this token's write."""
    B, S, _ = h.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.compute_dtype
    q = L.dense(p.wq, h, dtype=dt).reshape(B, S, H, dh)
    k = L.dense(p.wk, h, dtype=dt).reshape(B, S, Hkv, dh)
    v = L.dense(p.wv, h, dtype=dt).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(p.q_norm, q)
        k = L.rmsnorm(p.k_norm, k)
    if cfg.rope_on_global or kind == "local":
        ar = torch.arange(S, device=h.device)
        pos = ar[None, :] if kv_cache is None else cache_len[:, None] + ar[None, :]
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)

    window = cfg.window if kind == "local" else None
    if kv_cache is None:
        o = L.blockwise_attention(
            q, k, v, causal=True, window=window, block_q=cfg.block_q,
            block_kv=cfg.block_kv, attn_softcap=cfg.attn_softcap,
            scale=cfg.attn_scale)
    else:
        kc, vc = kv_cache                                        # [B, Smax, Hkv, dh]
        _write_cache(kc, k[:, 0], cache_len)
        _write_cache(vc, v[:, 0], cache_len)
        o = L.decode_attention(q, kc, vc, cache_len + 1, window=window,
                               attn_softcap=cfg.attn_softcap,
                               scale=cfg.attn_scale)
        k, v = kc, vc
    o = o.reshape(B, S, H * dh)
    return L.dense(p.wo, o, dtype=dt), (k, v)


def _ffn(p, h, cfg: TransformerConfig):
    dt = cfg.compute_dtype
    if cfg.moe is not None:
        return moe_mod.moe_ffn(p.moe, h.to(dt), cfg.moe)
    g = L.dense(p.w_gate, h, dtype=dt)
    u = L.dense(p.w_up, h, dtype=dt)
    return (L.dense(p.w_down, F.silu(g) * u, dtype=dt),
            torch.zeros((), device=h.device))


def _block(p, h, cfg: TransformerConfig, kind: str, **kw):
    a_out, kv = _attention(p, L.rmsnorm(p.ln_attn, h), cfg, kind, **kw)
    if cfg.sandwich_norm:
        a_out = L.rmsnorm(p.ln_attn_post, a_out)
    h = h + a_out
    f_out, aux = _ffn(p, L.rmsnorm(p.ln_ffn, h), cfg)
    if cfg.sandwich_norm:
        f_out = L.rmsnorm(p.ln_ffn_post, f_out)
    return h + f_out, kv, aux


def _embed(params, tokens, cfg: TransformerConfig):
    dt = cfg.compute_dtype
    h = params.embed[tokens].to(dt)
    if cfg.embed_scale:
        # the scale is rounded to the compute dtype first, as in JAX
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=h.device)
    return h


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            return_cache_pad: int = 0):
    """tokens i64/i32[B, S] → (hidden [B, S, d] in the compute dtype,
    aux_loss, cache | None).

    ``return_cache_pad > 0`` allocates decode KV caches of that length and
    fills the first S positions (the prefill path): ``{"kv": [(k, v) per
    layer], "len": i32[B]}``."""
    B, S = tokens.shape
    if return_cache_pad and return_cache_pad < S:
        raise ValueError(f"cache of {return_cache_pad} positions < prompt {S}")
    h = _embed(params, tokens, cfg)
    aux = torch.zeros((), device=h.device)
    kvs = []
    for l, layer in enumerate(params.layers):
        h, (k, v), a = _block(layer, h, cfg, cfg.kind(l))
        aux = aux + a
        if return_cache_pad:
            kvs.append(tuple(
                F.pad(x, (0, 0, 0, 0, 0, return_cache_pad - S)) for x in (k, v)))
    h = L.rmsnorm(params.ln_final, h)
    cache = None
    if return_cache_pad:
        cache = {"kv": kvs,
                 "len": torch.full((B,), S, dtype=torch.int32, device=h.device)}
    return h, aux, cache


def logits_from_hidden(params, h: torch.Tensor, cfg: TransformerConfig
                       ) -> torch.Tensor:
    """fp32 logits against the tied embedding, final softcap applied."""
    logit = h.float() @ params.embed.float().T
    if cfg.final_softcap is not None:
        logit = L.softcap(logit, cfg.final_softcap)
    return logit


def _chunk_nll(params, h, labels, mask, cfg: TransformerConfig) -> torch.Tensor:
    """Σ of one chunk's masked token losses: its [B, c, V] logits live only
    inside this call."""
    logits = logits_from_hidden(params, h, cfg)                  # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    return torch.where(mask, lse - gold, 0.0).sum()


def chunked_xent(params, h: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Sequence-chunked LM cross-entropy over ``cfg.xent_chunk`` positions a
    chunk, summed in chunk order and divided by the mask's count. Under
    autograd each chunk's logits are recomputed in the backward pass (JAX's
    ``jax.checkpoint(chunk_loss)``), so ``[B, S, V]`` is never held."""
    S = h.shape[1]
    c = min(cfg.xent_chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is no multiple of xent_chunk {c}")
    remat = torch.is_grad_enabled() and (h.requires_grad or params.embed.requires_grad)
    total = torch.zeros((), device=h.device)
    for lo in range(0, S, c):
        args = (params, h[:, lo:lo + c], labels[:, lo:lo + c], mask[:, lo:lo + c], cfg)
        nll = (checkpoint(_chunk_nll, *args, use_reentrant=False) if remat
               else _chunk_nll(*args))
        total = total + nll
    return total / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device=None):
    """An empty decode KV cache: one zero ``(k, v)`` pair per layer."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)

    def z():
        return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)

    return {"kv": [(z(), z()) for _ in range(cfg.n_layers)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(params, cache, tokens: torch.Tensor, cfg: TransformerConfig):
    """One-token decode: tokens [B, 1] → (logits f32[B, V], cache).

    The cache's k/v tensors are written in place (JAX returns new arrays);
    the returned cache holds them and ``len + 1``. A sequence whose cache is
    full drops its write, as JAX's scatter does, and attends over every
    position."""
    h = _embed(params, tokens, cfg)
    cache_len = cache["len"]
    new_kv = []
    for l, layer in enumerate(params.layers):
        h, kv, _ = _block(layer, h, cfg, cfg.kind(l), kv_cache=cache["kv"][l],
                          cache_len=cache_len)
        new_kv.append(kv)
    h = L.rmsnorm(params.ln_final, h)
    logits = logits_from_hidden(params, h[:, 0], cfg)
    return logits, {"kv": new_kv, "len": cache_len + 1}
