"""Shared layers of the model zoo (``repro.models.layers``).

Plain functions on tensors. A dense layer's parameter is its ``[d_in,
d_out]`` weight and a norm's its scale vector (JAX nests each in a dict).
Attention scores in fp32 whatever the compute dtype, as in JAX; nothing
here is a library attention, so the masking and the running-softmax
algorithm are JAX's own.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def truncated_normal(generator: torch.Generator, shape, device=None
                     ) -> torch.Tensor:
    """fp32 normal draws truncated to [-2, 2] (``jax.random.truncated_normal
    (key, -2, 2, shape)``); the generator lives on ``device``."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None, device=None) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    return truncated_normal(generator, (d_in, d_out), device).mul_(scale)


def dense(w: torch.Tensor, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """``x @ w``, both cast to ``dtype`` when given."""
    if dtype is not None:
        w, x = w.to(dtype), x.to(dtype)
    return x @ w


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm in fp32 with the ``(1 + scale)`` convention (scale starts at
    zero), cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, correction=0, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style tanh logit capping."""
    return torch.tanh(x / cap) * cap


def cast_weights_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Serving checkpoints' cast (``launch/cells.py:_bf16_serving``): every
    float32 parameter of two or more dimensions becomes ``dtype`` in place;
    norm scales stay float32."""
    for p in module.parameters():
        if p.dtype == torch.float32 and p.dim() >= 2:
            p.data = p.data.to(dtype)
    return module


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that serving never differentiates; a train step turns
    ``requires_grad`` on for the leaves it differentiates."""
    return nn.Parameter(t, requires_grad=False)


class _TakeRows(torch.autograd.Function):
    """``x.index_select(0, read)`` whose gradient adds into rows ``write``
    instead; a write id of ``x.shape[0]`` lands in a spare row and is
    dropped."""

    @staticmethod
    def forward(ctx, x, read, write):
        ctx.save_for_backward(write)
        ctx.shape = x.shape
        return x.index_select(0, read)

    @staticmethod
    def backward(ctx, grad):
        write, = ctx.saved_tensors
        n = ctx.shape[0]
        out = grad.new_zeros((n + 1,) + tuple(ctx.shape[1:]))
        return out.index_add_(0, write, grad)[:n], None, None


def take_rows(x: torch.Tensor, read: torch.Tensor, write) -> torch.Tensor:
    """``x.index_select(0, read)``; under autograd its gradient adds into
    the rows ``write()`` gives (a callable, so that a path that is not
    differentiated computes no write ids)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _TakeRows.apply(x, read, write())
    return x.index_select(0, read)


def jax_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis as JAX computes it and its gradient:
    a negative id counts from the end; the read clamps what is still out of
    ``[0, n)``, and the gradient (XLA's scatter, the gather's transpose)
    drops it."""
    n = x.shape[0]
    wrapped = torch.where(idx < 0, idx + n, idx)
    return take_rows(x, wrapped.clamp(0, n - 1),
                     lambda: torch.where((wrapped >= 0) & (wrapped < n), wrapped, n))


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, d_head]; positions broadcastable to [..., S]. Rotates
    the split halves ``(x1, x2)`` of each head, not interleaved pairs."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)       # [d/2]
    angles = positions[..., None].float() * freqs                 # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]                         # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention — O(block) memory, fp32 scores
# ---------------------------------------------------------------------------

def _attn_block(q, k, qpos, kpos, *, scale, causal, window, attn_softcap, full=False):
    """Masked fp32 scores of one (q-block, kv-block) tile.

    q: [B, bq, Hq, dh]  k: [B, bk, Hkv, dh]; GQA by head grouping (query
    head h reads kv head h // g). Returns s: [B, Hkv, g, bq, bk]. ``full``
    says that every pair of the tile is visible, so the mask is all True
    and is not built."""
    B, bq, Hq, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, bq, Hkv, Hq // Hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    if full:
        return s
    mask = (kpos >= 0)[None, :]                                  # padding blocks
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return s.masked_fill(~mask, float("-inf"))


def _q_block(qb, k, v, qpos, kpos_all, kv_blocks: list, block_kv: int, *,
             scale, causal, window, attn_softcap):
    """One q block against the kv blocks ``kv_blocks``, a list of (block
    index, every pair visible), in order: the running max and sum over fp32
    scores → [B, bq, Hq, dh] in q's dtype."""
    B, bq, Hq, dh = qb.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    dev = qb.device
    m = torch.full((B, Hkv, g, bq), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, g, bq), device=dev)
    o = torch.zeros((B, Hkv, g, bq, dh), device=dev)
    for j, full in kv_blocks:
        ks = slice(j * block_kv, (j + 1) * block_kv)
        s = _attn_block(qb, k[:, ks], qpos, kpos_all[ks], scale=scale,
                        causal=causal, window=window,
                        attn_softcap=attn_softcap, full=full)   # [B,Hkv,g,bq,bk]
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, ks].float())
        o = o * corr[..., None] + pv
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    # [B,Hkv,g,bq,dh] → [B,bq,Hq,dh]
    return o.permute(0, 3, 1, 2, 4).reshape(B, bq, Hq, dh).to(qb.dtype)


def blockwise_attention(
    q: torch.Tensor,             # [B, Sq, Hq, dh]
    k: torch.Tensor,             # [B, Sk, Hkv, dh]
    v: torch.Tensor,             # [B, Sk, Hkv, dh]
    *,
    causal: bool = True,
    window: int | None = None,   # local/sliding width (None = full)
    q_offset: int = 0,           # absolute position of q[0]
    block_q: int = 512,
    block_kv: int = 512,
    attn_softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Memory-efficient attention: loops over q-blocks × kv-blocks with a
    running max and sum (never materialises [Sq, Sk]).

    With a ``window`` only ``(window + block_q) // block_kv + 1`` kv blocks
    are visited per q block, starting near the diagonal; a causal q block
    skips the kv blocks wholly past its last row (JAX visits them, and they
    leave its sums bit for bit as they are). Under autograd each
    q block is recomputed in the backward pass (JAX recomputes each kv step,
    ``jax.checkpoint(kv_step)``), so no block's fp32 scores or probabilities
    outlive its forward."""
    B, Sq0, Hq, dh = q.shape
    Sk0 = k.shape[1]
    scale = dh ** -0.5 if scale is None else scale
    block_q = min(block_q, Sq0)
    block_kv = min(block_kv, Sk0)
    # pad ragged tails; padded keys are masked through kpos = -1
    pq, pk = (-Sq0) % block_q, (-Sk0) % block_kv
    if pq:
        q = nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    Sq, Sk = Sq0 + pq, Sk0 + pk
    nq, nk = Sq // block_q, Sk // block_kv
    n_kv_blocks = nk if window is None else min(nk, (window + block_q) // block_kv + 1)

    dev = q.device
    ar = torch.arange(Sk, device=dev)
    kpos_all = torch.where(ar < Sk0, ar, -1)
    qpos_all = torch.arange(Sq, device=dev) + q_offset
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(nq):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        q_lo, q_hi = qi * block_q + q_offset, (qi + 1) * block_q - 1 + q_offset
        if window is not None:
            # first kv position possibly visible to this q block
            lo = min(max(q_lo - window + 1, 0), Sk - n_kv_blocks * block_kv)
            k0 = lo // block_kv
        else:
            k0 = 0
        k_end = k0 + n_kv_blocks
        if causal:
            # every row has seen its own position by then, so its max is
            # finite, and a wholly masked block adds exact zeros to l and o
            k_end = min(k_end, max(k0 + 1, q_hi // block_kv + 1))
        kv_blocks = []
        for j in range(k0, k_end):
            k_first, k_last = j * block_kv, (j + 1) * block_kv - 1
            full = (k_last < Sk0 and (not causal or k_last <= q_lo)
                    and (window is None or q_hi - k_first < window))
            kv_blocks.append((j, full))
        args = (q[:, qs], k, v, qpos_all[qs], kpos_all, kv_blocks, block_kv)
        kw = dict(scale=scale, causal=causal, window=window, attn_softcap=attn_softcap)
        if remat:
            outs.append(checkpoint(_q_block, *args, use_reentrant=False, **kw))
        else:
            outs.append(_q_block(*args, **kw))
    return torch.cat(outs, dim=1)[:, :Sq0]


def decode_attention(
    q: torch.Tensor,          # [B, 1, Hq, dh]
    k_cache: torch.Tensor,    # [B, S, Hkv, dh]
    v_cache: torch.Tensor,    # [B, S, Hkv, dh]
    cache_len: torch.Tensor,  # i32[B] — valid prefix length per sequence
    *,
    window: int | None = None,
    attn_softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention against a (possibly windowed) KV cache."""
    B, S, Hkv, dh = k_cache.shape
    Hq = q.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, Hq // Hkv, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    kpos = torch.arange(S, device=q.device)[None, :]             # [1, S]
    valid = kpos < cache_len[:, None]
    if window is not None:
        valid = valid & (kpos >= cache_len[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, dh).to(q.dtype)
