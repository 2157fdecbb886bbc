"""Routed mixture-of-experts FFN (``repro.models.moe``), forward only.

GShard/Switch semantics with scatter/gather dispatch: top-k routing over
fp32 router probabilities, a capacity of ``C = max(1, int(N·K·cf) // E)``
rows per expert taken per call (so in decode ``N`` is the batch), and the
tokens past an expert's capacity dropped in the order an exclusive
``cumsum`` over the flattened (token, k) list gives. A dropped row adds
zeros into buffer cell ``(0, 0)``, as JAX's masked scatter-add does.
Routing ties go to the lower expert, as ``lax.top_k`` breaks them
(``core/stable.py::top_k``). JAX's sharding hints (``_constrain`` and the
config's ``ep_axis``) have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.stable import top_k
from repro_torch.models.layers import dense_init, frozen, truncated_normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    n_shared: int = 0          # llama4-style always-on shared expert(s)
    gated: bool = True         # SwiGLU experts


class MoEFFN(nn.Module):
    """The MoE FFN's parameters: ``router [d, E]``, ``w_in [E, d, n_in]``,
    ``w_out [E, f, d]`` and, with shared experts, ``shared_in``/
    ``shared_out``."""

    def __init__(self, cfg: MoEConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        for name, t in tensors.items():
            self.register_parameter(name, frozen(t))

    def forward(self, x):
        return moe_ffn(self, x, self.cfg)


def init_moe(cfg: MoEConfig, generator: torch.Generator, device=None) -> MoEFFN:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n_in = 2 * f if cfg.gated else f

    def tn(shape, fan_in):
        return truncated_normal(generator, shape, device).mul_((1.0 / fan_in) ** 0.5)

    p = {"router": dense_init(generator, d, E, device=device),
         "w_in": tn((E, d, n_in), d),
         "w_out": tn((E, f, d), f)}
    if cfg.n_shared:
        p["shared_in"] = tn((d, n_in * cfg.n_shared), d)
        p["shared_out"] = tn((f * cfg.n_shared, d), f)
    return MoEFFN(cfg, p)


def from_jax_params(cfg: MoEConfig, tree: dict, device=None) -> MoEFFN:
    """``repro.models.moe.init_moe``'s tree (numpy arrays) → the module."""
    return MoEFFN(cfg, {name: torch.from_numpy(np.array(a)).to(device)
                        for name, a in tree.items()})


def _act(h: torch.Tensor, gated: bool) -> torch.Tensor:
    if gated:
        u, g = h.chunk(2, dim=-1)
        return u * F.silu(g)
    return F.gelu(h, approximate="tanh")      # jax.nn.gelu's default


def _expert_ffn(x, w_in, w_out, gated: bool, dtype):
    """[E, C, d] → [E, C, d]: each expert's FFN over its buffer."""
    h = torch.bmm(x, w_in.to(dtype))
    return torch.bmm(_act(h, gated), w_out.to(dtype))


def route(params, xf: torch.Tensor, cfg: MoEConfig):
    """Routing of N tokens ``xf [N, d]``: (probs f32[N, E], gate weights
    f32[N, K], experts i64[N, K], slot i64[N·K] in the expert's buffer,
    keep bool[N·K], capacity C)."""
    N = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(N * K * cfg.capacity_factor) // E)
    logits = xf.float() @ params.router.float()
    probs = torch.softmax(logits, dim=-1)                      # [N, E]
    gate_w, gate_e = top_k(probs, K)                           # [N, K]
    if K > 1:
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    flat_e = gate_e.reshape(-1)                                # [N*K]
    onehot = F.one_hot(flat_e, E)                              # [N*K, E]
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot            # exclusive count
    slot = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    return probs, gate_w, gate_e, slot, slot < C, C


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., d] → (y: [..., d], aux_loss f32 scalar). Over-capacity
    tokens are dropped: their routed part is zero (the residual passes)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    dtype = x.dtype
    xf = x.reshape(-1, d)
    N = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    probs, gate_w, gate_e, slot, keep, C = route(params, xf, cfg)

    # load-balancing aux loss (Switch eq. 4, as JAX computes it: ``ce`` is
    # the mean over experts, a scalar)
    me = probs.mean(0)
    if K == 1:
        ce = (F.one_hot(gate_e[:, 0], E).float().sum(0) / N).mean() * E
    else:
        ce = (F.one_hot(gate_e, E).float().sum((0, 1)) / (N * K)).mean() * E
    aux = (me * ce).sum() * E

    # ---- scatter tokens into per-expert buffers [E, C, d] ----
    flat_e = gate_e.reshape(-1)
    xs = xf.repeat_interleave(K, dim=0)                        # [N*K, d]
    se = torch.where(keep, flat_e, 0)
    ss = torch.where(keep, slot, 0)
    buf = torch.zeros((E, C, d), dtype=dtype, device=x.device)
    buf.index_put_((se, ss), torch.where(keep[:, None], xs, 0).to(dtype),
                   accumulate=True)
    y = _expert_ffn(buf, params.w_in, params.w_out, cfg.gated, dtype)

    # ---- gather back + gate-weighted combine ----
    out_rows = torch.where(keep[:, None], y[se, ss], 0)        # [N*K, d]
    w = gate_w.reshape(-1)[:, None].to(dtype)
    combined = (out_rows * w).reshape(N, K, d).sum(1)

    if cfg.n_shared:
        h = xf.to(dtype) @ params.shared_in.to(dtype)
        combined = combined + _act(h, cfg.gated) @ params.shared_out.to(dtype)
    return combined.reshape(orig_shape), aux
