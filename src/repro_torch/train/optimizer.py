"""AdamW (decoupled weight decay) built from scratch
(``repro.train.optimizer``).

It works on a list of parameter tensors, in place: a GNN model's
``ParamTree.leaves()``, which lists them in ``jax.tree.leaves``' order, so
``global_norm`` adds the leaves' squared norms in JAX's order. The state
holds m and v in fp32 beside each parameter and an int32 step counter;
the bias corrections and the schedule are computed in fp32 on the
parameters' device, as JAX computes them. The element-wise update runs as
``torch._foreach_*`` calls (a few launches for all leaves), each operation
rounded where JAX's expression rounds it.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr (fp32)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac)
    )
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    params = list(params)
    device = params[0].device if params else None
    return {
        "m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors) -> torch.Tensor:
    """√ of the leaves' sums of squares, added in the list's order."""
    total = None
    for t in tensors:
        sq = torch.sum(torch.square(t.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: list, grads: list, opt_state: dict, cfg: AdamWConfig
                 ) -> tuple[list, dict, dict]:
    """One step over ``params`` (updated in place) → (params, new_opt_state,
    metrics ``grad_norm``, ``lr``)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    # a true division (a Python number over a tensor is its reciprocal times)
    clip = torch.clamp(gnorm.new_tensor(cfg.grad_clip) / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    g = torch._foreach_mul([x.float() for x in grads], clip)
    m = torch._foreach_mul(opt_state["m"], cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    v = torch._foreach_mul(opt_state["v"], cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2))
    den = torch._foreach_sqrt(torch._foreach_div(v, b2c))
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(torch._foreach_div(m, b1c), den)
    torch._foreach_add_(upd, torch._foreach_mul(params, cfg.weight_decay))
    torch._foreach_sub_(params, torch._foreach_mul(upd, lr))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": m, "v": v, "step": step}, metrics
