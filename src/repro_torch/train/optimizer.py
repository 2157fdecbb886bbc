"""AdamW (decoupled weight decay) built from scratch
(``repro.train.optimizer``).

It works on a list of parameter tensors, in place: a GNN model's
``ParamTree.leaves()``, which lists them in ``jax.tree.leaves``' order, so
``global_norm`` adds the leaves' squared norms in JAX's order. The state
holds m and v in fp32 beside each parameter and an int32 step counter;
the bias corrections and the schedule are computed in fp32 on the
parameters' device, as JAX computes them. The element-wise update runs as
``torch._foreach_*`` calls, each operation rounded where JAX's expression
rounds it, in place on the parameters, m and v. It goes over groups of at
most ``UPDATE_CHUNK`` elements (a leaf larger than that in flat slices), so
its temporaries stay a few times that size whatever the model (a few
launches for all the leaves of a small model).
"""
from __future__ import annotations

import dataclasses
import math

import torch

# elements of one group of the update: its temporaries (about five of them)
# stay near 1.3 GB in fp32, where a whole-model group would need 5 copies of
# a 1.7 G-parameter model or of DLRM-RM2's 1.7 G-row tables
UPDATE_CHUNK = 1 << 26


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


def _update_groups(tensors: list) -> list[list[tuple[int, int, int]]]:
    """The flat pieces of ``tensors``, as (leaf, start, stop), grouped so
    that a group holds at most ``UPDATE_CHUNK`` elements."""
    groups, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        n = t.numel()
        for lo in range(0, max(n, 1), UPDATE_CHUNK):
            hi = min(n, lo + UPDATE_CHUNK)
            if cur and size + hi - lo > UPDATE_CHUNK:
                groups.append(cur)
                cur, size = [], 0
            cur.append((i, lo, hi))
            size += hi - lo
    if cur:
        groups.append(cur)
    return groups


@torch.no_grad()
def adamw_update(params: list, grads: list, opt_state: dict, cfg: AdamWConfig
                 ) -> tuple[list, dict, dict]:
    """One step over ``params`` → (params, new_opt_state, metrics
    ``grad_norm``, ``lr``). The parameters and ``opt_state``'s m and v are
    updated in place (the new state holds the same tensors); the grads are
    only read."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    # a true division (a Python number over a tensor is its reciprocal times)
    clip = torch.clamp(gnorm.new_tensor(cfg.grad_clip) / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    m_all, v_all = opt_state["m"], opt_state["v"]
    for group in _update_groups(params):
        p = [params[i].view(-1)[lo:hi] for i, lo, hi in group]
        m = [m_all[i].view(-1)[lo:hi] for i, lo, hi in group]
        v = [v_all[i].view(-1)[lo:hi] for i, lo, hi in group]
        g = torch._foreach_mul([grads[i].float().reshape(-1)[lo:hi] for i, lo, hi in group],
                               clip)
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(v, cfg.b2)
        gg = torch._foreach_mul(g, g)
        del g
        torch._foreach_mul_(gg, 1 - cfg.b2)
        torch._foreach_add_(v, gg)
        del gg
        den = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(m, b1c)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p, upd)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": m_all, "v": v_all, "step": step}, metrics


def adamw_state_from_jax(state: dict, to_params) -> dict:
    """``repro``'s AdamW state (numpy leaves) → the port's: m and v each
    through ``to_params`` (a JAX parameter tree → the port's list of leaves
    in the step's order, e.g. a model's ``from_jax_params`` and its
    parameters), the step counter as int32 on their device."""
    m = [t.detach() for t in to_params(state["m"])]
    v = [t.detach() for t in to_params(state["v"])]
    step = torch.tensor(int(state["step"]), dtype=torch.int32,
                        device=m[0].device if m else None)
    return {"m": m, "v": v, "step": step}
