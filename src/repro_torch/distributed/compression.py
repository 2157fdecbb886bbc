"""Gradient compression for cross-replica sync — ``repro.distributed.compression``.

Stochastic-rounding int8 quantization (Seide et al. 2014 lineage): every
member quantizes its tensor with its own max-abs scale, the int8 payloads
sum exactly as int32, and the mean dequantizes with the mean scale — 4×
fewer wire bytes on a data-parallel all-reduce. On one device the members
are the leading axis of a stacked tensor and the ``psum`` is a sum over
it; every member draws its rounding noise from the same key, as every
device of JAX's ``shard_map`` program does.

The *deterministic* per-row quantizer of the index's vector codes lives in
``core.quantize`` (no key: ``codes == quantize_rows(vectors)`` must be
exactly re-checkable) and is re-exported here beside the stochastic one.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import prng
from repro_torch.core.quantize import (  # noqa: F401
    VECTOR_CODE_SCHEME,
    dequantize_rows,
    quantize_rows,
)


def _flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, rebuild) in ``jax.tree.flatten`` order: dict keys sorted,
    sequences by index."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        leaves = [x for p in parts for x in p[0]]

        def rebuild(xs):
            out, i = {}, 0
            for k, (ls, rb) in zip(keys, parts):
                out[k] = rb(xs[i:i + len(ls)])
                i += len(ls)
            return out
        return leaves, rebuild
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        leaves = [x for p in parts for x in p[0]]

        def rebuild(xs):
            out, i = [], 0
            for ls, rb in parts:
                out.append(rb(xs[i:i + len(ls)]))
                i += len(ls)
            return type(tree)(out)
        return leaves, rebuild
    return [tree], lambda xs: xs[0]


def quantize_int8(x: torch.Tensor, key: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization: (q i8, scale f32[]), the
    noise ``jax.random.uniform(key, x.shape, minval=-0.5, maxval=0.5)``
    bit for bit."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    y = x32 / scale
    noise = prng.uniform(key.to(x.device), x.numel(), -0.5, 0.5
                         ).reshape(x.shape)
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: Any, key: torch.Tensor) -> Any:
    """int8-compressed mean over the leading (member) axis of every leaf.

    Each leaf is ``[n, ...]``, one slice per member; the result has the
    leaf's trailing shape (the value every member holds after JAX's
    ``psum``). Leaf i quantizes with ``fold_in(key, i)`` (that is
    ``jax.random.split(key, n_leaves)[i]``), every member with the same
    key. The int32 sum is exact; the scales sum in fp32 in member order.
    """
    leaves, rebuild = _flatten(grads)
    out = []
    for i, leaf in enumerate(leaves):
        k = prng.fold_in(key.to(leaf.device), i)
        n = leaf.shape[0]
        q_sum, s_sum = None, None
        for m in range(n):
            q, scale = quantize_int8(leaf[m], k)
            q = q.to(torch.int32)
            q_sum = q if q_sum is None else q_sum + q
            s_sum = scale if s_sum is None else s_sum + scale
        # mean of the members' dequantized values ≈ (Σq · mean scale) / n
        mean_scale = s_sum / n
        out.append((q_sum.float() * mean_scale / n).to(leaf.dtype))
    return rebuild(out)


def wire_bytes_saved(grads: Any) -> tuple[int, int]:
    """(fp32 bytes, int8 bytes) for reporting."""
    leaves, _ = _flatten(grads)
    n = sum(int(torch.as_tensor(x).numel()) for x in leaves)
    return 4 * n, n + 4 * len(leaves)
