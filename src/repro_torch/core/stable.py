"""Tie-exact counterparts of the JAX primitives the index relies on.

``lax.top_k`` orders floats by their IEEE total order (+0.0 above -0.0) and
breaks ties toward the lower index; ``torch.topk`` promises no tie order.
``top_k`` below packs (total-order key, reversed index) into one unique
int64 key, so the order is fully determined on every device.

JAX's ``.at[].set(mode="drop")`` / ``.min`` / ``.max`` scatters become a
boolean lane mask followed by ``index_put_`` / ``scatter_reduce_``. Callers
keep the JAX code's guarantee that no two live lanes of a ``set`` write
different values to one slot (CUDA picks a nondeterministic winner).
"""
from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 key whose integer order is ``lax.top_k``'s value order: the
    IEEE total order for float32, the value itself for integers/bools."""
    if x.dtype == torch.float32:
        bits = x.contiguous().view(torch.int32)
        return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    if x.dtype.is_floating_point:
        raise TypeError(f"order_key supports float32 only, got {x.dtype}")
    return x.to(torch.int64)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, int64 indices), values
    descending, ties to the lower index. Integer inputs must fit in int32."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    comp = (order_key(x) << 32) | (_LOW32 - idx)
    _, pos = torch.topk(comp, k, dim=-1, largest=True, sorted=True)
    return torch.gather(x, -1, pos), pos


def argmax_first(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.argmax`` of a bool tensor: the first True along ``dim`` (0 when
    there is none)."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


def set_drop(dst: torch.Tensor, idx: torch.Tensor, values, keep: torch.Tensor
             ) -> torch.Tensor:
    """``dst.at[where(keep, idx, OOB)].set(values, mode="drop")`` in place.

    ``idx`` indexes ``dst``'s first axis; ``values`` broadcasts against the
    lanes (scalar, ``[R]`` or ``[R, ...]``)."""
    if not torch.is_tensor(values):
        values = torch.tensor(values, dtype=dst.dtype, device=dst.device)
    values = values.to(dst.dtype)
    if values.dim() > 0 and values.shape[0] == idx.shape[0]:
        values = values[keep]
    dst[idx[keep].long()] = values
    return dst


def scatter_min_(dst: torch.Tensor, idx: torch.Tensor, values: torch.Tensor
                 ) -> torch.Tensor:
    """``dst.at[idx].min(values)`` in place (1-D, repeated indices fine)."""
    return _scatter_reduce_(dst, idx, values, "amin")


def scatter_max_(dst: torch.Tensor, idx: torch.Tensor, values: torch.Tensor
                 ) -> torch.Tensor:
    """``dst.at[idx].max(values)`` in place (1-D, repeated indices fine)."""
    return _scatter_reduce_(dst, idx, values, "amax")


def _scatter_reduce_(dst, idx, values, how):
    if dst.dtype == torch.bool:
        tmp = dst.to(torch.uint8)
        tmp.scatter_reduce_(0, idx.long(), values.to(torch.uint8), how)
        dst.copy_(tmp.bool())
        return dst
    return dst.scatter_reduce_(0, idx.long(), values.to(dst.dtype), how)
