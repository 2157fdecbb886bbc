"""Threefry-2x32 counter-based PRNG, bit-compatible with ``jax.random``.

The JAX package draws every random number from threefry keys: the session's
base key and op-key chain, the per-lane entry-point folds of the beam engine
and the delete/insert chunk keys. ``torch.Generator`` cannot reproduce those
bits, and without them there is no parity of entry points and so none of
graph state, so the port carries its own generator.

Semantics follow jax 0.9 with ``jax_threefry_partitionable=True``:

  * a key is a pair of uint32 words; ``prng_key(seed) == [seed >> 32,
    seed & 0xFFFFFFFF]``;
  * ``fold_in(key, data) == threefry2x32(key, (0, data))``;
  * 32-bit random bits of element ``i`` of a flat draw are ``b0 ^ b1`` with
    ``(b0, b1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
  * ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2).

torch's uint32 support is partial, so words travel as non-negative int64
values and the rounds run in int32 (see :func:`threefry2x32`). A key tensor
has shape ``[..., 2]`` and holds the two words.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _as_i32(x) -> torch.Tensor:
    """uint32 words (int64 in [0, 2^32)) → the same bits as int32."""
    return torch.as_tensor(x, dtype=torch.int64).to(torch.int32)


def _threefry_i32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20 rounds on int32 tensors: two's-complement addition, left
    shift and xor give the uint32 bits, and the logical right shift is an
    arithmetic one with the sign bits masked off — half the bytes of the
    masked int64 form on a memory-bound chain of elementwise ops."""
    k0, k1, x0, x1 = (_as_i32(v) for v in (k0, k1, x0, x1))
    k2 = k0 ^ k1 ^ _as_i32(_PARITY)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + (ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function, broadcasting over all four
    operands (uint32 words held in int64). Returns the two output words as
    int64 in [0, 2^32)."""
    x0, x1 = _threefry_i32(k0, k1, x0, x1)
    return x0.to(torch.int64) & MASK32, x1.to(torch.int64) & MASK32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` key data as int64 ``[2]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (int or int tensor) broadcasts
    against the key's leading shape, giving one key per element."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def _bits_i32(key: torch.Tensor, n: int) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = _threefry_i32(key[..., 0, None], key[..., 1, None],
                           idx >> 32, idx & MASK32)
    return b0 ^ b1


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random bits ``[..., n]`` (int64 values in [0, 2^32)) for a key
    tensor ``[..., 2]`` — ``jax.random.bits(key, (n,))`` per key."""
    return _bits_i32(key, n).to(torch.int64) & MASK32


def uniform_mantissa(key: torch.Tensor, n: int) -> torch.Tensor:
    """The 23 mantissa bits behind ``uniform`` draws: ``uniform == m·2^-23``
    (clamped below at ``minval``), so ordering by ``m`` is ordering by the
    float draw. int32 ``[..., n]`` in [0, 2^23)."""
    return (_bits_i32(key, n) >> 9) & 0x7FFFFF


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    m = uniform_mantissa(key, n)
    floats = (m | 0x3F800000).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (``mode="low"``): ``-log(-log(u))`` over
    ``u = uniform(minval=tiny, maxval=1)``. The uniform draw is bit-exact;
    the two float32 logs are torch's, which can differ from XLA's by an ulp,
    so the result can too. Ranking code uses :func:`uniform_mantissa`
    instead, which orders the draws exactly as the monotone transform does.
    """
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))
