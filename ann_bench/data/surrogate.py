"""The SIFT-shaped surrogate: ``x = z·A + noise·ε``.

``z ~ N(0, I_rank)``, ``A`` a seeded ``rank × dim`` matrix with entries
``N(0, 1/rank)`` and ``ε ~ N(0, I_dim)``: every coordinate has variance
``1 + noise²``, and the vectors lie near a ``rank``-dimensional subspace,
as SIFT descriptors lie near a low-dimensional one. Queries and inserted
rows come from the same law as the base.

Everything is drawn on the given device from ``torch.Generator``s seeded
from the run's seed and a tag, in blocks of large calls. ``z·A`` is
summed one rank term at a time with ``addcmul_``, so the bytes depend on
the device type alone and not on a matrix-multiply algorithm: two
processes on two cards of one kind draw the same rows.
"""
from __future__ import annotations

import hashlib
import math

import torch

DRAW_BLOCK = 1 << 18          # rows drawn per call


def subseed(seed: int, *tag) -> int:
    """A 63-bit seed for one stream of draws: the run's seed and a tag."""
    h = hashlib.blake2b(repr((int(seed),) + tag).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, *tag) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(subseed(seed, *tag))
    return g


class Law:
    """The surrogate's law for one run: its basis ``A`` is drawn once."""

    def __init__(self, dim: int, rank: int, noise: float, seed: int, device):
        self.dim, self.rank, self.noise = int(dim), int(rank), float(noise)
        self.seed = int(seed)
        self.device = torch.device(device)
        g = generator(self.device, self.seed, "basis")
        self.basis = torch.randn(self.rank, self.dim, generator=g,
                                 device=self.device) / math.sqrt(self.rank)

    @classmethod
    def from_config(cls, data: dict, seed: int, device) -> "Law":
        return cls(data["dim"], data["rank"], data["noise"], seed, device)

    def draw(self, n: int, *tag) -> torch.Tensor:
        """f32 ``[n, dim]`` on the law's device, a pure function of the
        run's seed, ``tag`` and ``n``."""
        g = generator(self.device, self.seed, *tag)
        out = torch.empty((n, self.dim), dtype=torch.float32, device=self.device)
        for lo in range(0, n, DRAW_BLOCK):
            m = min(DRAW_BLOCK, n - lo)
            z = torch.randn((m, self.rank), generator=g, device=self.device)
            x = out[lo:lo + m]
            x.copy_(torch.randn((m, self.dim), generator=g, device=self.device))
            x.mul_(self.noise)
            for j in range(self.rank):
                x.addcmul_(z[:, j:j + 1], self.basis[j])
        return out
