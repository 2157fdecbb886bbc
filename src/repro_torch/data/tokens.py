"""Deterministic, resumable synthetic token stream for LM training.

Each batch is derived purely from (seed, step) — restarting at step k
reproduces the exact stream, which is what makes checkpoint/restart
bit-reproducible (asserted in tests/test_checkpoint.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        # markov-ish stream so the loss actually decreases
        base = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1))
        drift = np.arange(self.seq + 1) % max(self.vocab // 7, 1)
        toks = (base + drift) % self.vocab
        self.step += 1
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((self.batch, self.seq), bool),
        }

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, s: dict) -> None:
        self.step, self.seed = int(s["step"]), int(s["seed"])
