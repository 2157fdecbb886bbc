"""``repro_torch.data.tokens`` against ``repro.data.tokens``: the port's
copy of the resumable token stream gives byte-equal batches, and resumes
from its ``state_dict`` mid-stream."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from repro.data import tokens as jtok
from repro_torch.data import tokens as ttok

ROOT = Path(__file__).resolve().parents[1]


def test_the_copy_is_byte_equal_to_the_original():
    assert ((ROOT / "src/repro_torch/data/tokens.py").read_bytes()
            == (ROOT / "src/repro/data/tokens.py").read_bytes())


@pytest.mark.parametrize("seed", [0, 7])
def test_batches_are_byte_equal_across_steps(seed):
    a = jtok.TokenStream(vocab=151_936, batch=3, seq=17, seed=seed)
    b = ttok.TokenStream(vocab=151_936, batch=3, seq=17, seed=seed)
    for _ in range(5):
        x, y = a.next_batch(), b.next_batch()
        assert x.keys() == y.keys() == {"tokens", "labels", "mask"}
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
        # labels are the tokens shifted by one position
        assert np.array_equal(y["tokens"][:, 1:], y["labels"][:, :-1])
    assert a.state_dict() == b.state_dict() == {"step": 5, "seed": seed}


def test_state_dict_resume_continues_the_stream():
    full = ttok.TokenStream(vocab=128, batch=2, seq=16, seed=3)
    batches = [full.next_batch() for _ in range(6)]
    first = ttok.TokenStream(vocab=128, batch=2, seq=16, seed=3)
    for _ in range(4):
        first.next_batch()
    resumed = ttok.TokenStream(vocab=128, batch=2, seq=16, seed=99)
    resumed.load_state_dict(first.state_dict())
    for want in batches[4:]:
        got = resumed.next_batch()
        assert all(np.array_equal(got[k], want[k]) for k in want)
