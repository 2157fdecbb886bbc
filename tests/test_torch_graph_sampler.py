"""The port's copies of the GNN data pipeline — ``data/graph_sampler.py``
and DimeNet's ``build_triplets`` — byte-equal to ``repro``'s for a seed."""
from __future__ import annotations

import numpy as np
import pytest

from repro.data import graph_sampler as jsampler
from repro.models.gnn.dimenet import build_triplets as jbuild_triplets
from repro_torch.data import graph_sampler as tsampler
from repro_torch.models.gnn.dimenet import build_triplets as tbuild_triplets

# fanout 4 and 2 against an average degree of 3: nodes above and below the
# fanout (sampled with replacement) and nodes of degree 0 (-1 padded)
FANOUT, BATCH = (4, 2), 64


def _equal(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _graphs(seed):
    return (jsampler.random_graph(200, 3, 5, 4, seed=seed),
            tsampler.random_graph(200, 3, 5, 4, seed=seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_graph_and_csr_equal(seed):
    jg, tg = _graphs(seed)
    for f in ("indptr", "indices", "feats", "labels"):
        _equal(getattr(jg, f), getattr(tg, f))
    assert (np.diff(tg.indptr) == 0).any()          # a node without neighbours


@pytest.mark.parametrize("seed", [0, 1])
def test_batches_across_epochs_equal(seed):
    """next_batch and as_subgraph interleaved over more than one epoch
    (200 nodes, 64 a batch): the same draws in the same order."""
    jg, tg = _graphs(seed)
    js = jsampler.NeighborSampler(jg, FANOUT, BATCH, seed=seed)
    ts = tsampler.NeighborSampler(tg, FANOUT, BATCH, seed=seed)
    padded = 0
    for i in range(7):
        kind = "as_subgraph" if i % 3 == 2 else "next_batch"
        jb, tb = getattr(js, kind)(), getattr(ts, kind)()
        _equal(jb, tb)
        assert ts.state.state_dict() == js.state.state_dict()
        mask = tb["node_mask"] if "node_mask" in tb else tb["blocks"]["masks"][0]
        padded += int((~mask).sum())
    assert ts.state.epoch == 2 and padded > 0       # -1 padding was drawn


@pytest.mark.parametrize("seed", [0, 1])
def test_state_dict_resume_equal(seed):
    """A sampler saved after three batches and resumed in a new sampler
    (same seed, ``load_state_dict``) draws what JAX's resumed one draws."""
    jg, tg = _graphs(seed)
    resumed = []
    for mod, g in ((jsampler, jg), (tsampler, tg)):
        s = mod.NeighborSampler(g, FANOUT, BATCH, seed=seed)
        for _ in range(3):
            s.next_batch()
        saved = s.state.state_dict()
        r = mod.NeighborSampler(g, FANOUT, BATCH, seed=seed)
        r.state.load_state_dict(saved)
        resumed.append((saved, [r.next_batch() for _ in range(2)], r.as_subgraph()))
    assert resumed[0][0] == resumed[1][0] == {"epoch": 0, "cursor": 192}
    _equal(resumed[0][1:], resumed[1][1:])


@pytest.mark.parametrize("cap", [64, 4096])
def test_build_triplets_equal(cap):
    """Capped and uncapped, on a graph with backtracking edges (k = i)."""
    rng = np.random.default_rng(cap)
    senders = rng.integers(0, 30, 200)
    receivers = (senders + 1 + rng.integers(0, 29, 200)) % 30
    senders[:20], receivers[:20] = receivers[20:40], senders[20:40]
    j = jbuild_triplets(senders, receivers, 200, cap)
    t = tbuild_triplets(senders, receivers, 200, cap)
    _equal(j, t)
    assert int(t["mask"].sum()) == (cap if cap == 64 else int(t["mask"].sum()))
    assert (cap == 64) == bool(t["mask"].all())
