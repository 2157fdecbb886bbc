"""Faults planted in the program under a tiny run, for the tests that show
``correct`` can fail: each is one way a timed path can be wrong."""
from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "no_exchange")


def plant(fault: str) -> None:
    """Break the program in this process (its modules' attributes)."""
    import repro_torch.core.delete as delete
    import repro_torch.core.search as search
    import repro_torch.kernels.ref as ref
    from repro_torch.launch.mesh import CardGroup

    if fault == "state_unchanged":            # a delete step that changes nothing
        delete.delete_batch = lambda state, *a, **k: state
    elif fault == "half_batch":               # the second half of every query batch left out
        real = search.beam_search

        def half(state, queries, starts, params, **kw):
            res = real(state, queries, starts, params, **kw)
            h = queries.shape[0] // 2
            ids, scores = res.ids.clone(), res.scores.clone()
            ids[h:], scores[h:] = -1, float("-inf")
            return res._replace(ids=ids, scores=scores)
        search.beam_search = half
    elif fault == "answer_altered":           # a score altered where it is produced
        real_g = ref.gather_scores
        ref.gather_scores = lambda *a, **k: real_g(*a, **k) * (1 + 1e-3)
    elif fault == "no_exchange":              # the exchange between cards left out
        def local(self, t):
            return torch.cat([t] * self.world) if t.dim() else torch.stack([t] * self.world)
        CardGroup.all_gather = local
    else:
        raise ValueError(fault)


def faulty_rank_main(group, cell, seed, seconds, trace):
    """The sharded deployment's rank entry with ``cell.config["fault"]``
    planted in the rank first."""
    plant(cell.config["fault"])
    return REAL_RANK_MAIN(group, cell, seed, seconds, trace)


def _real():
    from ann_bench.deployments import sharded
    return sharded.rank_main


REAL_RANK_MAIN = _real()
