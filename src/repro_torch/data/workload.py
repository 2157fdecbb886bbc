"""Online-update workload builder — the port's copy of ``repro.data.workload``.

Paper protocol (§6): from a base set, run ``n_steps`` batches; each batch
deletes ``batch_size`` vectors, inserts ``batch_size`` fresh vectors, then
issues ``n_queries`` top-K queries. Two update patterns:

  random    base/delete/insert/query drawn from a global permutation.
  clustered k-means the corpus into 10 clusters, lay the clusters out in
            sequence, and delete/insert whole cluster spans (a vector AND
            its nearest neighbours expire together — the hard case for edge
            repair, §6.1.2).

Deletes are positions in the live pool (base, then each step's inserts in
order); the driver maps them to graph ids.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import kmeans, make_dataset


@dataclasses.dataclass
class UpdateWorkload:
    base: np.ndarray                  # [n_base, d] initial corpus
    step_deletes: list[np.ndarray]    # per-step positions in the live pool
    step_inserts: list[np.ndarray]    # per-step fresh vectors
    queries: np.ndarray               # [n_query, d], reused every step
    pattern: str
    cursor: int = 0                   # resumable step pointer

    @property
    def n_steps(self) -> int:
        return len(self.step_inserts)

    def state_dict(self) -> dict:
        return {"cursor": self.cursor}

    def load_state_dict(self, s: dict) -> None:
        self.cursor = int(s["cursor"])


def make_workload(dataset: str, *, n_base: int = 9000, n_steps: int = 10,
                  batch_size: int = 1000, n_queries: int = 1000,
                  pattern: str = "random", seed: int = 0,
                  dim: int | None = None) -> UpdateWorkload:
    """Build the §6 workload at any scale (paper: 900k/10k/10k)."""
    assert pattern in ("random", "clustered")
    total = n_base + n_steps * batch_size + n_queries
    x = make_dataset(dataset, total, seed=seed, dim=dim)
    rng = np.random.default_rng(seed + 1)

    if pattern == "random":
        perm = rng.permutation(total)
        x = x[perm]
        base = x[:n_base]
        ins_pool = x[n_base:n_base + n_steps * batch_size]
        queries = x[n_base + n_steps * batch_size:]
        step_inserts = [ins_pool[i * batch_size:(i + 1) * batch_size]
                        for i in range(n_steps)]
        # a step removes first, then digests its inserts
        live = np.zeros(n_base + n_steps * batch_size, bool)
        live[:n_base] = True
        step_deletes = []
        for i in range(n_steps):
            pick = rng.choice(np.flatnonzero(live), size=batch_size,
                              replace=False)
            live[pick] = False
            step_deletes.append(pick)
            live[n_base + i * batch_size: n_base + (i + 1) * batch_size] = True
    else:
        # order the corpus by cluster; base = leading span, each step deletes
        # the oldest remaining span and inserts the next one
        corpus = x[:n_base + n_steps * batch_size]
        queries = x[n_base + n_steps * batch_size:]
        labels = kmeans(corpus, 10, seed=seed)
        order = np.argsort(labels, kind="stable")
        corpus = corpus[order]
        base = corpus[:n_base]
        step_inserts = [corpus[n_base + i * batch_size:
                               n_base + (i + 1) * batch_size]
                        for i in range(n_steps)]
        step_deletes = [np.arange(i * batch_size, (i + 1) * batch_size)
                        for i in range(n_steps)]

    return UpdateWorkload(
        base=base,
        step_deletes=[d.astype(np.int64) for d in step_deletes],
        step_inserts=list(step_inserts), queries=queries, pattern=pattern)
