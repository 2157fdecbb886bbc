"""Synthetic ANN datasets — the port's own copy of ``repro.data.synthetic``.

The paper evaluates on SIFT (d=128), GloVe200 (d=200), NYTimes (d=256) and
GIST (d=960); the raw files are not in the repository, so these surrogates
stand in: SIFT/GIST as near-uniform Gaussian clouds, GloVe/NYTimes as skewed
Gaussian mixtures. ``make_dataset`` and ``kmeans`` give the same numpy
arrays as the JAX package's for the same arguments.
"""
from __future__ import annotations

import numpy as np

DATASET_SPECS = {
    # name: (dim, skewed?) — mirrors §6 "Data"
    "sift": (128, False),
    "glove200": (200, True),
    "nytimes": (256, True),
    "gist": (960, False),
}


def make_dataset(
    name: str,
    n: int,
    *,
    seed: int = 0,
    dim: int | None = None,
) -> np.ndarray:
    """Generate ``n`` float32 vectors shaped like the named benchmark set."""
    if name not in DATASET_SPECS:
        raise ValueError(f"unknown dataset {name!r}; have {list(DATASET_SPECS)}")
    d, skewed = DATASET_SPECS[name]
    d = dim if dim is not None else d
    rng = np.random.default_rng(seed)
    if not skewed:
        # near-uniform cloud with mild local structure
        base = rng.normal(0.0, 1.0, size=(n, d))
        return base.astype(np.float32)
    # skewed: Gaussian mixture with power-law component weights
    n_comp = max(8, d // 16)
    weights = rng.pareto(1.5, size=n_comp) + 1.0
    weights = weights / weights.sum()
    centers = rng.normal(0.0, 4.0, size=(n_comp, d))
    scales = rng.uniform(0.3, 1.2, size=n_comp)
    comp = rng.choice(n_comp, size=n, p=weights)
    out = centers[comp] + rng.normal(size=(n, d)) * scales[comp][:, None]
    return out.astype(np.float32)


def kmeans(x: np.ndarray, k: int, *, iters: int = 12, seed: int = 0
           ) -> np.ndarray:
    """Tiny k-means (labels only) for the clustered-update pattern (§6)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(x.shape[0], size=k, replace=False)].copy()
    labels = np.zeros(x.shape[0], np.int64)
    for _ in range(iters):
        # ||x - c||^2 = ||x||^2 - 2 x·c + ||c||^2 (chunked to bound memory)
        cn = (centers**2).sum(1)
        new_labels = np.empty_like(labels)
        for lo in range(0, x.shape[0], 65536):
            blk = x[lo:lo + 65536]
            d2 = cn[None, :] - 2.0 * blk @ centers.T
            new_labels[lo:lo + 65536] = d2.argmin(1)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for j in range(k):
            m = labels == j
            if m.any():
                centers[j] = x[m].mean(0)
    return labels
