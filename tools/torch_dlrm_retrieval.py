"""DLRM × IPGM on the port: the paper's motivating deployment.

A DLRM-RM2 bottom tower turns items' dense features into item
embeddings; a metric-ip ``IPGMIndex`` serves candidate retrieval while the
items churn (ads expire under GLOBAL repair, fresh ads are inserted).
Brute-force ``retrieval_scores`` (the ``score_topk`` kernel on the card) is
the exactness reference. The counterpart of ``examples/dlrm_retrieval.py``:
by default the items are inserted, as there (``--build insert``).
``--build bulk`` builds the index by exact kNN (``bulk_knn_build``) instead,
which reaches 10^6 items in seconds; its metric-ip graph keeps far fewer
edges a node than the inserted one, so its overlap is no operating point.

    PYTHONPATH=src python tools/torch_dlrm_retrieval.py --device cpu
    python tools/torch_dlrm_retrieval.py --build bulk --n-items 100000 \\
        --n-churn 256 --n-queries 1000 --capacity 131072 --d-out 32 --pool 64 \\
        --max-steps 128

Prints one JSON line: the top-10 overlap of the graph with brute force,
recall@10 after the churn, the seconds of each step and the index stats.
The tower is the smoke config's; ``chip_smoke.py``'s models phase runs
``run`` with the full DLRM-RM2 at the example's size (inserted) and over
10^6 items (bulk-built). Runs on the card unless
``--device cpu``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import registry as reg  # noqa: E402
from repro_torch.core import NULL, IndexParams, IPGMIndex, SearchParams  # noqa: E402
from repro_torch.core.rebuild import bulk_knn_build  # noqa: E402
from repro_torch.models import dlrm as dlrm_mod  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tower(model, dense: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Embeddings of the bottom MLP (the two-tower's item and user side)."""
    x = torch.as_tensor(dense, dtype=torch.float32).to(dev)
    return dlrm_mod._mlp(model.bot, x, final_act=True).contiguous()


def run(*, n_items: int = 1500, n_churn: int = 300, n_queries: int = 32,
        capacity: int = 2048, d_out: int = 12, pool: int = 32,
        max_steps: int = 96, k: int = 10, seed: int = 0, build: str = "insert",
        model=None, device=None) -> dict:
    """The flow of ``examples/dlrm_retrieval.py``; ``model`` defaults to a
    smoke-config DLRM drawn from ``seed``; ``build`` is ``"insert"`` (the
    example's) or ``"bulk"``. Returns what it measured."""
    if build not in ("insert", "bulk"):
        raise ValueError(f"build must be 'insert' or 'bulk', not {build!r}")
    dev = resolve_device(device)
    if model is None:
        cfg = reg.get_arch("dlrm-rm2").smoke_config()
        model = dlrm_mod.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    n_dense = model.cfg.n_dense
    rng = np.random.default_rng(seed)
    out: dict = {"n_items": n_items, "n_churn": n_churn, "n_queries": n_queries,
                 "build": build}

    # --- item corpus: embeddings from the DLRM bottom tower ---
    item_emb = tower(model, rng.normal(size=(n_items, n_dense)).astype(np.float32), dev)
    params = IndexParams(capacity=capacity, dim=item_emb.shape[1], d_out=d_out,
                         metric="ip",
                         search=SearchParams(pool_size=pool, max_steps=max_steps,
                                             num_starts=2))
    _sync(dev)
    t0 = time.perf_counter()
    if build == "insert":
        index = IPGMIndex(params, strategy="global", device=dev)
        ids = index.insert(item_emb.cpu().numpy())
    else:
        state = bulk_knn_build(item_emb, torch.ones(n_items, dtype=torch.bool, device=dev),
                               params, device=dev)
        index = IPGMIndex(params, strategy="global", state=state, device=dev)
        ids = np.arange(n_items, dtype=np.int32)
    _sync(dev)
    out["build_s"] = time.perf_counter() - t0

    # --- user queries through the same tower (the index API takes host rows) ---
    user_emb = tower(model, rng.normal(size=(n_queries, n_dense)).astype(np.float32), dev)
    users = user_emb.cpu().numpy()

    # graph retrieval against brute force (score_topk on the card)
    t0 = time.perf_counter()
    graph_ids, _ = index.query(users, k=k)
    out["query_s"] = time.perf_counter() - t0
    _, bf_ids = dlrm_mod.retrieval_scores(user_emb, item_emb, k)
    bf_ids = bf_ids.cpu().numpy()
    out["overlap_at_10"] = float(np.mean(
        [len(set(graph_ids[i]) & set(bf_ids[i])) / k for i in range(n_queries)]))

    # --- ad churn: expire n_churn items, insert as many fresh ones ---
    t0 = time.perf_counter()
    index.delete(ids[:n_churn])
    _sync(dev)
    out["delete_s"] = time.perf_counter() - t0
    fresh = tower(model, rng.normal(size=(n_churn, n_dense)).astype(np.float32), dev)
    t0 = time.perf_counter()
    new_ids = index.insert(fresh.cpu().numpy())
    _sync(dev)
    out["insert_s"] = time.perf_counter() - t0
    out["inserted"] = int((new_ids != NULL).sum())
    out["recall_at_10_after_churn"] = index.recall(users, k=k)
    ids, _ = index.query(users, k=k)
    alive = index.state.alive.cpu().numpy()
    out["graph_ids_alive"] = bool(alive[ids[ids != NULL]].all())
    out["alive"] = int(alive.sum())
    out["stats"] = index.stats()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--build", choices=("insert", "bulk"), default="insert")
    ap.add_argument("--n-items", type=int, default=1500)
    ap.add_argument("--n-churn", type=int, default=300)
    ap.add_argument("--n-queries", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--d-out", type=int, default=12)
    ap.add_argument("--pool", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(n_items=args.n_items, n_churn=args.n_churn, n_queries=args.n_queries,
              capacity=args.capacity, d_out=args.d_out, pool=args.pool,
              max_steps=args.max_steps, seed=args.seed, build=args.build, device=dev)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
