"""Quickstart on the port: stream queries, inserts and deletes through a
TWO-TIER online index — a small exact fresh tier absorbing writes in front
of a large main tier, with a streaming merge draining fresh items into main
in bounded chunks behind the stream. The counterpart of
``examples/quickstart.py``, on ``repro_torch``'s ``TieredSession``.

    PYTHONPATH=src python tools/torch_quickstart.py --device cpu

Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (IndexParams, MaintenanceParams,  # noqa: E402
                              SearchParams, TieredSession)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # 1. main starts at 2,048 slots; max_capacity arms the growth engine, and
    #    the merge_* thresholds arm the streaming-merge trigger (fresh tier
    #    half full, or main 25% tombstones)
    params = IndexParams(
        capacity=2048, dim=64, d_out=12,
        search=SearchParams(pool_size=32, max_steps=96, num_starts=2),
        maintenance=MaintenanceParams(strategy="mask",  # main-tier tombstones
                                      merge_fresh_threshold=0.5,
                                      merge_tombstone_threshold=0.25,
                                      max_capacity=65536),
    )
    session = TieredSession(params, fresh_capacity=256, device=args.device)

    # 2. a base set in fresh-tier-sized waves; merges drain earlier waves
    X = rng.normal(size=(1000, 64)).astype(np.float32)
    ids = np.concatenate([
        np.asarray(session.insert(X[lo:lo + 256]).result()) for lo in range(0, 1000, 256)])
    print("inserted:", session.stats())

    # 3. one fan-out query over both tiers, deduplicated by external id
    Q = rng.normal(size=(64, 64)).astype(np.float32)
    session.query(Q, k=10).result()
    print(f"recall@10 before churn: {session.recall(Q, k=10):.3f}")

    # 4. churn: fresh-resident ids hard-delete, main-resident ids tombstone
    session.delete(ids[:200])
    session.insert(rng.normal(size=(200, 64)).astype(np.float32))
    session.flush()
    print(f"recall@10 after churn:  {session.recall(Q, k=10):.3f}")

    # 5. net growth past main's 2,048 slots: merge drains grow the main tier
    for _ in range(6):
        session.insert(rng.normal(size=(250, 64)).astype(np.float32))
    session.flush()
    st = session.stats()
    print(f"after net growth: n_alive={st['n_alive']} "
          f"main_capacity={st['main_capacity']} n_merges={st['n_merges']} "
          f"n_refused={st['n_refused']}")
    print("timers:", session.timers.to_dict())


if __name__ == "__main__":
    main()
