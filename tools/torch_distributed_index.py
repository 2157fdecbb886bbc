"""The sharded online index on the port: 8 shards of a (4, 2) mesh, routed
inserts, fan-out queries with a hierarchical top-k merge, GLOBAL delete
repair shard by shard. The counterpart of ``examples/distributed_index.py``:
``repro_torch``'s ``ShardedSession`` stacks the shards on one device, so no
forced device count is needed.

    PYTHONPATH=src python tools/torch_distributed_index.py --device cpu

Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.params import IndexParams, SearchParams  # noqa: E402
from repro_torch.distributed.ann import DistParams, ShardedSession, ShardMesh  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mesh = ShardMesh((4, 2), ("data", "model"))
    dp = DistParams(index=IndexParams(
        capacity=128, dim=32, d_out=8,
        search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
    ))
    rng = np.random.default_rng(0)

    # the session owns the stacked per-shard state (updated in place)
    sess = ShardedSession(dp, mesh, strategy="global", seed=0, device=args.device)
    X = rng.normal(size=(400, 32)).astype(np.float32)
    gids = sess.insert(X, np.arange(400))
    print("inserted:", int((gids.cpu().numpy() >= 0).sum()), "across",
          int(np.prod(mesh.shape)), "shards")

    Q = rng.normal(size=(16, 32)).astype(np.float32)
    ids, _ = sess.query(Q)
    print("query results (global ids):", ids.cpu().numpy()[0, :5])

    sess.delete(gids.cpu().numpy()[:100])
    sess.flush()
    print("alive after GLOBAL delete of 100:", sess.n_alive())
    print("timers:", sess.timers.to_dict())


if __name__ == "__main__":
    main()
