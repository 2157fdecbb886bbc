"""The sharded online index on the port: 8 shards of a (4, 2) mesh, routed
inserts, fan-out queries with a hierarchical top-k merge, GLOBAL delete
repair shard by shard. The counterpart of ``examples/distributed_index.py``.
With ``--ranks 1`` (the default) ``repro_torch``'s ``ShardedSession`` stacks
the shards on one device, so no device count is needed; with ``--ranks W``
(W divides 8) W processes each hold 8/W shards, one card a rank over NCCL,
or gloo with ``--device cpu``, and print the same ids and counts.

    PYTHONPATH=src python tools/torch_distributed_index.py --device cpu
    PYTHONPATH=src python tools/torch_distributed_index.py --device cpu --ranks 2

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
from repro_torch.launch.mesh import run_on_ranks  # noqa: E402


def run(group, device) -> list[str]:
    """The stream on this process's shards (all of them when ``group`` is
    None); returns the lines to print, the same on every rank."""
    mesh = ShardMesh((4, 2), ("data", "model"))
    dp = DistParams(index=IndexParams(
        capacity=128, dim=32, d_out=8,
        search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
    ))
    rng = np.random.default_rng(0)

    # the session owns the stacked per-shard state (updated in place)
    sess = ShardedSession(dp, mesh, strategy="global", seed=0, device=device,
                          group=group)
    X = rng.normal(size=(400, 32)).astype(np.float32)
    gids = sess.insert(X, np.arange(400))
    lines = [f"inserted: {int((gids.cpu().numpy() >= 0).sum())} across "
             f"{int(np.prod(mesh.shape))} shards"]

    Q = rng.normal(size=(16, 32)).astype(np.float32)
    ids, _ = sess.query(Q)
    lines.append(f"query results (global ids): {ids.cpu().numpy()[0, :5]}")

    sess.delete(gids.cpu().numpy()[:100])
    sess.flush()
    lines.append(f"alive after GLOBAL delete of 100: {sess.n_alive()}")
    where = "" if group is None else f" (rank 0 of {group.world})"
    lines.append(f"timers{where}: {sess.timers.to_dict()}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes, each holding 8/ranks shards")
    args = ap.parse_args(argv)
    if args.ranks == 1:
        lines = run(None, args.device)
    else:
        lines = run_on_ranks(run, args.ranks, device=args.device or "cuda",
                             timeout_s=600, args=(args.device,))[0]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
