"""Online ANN serving driver — ``repro.launch.serve`` on PyTorch.

Drives the §6 update stream through a streaming :class:`Session` (or the
two-tier :class:`TieredSession`): each maintenance step dispatches its
delete and insert ops back to back and synchronises once (``flush``);
recall@k on held-out queries follows every step, with the session's
per-phase timers. A checkpoint directory arms the write-ahead journal;
``--recover`` restarts from it (newest complete checkpoint + journal
replay). Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --scale 2000 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --scale 600
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (
    IndexParams,
    MaintenanceParams,
    SearchParams,
    Session,
    TieredSession,
)
from repro_torch.data.workload import make_workload


def serve_online(*, dataset: str = "sift", strategy: str = "global",
                 n_base: int = 2000, n_steps: int = 3, batch_size: int = 200,
                 n_queries: int = 256, d_out: int = 12, pool: int = 32,
                 seed: int = 0, k: int = 10,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, recover: bool = False,
                 tiered: bool = False, fresh_capacity: int | None = None,
                 device=None) -> list[dict]:
    """Build a base index, then run ``n_steps`` steps of (delete, insert,
    recall) and return one record per step. ``device=None`` is the card."""
    wl = make_workload(dataset, n_base=n_base, n_steps=n_steps,
                       batch_size=batch_size, n_queries=n_queries,
                       pattern="random", seed=seed)
    dim = wl.base.shape[1]
    capacity = n_base + n_steps * batch_size + 16
    maintenance = MaintenanceParams(strategy=strategy)
    if tiered:
        # inserts land in a small fresh tier, deletes of main-resident
        # points tombstone, and the streaming merge drains fresh → main
        fresh_capacity = fresh_capacity or max(2 * batch_size, 256)
        maintenance = MaintenanceParams(
            strategy="mask", merge_fresh_threshold=0.5,
            merge_tombstone_threshold=0.25, max_capacity=2 * capacity)
    params = IndexParams(
        capacity=capacity, dim=dim, d_out=d_out,
        search=SearchParams(pool_size=pool, max_steps=3 * pool, num_starts=2),
        maintenance=maintenance)
    if recover:
        # crash restart: params, strategy and seed must match the dead run
        if checkpoint_dir is None:
            raise ValueError("--recover requires --checkpoint-dir")
        t0 = time.perf_counter()
        if tiered:
            session = TieredSession.recover(
                checkpoint_dir, params, fresh_capacity=fresh_capacity,
                seed=seed, device=device)
        else:
            session = Session.recover(checkpoint_dir, params,
                                      strategy=strategy, seed=seed,
                                      device=device)
        info = session.recovery_info or {}
        print(f"recovered from {checkpoint_dir}: step={info.get('step')} "
              f"replayed={info.get('n_replayed', 0)} ops "
              f"(skipped {info.get('n_skipped', 0)}, "
              f"dropped {info.get('dropped_bytes', 0)}B torn tail) "
              f"in {time.perf_counter() - t0:.2f}s")
    elif tiered:
        session = TieredSession(params, fresh_capacity=fresh_capacity,
                                seed=seed, checkpoint_dir=checkpoint_dir,
                                device=device)
    else:
        # a checkpoint_dir arms the write-ahead journal
        session = Session(params, seed=seed, checkpoint_dir=checkpoint_dir,
                          device=device)

    if recover and session._op_counter > 0:
        # the recovered timeline already holds the base build (and the
        # acknowledged stream prefix); the workload is deterministic, so the
        # id map is rebuilt on the host
        print("skipping base build (recovered mid-stream)")
        id_map = list(range(n_base))
    else:
        print(f"building base index ({n_base} × d={dim}) ...")
        t0 = time.perf_counter()
        if tiered:
            # the fresh tier holds fresh_capacity rows at once: load in
            # fresh-sized waves, the merge drains between them
            id_map = []
            for lo in range(0, n_base, fresh_capacity):
                ids = session.insert(wl.base[lo:lo + fresh_capacity]).result()
                id_map.extend(ids)
        else:
            ids = session.insert(wl.base).result()
            id_map = list(np.asarray(ids))   # pool position → graph id
        session.flush()
        print(f"  built in {time.perf_counter() - t0:.1f}s")

    records = []
    for step in range(wl.n_steps):
        rec = {"step": step}
        gids = [id_map[p] for p in wl.step_deletes[step]]
        # one maintenance step = delete + insert, one synchronisation
        t0 = time.perf_counter()
        session.delete(np.asarray(gids))
        new_ids = session.insert(wl.step_inserts[step]).result()
        session.flush()
        rec["update_s"] = time.perf_counter() - t0
        rec["update_ops_per_s"] = (len(gids) + len(new_ids)) / rec["update_s"]
        id_map.extend(new_ids)

        t0 = time.perf_counter()
        rec["recall@10"] = session.recall(wl.queries, k=k)
        rec["query_s"] = time.perf_counter() - t0
        rec["qps"] = n_queries / rec["query_s"]
        rec.update(session.stats())
        if (checkpoint_dir is not None and checkpoint_every
                and (step + 1) % checkpoint_every == 0):
            session.save(step)   # publishes atomically, truncates the journal
            rec["checkpointed"] = True
        records.append(rec)
        print(f"step {step}: recall@{k}={rec['recall@10']:.3f} "
              f"qps={rec['qps']:.1f} upd={rec['update_s']:.2f}s "
              f"({rec['update_ops_per_s']:.0f} ops/s) alive={rec['n_alive']}")
    print("session timers:", session.flush().to_dict())
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sift")
    ap.add_argument("--strategy", default="global")
    ap.add_argument("--scale", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="arm checkpoints + the write-ahead op journal")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every N maintenance steps (0 = never)")
    ap.add_argument("--recover", action="store_true",
                    help="restart from checkpoint-dir: newest complete "
                         "checkpoint + journal replay")
    ap.add_argument("--tiered", action="store_true",
                    help="serve through the two-tier index (fresh tier + "
                         "streaming merge)")
    ap.add_argument("--fresh-capacity", type=int, default=None,
                    help="fresh-tier slot count (tiered mode only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    serve_online(
        dataset=args.dataset, strategy=args.strategy, n_base=args.scale,
        n_steps=args.steps, batch_size=max(args.scale // 10, 10),
        n_queries=min(256, args.scale), checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, recover=args.recover,
        tiered=args.tiered, fresh_capacity=args.fresh_capacity,
        device=args.device)


if __name__ == "__main__":
    main()
