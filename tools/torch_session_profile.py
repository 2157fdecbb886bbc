"""Where the time of the port's SIFT1M-scale session goes, on one card.

    python3 tools/torch_session_profile.py [--n-base 1000000]

Builds the sift1m-session index of ``chip_smoke.py`` (make_dataset("sift"),
ipgm_ann d = 128 settings, capacity 2^20), then prints one JSON line each:

  recall_budget  recall@10 of 1,000 held-out queries against the walk budget
                 (max_steps 128 / 512 / 2048 at W = 1; W = 4 at 128), with
                 the mean hop count;
  phases         one op of 64 queries, 64 inserts, 64 GLOBAL, LOCAL and
                 RWALK deletes, one 64-tombstone consolidation chunk (GLOBAL
                 repair) and one 64-slot refine chunk, split into
                 entry-point draw, beam search, select, row apply and the
                 rest, by synchronised host timers (ms/op); the
                 ``score_matrix`` kernel's share of select is reported
                 beside them (it is inside select, not added to the sum);
  profile        a torch.profiler trace of the same ops: device time by
                 kernel name, launches, the device's busy share of the wall
                 time, and the two gather kernels' device time and launches.

    python3 tools/torch_session_profile.py --sharded [--n-base 1000000]

profiles cell sift1m-sharded of ``chip_smoke.py`` instead: the base placed
by ``reshard`` into 8 shards of a (4, 2) mesh, rows in bf16, then ops of
256 queries, 512 routed inserts, 512 GLOBAL deletes and a consolidation of
512 MASK tombstones through ``ShardedSession``, split as above plus the
folded query's flat view and merge (``phases``), and traced (``profile``).

The card's name and power limit come first. Needs one CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import IndexParams, MaintenanceParams, SearchParams, Session  # noqa: E402
from repro_torch.core import delete as delete_mod  # noqa: E402
from repro_torch.core import insert as insert_mod  # noqa: E402
from repro_torch.core import refine as refine_mod  # noqa: E402
from repro_torch.core import distances, search, select  # noqa: E402
from repro_torch.core.rebuild import bulk_knn_build  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402


NESTED = "score_matrix_in_select"   # timed inside "select", not summed
GATHER_KERNELS = ("gather_rows_kernel", "gather_q8_kernel")   # csrc/gather_scores.cu


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase_timers(acc: dict):
    """Wrap the pipeline's stages with synchronised host timers."""
    from repro_torch.distributed import ann
    targets = [
        (ann, "flat_view", "flat_view"),
        (ann, "_merge", "merge"),
        (search, "batch_entry_points", "entry_points"),
        (search, "beam_search", "beam_search"),
        (select, "select_neighbors", "select"),
        (distances, "score_matrix", NESTED),
        (insert_mod, "set_out_edges_batch", "apply_rows"),
        (delete_mod, "set_out_edges_batch", "apply_rows"),
        (refine_mod, "set_out_edges_batch", "apply_rows"),
    ]
    saved = []
    for mod, attr, name in targets:
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def timed(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            acc[_name] += time.perf_counter() - t
            return out
        setattr(mod, attr, timed)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-base", type=int, default=1_000_000)
    ap.add_argument("--ops", type=int, default=4, help="ops of 64 per type")
    ap.add_argument("--sharded", action="store_true",
                    help="profile the sharded cell (8 shards, bf16 rows)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi})
    if args.sharded:
        return sharded_main(args.n_base, max(2, args.ops // 2))

    n = args.n_base
    n_ops = args.ops
    data = make_dataset("sift", n + 2 * 64 * n_ops + 1000, seed=0)
    base, fresh, held = data[:n], data[n:n + 64 * n_ops], data[-1000:]
    queries = data[n + 64 * n_ops:n + 128 * n_ops]
    sp = SearchParams(pool_size=64, max_steps=128, num_starts=2)
    params = IndexParams(capacity=1 << max(10, (n - 1).bit_length()), dim=128,
                         d_out=32, d_in=64, search=sp,
                         maintenance=MaintenanceParams(strategy="global"))
    t = time.perf_counter()
    state = bulk_knn_build(base, np.ones(n, bool), params, k_nn=64)
    torch.cuda.synchronize()
    emit({"build_s": time.perf_counter() - t, "n_base": n})

    rows = []
    for steps, width in ((128, 1), (512, 1), (2048, 1), (128, 4)):
        p = dataclasses.replace(params, search=dataclasses.replace(
            sp, max_steps=steps, beam_width=width))
        s = Session(p, state=state, seed=0)
        t = time.perf_counter()
        r = s.recall(held, 10)
        dt = time.perf_counter() - t
        starts = search.batch_entry_points(state, s._op_key(), 1000, 2)
        res = search.beam_search(state, torch.as_tensor(held).cuda(), starts,
                                 p.search)
        rows.append({"max_steps": steps, "beam_width": width, "recall10": r,
                     "mean_hops": float(res.n_expanded.float().mean()),
                     "query_s_1000": dt})
    emit({"recall_budget": rows})

    sess = Session(params, state=state, seed=1)
    rng = np.random.default_rng(0)
    # sessions of the other strategies share the one state (in place)
    other = {name: Session(dataclasses.replace(params, maintenance=MaintenanceParams(
        strategy=name)), state=state, seed=2) for name in ("local", "rwalk", "mask")}

    def delete_with(s, n=64):
        alive = torch.nonzero(s.state.alive).flatten().cpu().numpy()
        s.delete(rng.choice(alive, n, replace=False))
        s.flush()

    def consolidate_all():
        other["mask"].consolidate()     # GLOBAL repair, 64 tombstones a chunk
        other["mask"].flush()

    ops = {
        "query": lambda i: sess.query(queries[64 * i:64 * (i + 1)]).result(),
        "insert": lambda i: sess.insert(fresh[64 * i:64 * (i + 1)]).result(),
        "delete_global": lambda i: delete_with(sess),
        "delete_local": lambda i: delete_with(other["local"]),
        "delete_rwalk": lambda i: delete_with(other["rwalk"]),
        "refine": lambda i: (sess.refine(n=64), sess.flush()),
        "consolidate": lambda i: consolidate_all(),   # n_ops chunks in one pass
    }
    sess.query(queries[:64]).result()              # warm-up of every path
    delete_with(other["mask"], 64 * n_ops)         # tombstones to consolidate
    emit({"phases": timed_phases(ops, n_ops, {"consolidate": 1}),
          "items_per_op": 64})
    emit({"profile": profile_ops(ops, {"consolidate": lambda: delete_with(
        other["mask"])})})
    return 0


def timed_phases(ops: dict, n_ops: int, runs: dict | None = None) -> dict:
    """ms per op of each op, split by ``phase_timers``; ``runs`` names ops
    that run fewer times than ``n_ops`` (their one run covers n_ops items)."""
    runs = runs or {}
    acc: dict = defaultdict(float)
    totals = {}
    with phase_timers(acc):
        for name, fn in ops.items():
            n = runs.get(name, n_ops)
            before = dict(acc)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
            per = n_ops if name in runs else n
            wall = (time.perf_counter() - t) / per * 1e3
            part = {k: (acc[k] - before.get(k, 0.0)) / per * 1e3 for k in acc}
            part = {k: v for k, v in part.items() if v > 0}
            part["other"] = wall - sum(v for k, v in part.items() if k != NESTED)
            totals[name] = {"ms_per_op": wall, "phases_ms": part}
    return totals


def profile_ops(ops: dict, prepare: dict | None = None) -> dict:
    """One traced run of each op: device time by kernel, launches, the
    device's busy share of the wall time, the gathers' device time."""
    prepare = prepare or {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof_out = {}
    for name, fn in ops.items():
        if name in prepare:
            prepare[name]()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            fn(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels = []
        busy = 0.0
        launches = 0
        gather_us, gather_n = 0.0, 0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
                busy += dev_us
                launches += ev.count
                kernels.append((dev_us, ev.count, ev.key[:80]))
                if any(k in ev.key for k in GATHER_KERNELS):
                    gather_us += dev_us
                    gather_n += ev.count
        kernels.sort(reverse=True)
        prof_out[name] = {
            "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / 1e6 / wall if wall > 0 else None,
            "kernel_launches": launches,
            "gather_device_ms": gather_us / 1e3, "gather_launches": gather_n,
            "top": [{"kernel": k, "device_ms": us / 1e3, "count": c}
                    for us, c, k in kernels[:8]]}
    return prof_out


def sharded_main(n: int, n_ops: int) -> int:
    """The sharded cell's ops, split and traced (see the module doc)."""
    import chip_smoke
    from repro_torch.core.graph import NULL
    from repro_torch.distributed import (DistParams, ShardedSession, ShardMesh,
                                         init_sharded_state, reshard)

    S, per = 8, 512
    data = make_dataset("sift", n + per * n_ops + 1000, seed=0)
    base, fresh = data[:n], data[n:n + per * n_ops]
    queries = make_dataset("sift", 256 * n_ops, seed=1)
    cap = chip_smoke.shard_capacity(n, per, S)
    params = chip_smoke.sift_params(cap, strategy="global", max_capacity=2 * cap)
    dp = DistParams(index=params, vec_dtype="bfloat16")
    t = time.perf_counter()
    src_params = chip_smoke.sift_params(1 << max(10, (n - 1).bit_length()))
    src = init_sharded_state(DistParams(index=src_params),
                             ShardMesh((1, 1), ("data", "model")))
    src.vectors[0, :n] = torch.from_numpy(base).cuda()
    src.alive[0, :n] = True
    placed, _ = reshard(src, src_params, params, S)
    del src
    sess = ShardedSession(dp, ShardMesh(*chip_smoke.SHARD_MESH), seed=0,
                          state=chip_smoke.bf16_rows(torch, placed))
    del placed
    torch.cuda.synchronize()
    emit({"place_s": time.perf_counter() - t, "n_base": n, "shards": S,
          "capacity_per_shard": cap})
    rng = np.random.default_rng(0)

    def alive_gids(k):
        st = sess.state
        flat = torch.nonzero(st.alive.reshape(-1)).flatten().cpu().numpy()
        pick = rng.choice(flat, k, replace=False)
        return (pick // st.capacity) * dp.gid_stride() + pick % st.capacity

    def delete_with(strategy):
        sess.strategy = strategy
        sess.delete(alive_gids(per))
        sess.flush()
        sess.strategy = "global"

    def consolidate():
        sess.consolidate()
        sess.flush()

    def insert(i):
        g = sess.insert(fresh[per * i:per * (i + 1)],
                        n + per * i + np.arange(per))
        assert bool((g != NULL).all())

    ops = {"query": lambda i: sess.query(queries[256 * i:256 * (i + 1)]),
           "insert": insert,
           "delete_global": lambda i: delete_with("global"),
           "consolidate": lambda i: consolidate()}
    sess.query(queries[:256])                      # warm-up
    delete_with("mask")                            # tombstones to consolidate
    emit({"phases": timed_phases({"query": ops["query"],
                                  "delete_global": ops["delete_global"]}, n_ops),
          "items_per_op": {"query": 256, "delete_global": per}})
    emit({"phases_consolidate": timed_phases({"consolidate": ops["consolidate"]}, 1),
          "tombstones": per})
    # inserts last but one: each consumes rows of ``fresh``
    emit({"phases_insert": timed_phases({"insert": insert}, n_ops - 1),
          "items_per_op": per})
    emit({"profile": profile_ops(
        {"query": ops["query"], "insert": lambda i: insert(n_ops - 1),
         "delete_global": ops["delete_global"], "consolidate": ops["consolidate"]},
        {"consolidate": lambda: delete_with("mask")})})
    return 0


if __name__ == "__main__":
    sys.exit(main())
