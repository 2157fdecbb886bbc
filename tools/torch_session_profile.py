"""Where the time of the port's SIFT1M-scale session goes, on one card.

    python3 tools/torch_session_profile.py [--n-base 1000000]

Builds the sift1m-session index of ``chip_smoke.py`` (make_dataset("sift"),
ipgm_ann d = 128 settings, capacity 2^20), then prints one JSON line each:

  recall_budget  recall@10 of 1,000 held-out queries against the walk budget
                 (max_steps 128 / 512 / 2048 at W = 1; W = 4 at 128), with
                 the mean hop count;
  phases         one op of 64 queries, 64 inserts, 64 GLOBAL, LOCAL and
                 RWALK deletes, one 64-tombstone consolidation chunk (GLOBAL
                 repair) and one 64-slot refine chunk, split by the
                 program's spans (``repro_torch.tracing``: the entry draw,
                 the beam loop, select, the edge apply) and the rest, each
                 span timed on the host with the card synchronised at both
                 ends (ms/op); beside them what the program's counters say
                 of the op: beam trips a search, the gathers' valid lanes
                 over the lanes they launched, ``score_topk`` and
                 ``score_matrix`` launches by shape;
  profile        a torch.profiler trace of the same ops: device time by
                 kernel name, launches, the device's busy share of the wall
                 time, the gather kernels' device time, launches and share
                 of their roofline (the rows of the valid lanes, counted by
                 the kernels), and the ``score_matrix`` kernel's device time
                 and its share of the op's select span.

    python3 tools/torch_session_profile.py --sharded [--n-base 1000000]

profiles cell sift1m-sharded of ``chip_smoke.py`` instead: the base placed
by ``reshard`` into 8 shards of a (4, 2) mesh, rows in bf16, then ops of
256 queries, 512 routed inserts, 512 GLOBAL deletes and a consolidation of
512 MASK tombstones through ``ShardedSession`` in a one-rank NCCL group,
split as above plus the folded query's flat view and merge and the
group's collectives (``phases``), and traced (``profile``).

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

from repro_torch import tracing  # noqa: E402
from repro_torch.core import IndexParams, MaintenanceParams, SearchParams, Session  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.rebuild import bulk_knn_build  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.analysis import HBM_BYTES_PER_S, device_kernels  # noqa: E402


GATHER_KERNELS = ("gather_rows_kernel", "gather_q8_kernel")   # csrc/gather_scores.cu
ROW_BYTES = {"gather_scores": 4, "gather_scores_bf16": 2, "gather_scores_q8": 1}  # a value


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class HostSpans:
    """A span sink (``tracing.set_sink``) that times each span on the host,
    the card synchronised at both ends: ``s[name]`` sums the spans of that
    name, ``top_s`` those opened while no other span was open (a nested
    span's time is also its parent's)."""

    def __init__(self):
        self.open: list = []            # (name, start) of the open spans, innermost last
        self.s: dict = defaultdict(float)
        self.top_s = 0.0

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        if self.open and self.open[-1][0] == name:
            _, t0 = self.open.pop()
            self.s[name] += now - t0
            if not self.open:
                self.top_s += now - t0
        else:
            self.open.append((name, now))


@contextlib.contextmanager
def sink(fn):
    tracing.set_sink(fn)
    try:
        yield fn
    finally:
        tracing.set_sink(None)


def counted(before: dict, after: dict, per: int) -> dict:
    """What the program's counters say of the work between two snapshots
    (``tracing.counters``): beam trips a search, each gather's valid lanes
    and the lanes it launched, per op, and ``score_topk`` (B, M, k) and
    ``score_matrix`` (R, B, M) launches by shape."""
    loops = {k: after["loop_counts"][k] - before["loop_counts"][k]
             for k in after["loop_counts"]}
    lanes = {}
    for name in kops.GATHERS:
        was = before["launches_by_shape"][name]
        launched = sum(b * c * (n - was.get((b, c), 0))
                       for (b, c), n in after["launches_by_shape"][name].items())
        valid = after["valid_lanes"][name] - before["valid_lanes"][name]
        if launched or valid:
            lanes[name] = {"valid": valid / per, "launched": launched / per}
    shapes = {name: {"x".join(map(str, shape)): n - before["launches_by_shape"][name].get(shape, 0)
                     for shape, n in after["launches_by_shape"][name].items()
                     if n > before["launches_by_shape"][name].get(shape, 0)}
              for name in ("score_topk", "score_matrix")}
    return {"trips_per_search": loops["trips"] / loops["searches"] if loops["searches"] else None,
            "gather_lanes": lanes, "launches_by_shape": shapes}


def gather_bytes(before: dict, after: dict, d: int) -> float:
    """The gathers' bytes between two snapshots: each valid lane's row, id,
    norm or scale and score once, and each launch's queries once
    (``kernels/ops.py::gather_work`` with the valid lanes for B·C)."""
    total = 0.0
    for name in kops.GATHERS:
        was = before["launches_by_shape"][name]
        launches_q = sum(b * (n - was.get((b, c), 0))
                         for (b, c), n in after["launches_by_shape"][name].items())
        valid = after["valid_lanes"][name] - before["valid_lanes"][name]
        total += valid * (ROW_BYTES[name] * d + 12) + launches_q * d * 4
    return total


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
        from repro_torch.launch.mesh import one_rank
        with one_rank("cuda", timeout_s=900) as group:
            return sharded_main(args.n_base, max(2, args.ops // 2), group)

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
    phases = timed_phases(ops, n_ops, {"consolidate": 1})
    emit({"phases": phases, "items_per_op": 64})
    emit({"profile": profile_ops(ops, params.dim, phases,
                                 {"consolidate": lambda: delete_with(other["mask"])})})
    return 0


def timed_phases(ops: dict, n_ops: int, runs: dict | None = None) -> dict:
    """ms per op of each op, split by the program's spans (``HostSpans``),
    with its counters; ``runs`` names ops that run fewer times than
    ``n_ops`` (their one run covers n_ops items)."""
    runs = runs or {}
    totals = {}
    with sink(HostSpans()) as spans:
        for name, fn in ops.items():
            n = runs.get(name, n_ops)
            before, top = dict(spans.s), spans.top_s
            was = tracing.counters()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
            per = n_ops if name in runs else n
            part = {k: (v - before.get(k, 0.0)) / per * 1e3 for k, v in spans.s.items()}
            part = {k: v for k, v in part.items() if v > 0}
            part["other"] = (wall_s - (spans.top_s - top)) / per * 1e3
            totals[name] = {"ms_per_op": wall_s / per * 1e3, "phases_ms": part,
                            **counted(was, tracing.counters(), per)}
    return totals


def profile_ops(ops: dict, d: int, phases: dict, prepare: dict | None = None) -> dict:
    """One traced run of each op: device time by kernel, launches, the
    device's busy share of the wall time, the gathers' device time and
    share of their roofline (valid lanes counted by the kernels, armed by a
    sink that does nothing), and the ``score_matrix`` kernel's device time
    and its share of the op's ``graph.select`` span in ``phases``."""
    prepare = prepare or {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof_out = {}
    for name, fn in ops.items():
        if name in prepare:
            prepare[name]()
        torch.cuda.synchronize()
        with sink(lambda span: None):
            was = tracing.counters()
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                fn(0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            now = tracing.counters()
        kernels = []
        busy = 0.0
        launches = 0
        gather_us, gather_n, matrix_us = 0.0, 0, 0.0
        for dev_us, count, key in device_kernels(prof):
            busy += dev_us
            launches += count
            kernels.append((dev_us, count, key[:80]))
            if any(k in key for k in GATHER_KERNELS):
                gather_us += dev_us
                gather_n += count
            if "score_matrix" in key:
                matrix_us += dev_us
        kernels.sort(reverse=True)
        select_ms = phases.get(name, {}).get("phases_ms", {}).get("graph.select")
        prof_out[name] = {
            "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / 1e6 / wall if wall > 0 else None,
            "kernel_launches": launches,
            "gather_device_ms": gather_us / 1e3, "gather_launches": gather_n,
            "gather_roofline_pct": (100.0 * gather_bytes(was, now, d) / HBM_BYTES_PER_S
                                    / (gather_us / 1e6) if gather_us else None),
            "score_matrix_device_ms": matrix_us / 1e3,
            "score_matrix_share_of_select": (matrix_us / 1e3 / select_ms
                                             if select_ms and matrix_us else None),
            "top": [{"kernel": k, "device_ms": us / 1e3, "count": c}
                    for us, c, k in kernels[:8]]}
    return prof_out


def sharded_main(n: int, n_ops: int, group) -> int:
    """The sharded cell's ops on ``group``, split and traced (see the
    module doc)."""
    import chip_smoke
    from repro_torch.core.graph import NULL
    from repro_torch.distributed import (DistParams, ShardedSession, ShardMesh,
                                         init_sharded_state, reshard)
    from repro_torch.distributed.ann import bf16_rows

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
                          state=bf16_rows(placed), group=group)
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
    phases = timed_phases({"query": ops["query"], "delete_global": ops["delete_global"]},
                          n_ops)
    emit({"phases": phases, "items_per_op": {"query": 256, "delete_global": per}})
    phases.update(timed_phases({"consolidate": ops["consolidate"]}, 1))
    emit({"phases_consolidate": phases["consolidate"], "tombstones": per})
    # inserts last but one: each consumes rows of ``fresh``
    phases.update(timed_phases({"insert": insert}, n_ops - 1))
    emit({"phases_insert": phases["insert"], "items_per_op": per})
    emit({"profile": profile_ops(
        {"query": ops["query"], "insert": lambda i: insert(n_ops - 1),
         "delete_global": ops["delete_global"], "consolidate": ops["consolidate"]},
        params.dim, phases, {"consolidate": lambda: delete_with("mask")})})
    return 0


if __name__ == "__main__":
    sys.exit(main())
