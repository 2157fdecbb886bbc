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
GATHER_KERNELS = ("gather_f32_kernel", "gather_q8_kernel")   # csrc/gather_scores.cu


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase_timers(acc: dict):
    """Wrap the pipeline's stages with synchronised host timers."""
    targets = [
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi})

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
        "consolidate": None,            # n_ops chunks in one pass
    }
    sess.query(queries[:64]).result()              # warm-up of every path
    delete_with(other["mask"], 64 * n_ops)         # tombstones to consolidate
    acc: dict = defaultdict(float)
    totals = {}
    with phase_timers(acc):
        for name, fn in ops.items():
            before = dict(acc)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if fn is None:
                consolidate_all()
            else:
                for i in range(n_ops):
                    fn(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / n_ops * 1e3
            part = {k: (acc[k] - before.get(k, 0.0)) / n_ops * 1e3 for k in acc}
            part = {k: v for k, v in part.items() if v > 0}
            part["other"] = wall - sum(v for k, v in part.items() if k != NESTED)
            totals[name] = {"ms_per_op": wall, "phases_ms": part}
    emit({"phases": totals, "items_per_op": 64})

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof_out = {}
    for name, fn in ops.items():
        if fn is None:
            delete_with(other["mask"])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            consolidate_all() if fn is None else fn(0)
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
    emit({"profile": prof_out})
    return 0


if __name__ == "__main__":
    sys.exit(main())
