"""One ``repro_torch.core.Session`` on one card: the online index as one
process serves it.

Set-up draws the base from the seed on the card, bulk-builds the index
over it (``core.rebuild.bulk_knn_build``, exact kNN through
``score_topk``, then SELECT-NEIGHBORS), opens a ``Session`` on that state
and runs the warm-up ops. The window runs the traffic's rounds through
``Session.query(chunk=n)`` (one micro-batch an op), ``Session.insert``
and ``Session.delete`` + ``flush``. After it the state is read back and
judged, freed, and the reference scores the sampled answers. What only
the reference needs (the base on the host) is fetched after the window,
so set-up holds the program's work alone.

The configuration's ``index`` block gives the index's settings;
``build_sample`` rows of the base have their bulk-built edges kept, to be
held to their exact neighbours.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ann_bench.data.streams import Plan
from ann_bench.data.surrogate import Law, subseed
from ann_bench.harness import forbidden_modules
from ann_bench.reference import judge
from ann_bench.runner import Runner
from ann_bench.trace import Tracer


def index_params(ix: dict, capacity: int | None = None):
    from repro_torch.core import IndexParams, MaintenanceParams, SearchParams

    return IndexParams(
        capacity=capacity or ix["capacity"], dim=ix["dim"], d_out=ix["d_out"],
        d_in=ix["d_in"], metric=ix["metric"],
        search=SearchParams(pool_size=ix["pool_size"], max_steps=ix["max_steps"],
                            num_starts=ix["num_starts"]),
        maintenance=MaintenanceParams(strategy=ix["strategy"],
                                      insert_chunk=ix["insert_chunk"],
                                      delete_chunk=ix["delete_chunk"]))


def build_sample(seed: int, n_base: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(subseed(seed, "build-sample"))
    return np.sort(rng.choice(n_base, size=min(m, n_base), replace=False))


class Adapter:
    def __init__(self, sess):
        self.sess = sess

    def query(self, q, k):
        return self.sess.query(q, k=k, chunk=q.shape[0]).result()

    def insert(self, x, rows):
        return self.sess.insert(x).result()

    def delete(self, ids):
        self.sess.delete(ids)
        self.sess.flush()


def log(what: str, t0: float) -> None:
    print(f"ann_bench: {what} at {time.perf_counter() - t0:.2f} s", file=sys.stderr)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell, seed: int, seconds: float, trace: bool, device: str) -> dict:
    import torch

    from repro_torch.core import Session
    from repro_torch.core.rebuild import bulk_knn_build

    cfg, ix = cell.config, cell.config["index"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n_base = cfg["data"]["n_base"]
    row_dtype = cfg["rows"]
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    plan = Plan(cell.traffic, Law.from_config(cfg["data"], seed, dev), n_base, seed)
    params = index_params(ix)
    base = plan.base()
    sync(torch, dev)
    log("data drawn", t0)
    state = bulk_knn_build(base, torch.ones(n_base, dtype=torch.bool, device=dev),
                           params, k_nn=ix["k_nn"], device=dev)
    sync(torch, dev)
    log("data drawn and index built", t0)
    sample = build_sample(seed, n_base, cfg["build_sample"])
    edges = state.adj[torch.as_tensor(sample, device=dev)].clone()   # read after the window
    plan.release_base()
    del base
    sess = Session(params, state=state, seed=seed, device=dev)
    del state
    tracer = Tracer(trace, cell.traffic["trace_rounds"])
    runner = Runner(plan, Adapter(sess), np.arange(n_base, dtype=np.int64),
                    span=tracer.span)
    runner.warmup()
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    log("set-up done", t0)

    window_s = runner.window(seconds, tracer=tracer)
    sync(torch, dev)
    tracer.read()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    modules = forbidden_modules()
    log(f"window of {window_s:.2f} s closed, trace read ({tracer.timing})", t0)

    # the state read back, then freed; then the reference
    edges = edges.long().cpu().numpy()
    rows = judge.rows_of(plan.base().cpu(), runner.events)
    st = sess.state
    rep = judge.replay(runner.events, np.arange(n_base, dtype=np.int64),
                       st.capacity, rows.n, plan.k)
    lost = rep.lost_writes + judge.state_faults(st.alive, st.vectors, rep.slot_row,
                                                rows, row_dtype=row_dtype)
    graph = judge.graph_faults(st.alive, st.present, st.adj, st.radj, st.size)
    del st, sess, runner.index
    if on_card:
        torch.cuda.empty_cache()
    log("state judged", t0)
    checks = judge.answer_checks(rep, rows, plan.k, dev, row_dtype=row_dtype)
    checks.update(bad_answers=rep.bad_answers, lost_writes=lost, graph_faults=graph,
                  build_gap=judge.build_gap(sample, edges, rows, n_base, ix["k_nn"], dev))
    log("answers judged", t0)
    return {"setup_s": setup_s, "window_s": window_s,
            "attempted": runner.attempted, "items": runner.items,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "checks": checks,
            "ranks": [{"latency_s": runner.latency_s,
                       "untraced_from": runner.untraced_from, "query_ops": runner.query_ops,
                       "items": runner.items, "by_kind": runner.n_by_kind,
                       "collective_query_s": None,
                       "memory_peak_bytes": peak, "trace": tracer.view, "traced": tracer.counts,
                       "dim": cfg["data"]["dim"], "modules": modules}]}
