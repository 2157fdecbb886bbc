"""``repro_torch.distributed.ShardedSession`` over one rank a card: the
index sharded and replicated as a retrieval service deploys it.

The configuration's ``mesh`` (for example ``(2, 4, 2)`` over ``("pod",
"data", "model")``) and ``ranks`` lay the pods over the ranks as
``launch.mesh.run_on_ranks`` starts them (NCCL on cards, the store under
``TMPDIR``). Every rank draws the same base from the seed on its card and
places it as the port's placement does: one 2^20-slot shard re-sharded by
hash (``distributed.elastic.reshard``), each rank bulk-linking only its
block, the rows then kept in the configuration's row type
(``ann.bf16_rows``). Every rank runs every op with the whole batch (the
query splits by pod inside the program; writes go to every replica); the
ranks agree after each round whether the window is over.

Rank 0 returns the record of the run; every rank returns a digest of its
answers (which must all agree), its block's state read back and judged,
its counters and, in a traced run, its trace. What only the judge needs
(the base on the host, its digest, the sampled edges) leaves the card
after the window, so set-up holds the program's work alone; each rank's
times since launch (group joined, placed, warm) are logged. The parent
process, which touches no card until the ranks have ended, draws the
base again on card 0 and runs the reference there.
"""
from __future__ import annotations

import hashlib
import sys
import time

import numpy as np

from ann_bench.data.streams import Plan
from ann_bench.data.surrogate import Law
from ann_bench.deployments.session import build_sample, index_params, log, sync
from ann_bench.harness import forbidden_modules
from ann_bench.reference import judge
from ann_bench.runner import Runner
from ann_bench.trace import Tracer

RANK_TIMEOUT_S = 330


def digest_rows(base):
    """Every 97th row of the base, kept on the card until the window closes."""
    return base[::97].clone()


def base_digest(rows) -> str:
    """A digest of ``digest_rows``, to hold the parent's second draw to the
    ranks' first."""
    return hashlib.sha256(rows.contiguous().cpu().numpy().tobytes()).hexdigest()


class Adapter:
    def __init__(self, sess):
        self.sess = sess

    def query(self, q, k):
        gids, scores = self.sess.query(q)
        return gids[:, :k].cpu().numpy(), scores[:, :k].cpu().numpy()

    def insert(self, x, rows):
        return self.sess.insert(x, rows).cpu().numpy()

    def delete(self, ids):
        self.sess.delete(ids)
        self.sess.flush()


def _setup(cell, seed: int, group):
    import torch

    from repro_torch.distributed import (DistParams, ShardedSession, ShardMesh,
                                         init_sharded_state, reshard, shard_block)
    from repro_torch.distributed.ann import bf16_rows

    cfg, ix = cell.config, cell.config["index"]
    dev = group.device
    n_base = cfg["data"]["n_base"]
    mesh = ShardMesh(tuple(cfg["mesh"]["shape"]), tuple(cfg["mesh"]["axes"]))
    dp = DistParams(index=index_params(ix), vec_dtype=cfg["rows"],
                    pod_axis="pod" if "pod" in mesh.axis_names else None)
    S = int(np.prod([mesh.size(a) for a in dp.shard_axes]))
    block = shard_block(dp, mesh, group)
    plan = Plan(cell.traffic, Law.from_config(cfg["data"], seed, dev), n_base, seed)
    base = plan.base()
    src_params = index_params(ix, capacity=cfg["placement_capacity"])
    src = init_sharded_state(DistParams(index=src_params),
                             ShardMesh((1, 1), ("data", "model")), device=dev)
    src.vectors[0, :n_base] = base
    src.alive[0, :n_base] = True
    placed, remap = reshard(src, src_params, dp.index, S, shards=block)
    del src
    state = bf16_rows(placed) if cfg["rows"] == "bfloat16" else placed
    del placed
    sess = ShardedSession(dp, mesh, seed=seed, state=state, group=group)
    del state
    kept = digest_rows(base)
    plan.release_base()
    del base
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    return plan, sess, dp, S, block, np.asarray(remap[:n_base], np.int64), kept


def rank_main(group, cell, seed: int, seconds: float, trace: bool) -> dict:
    import torch


    t0 = time.perf_counter()
    times = {"joined": time.time()}
    dev = group.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    plan, sess, dp, S, block, base_ids, kept = _setup(cell, seed, group)
    stride, cap = dp.gid_stride(), dp.index.capacity
    cfg = cell.config
    # the bulk build's edges of the sampled base rows this rank linked (pod 0)
    sample = build_sample(seed, cfg["data"]["n_base"], cfg["build_sample"])
    owner = base_ids[sample] // stride
    mine = sample[(owner >= block.start) & (owner < block.stop)] if sess.peers is None \
        or sess.peers.rank == 0 else sample[:0]
    g = base_ids[mine]
    lids = sess.state.adj[torch.as_tensor(g // stride - block.start, device=dev),
                          torch.as_tensor(g % stride, device=dev)].clone()
    sync(torch, dev)
    times["placed"] = time.time()
    replica, peers = sess.replica, sess.peers
    coll = [0.0]

    def on_query():
        before = sum(x.collective_s for x in (replica, peers) if x is not None)

        def after():
            coll[0] += sum(x.collective_s for x in (replica, peers)
                           if x is not None) - before
        return after

    def agree(done: bool) -> bool:
        flag = torch.tensor([int(done)], dtype=torch.int32, device=dev)
        return bool(group.all_reduce(flag, "max"))

    tracer = Tracer(trace, cell.traffic["trace_rounds"])
    runner = Runner(plan, Adapter(sess), base_ids, span=tracer.span, on_query=on_query)
    runner.warmup()
    sync(torch, dev)
    times["warm"] = time.time()
    agree(False)                 # the ranks open the window together
    setup_end = time.time()
    coll[0] = 0.0
    window_s = runner.window(seconds, agree=agree, tracer=tracer)
    sync(torch, dev)
    tracer.read()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    modules = forbidden_modules()
    if group.rank == 0:
        log(f"window of {window_s:.2f} s closed, trace read ({tracer.timing})", t0)

    # this rank's block read back and judged
    lids = lids.long().cpu().numpy()
    edges_gid = np.where(lids >= 0, (g // stride)[:, None] * stride + lids, -1)
    rows = judge.rows_of(plan.base().cpu(), runner.events)
    rep = judge.replay(runner.events, base_ids, S * stride, rows.n, plan.k)
    st = sess.state
    lost = graph = 0
    for j, s in enumerate(block):
        expected = rep.slot_row[s * stride + np.arange(cap)]
        lost += judge.state_faults(st.alive[j], st.vectors[j], expected, rows,
                                   row_dtype=cfg["rows"])
        graph += judge.graph_faults(st.alive[j], st.present[j], st.adj[j], st.radj[j],
                                    st.size[j])
    answers = hashlib.sha256()
    for e in runner.events:
        if e["kind"] == "query":
            answers.update(np.ascontiguousarray(e["ids"]).tobytes())
    out = {"setup_end": setup_end, "times": times, "window_s": window_s,
           "digest": base_digest(kept),
           "answers": answers.hexdigest(), "lost_writes": lost, "graph_faults": graph,
           "latency_s": runner.latency_s,
           "untraced_from": runner.untraced_from, "query_ops": runner.query_ops,
           "items": runner.items, "by_kind": runner.n_by_kind,
           "attempted": runner.attempted,
           "collective_query_s": coll[0],
           "memory_peak_bytes": peak, "trace": tracer.view, "traced": tracer.counts,
           "dim": cfg["data"]["dim"], "modules": modules,
           "edges": (mine, edges_gid)}
    if group.rank == 0:
        out.update(events=runner.events, base_ids=base_ids, id_space=S * stride,
                   stride=stride, k=plan.k)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str) -> dict:
    import torch

    from repro_torch.launch.mesh import run_on_ranks

    cfg = cell.config
    t0 = time.time()
    ranks = run_on_ranks(rank_main, int(cfg["ranks"]), device=device,
                         timeout_s=RANK_TIMEOUT_S, args=(cell, seed, seconds, trace))
    r0 = ranks[0]
    setup_s = r0["setup_end"] - t0
    for what in ("joined", "placed", "warm"):
        at = [r["times"][what] - t0 for r in ranks]
        print(f"ann_bench: ranks {what} at {min(at):.2f}-{max(at):.2f} s", file=sys.stderr)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    n_base = cfg["data"]["n_base"]

    # the reference, on card 0 now that the ranks have ended
    plan = Plan(cell.traffic, Law.from_config(cfg["data"], seed, dev), n_base, seed)
    base = plan.base()
    if base_digest(digest_rows(base)) != r0["digest"]:
        raise RuntimeError("the parent's draw of the base differs from the ranks'")
    rows = judge.rows_of(base.cpu(), r0["events"])
    del plan, base
    rep = judge.replay(r0["events"], r0["base_ids"], r0["id_space"], rows.n, r0["k"])
    checks = judge.answer_checks(rep, rows, r0["k"], dev, row_dtype=cfg["rows"])
    disagree = sum(r["answers"] != r0["answers"] for r in ranks)
    # the bulk build's edges, gid → base row, held to each row's shard
    gid_row = np.full(r0["id_space"], -1, np.int64)
    gid_row[r0["base_ids"]] = np.arange(n_base)
    sample = np.concatenate([r["edges"][0] for r in ranks])
    egid = np.concatenate([r["edges"][1] for r in ranks])
    edges = np.where(egid >= 0, gid_row[np.maximum(egid, 0)], -1)
    shard_of = np.full(rows.n, -1, np.int64)
    shard_of[:n_base] = r0["base_ids"] // r0["stride"]
    bgap = (judge.build_gap(sample, edges, rows, n_base, cfg["index"]["k_nn"], dev,
                            groups=shard_of) if sample.size == cfg["build_sample"]
            else float("inf"))
    checks.update(bad_answers=rep.bad_answers + disagree * r0["query_ops"],
                  lost_writes=rep.lost_writes + sum(r["lost_writes"] for r in ranks),
                  graph_faults=sum(r["graph_faults"] for r in ranks), build_gap=bgap)
    for r in ranks:
        r.pop("events", None)
    return {"setup_s": setup_s, "window_s": r0["window_s"],
            "attempted": r0["attempted"], "items": r0["items"],
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "checks": checks, "ranks": ranks}
