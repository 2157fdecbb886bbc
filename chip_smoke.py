#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # every phase, at SIFT1M scale
    python3 chip_smoke.py --phases build,kernels,maint
    python3 chip_smoke.py --phases build,kernels,sharded --n-base 100000
    python3 chip_smoke.py --phases build,kernels,models
    python3 chip_smoke.py --phases build,gnn
    python3 chip_smoke.py --phases build,train
    python3 chip_smoke.py --phases build,dryrun
    python3 chip_smoke.py --phases build,sharded4    # four cards
    python3 chip_smoke.py --phases build,pods4       # four cards, 2 replicas

Phases, each printing one JSON line:
  device   the card's name and power limit;
  build    nvcc builds every kernel of ``src/repro_torch/kernels/csrc``;
  kernels  each kernel against its plain PyTorch version on the card, at the
           main paths' shapes, edge ids and grown-tier table sizes: exact on
           integer-valued data, within the Pallas tests' tolerances on
           Gaussian data (rtol 1e-4 / atol 1e-3; score_matrix 2e-4 / 2e-4·d
           in fp32, 2e-2 / 2e-2·d in bf16); score_topk at k = 1, 10, 65 and
           128, B no multiple of its query tile, n_valid inside a row tile,
           in its single- and multi-split forms, and at the ipgm-online
           serve_d960 cell's bulk build (M 2,048, d 960, k 65);
           score_matrix's self path (q is x) against its general path and
           the plain version at n = 1..128, and at d 960; the gathers at
           d = 8, 32, 100, 128, 130, 960 and on offset table views, at B
           64 and 4,096 × C 32, and one
           gather_scores launch captured in a CUDA graph and replayed on
           new ids; median times of kernel, plain version and one
           library call (per select shape for score_matrix, at the bulk
           build's 16,384-query block for score_topk, at B = 64 for the
           gathers, whose calls each take the next id set of a rotation
           that keeps their rows cold, also as device time per launch
           replayed from a CUDA graph), with the bounds; the bf16-row
           gather on the bf16 cast of every such table, bit-equal to the
           fp32 kernel on the widened rows and held to its plain version,
           timed beside the fp32 row at B 64 and 4,096 × C 32;
           score_topk at DLRM retrieval's shape (B 1 in a 64-query tile,
           k 100, ip, d 64, M 10^6 and 10^6 - 37, both ragged against the
           128-row tile): exact on integer data, ids equal on Gaussian
           data wherever the k-th and (k+1)-th scores lie further apart
           than the tolerance; kernel, plain and matmul + topk times;
  parity   small sessions (GLOBAL, LOCAL, RWALK, MASK with consolidation
           and a refine pass, an armed session that grows, LOCAL_REFERENCE
           and GLOBAL_REFERENCE), a bulk build, the reference engine (equal
           to the batched engine at W = 1 on each device),
           consolidate_reference, one BatchedServer step and a small
           sharded stream (8 shards of 64 slots, f32 and bf16 rows: routed
           inserts, fan-out queries, GLOBAL, LOCAL and MASK deletes,
           consolidate, grow) run on the card and on the CPU must leave
           byte-equal state and results; the smoke-size DLRM (serve step,
           top-100 retrieval on integer rows), a dense (qwen3) and an MoE
           (phi3.5) LM's prefill and three decode steps, from the same
           weights, must agree: integers equal, fp32 within 1e-4; and the
           four GNN archs at their smoke configs plus the sampled GraphSAGE
           (forward, the loss's gradients, one AdamW step) from the same
           weights and graphs, within a relative L2 error of 1e-5 (logits,
           loss), 1e-4 (gradients) and 1e-6 (parameters after the step);
  sift1m   the main path: bulk-build a 10^6-vector SIFT-shaped index into
           2^20 slots, stream rounds (2 of the cell's 4 by default, printed
           as ``reduced``) of queries, inserts and GLOBAL deletes
           through ``Session``, recall@10 before and after (fp32 and
           quantized with rerank), with the launch counts of every kernel
           and the gathers' split by (B, C);
  maint    the paper's §6 protocol on the clustered update pattern at the
           same scale: PURE, MASK, LOCAL, GLOBAL and RWALK each on a copy of
           one bulk-built state, ReBuild (PURE + bulk rebuild each step),
           then MASK's consolidation and a capacity grow, and a refine pass
           on LOCAL; per-strategy rates and recall@10 after every step, and
           the launch counts as in sift1m;
  durable  cell sift1m-durable: a journaled LOCAL session over the bulk-built
           10^6 index (checkpoints in a fresh directory under build/, its
           filesystem printed): save(0), 2 rounds of 2,048 queries, inserts
           and deletes with save(1) between them as the control; the same
           stream from a copy of step 0, killed by a simulated crash after
           the journal append of the last round's insert, recovered and
           finished — every GraphState array torch.equal to the control's,
           and the counters; then a child process recovers the directory,
           streams batches with a flush after each and is sent SIGKILL after
           its second acknowledgement: every acknowledged insert must be alive
           with its row, no acknowledged delete alive (unless a later batch's
           insert took its slot), I1–I7 hold; checkpoint bytes, save/restore
           seconds, journal bytes per round, records replayed and skipped;
  tiered   cell sift1m-tiered: a TieredSession whose main tier is the
           bulk-built index (fresh tier 2^17 slots, GLOBAL), 2 rounds of 8 ×
           (256 inserts with 16 upserts, 256 deletes half on main-resident
           and half on fresh ids, 256 queries), an auto-merge during the
           stream and an explicit merge at the end; no query may return a
           deleted id or a stale score; check_mirrors; recall@10 (fp32 and
           quantized + rerank 64) before and after; save and recover
           bit-exact; rates, merge seconds and rows, peak memory;
  serve    cell sift1m-serve: a BatchedServer (max_batch 64, max_wait 5 ms,
           k 10) over a GLOBAL session on the bulk-built 10^6 index, one
           driver loop (submit what has arrived, then step) over held-out
           queries: a closed loop of 2,048 requests gives the capacity C,
           Poisson arrivals at 0.5·C and 0.9·C (2,048 each, times drawn from
           --seed), a burst at 4·C (1,024) against max_queue 256 and a 1 s
           deadline (every admitted request served within the deadline plus
           one step), the readiness gate; requests/s, p50/p99/max latency,
           batch fill, shed counts, recall@10 of the served answers, no
           served id non-alive; then ``python -m repro_torch.launch.serve``
           at --scale 10000 (printed as ``reduced``) plain, --tiered and
           checkpointed in parallel, and --recover from the checkpoints;
  sharded  cell sift1m-sharded: the base placed by elastic.reshard (hash
           routing) into 8 shards of 2^17 slots (mesh 4 × 2) stacked on the
           card, in a one-rank NCCL group (its start timed; the query's
           all_gather and the insert's all_reduce run), rows in bf16 (the
           sharded config's vec_dtype); 2 rounds of
           512 routed inserts, 4 fan-out ops of 256 held-out queries, 512
           GLOBAL deletes and a flush; 2,048 MASK deletes and consolidate;
           a lockstep grow to 2^18 and 512 more inserts; a reshard to 4
           shards and one more query op. Acked inserts keep a unique gid on
           their owner, alive with their row through the grow and the
           remap; no answer non-alive; I1–I7 per shard after every round;
           no tombstone left; nothing refused; the first query op of each
           round bit-equal between the folded fan-out and the per-shard
           loop (whose launches are not counted); rates, consolidate, grow
           and reshard seconds, recall@10 of 1,000 held-out queries against
           score_topk over every alive row, peak memory, launches;
  sharded4 (not in the default phases; needs 4 cards, else exits 1) cell
           sift1m-sharded-4: the same stream on 4 NCCL ranks, one a card,
           each holding and linking 2 of the 8 shards, with the checks on
           every rank and one query op and one insert round traced for each
           card's busy share; then the stream stacked on cuda:0 as the
           control: every query op's ids and scores, every insert's gids
           and the gathered state before and after the reshard byte-equal
           to it; per-rank rates, peak memory, collective ms per op,
           placement seconds and launches;
  pods4    (not in the default phases; needs 4 cards, else exits 1) cell
           sift1m-pods-4: the same stream on a (2, 4, 2) pod mesh over 4
           NCCL ranks, each pod a replica of the 8 shards on 2 cards, each
           card holding and linking 4 of its pod's shards, each query op of
           256 split into 128 a pod, writes applied by every replica, the
           reshard tail to (2, 2, 2); then the pod loop on the same mesh
           stacked on cuda:0 as the control: every query op's ids and
           scores and every insert's gids on every rank, and each pod's
           gathered state before and after the reshard, byte-equal to it;
           per-rank rates, collective ms per op for the replica group and
           the pod-peer group apart, peak memory, placement seconds, busy
           and NCCL shares, launches;
  models   cell dlrm-rm2-serve: the full dlrm_rm2.config() (26 tables ×
           2^20 rows × 64, fp32, drawn on the card from a seed), logits
           held to a float64 loop reference on 16 samples (padded ids
           past both table ends), ms a step at B 512 and samples/s at
           B 262,144, retrieval_cand (1 query × 10^6 item embeddings, k
           100) through the score_topk kernel held to its plain version,
           then tools/torch_dlrm_retrieval.py's flow at the example's
           size (1,500 items inserted) and over 10^6 items (bulk build,
           top-10 overlap with brute force, 256 GLOBAL expiries, 256
           inserts, recall@10 of 1,000 users); the LM cells
           with bf16 serving weights: qwen3-1.7b at full depth (B 4 ×
           S 2,048 prefill, 32 greedy decode steps) and gemma2-27b,
           mistral-nemo-12b, phi3.5-moe and llama4-scout at full width
           with one layer period (at least 2 layers), printed as
           ``reduced``; every decode step's logits held to forward over the
           same prefix (bf16: relative L2 ≤ 0.05; the MoE models' check in
           fp32 with no token dropped, ≤ 1e-3), and the MoE models' bf16
           forward over the prompt held to fp32 forward at capacity factor
           1.25 (median relative L2 over every 8th position ≤ 0.05);
           prefill and decode tokens/s, peak memory, launches;
  gnn      the GNN family at full width, weights and random graphs of the
           published shapes from --seed: gat-cora-full (2,708 nodes, 10,556
           edges, padded to 3,072 / 10,752), graphsage-reddit-sampled (the
           CSR build of random_graph(232,965, 492, 602, 41) on the host,
           NeighborSampler batches of 1,024 targets at fanout 15-10: the
           sampler's host ms a batch, the copy to the card, steps on one
           batch and steps that each sample a fresh one),
           graphsage-products-full (2,449,029 nodes, 61,859,140 edges drawn
           on the card; forward only, printed as ``reduced``; 64 rows of the
           logits held to a float64 two-hop reference), gatedgcn-molecule
           and dimenet-molecule (128 graphs × 30 nodes × 64 edges, no
           self-loops; DimeNet's triplets from build_triplets, capped at
           32,768); ms a forward (the median of 10 after 2, of 3 for
           products), ms a train step (the median of 10 AdamW steps after
           2, the loss falling over them), nodes and edges per second, peak
           memory; each full-width forward and the sampled forward held to
           the CPU's forward of the same weights and inputs (relative L2
           error 1e-4); the path launches none of the kernels;
  train    the LM and DLRM training path: the five LM smoke configs and the
           DLRM smoke config from the same weights and numpy batches, the
           loss's gradients and one AdamW step on the card against the CPU
           (relative L2 within 1e-5 for loss and grad_norm, 1e-4 for the
           gradients, 1e-6 for the parameters after the step); qwen3-1.7b's
           train_4k config at full width (28 layers, d 2,048, vocab 151,936,
           bf16 compute, fp32 masters and AdamW state) at S 4,096 and the
           largest B that fits the card (from the peak memory of one step at
           B 1 and B 2; printed as ``reduced``), 1 + 5 steps on one repeated
           TokenStream batch: every loss, ms a step, tokens/s, peak memory,
           the last loss below the first; DLRM-RM2's train_batch at full size
           (26 tables × 2^20 × 64, B 65,536, dense table gradients), the first
           step's loss within 1e-5 of a float64 CPU forward of the same
           parameters and batch, then 1 + 5 steps: losses falling, parameters
           finite, ms a step, samples/s, peak memory; train_lm at qwen3's
           smoke config on the card, 30 steps straight against 20 steps, a
           simulated preemption and a resume for the last 10 (final losses
           within 1e-4 relative); the path launches none of the kernels;
  dryrun   the planner of ``repro_torch.launch.dryrun``: every non-skipped
           registry cell but the LM prefill_32k ones (planned by the CLI
           alone, printed as ``reduced``) traced on meta and planned for one
           card and for four (per-device bytes of params, optimizer state
           and batch by the sharding rules, the planned peak, FLOPs and
           bytes, the analytic collective bytes, the roofline terms at the
           card's peaks, fits within 0.9 of 80 GB), the traces spread over
           one process for every two cores; as each plan comes in, every cell
           planned to fit one card runs on the card in this process with
           seeded weights and inputs — the index cells as one shard of 8,192
           (2,048 at d 960) slots, every slot bulk-built but the insert
           cell's room for its batches, bf16 rows, and as four such shards
           stacked — for 1 warm, 3 timed and 1 counted step: ms, peak
           memory against the plan, kernel launches (the index cells'
           FLOPs, bytes and peak from the counted run, with the beam loop's
           trips beside JAX's max_steps bound); each kernel's launches by
           full shape, and the first launch at each shape held against the
           plain version on host copies of its inputs (gathers rtol 1e-4 /
           atol 1e-3, score_topk the same with ids equal outside near-ties,
           score_matrix 2e-4 / 2e-4·d); fails if a cell planned to fit did
           not run or ran past the card's memory, if the bf16-row gather,
           score_matrix or score_topk was not launched, or if a shape
           launched unchecked or disagreed; the whole manifest goes to
           build/dryrun_manifest.json.
Then the kernel table line, the card line as nvidia-smi prints it, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Without
a CUDA device, or without the repository beside it, it exits 2 and prints
no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

RTOL, ATOL = 1e-4, 1e-3         # the Pallas kernels' tolerance (tests/test_kernels.py)

KERNELS = {
    "gather_scores": dict(
        source="src/repro_torch/kernels/csrc/gather_scores.cu",
        replaces="src/repro/kernels/gather_distance.py:37"),
    "gather_scores_bf16": dict(
        source="src/repro_torch/kernels/csrc/gather_scores.cu",
        replaces="src/repro/kernels/gather_distance.py:37"),
    "gather_scores_q8": dict(
        source="src/repro_torch/kernels/csrc/gather_scores.cu",
        replaces="src/repro/kernels/gather_distance.py:87"),
    "score_topk": dict(
        source="src/repro_torch/kernels/csrc/score_topk.cu",
        replaces="src/repro/kernels/distance_matrix.py:146"),
    "score_matrix": dict(
        source="src/repro_torch/kernels/csrc/score_matrix.cu",
        replaces="src/repro/kernels/distance_matrix.py:59"),
    "entry_draw": dict(
        source="src/repro_torch/kernels/csrc/entry_draw.cu",
        replaces="none (src/repro/core/search.py:73 draws with jax.random.gumbel "
                 "and lax.top_k)"),
}
# the kernels of the f32 session paths (sift1m, maint, durable, tiered,
# serve); the bf16-row gather runs on the sharded path
F32_PATH_KERNELS = tuple(k for k in KERNELS if k != "gather_scores_bf16")
# (rows R, candidates n) of SELECT-NEIGHBORS' pair matrix at the sift1m
# settings (d = 128, pool 64, d_out 32, d_in 64, chunk 64): insert, GLOBAL
# repair, refine, LOCAL, RWALK
SELECT_SHAPES = ((64, 64), (4096, 64), (64, 96), (4096, 32), (4096, 8))


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line(all_cards: bool = False) -> str | list[str]:
    """The first card's (or every card's) name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    lines = out.stdout.strip().splitlines()
    return lines if all_cards else lines[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------

def _int_data(g, shape, device):
    import torch
    return torch.randint(-4, 5, shape, generator=g, device=device).float()


def _close(got, want, rtol=RTOL, atol=ATOL):
    import torch
    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    check(torch.equal(inf_g, inf_w), "-inf mask differs")
    m = ~inf_g
    if not bool(m.any()):                       # every entry -inf in both
        return 0.0
    err = (got[m] - want[m]).abs()
    tol = atol + rtol * want[m].abs()
    check(bool((err <= tol).all()), f"max error {float(err.max())} over tolerance")
    return float(err.max()) if err.numel() else 0.0


def _topk_ids_ok(gs, gi, ws, wi):
    """Gaussian data: ids equal except where the plain version's scores of
    the swapped entries lie within the tolerance of each other."""
    import torch
    diff = gi != wi
    if not bool(diff.any()):
        return 0
    rows = torch.nonzero(diff.any(1)).flatten()
    for r in rows.tolist():
        a, b = set(gi[r].tolist()), set(wi[r].tolist())
        lo = float(ws[r].min())
        tol = ATOL + RTOL * abs(lo)
        # swaps only inside the tie band at the boundary or between equal scores
        ok = all(abs(float(ws[r][j]) - float(gs[r][j])) <= tol
                 for j in range(ws.shape[1]))
        check(ok, f"score_topk row {r}: scores differ beyond tolerance")
        if a != b:
            check(abs(float(gs[r][-1]) - lo) <= tol,
                  f"score_topk row {r}: ids differ outside a near-tie")
    return int(diff.sum())


# widths the gathers are held at: fp32 rows take float4 pieces at 8, 32, 100,
# 128 and 960 and single floats at 130; codes take 16-byte pieces at 32, 128
# and 960 and single bytes at 8, 100 and 130; 960 is the ipgm-online
# serve_d960 cell's
GATHER_WIDTHS = (8, 32, 100, 128, 130, 960)
ROTATION_BYTES = 128 << 20      # rows one rotation of id sets reads: > 2 × the 50 MB L2


def id_rotation(g, N: int, B: int, C: int, row_bytes: int, dev):
    """[n, B, C] pre-drawn id sets whose rows together exceed twice the L2,
    so a call that takes the next set finds its rows cold, as a beam trip
    that expands new rows does."""
    import torch
    n = max(3, -(-ROTATION_BYTES // (B * C * row_bytes)))
    return torch.randint(0, N, (n, B, C), generator=g, device=dev, dtype=torch.int32)


def median_ms_rotating(fn, n_sets: int, runs: int = 20, warmup: int = 3,
                       calls: int = 1) -> float:
    """Median time per call of ``fn(i)``, each call on the next set i of a
    rotation of ``n_sets``; ``calls`` back-to-back calls a timed run."""
    turn = itertools.count()

    def batch():
        for _ in range(calls):
            fn(next(turn) % n_sets)
    return median_ms(batch, runs=runs, warmup=warmup) / calls


GRAPH_LAUNCHES = 32


def graph_ms_rotating(fn, n_sets: int) -> float:
    """Device time per launch: ``GRAPH_LAUNCHES`` calls of ``fn(i)``, each on
    the next set of a rotation, captured in one CUDA graph and replayed, so
    the host's cost of a launch is left out."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(GRAPH_LAUNCHES):
            fn(k % n_sets)
    ms = median_ms(graph.replay, runs=10, warmup=2) / GRAPH_LAUNCHES
    del graph
    return ms


def kernel_bound(work: tuple, dtype: str = "float32") -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel's (operations, bytes), as
    ``kernels/ops.py``'s ``*_work`` reckons them, at the card's peak for
    ``dtype`` (fp32, or int32 for the entry draw) and its HBM peak
    (``launch/analysis.py``)."""
    from repro_torch.launch.analysis import bound_ms
    ms, by = bound_ms(*work, dtype=dtype)
    return dict(bound_ms=ms, bound_by=by)


def gather_tables(torch, make, full, dev, n_small: int = 1 << 16):
    """(label, rows, (codes, scales)) at every width of ``GATHER_WIDTHS``
    (``full`` at 128), on a view offset by one row of an odd width (129) and
    on one offset by one element (d 128): both views take the narrow paths.
    An offset view's codes keep its offset."""
    from repro_torch.core.quantize import quantize_rows
    for d in GATHER_WIDTHS:
        t = full if d == 128 else make((n_small, d))
        yield f"d{d}", t, quantize_rows(t)
    base = make((n_small + 1, 129))
    c, s = quantize_rows(base)
    yield "d129_row_offset", base[1:], (c[1:], s[1:])
    t = make((n_small * 128 + 1,))[1:].view(n_small, 128)
    c, s = quantize_rows(t)
    c_off = torch.empty(c.numel() + 1, dtype=torch.int8, device=dev)[1:].view(c.shape)
    c_off.copy_(c)
    yield "d128_elem_offset", t, (c_off, s)


def edge_ids(torch, g, N: int, B: int, C: int, dev):
    """[B, C] random ids with -1, N-1, N in the first row and two more
    invalid ids inside warp tiles."""
    ids = torch.randint(0, N, (B, C), generator=g, device=dev, dtype=torch.int32)
    ids[0, :3] = torch.tensor([-1, N - 1, N], dtype=torch.int32)
    ids[1, 5], ids[B - 1, C - 1] = -7, N + 5
    return ids


def gather_exactness(torch, kops, kref, dev, g, xi, xg) -> dict:
    """Both gathers against their plain versions on ``gather_tables``, at
    B 64 × C 32 and B 4,096 × C 32 with ``edge_ids``: byte-equal on integer
    data, within rtol 1e-4 / atol 1e-3 on Gaussian data. Returns the
    largest Gaussian errors [fp32, q8] per case."""
    report = {}
    for kind in ("int", "gauss"):
        make = ((lambda shape: _int_data(g, shape, dev)) if kind == "int"
                else (lambda shape: torch.randn(shape, generator=g, device=dev)))
        full = xi if kind == "int" else xg
        for label, t, (codes, scales) in gather_tables(torch, make, full, dev):
            N, d = t.shape
            tsq = (t * t).sum(1)
            for B in (64, 4096):
                C = 32
                ids = edge_ids(torch, g, N, B, C, dev)
                q = make((B, d))
                for metric in ("l2", "ip"):
                    for name, tab, aux in (("gather_scores", t, tsq),
                                           ("gather_scores_q8", codes, scales)):
                        fn = getattr(kops, name)
                        pf = getattr(kref, name)
                        got, want = fn(tab, aux, ids, q, metric=metric), pf(tab, aux, ids, q, metric)
                        what = f"{name} {kind} {label} B={B} {metric}"
                        check(got.shape == (B, C), f"{what}: output shape")
                        if kind == "int":
                            check(torch.equal(got, want), f"{what}: integer data not exact")
                        else:
                            key = f"{label}_B{B}_{metric}"
                            report.setdefault(key, []).append(_close(got, want))
    return report


def gather_valid_lanes(torch, kops, dev, g, table) -> dict:
    """The gathers' in-kernel valid-lane count: armed, each of the three
    (f32, bf16, q8 rows; every tile size at B 64, 1,000 and 4,096 × C 32
    with ``edge_ids``, a quarter of the lanes set to -1) adds
    ``((ids >= 0) & (ids < N)).sum()`` and launches as often as unarmed,
    with the same bits; unarmed it adds nothing. Returns the counts."""
    from repro_torch.core.quantize import quantize_rows
    N = table.shape[0]
    tsq = (table * table).sum(1)
    codes, scales = quantize_rows(table)
    tables = {"gather_scores": (kops.gather_scores, table, tsq),
              "gather_scores_bf16": (kops.gather_scores, table.bfloat16(), tsq),
              "gather_scores_q8": (kops.gather_scores_q8, codes, scales)}
    counted = {}
    for B in (64, 1000, 4096):
        ids = edge_ids(torch, g, N, B, 32, dev)
        ids[torch.rand(ids.shape, generator=g, device=dev) < 0.25] = -1
        q = torch.randn((B, table.shape[1]), generator=g, device=dev)
        want = int(((ids >= 0) & (ids < N)).sum())
        for name, (fn, tab, aux) in tables.items():
            n0, v0 = kops.launches[name], kops.read_valid_lanes()[name]
            plain = fn(tab, aux, ids, q)
            v1 = kops.read_valid_lanes()[name]
            kops.arm_valid_lanes(True)
            try:
                armed = fn(tab, aux, ids, q)
            finally:
                kops.arm_valid_lanes(False)
            got = kops.read_valid_lanes()[name] - v1
            check(v1 == v0, f"{name} B={B}: an unarmed launch counted valid lanes")
            check(got == want, f"{name} B={B}: {got} valid lanes counted, {want} in the ids")
            check(kops.launches[name] - n0 == 2, f"{name} B={B}: arming added a launch")
            check(torch.equal(plain, armed), f"{name} B={B}: armed bits differ")
            counted[f"{name}_B{B}"] = [got, B * 32]
    return counted


def gather_graph_replay(torch, kops, dev, g, table, tsq) -> bool:
    """One gather_scores launch at B = 64, C = 32 captured in a CUDA graph,
    new ids and queries copied into its static inputs, replayed: the same
    bits as an eager call (the wrapper has no host sync or allocation that
    a captured beam trip could not hold)."""
    N, d = table.shape
    B, C = 64, 32

    def draw():
        return edge_ids(torch, g, N, B, C, dev), torch.randn((B, d), generator=g, device=dev)

    ids, q = draw()
    kops.gather_scores(table, tsq, ids, q)          # binds the library first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kops.gather_scores(table, tsq, ids, q)
    new_ids, new_q = draw()
    ids.copy_(new_ids)
    q.copy_(new_q)
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(out, kops.gather_scores(table, tsq, new_ids, new_q)))


def offset_copy(torch, src, dtype, offset: int):
    """``src`` in ``dtype`` at ``offset`` elements into a fresh buffer."""
    buf = torch.empty(src.numel() + offset, dtype=dtype, device=src.device)
    out = buf[offset:].view(src.shape)
    out.copy_(src)
    return out


def bf16_gather_exactness(torch, kops, kref, dev, g, xi, xg) -> dict:
    """The bf16-row gather on the bf16 cast of every ``gather_tables``
    table, at the table's element offset: bit-equal to the fp32 kernel on
    the f32 table of its widened rows at the same offset (so both take the
    same piece width), byte-equal to its plain version on integer data and
    within rtol 1e-4 / atol 1e-3 of it on Gaussian data, at B 64 and 4,096
    × C 32 with ``edge_ids``. Returns the largest Gaussian errors."""
    report = {}
    for kind in ("int", "gauss"):
        make = ((lambda shape: _int_data(g, shape, dev)) if kind == "int"
                else (lambda shape: torch.randn(shape, generator=g, device=dev)))
        full = xi if kind == "int" else xg
        for label, t, _ in gather_tables(torch, make, full, dev):
            N, d = t.shape
            off = t.storage_offset()
            tb = offset_copy(torch, t.bfloat16(), torch.bfloat16, off)
            tw = offset_copy(torch, tb.float(), torch.float32, off)
            tsq = (tw * tw).sum(1)
            for B in (64, 4096):
                ids = edge_ids(torch, g, N, B, 32, dev)
                q = make((B, d))
                for metric in ("l2", "ip"):
                    what = f"gather_scores_bf16 {kind} {label} B={B} {metric}"
                    got = kops.gather_scores(tb, tsq, ids, q, metric=metric)
                    check(torch.equal(got, kops.gather_scores(tw, tsq, ids, q, metric=metric)),
                          f"{what}: not bit-equal to the fp32 kernel on the widened rows")
                    want = kref.gather_scores(tb, tsq, ids, q, metric)
                    if kind == "int":
                        check(torch.equal(got, want), f"{what}: integer data not exact")
                    else:
                        report[f"{label}_B{B}_{metric}"] = _close(got, want)
    return report


def phase_kernels(torch, kops, kref, dev) -> dict:
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    N, d = 1 << 20, 128
    results = {}

    def gather_case(table, aux, ids, q, name, metric):
        fn = kops.gather_scores if name == "gather_scores" else kops.gather_scores_q8
        pf = kref.gather_scores if name == "gather_scores" else kref.gather_scores_q8
        return fn(table, aux, ids, q, metric=metric), pf(table, aux, ids, q, metric)

    # ---- gather_scores / gather_scores_q8: exact on integer data ----
    from repro_torch.core.quantize import quantize_rows
    xi = _int_data(g, (N, d), dev)
    xg = torch.randn((N, d), generator=g, device=dev)
    report = gather_exactness(torch, kops, kref, dev, g, xi, xg)
    report_bf16 = bf16_gather_exactness(torch, kops, kref, dev, g, xi, xg)
    # grown-tier table sizes and the tier boundary ids
    for M in (1 << 10, (1 << 10) + 1, 3 << 10, 1 << 17, (1 << 17) + 1, 3 << 17):
        t = xg[:M].contiguous()
        ids = torch.randint(0, M, (13, 17), generator=g, device=dev, dtype=torch.int32)
        ids[0, :3] = torch.tensor([M - 1, M, -1], dtype=torch.int32)
        q = torch.randn((13, d), generator=g, device=dev)
        _close(*gather_case(t, (t * t).sum(1), ids, q, "gather_scores", "l2"))
        c, s = quantize_rows(t)
        _close(*gather_case(c, s, ids, q, "gather_scores_q8", "l2"))
    valid_lanes = gather_valid_lanes(torch, kops, dev, g, xg)
    tsq = (xg * xg).sum(1)
    check(gather_graph_replay(torch, kops, dev, g, xg, tsq),
          "gather_scores: a captured launch replayed to other bits than an eager call")

    # timings at the GLOBAL-repair shape (B = 64·d_in = 4096, C = 32) and the
    # beam trip's B = 64, each call on the next id set of a rotation whose
    # rows exceed twice the L2 (cold rows): single calls through the wrapper
    # (``ms``, what an eager caller pays) and device time per launch
    # (``device_ms``, replayed from a CUDA graph)
    B, C = 4096, 32
    q = torch.randn((B, d), generator=g, device=dev)
    cg, sg = quantize_rows(xg)
    xb = xg.bfloat16()

    def lib_gather(ids, q, table=xg):
        safe = ids.long().flatten()
        rows = table.index_select(0, safe).view(*ids.shape, d).float()
        return (2.0 * torch.einsum("bcd,bd->bc", rows, q)
                - tsq.index_select(0, safe).view(ids.shape))

    def lib_gather_q8(ids, q):
        safe = ids.long().flatten()
        rows = cg.index_select(0, safe).view(*ids.shape, d).float()
        s = sg.index_select(0, safe).view(ids.shape)
        return s * (2.0 * torch.einsum("bcd,bd->bc", rows, q)
                    - s * torch.einsum("bcd,bcd->bc", rows, rows))

    for name, fn_name, table, aux, lib, row_bytes, errs in (
            ("gather_scores", "gather_scores", xg, tsq, lib_gather, 4 * d,
             [v[0] for v in report.values()]),
            ("gather_scores_bf16", "gather_scores", xb, tsq,
             lambda i, q: lib_gather(i, q, xb), 2 * d, list(report_bf16.values())),
            ("gather_scores_q8", "gather_scores_q8", cg, sg, lib_gather_q8, d,
             [v[1] for v in report.values()])):
        kfn, pfn = getattr(kops, fn_name), getattr(kref, fn_name)
        rot = id_rotation(g, N, B, C, row_bytes, dev)
        n = rot.shape[0]
        rot64 = id_rotation(g, N, 64, C, row_bytes, dev)
        n64 = rot64.shape[0]
        q64 = q[:64].contiguous()
        results[name] = dict(
            ms=median_ms_rotating(lambda i: kfn(table, aux, rot[i], q, metric="l2"), n),
            plain_ms=median_ms_rotating(lambda i: pfn(table, aux, rot[i], q, "l2"), n),
            library_ms=median_ms_rotating(lambda i: lib(rot[i], q), n),
            **kernel_bound(kops.gather_work(B, C, d, row_bytes)),
            max_abs_err=max(errs),
            device_ms=graph_ms_rotating(lambda i: kfn(table, aux, rot[i], q, metric="l2"), n),
            ms_B64=median_ms_rotating(lambda i: kfn(table, aux, rot64[i], q64), n64),
            device_ms_B64=graph_ms_rotating(lambda i: kfn(table, aux, rot64[i], q64), n64),
            plain_ms_B64=median_ms_rotating(lambda i: pfn(table, aux, rot64[i], q64, "l2"), n64),
            library_ms_B64=median_ms_rotating(lambda i: lib(rot64[i], q64), n64),
            bound_ms_B64=kernel_bound(kops.gather_work(64, C, d, row_bytes))["bound_ms"],
            rotation_sets=n, shape=dict(B=B, C=C, N=N, d=d))
        del rot, rot64
    del cg, sg, xb

    # ---- score_topk: ids identical on integer data ----
    # B = 1,000 is no multiple of the query tile (128, or 64 at k > 70) and
    # splits the rows; each n_valid below N cuts a row tile inside
    sms = kops.num_sms(dev)
    Bq, k = 1000, 10
    qi = _int_data(g, (Bq, d), dev)
    xsq_i = (xi * xi).sum(1)
    for metric in ("l2", "ip"):
        for (kk, nv) in ((1, N), (10, N), (65, N - 12345), (128, N - 77)):
            check(kops.topk_splits(Bq, nv, sms, kk) > 1, "multi-split case")
            gs, gi = kops.score_topk(xi, xsq_i, qi, kk, metric=metric, n_valid=nv)
            ws, wi = kref.score_topk(xi, xsq_i, qi, kk, metric, nv)
            check(torch.equal(gi, wi) and torch.equal(gs, ws),
                  f"score_topk {metric} k={kk} n_valid={nv}: integer data ids/scores differ")
    del gs, gi, ws, wi
    # one split: the query tiles alone cover the SMs four times (the bulk
    # build's row blocks at large n)
    M1 = 1 << 12
    B1 = 128 * 4 * sms
    q1 = _int_data(g, (B1, d), dev)
    x1 = xi[:M1].contiguous()
    for kk in (65, 128):
        check(kops.topk_splits(B1, M1, sms, kk) == 1, "single-split case")
        gs, gi = kops.score_topk(x1, (x1 * x1).sum(1), q1, kk, n_valid=M1 - 50)
        ws, wi = kref.score_topk(x1, (x1 * x1).sum(1), q1, kk, "l2", M1 - 50)
        check(torch.equal(gi, wi) and torch.equal(gs, ws),
              f"score_topk single split k={kk}: integer data ids/scores differ")
        del gs, gi, ws, wi
    del q1, x1
    # the serve_d960 cell's bulk build: each row of a full 2,048-slot shard
    # at d 960 against all of them, k 65 (k_nn 64 and the row itself), all
    # rows valid and n_valid cutting a row tile
    M9, d9 = ipgm_d960()
    x9 = _int_data(g, (M9, d9), dev)
    for metric in ("l2", "ip"):
        for nv in (M9, M9 - 50):
            gs, gi = kops.score_topk(x9, (x9 * x9).sum(1), x9, 65, metric=metric, n_valid=nv)
            ws, wi = kref.score_topk(x9, (x9 * x9).sum(1), x9, 65, metric, nv)
            check(torch.equal(gi, wi) and torch.equal(gs, ws),
                  f"score_topk d {d9} M {M9} {metric} n_valid={nv}: integer data ids/scores differ")
    del x9, gs, gi, ws, wi
    # all-negative ip padding case and grown tiers (Gaussian)
    xn = -xg[:123].abs().contiguous()
    qp = torch.randn((9, 64), generator=g, device=dev).abs()
    gs, gi = kops.score_topk(xn[:, :64].contiguous(), (xn[:, :64] ** 2).sum(1), qp, 7, metric="ip")
    ws, wi = kref.score_topk(xn[:, :64].contiguous(), (xn[:, :64] ** 2).sum(1), qp, 7, "ip")
    check(torch.equal(gi, wi), "score_topk all-negative ip padding case")
    for M in (1 << 10, (1 << 10) + 1, 3 << 10, 1 << 17, (1 << 17) + 1, 3 << 17):
        t = xg[:M].contiguous()
        q = torch.randn((13, d), generator=g, device=dev)
        gs, gi = kops.score_topk(t, (t * t).sum(1), q, 9)
        ws, wi = kref.score_topk(t, (t * t).sum(1), q, 9, "l2")
        _close(gs, ws)
        _topk_ids_ok(gs, gi, ws, wi)
        check(bool((gi < M).all()), "score_topk reported a padded row")
    qg = torch.randn((Bq, d), generator=g, device=dev)
    tsq = (xg * xg).sum(1)
    gs, gi = kops.score_topk(xg, tsq, qg, k)
    ws, wi = kref.score_topk(xg, tsq, qg, k, "l2")
    err = _close(gs, ws)
    swaps = _topk_ids_ok(gs, gi, ws, wi)

    def lib_topk():
        return torch.topk(2.0 * (qg @ xg.T) - tsq[None, :], k, dim=1)

    results["score_topk"] = dict(
        ms=median_ms(lambda: kops.score_topk(xg, tsq, qg, k)),
        plain_ms=median_ms(lambda: kref.score_topk(xg, tsq, qg, k, "l2"), runs=20, warmup=1),
        library_ms=median_ms(lib_topk, runs=20, warmup=1),
        **kernel_bound(kops.topk_work(Bq, N, d, k, "l2")),
        max_abs_err=err, id_swaps_near_ties=swaps,
        shape=dict(B=Bq, M=N, d=d, k=k))
    # the bulk build's block (no single library call: its [16384, 2^20]
    # score matrix would be 64 GiB)
    Bb, kb = 16384, 65
    qb = torch.randn((Bb, d), generator=g, device=dev)
    results["score_topk"]["ms_build_block"] = median_ms(
        lambda: kops.score_topk(xg, tsq, qb, kb), runs=5, warmup=1)
    results["score_topk"]["bound_ms_build_block"] = kernel_bound(
        kops.topk_work(Bb, N, d, kb, "l2"))["bound_ms"]
    del qb
    results["score_topk"].update(score_topk_b1_case(torch, kops, kref, dev, g))
    results["score_matrix"] = score_matrix_case(torch, kops, kref, dev, g, xg)
    results["gather_valid_lanes"] = valid_lanes
    results["entry_draw"] = entry_draw_case(torch, kops, kref, dev, g)
    return results


def index_present(torch, g, capacity: int, dev, rows: float = 0.954, holes: float = 0.001):
    """A bulk-built index's present flags: the first ``rows`` of the slots
    (10^6 of 2^20), with ``holes`` of them freed again at random."""
    present = torch.arange(capacity, device=dev) < int(rows * capacity)
    return present & (torch.rand(capacity, generator=g, device=dev) >= holes)


# (lanes, capacity, starts, share of lanes active, fold, present slots or
# None for a bulk-built index's): the search's query op, the GLOBAL
# repair's 4,096 lanes with half inactive, a pods shard's query op,
# insert_one's single key, and 512 lanes over 3 present slots of 2^12
ENTRY_DRAW_ROWS = ((512, 1 << 20, 2, 1.0, True, None), (4096, 1 << 20, 2, 0.5, True, None),
                   (512, 1 << 17, 2, 1.0, True, None), (1, 1 << 20, 2, 1.0, False, None),
                   (512, 1 << 12, 4, 1.0, True, 3))


def entry_draw_case(torch, kops, kref, dev, g) -> dict:
    """``entry_draw`` against its plain version on the card, id for id: at
    ``ENTRY_DRAW_ROWS`` over a bulk-built index's present flags (timed:
    kernel device ms by CUDA events, its int32 bound over the drawn lanes'
    present slots, the plain version's ms; no one library call computes
    it), and untimed over random holes (half the slots, so chunks are
    rarely full), with fewer present slots than starts (S 2 and 4), with
    offsets across 2^31, S 1 to 16, L 1 to 512 and the key on the card
    or the host. Through
    ``search.batch_entry_points``: one launch a call in
    ``launches_by_shape``, no ``topk`` or ``nonzero`` kernel and no
    allocation near lanes × capacity."""
    import types

    from repro_torch.core import prng, search
    from repro_torch.launch.analysis import device_kernels

    def both(present, key, L, S, **kw):
        got = kops.entry_draw(present, key, L, S, **kw)
        want = kref.entry_draw(present, key, L, S, **kw)
        check(torch.equal(got, want), f"entry_draw L {L} capacity {present.shape[0]} S {S} "
                                      f"{kw}: ids differ from the plain version")
        return got

    key = prng.prng_key(20260, device=dev)
    rows = []
    for L, cap, S, share, fold, n_present in ENTRY_DRAW_ROWS:
        if n_present is None:
            present = index_present(torch, g, cap, dev)
        else:
            present = torch.zeros(cap, dtype=torch.bool, device=dev)
            present[torch.randperm(cap, generator=g, device=dev)[:n_present]] = True
        active = (None if share == 1.0 else
                  torch.rand(L, generator=g, device=dev) < share)
        kw = dict(offset=977, active=active, fold=fold)
        got = both(present, key, L, S, **kw)
        drawn = L if active is None else int(active.sum())
        check(int((got[:, 0] >= 0).sum()) == drawn, "entry_draw: a drawn lane has no start")
        check(int((got >= 0).sum()) == drawn * min(S, int(present.sum())),
              "entry_draw: NULL where a present slot was left")
        wl, tile = kops.entry_plan(L, cap, kops.num_sms(dev))
        rows.append(dict(
            L=L, capacity=cap, S=S, active=drawn, fold=fold, lanes_per_warp=wl, tile=tile,
            present=int(present.sum()),
            ms=median_ms(lambda: kops.entry_draw(present, key, L, S, **kw), runs=20, warmup=3),
            plain_ms=median_ms(lambda: kref.entry_draw(present, key, L, S, **kw),
                               runs=3, warmup=1),
            **kernel_bound(kops.entry_draw_work(drawn, int(present.sum()), S), "int32"),
            library_ms=None))
        del present, active, got
    for L, cap, S, p in ((512, 1 << 17, 2, 0.5), (37, 5000, 16, 0.5), (33, 1 << 12, 4, 0.9),
                         (1, 777, 3, 0.5), (9, 70000, 1, 0.99)):
        present = torch.rand(cap, generator=g, device=dev) < p
        for offset in (0, 2**31 - 5, 2**32 - 3):
            for k in (key, key.cpu()):         # words read on the card, or passed
                both(present, k, L, S, offset=offset,
                     active=torch.rand(L, generator=g, device=dev) < 0.7)
        both(present, key.cpu(), L, S, fold=False)
    few = torch.zeros(1 << 12, dtype=torch.bool, device=dev)
    few[torch.tensor([5, 3000], device=dev)] = True
    for S in (2, 4):
        got = both(few[:2000], key, 64, S)     # one present slot
        check(bool((got[:, 1:] == -1).all()), "entry_draw: NULL past the present slots")
        both(few, key, 64, S)                   # two present slots
        both(torch.zeros(300, dtype=torch.bool, device=dev), key, 3, S)
    del few

    # the engine's call: one launch, no top-k or nonzero, nothing lanes × capacity wide
    L, cap = 512, 1 << 20
    state = types.SimpleNamespace(present=index_present(torch, g, cap, dev))
    active = torch.rand(L, generator=g, device=dev) < 0.9
    search.batch_entry_points(state, key, L, 2, offset=3, active=active)
    torch.cuda.synchronize()
    before = dict(kops.launches_by_shape["entry_draw"])
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        search.batch_entry_points(state, key, L, 2, offset=3, active=active)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - allocated
    names = sorted({name for _, _, name in device_kernels(prof)})
    after = kops.launches_by_shape["entry_draw"]
    check({k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
          == {(L, cap, 2): 1}, "batch_entry_points: not one entry_draw launch a call")
    check(not any("topk" in n.lower() or "nonzero" in n.lower() for n in names),
          f"batch_entry_points launched {names}")
    check(peak < L * cap // 8, f"batch_entry_points allocated {peak} bytes")
    return dict(rows=rows, ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
                bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
                library_ms=None, engine_call=dict(kernels=names, peak_bytes=peak))


def _topk_gap_ok(gs, gi, ws, wi, k: int) -> int:
    """Gaussian data against the plain version's top k + 1 (ws, wi): scores
    within the tolerance, and ids equal wherever the k-th and (k+1)-th
    scores lie further apart than it (in order, except between scores
    within it of each other). Returns the rows whose cut was a near-tie."""
    import torch
    _close(gs, ws[:, :k])
    near = 0
    for r in range(gs.shape[0]):
        s = ws[r]
        tol = ATOL + RTOL * abs(float(s[k - 1]))
        if float(s[k - 1] - s[k]) <= tol:
            near += 1
            continue
        check(set(gi[r].tolist()) == set(wi[r, :k].tolist()),
              f"score_topk row {r}: ids differ though the k-th score is no near-tie")
        gap = torch.full((k,), float("inf"), device=s.device)
        gap[:-1] = s[:k - 1] - s[1:k]
        apart = (gap > tol) & torch.cat([gap.new_tensor([float("inf")]), gap[:-1]]).gt(tol)
        check(torch.equal(gi[r][apart], wi[r, :k][apart]),
              f"score_topk row {r}: well-separated ids out of order")
    return near


# DLRM retrieval_cand: one query against 10^6 item embeddings, k 100 (the
# retrieval step's), metric ip. k > TOPK_WIDE_MAX_K takes the 64-query tile
# with one live query; 10^6 and 10^6 - 37 rows end in a ragged row tile.
RETRIEVAL_M, RETRIEVAL_D, RETRIEVAL_K = 1_000_000, 64, 100


def score_topk_b1_case(torch, kops, kref, dev, g) -> dict:
    """score_topk at the retrieval shape against its plain version: ids and
    scores identical on integer data, ids equal away from near-ties on
    Gaussian data; kernel, plain and ``matmul`` + ``topk`` times beside the
    bytes bound (every row read once)."""
    M, d, k = RETRIEVAL_M, RETRIEVAL_D, RETRIEVAL_K
    check(k > kops.TOPK_WIDE_MAX_K and kops.topk_query_tile(k) == 64,
          "retrieval case: k must take the 64-query tile")
    xi, qi = _int_data(g, (M, d), dev), _int_data(g, (1, d), dev)
    xg, qg = torch.randn((M, d), generator=g, device=dev), torch.randn((1, d), generator=g, device=dev)
    near = 0
    for m in (M, M - 37):
        check(m % kops.TOPK_ROWS_PER_TILE != 0, "retrieval case: a ragged row tile")
        x = xi[:m]
        gs, gi = kops.score_topk(x, (x * x).sum(1), qi, k, metric="ip")
        ws, wi = kref.score_topk(x, (x * x).sum(1), qi, k, "ip")
        check(torch.equal(gi, wi) and torch.equal(gs, ws),
              f"score_topk B 1 k {k} ip M {m}: integer data ids/scores differ")
        x = xg[:m]
        gs, gi = kops.score_topk(x, (x * x).sum(1), qg, k, metric="ip")
        ws, wi = kref.score_topk(x, (x * x).sum(1), qg, k + 1, "ip")
        near += _topk_gap_ok(gs, gi, ws, wi, k)
    err = float((gs - ws[:, :k]).abs().max())
    xsq = (xg * xg).sum(1)
    planned = kops.topk_splits(1, M, kops.num_sms(dev), k)
    return {"retrieval_b1": dict(
        ms=median_ms(lambda: kops.score_topk(xg, xsq, qg, k, metric="ip")),
        plain_ms=median_ms(lambda: kref.score_topk(xg, xsq, qg, k, "ip")),
        library_ms=median_ms(lambda: torch.topk(qg @ xg.T, k, dim=1)),
        **kernel_bound(kops.topk_work(1, M, d, k, "ip")),
        max_abs_err=err, near_tie_cuts=near, splits=planned,
        shape=dict(B=1, M=M, d=d, k=k, metric="ip"))}


def matrix_tol(dtype, d: int) -> dict:
    """score_matrix's tolerance, as the Pallas tests': 2e-4 / 2e-4·d in
    fp32, 2e-2 / 2e-2·d in bf16."""
    import torch
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    return dict(rtol=t, atol=t * d)


def ipgm_d960():
    """(capacity, dim) of the ipgm-online serve_d960 cell's shard."""
    from repro_torch.configs import registry as reg
    cfg = reg.get_arch("ipgm-online").config_for_shape("serve_d960")
    return cfg.capacity, cfg.dim


def score_matrix_case(torch, kops, kref, dev, g, xg) -> dict:
    """score_matrix against its plain version: byte-equal on integer data,
    within the Pallas tolerances on Gaussian fp32 and bf16 data, at the
    select shapes (x and q one tensor, as select calls it), the Pallas test
    shapes and the grown-tier row counts at B = 13."""
    d = 128
    errs = []

    def sq(x):
        return (x.float() * x.float()).sum(-1)

    for R, n in SELECT_SHAPES:
        xi = _int_data(g, (R, n, d), dev)
        for metric in ("l2", "ip"):
            check(torch.equal(kops.score_matrix(xi, sq(xi), xi, metric=metric),
                              kref.score_matrix(xi, sq(xi), xi, metric)),
                  f"score_matrix R={R} n={n} {metric}: integer data not exact")
        xb = xi.to(torch.bfloat16)
        check(torch.equal(kops.score_matrix(xb, sq(xb), xb),
                          kref.score_matrix(xb, sq(xb), xb)),
              f"score_matrix R={R} n={n} bf16: integer data not exact")
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((R, n, d), generator=g, device=dev).to(dtype)
            e = _close(kops.score_matrix(x, sq(x), x),
                       kref.score_matrix(x, sq(x), x), **matrix_tol(dtype, d))
            if dtype == torch.float32:
                errs.append(e)
    # the self path (q is x; n <= 64) against the general path (q a copy of
    # x) and the plain version, at every n the self path sizes its tiles by
    # and past its limit; R = 515 is no multiple of any group of rows
    self_equals_general = True
    for n in (1, 8, 31, 32, 33, 64, 96, 128):
        xi = _int_data(g, (515, n, d), dev)
        xg3 = torch.randn((515, n, d), generator=g, device=dev)
        check(kops.is_self_pair(xi, xi) == (n <= kops.SELF_MAX_N)
              and not kops.is_self_pair(xi, xi.clone()),
              f"score_matrix n={n}: self-path routing")
        for metric in ("l2", "ip"):
            got = kops.score_matrix(xi, sq(xi), xi, metric=metric)
            check(torch.equal(got, kref.score_matrix(xi, sq(xi), xi, metric))
                  and torch.equal(got, kops.score_matrix(xi, sq(xi), xi.clone(),
                                                         metric=metric)),
                  f"score_matrix self n={n} {metric}: integer data not exact")
            got = kops.score_matrix(xg3, sq(xg3), xg3, metric=metric)
            errs.append(_close(got, kref.score_matrix(xg3, sq(xg3), xg3, metric),
                               **matrix_tol(torch.float32, d)))
            gen = kops.score_matrix(xg3, sq(xg3), xg3.clone(), metric=metric)
            _close(got, gen, **matrix_tol(torch.float32, d))
            self_equals_general &= bool(torch.equal(got, gen))
    # the self path at the serve_d960 cell's width: SELECT-NEIGHBORS of its
    # bulk build takes pools of 64 at d 960
    _, d9 = ipgm_d960()
    for n in (1, 33, 64):
        xi = _int_data(g, (515, n, d9), dev)
        check(kops.is_self_pair(xi, xi), f"score_matrix d {d9} n={n}: self-path routing")
        for metric in ("l2", "ip"):
            got = kops.score_matrix(xi, sq(xi), xi, metric=metric)
            check(torch.equal(got, kref.score_matrix(xi, sq(xi), xi, metric))
                  and torch.equal(got, kops.score_matrix(xi, sq(xi), xi.clone(),
                                                         metric=metric)),
                  f"score_matrix self d {d9} n={n} {metric}: integer data not exact")
    for M, B, dd in ((300, 50, 200), (512, 128, 128), (1000, 17, 960),
                     (257, 33, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            for metric in ("l2", "ip"):
                x = torch.randn((M, dd), generator=g, device=dev).to(dtype)
                q = torch.randn((B, dd), generator=g, device=dev).to(dtype)
                e = _close(kops.score_matrix(x, sq(x), q, metric=metric),
                           kref.score_matrix(x, sq(x), q, metric), **matrix_tol(dtype, dd))
                if dtype == torch.float32:
                    errs.append(e)
    for M in (1 << 10, (1 << 10) + 1, 3 << 10, 1 << 17, (1 << 17) + 1, 3 << 17):
        x = xg[:M].contiguous()
        q = torch.randn((13, d), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xx, qq = x.to(dtype), q.to(dtype)
            got = kops.score_matrix(xx, sq(xx), qq)
            check(got.shape == (13, M), "score_matrix output not cropped to [B, M]")
            e = _close(got, kref.score_matrix(xx, sq(xx), qq, "l2"), **matrix_tol(dtype, d))
            if dtype == torch.float32:
                errs.append(e)

    ms_by_shape, general_ms_by_shape, library_ms_by_shape, bound_ms_by_shape = {}, {}, {}, {}
    for R, n in SELECT_SHAPES:
        x = torch.randn((R, n, d), generator=g, device=dev)
        xsq = sq(x)
        xc = x.clone()
        key = f"R{R}_n{n}"
        ms_by_shape[key] = median_ms(lambda: kops.score_matrix(x, xsq, x))
        general_ms_by_shape[key] = median_ms(lambda: kops.score_matrix(x, xsq, xc))
        library_ms_by_shape[key] = median_ms(lambda: torch.baddbmm(
            -xsq[:, None, :], x, x.transpose(1, 2), alpha=2.0))
        bound_ms_by_shape[key] = kernel_bound(
            kops.matrix_work(R, n, n, d, 4, True))["bound_ms"]
    R, n = 4096, 64                      # the GLOBAL-repair select
    x = torch.randn((R, n, d), generator=g, device=dev)
    xsq = sq(x)
    return dict(
        ms=median_ms(lambda: kops.score_matrix(x, xsq, x)),
        plain_ms=median_ms(lambda: kref.score_matrix(x, xsq, x, "l2")),
        library_ms=median_ms(lambda: torch.baddbmm(
            -xsq[:, None, :], x, x.transpose(1, 2), alpha=2.0)),
        **kernel_bound(kops.matrix_work(R, n, n, d, 4, True)),     # q is x
        max_abs_err=max(errs), ms_by_shape=ms_by_shape,
        general_ms_by_shape=general_ms_by_shape,
        library_ms_by_shape=library_ms_by_shape,
        bound_ms_by_shape=bound_ms_by_shape,
        self_equals_general_gaussian=self_equals_general,
        shape=dict(R=R, B=n, M=n, d=d))


# ---------------------------------------------------------------------------
# card vs CPU session parity
# ---------------------------------------------------------------------------

def run_parity_session(device: str, seed: int = 0) -> dict:
    import numpy as np

    from repro_torch.core import IndexParams, MaintenanceParams, SearchParams, Session
    from repro_torch.core.graph import graph_state_to_numpy

    params = IndexParams(
        capacity=4096, dim=32, d_out=8,
        search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
        maintenance=MaintenanceParams(strategy="global"))
    rng = np.random.default_rng(seed)
    s = Session(params, seed=seed, device=device)
    out = {"ids0": s.insert(rng.integers(-4, 5, (1024, 32)).astype(np.float32)).result()}
    alive = set(out["ids0"].tolist())
    for rnd in range(2):
        Q = rng.integers(-4, 5, (256, 32)).astype(np.float32)
        out[f"q{rnd}"] = s.query(Q, k=10).result()
        ins = s.insert(rng.integers(-4, 5, (256, 32)).astype(np.float32)).result()
        out[f"ins{rnd}"] = ins
        alive |= set(ins[ins >= 0].tolist())
        dels = rng.choice(sorted(alive), 256, replace=False).astype(np.int32)
        s.delete(dels)
        alive -= set(dels.tolist())
        s.flush()
    qparams = dataclasses.replace(params, search=dataclasses.replace(
        params.search, quantized=True, rerank_depth=16))
    sq = Session(qparams, seed=seed + 1, state=s.state)
    out["quantized"] = sq.query(rng.integers(-4, 5, (128, 32)).astype(np.float32), k=10).result()
    out["state"] = graph_state_to_numpy(s.state)
    return out


def run_parity_build(device: str) -> dict:
    """bulk_knn_build of integer-valued rows, big enough that score_topk
    runs both its single-split and its multi-split form."""
    import numpy as np

    from repro_torch.core import IndexParams, SearchParams
    from repro_torch.core.graph import graph_state_to_numpy
    from repro_torch.core.rebuild import bulk_knn_build

    rng = np.random.default_rng(2)
    n = 9000
    X = rng.integers(-4, 5, (n, 32)).astype(np.float32)
    valid = rng.random(n) > 0.05
    params = IndexParams(capacity=9216, dim=32, d_out=8,
                         search=SearchParams(pool_size=16, num_starts=2))
    return graph_state_to_numpy(bulk_knn_build(X, valid, params, k_nn=16,
                                               device=device))


def run_parity_maint(device: str) -> dict:
    """LOCAL and RWALK sessions, a MASK session with consolidation armed and
    an explicit refine pass, and an armed session that grows twice."""
    import numpy as np

    from repro_torch.core import IndexParams, MaintenanceParams, SearchParams, Session
    from repro_torch.core.graph import graph_state_to_numpy

    def params(capacity, **mkw):
        return IndexParams(
            capacity=capacity, dim=32, d_out=8,
            search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
            maintenance=MaintenanceParams(insert_chunk=64, delete_chunk=64, **mkw))

    scenarios = {
        "local": params(1024, strategy="local"),
        "rwalk": params(1024, strategy="rwalk"),
        "mask": params(1024, strategy="mask", consolidate_threshold=0.15),
        "grow": params(256, strategy="global", max_capacity=2048),
    }
    out = {}
    for i, (name, p) in enumerate(scenarios.items()):
        rng = np.random.default_rng(10 + i)
        s = Session(p, seed=i, device=device)
        res = {"ins0": s.insert(rng.integers(-4, 5, (512, 32)).astype(np.float32)).result()}
        alive = set(res["ins0"].tolist())
        for rnd in range(2):
            res[f"q{rnd}"] = s.query(rng.integers(-4, 5, (128, 32)).astype(np.float32),
                                     k=10).result()
            ins = s.insert(rng.integers(-4, 5, (128, 32)).astype(np.float32)).result()
            res[f"ins{rnd + 1}"] = ins
            alive |= set(ins[ins >= 0].tolist())
            dels = rng.choice(sorted(alive), 128, replace=False).astype(np.int32)
            s.delete(dels)
            alive -= set(dels.tolist())
            s.flush()
        if name == "mask":
            s.refine(n=256)
            s.flush()
        t = s.timers
        res["counters"] = np.array([t.n_consolidations, t.n_grows, t.n_refines,
                                    s.state.capacity])
        res["state"] = graph_state_to_numpy(s.state)
        out[name] = res
    return out


def run_parity_reference(device: str) -> dict:
    """The sequential oracles and the serving front end: a
    ``local_reference`` and a ``global_reference`` session stream, the
    reference engine against the batched engine at W = 1 (filtered and raw,
    with MASK tombstones; equal on this device), ``consolidate_reference``
    on a MASK index and one ``BatchedServer`` step."""
    import numpy as np

    from repro_torch.core import IndexParams, MaintenanceParams, SearchParams, Session
    from repro_torch.core import prng, search
    from repro_torch.core.consolidate import consolidate_reference
    from repro_torch.core.graph import graph_state_to_numpy
    from repro_torch.core.maintenance import IPGMIndex
    from repro_torch.serving import BatchedServer, ServeConfig

    def params(strategy):
        return IndexParams(
            capacity=1024, dim=32, d_out=8,
            search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
            maintenance=MaintenanceParams(strategy=strategy, insert_chunk=64,
                                          delete_chunk=64))

    def rows(rng, n):
        return rng.integers(-4, 5, (n, 32)).astype(np.float32)

    out = {}
    for i, strategy in enumerate(("local_reference", "global_reference")):
        rng = np.random.default_rng(20 + i)
        s = Session(params(strategy), seed=i, device=device)
        res = {"ins0": s.insert(rows(rng, 384)).result()}
        alive = set(res["ins0"].tolist())
        for rnd in range(2):
            res[f"q{rnd}"] = s.query(rows(rng, 64), k=10).result()
            ins = s.insert(rows(rng, 64)).result()
            res[f"ins{rnd + 1}"] = ins
            alive |= set(ins[ins >= 0].tolist())
            dels = rng.choice(sorted(alive), 64, replace=False).astype(np.int32)
            s.delete(dels)
            alive -= set(dels.tolist())
            s.flush()
        res["state"] = graph_state_to_numpy(s.state)
        out[strategy] = res

    # the reference engine against the batched one at W = 1, tombstones in
    # (on a copy: on the CPU the state arrays above share the tensors' memory)
    st = _clone_state(s.state)
    st.alive[: st.capacity // 8] = False
    st.size.fill_(int(st.alive.sum()))
    sp = params("mask").search
    Q = rows(np.random.default_rng(30), 48)
    eng = {}
    for raw in (False, True):
        tag = "raw" if raw else "alive"
        ref = (search.search_batch_reference_raw if raw else
               search.search_batch_reference)(st, Q, prng.prng_key(5), sp)
        bat = (search.search_batch_raw if raw else search.search_batch)(
            st, Q, prng.prng_key(5), sp)
        for name in ("ids", "scores", "n_expanded"):
            check(bool(getattr(ref, name).eq(getattr(bat, name)).all()),
                  f"parity: reference engine differs from the batched one "
                  f"in {tag} {name} on {device}")
        eng[tag] = tuple(x.cpu().numpy() for x in ref)
    out["engine"] = eng

    rng = np.random.default_rng(31)
    idx = IPGMIndex(params("mask"), seed=3, device=device)
    ids = idx.insert(rows(rng, 320))
    idx.delete(rng.choice(ids, 80, replace=False))
    n = consolidate_reference(idx, strategy="global")
    check(n == 80 and idx.strategy == "mask",
          f"parity: consolidate_reference removed {n} of 80 tombstones")
    out["consolidate_reference"] = graph_state_to_numpy(idx.state)

    srv = BatchedServer(idx, ServeConfig(max_batch=32, k=10, max_wait_s=0.0))
    rids = [srv.submit(q) for q in rows(rng, 20)]
    served = srv.step()
    out["server_step"] = (np.stack([served[r][0] for r in rids]),
                          np.stack([served[r][1] for r in rids]))
    return out


def run_parity_sharded(device: str) -> dict:
    """A small sharded stream, S 8 (mesh 4 × 2), cap 64, integer-valued rows,
    f32 and bf16: routed inserts, fan-out queries, GLOBAL, LOCAL and MASK
    deletes, a consolidation and a lockstep grow."""
    import numpy as np

    from repro_torch.core import IndexParams, MaintenanceParams, SearchParams
    from repro_torch.core.graph import graph_state_to_numpy
    from repro_torch.distributed import DistParams, ShardedSession, ShardMesh

    mesh = ShardMesh((4, 2), ("data", "model"))
    rng = np.random.default_rng(5)
    X = rng.integers(-4, 5, (384, 16)).astype(np.float32)
    Q = rng.integers(-4, 5, (32, 16)).astype(np.float32)
    out = {}
    for vd in ("float32", "bfloat16"):
        ip = IndexParams(capacity=64, dim=16, d_out=8,
                         search=SearchParams(pool_size=16, max_steps=32, num_starts=2),
                         maintenance=MaintenanceParams(delete_chunk=16,
                                                       consolidate_chunk=16,
                                                       max_capacity=128))
        sess = ShardedSession(DistParams(index=ip, vec_dtype=vd), mesh, seed=7,
                              device=device)
        r = {"g0": sess.insert(X[:192], np.arange(192)).cpu().numpy()}
        r["q0"] = tuple(t.cpu().numpy() for t in sess.query(Q))
        g = r["g0"]
        for i, strategy in enumerate(("global", "local", "mask")):
            sess.strategy = strategy
            sess.delete(g[i::6][:24])
        sess.consolidate()
        sess.grow(128)
        r["g1"] = sess.insert(X[192:], np.arange(192, 384)).cpu().numpy()
        sess.flush()
        r["q1"] = tuple(t.cpu().numpy() for t in sess.query(Q))
        r["state"] = {f: (a.view(np.uint16) if a.dtype.itemsize == 2 else a)
                      for f, a in graph_state_to_numpy(sess.state).items()}
        r["counters"] = np.asarray([sess.timers.n_grows, sess.timers.n_consolidated,
                                    sess.timers.n_refused])
        out[vd] = r
    return out


MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-4   # fp32 smoke models, card vs CPU: summation order only


def run_parity_models(device: str) -> dict:
    """The model zoo at smoke size on one device, from weights drawn on the
    CPU: DLRM's serve step and retrieval (integer rows and query, so the
    top-100 ids are exact), and a dense (qwen3) and an MoE (phi3.5) LM's
    prefill and three decode steps."""
    import numpy as np
    import torch

    from repro_torch.configs import registry as reg
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.train import steps

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def t(a):
        return torch.as_tensor(a).to(device)

    rng = np.random.default_rng(7)
    cfg = reg.get_arch("dlrm-rm2").smoke_config()
    model = dlrm_mod.init_params(cfg, gen(0)).to(device)
    batch = {"dense": t(rng.normal(size=(64, cfg.n_dense)).astype(np.float32)),
             "sparse_ids": t(rng.integers(-3, cfg.n_rows + 3, (64, cfg.n_sparse, cfg.nnz))),
             "sparse_mask": t(rng.random((64, cfg.n_sparse, cfg.nnz)) > 0.3)}
    out = {"dlrm": {"serve": steps.make_dlrm_serve_step(cfg)(model, batch)}}
    cands = t(rng.integers(-4, 5, (3000, 8)).astype(np.float32))
    q = t(rng.integers(-4, 5, (3, 8)).astype(np.float32))
    out["dlrm"]["retrieval"] = dlrm_mod.retrieval_scores(q, cands, 100)
    for arch in ("qwen3-1.7b", "phi3.5-moe-42b-a6.6b"):
        cfg = reg.get_arch(arch).smoke_config()
        model = tfm.init_params(cfg, gen(1)).to(device)
        tokens = t(rng.integers(0, cfg.vocab, (2, 21)))
        logits, cache = steps.make_lm_prefill_step(cfg, 24)(model, {"tokens": tokens})
        r = {"prefill": logits}
        for i in range(3):
            nxt = t(rng.integers(0, cfg.vocab, (2, 1)))
            r[f"decode{i}"], cache = steps.make_lm_decode_step(cfg)(
                model, cache, {"tokens": nxt})
        r["cache_last_layer"] = cache["kv"][-1]
        out[arch] = r
    return {k: v.cpu().numpy() for k, v in _flatten(out)}


def models_parity() -> dict:
    """run_parity_models on the card against the CPU: integer outputs
    equal, float outputs within MODEL_RTOL / MODEL_ATOL."""
    import numpy as np
    gpu, cpu = run_parity_models("cuda"), run_parity_models("cpu")
    check(gpu.keys() == cpu.keys(), "parity: model result keys differ")
    err = 0.0
    for k in gpu:
        a, b = gpu[k], cpu[k]
        if a.dtype.kind in "iub":
            check(np.array_equal(a, b), f"parity: model output {k} differs")
        else:
            check(bool(np.isfinite(a).all()) and np.allclose(a, b, rtol=MODEL_RTOL,
                                                              atol=MODEL_ATOL),
                  f"parity: model output {k} off by {float(np.abs(a - b).max())}")
            err = max(err, float(np.abs(a - b).max()))
    return dict(models_compared=len(gpu), models_max_abs_err=err)


def _flatten(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), obj


def phase_parity() -> dict:
    import numpy as np
    t0 = time.perf_counter()
    gpu = dict(_flatten({"session": run_parity_session("cuda"),
                         "build": run_parity_build("cuda"),
                         "maint": run_parity_maint("cuda"),
                         "reference": run_parity_reference("cuda"),
                         "sharded": run_parity_sharded("cuda")}))
    t1 = time.perf_counter()
    cpu = dict(_flatten({"session": run_parity_session("cpu"),
                         "build": run_parity_build("cpu"),
                         "maint": run_parity_maint("cpu"),
                         "reference": run_parity_reference("cpu"),
                         "sharded": run_parity_sharded("cpu")}))
    t2 = time.perf_counter()
    check(gpu.keys() == cpu.keys(), "parity: result keys differ")
    bad = [k for k in gpu if not np.array_equal(gpu[k], cpu[k])]
    check(not bad, f"parity: card and CPU differ in {bad}")
    # the maintenance each scenario exists for really fired
    mask, grow = gpu["maint.mask.counters"], gpu["maint.grow.counters"]
    check(mask[0] >= 1 and mask[2] == 1, "parity: MASK session did not consolidate/refine")
    check(grow[1] >= 1 and grow[3] > 256, "parity: armed session did not grow")
    for vd in ("float32", "bfloat16"):
        n_grows, n_cons, n_refused = gpu[f"sharded.{vd}.counters"]
        check(n_grows == 1 and n_cons > 0 and n_refused == 0,
              f"parity: the {vd} sharded stream did not grow or consolidate")
    check(gpu["sharded.bfloat16.state.vectors"].dtype == np.uint16,
          "parity: the bf16 sharded state does not hold bf16 rows")
    return dict(compared=len(gpu), cuda_s=t1 - t0, cpu_s=t2 - t1, **models_parity(),
                **gnn_parity())


def gather_shape_split(kops) -> dict:
    """The gathers' launches by (B, C), most launched first."""
    return {name: {f"B{b}xC{c}": n for (b, c), n in sorted(
        kops.launches_by_shape[name].items(), key=lambda kv: -kv[1])}
        for name in kops.GATHERS}


# ---------------------------------------------------------------------------
# the main path at SIFT1M scale
# ---------------------------------------------------------------------------

def sift_params(capacity: int, **maintenance):
    """The cells' ipgm_ann d = 128 settings (PERF.md §4)."""
    from repro_torch.core import IndexParams, MaintenanceParams, SearchParams
    return IndexParams(
        capacity=capacity, dim=128, d_out=32, d_in=64,
        search=SearchParams(pool_size=64, max_steps=128, num_starts=2),
        maintenance=MaintenanceParams(insert_chunk=64, delete_chunk=64,
                                      **maintenance))


def sift_capacity(n_base: int, n_extra: int) -> int:
    return 1 << max(10, (n_base + n_extra - 1).bit_length())


def phase_sift1m(torch, n_base: int, rounds: int, per_round: int) -> dict:
    import numpy as np

    from repro_torch.core import Session
    from repro_torch.core.graph import NULL
    from repro_torch.core.health import check_health
    from repro_torch.core.rebuild import bulk_knn_build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ops as kops

    n_ins = rounds * per_round
    data = make_dataset("sift", n_base + n_ins + 1000, seed=0)
    base, fresh, held = data[:n_base], data[n_base:n_base + n_ins], data[n_base + n_ins:]
    stream_q = make_dataset("sift", max(n_ins, 1), seed=1)
    capacity = sift_capacity(n_base, n_ins)
    params = sift_params(capacity, strategy="global")
    qparams = dataclasses.replace(params, search=dataclasses.replace(
        params.search, quantized=True, rerank_depth=64))
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()                       # the main path starts here

    t0 = time.perf_counter()
    state = bulk_knn_build(base, np.ones(n_base, bool), params, k_nn=64)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sess = Session(params, state=state, seed=0)

    def recalls(tag):
        r32 = sess.recall(held, 10)
        rq = Session(qparams, state=sess.state, seed=0).recall(held, 10)
        return {f"recall10_fp32_{tag}": r32, f"recall10_q8_rerank64_{tag}": rq}

    out = {"n_base": n_base, "capacity": capacity, "build_s": build_s}
    out.update(recalls("before"))
    alive = np.zeros(capacity, bool)
    alive[:n_base] = True
    acked = {}
    op_s = {"query": 0.0, "insert": 0.0, "delete": 0.0}
    for rnd in range(rounds):
        sl = slice(rnd * per_round, (rnd + 1) * per_round)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, _ = sess.query(stream_q[sl], k=10).result()
        op_s["query"] += time.perf_counter() - t
        live = sess.state.alive.cpu().numpy()
        rep = ids[ids != NULL]
        check(bool(live[rep].all()), "a query reported a non-alive id")
        t = time.perf_counter()
        new = sess.insert(fresh[sl]).result()
        op_s["insert"] += time.perf_counter() - t
        check(bool((new != NULL).all()), "an insert was refused")
        for j, v in zip(new.tolist(), range(sl.start, sl.stop)):
            acked[j] = v
        alive[new] = True
        dels = rng.choice(np.flatnonzero(alive), per_round, replace=False).astype(np.int32)
        t = time.perf_counter()
        sess.delete(dels)
        sess.flush()
        op_s["delete"] += time.perf_counter() - t
        alive[dels] = False
        for j in dels.tolist():
            acked.pop(j, None)
    sess.flush()
    st = sess.state
    live = st.alive.cpu().numpy()
    check(bool((live == alive).all()), "alive set differs from the host's book")
    keep = np.array(sorted(acked), np.int64)
    rows = st.vectors[torch.as_tensor(keep, device=st.device)].cpu().numpy()
    check(bool(np.array_equal(rows, fresh[[acked[j] for j in keep.tolist()]])),
          "an acked insert's row differs from the inserted vector")
    check(int(st.size) == int(st.alive.sum()), "size != alive.sum()")
    errs = check_health(st)
    check(not errs, f"health check: {errs}")
    out.update(recalls("after"))
    for tag in ("before", "after"):
        gap = out[f"recall10_fp32_{tag}"] - out[f"recall10_q8_rerank64_{tag}"]
        check(gap <= 0.02, f"quantized+rerank recall trails fp32 by {gap} ({tag})")
    torch.cuda.synchronize()
    out["launches"] = dict(kops.launches)    # the main path ends here
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["items_per_s"] = {k: rounds * per_round / v for k, v in op_s.items() if v > 0}
    out["timers"] = sess.timers.to_dict()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for name in F32_PATH_KERNELS:
        check(out["launches"][name] > 0, f"kernel {name} was not launched on the main path")
    return out


# ---------------------------------------------------------------------------
# the maintenance path: the paper's §6 protocol at SIFT1M scale
# ---------------------------------------------------------------------------

MAINT_ORDER = ("pure", "global", "rwalk", "local", "rebuild", "mask")


def _clone_state(state):
    from repro_torch.core.graph import DATA_FIELDS
    return dataclasses.replace(
        state, **{f: getattr(state, f).clone() for f in DATA_FIELDS})


def _verify_session(torch, sess, acked: dict, name: str) -> None:
    """Acked inserts alive and bit-exact, size == alive.sum(), health."""
    import numpy as np

    from repro_torch.core.health import check_health
    st = sess.state
    keep = np.array(sorted(acked), np.int64)
    idx = torch.as_tensor(keep, device=st.device)
    check(bool(st.alive[idx].all()), f"{name}: an acked insert is not alive")
    rows = st.vectors[idx].cpu().numpy()
    check(np.array_equal(rows, np.stack([acked[j] for j in keep.tolist()])),
          f"{name}: an acked insert's row differs from the inserted vector")
    check(int(st.size) == int(st.alive.sum()), f"{name}: size != alive.sum()")
    errs = check_health(st)
    check(not errs, f"{name}: health check: {errs}")


def _query_step(torch, sess, Q, rec: dict, name: str) -> None:
    """One timed query op of all of Q, its reported ids checked alive, and
    recall@10 against the exact top-k of the same state."""
    from repro_torch.core import metrics
    from repro_torch.core.graph import NULL
    sync()
    t = time.perf_counter()
    ids, _ = sess.query(Q, k=10).result()
    rec["query_s"] += time.perf_counter() - t
    live = sess.state.alive.cpu().numpy()
    check(bool(live[ids[ids != NULL]].all()), f"{name}: a query reported a non-alive id")
    _, true_ids = sess.ground_truth(Q, 10)
    found = torch.as_tensor(ids).to(true_ids.device)
    rec["recall10"].append(float(metrics.recall_at_k(found, true_ids, 10)))


def phase_maint(torch, n_base: int, per_step: int, steps: int,
                n_queries: int) -> dict:
    """PURE, GLOBAL, RWALK, LOCAL, ReBuild and MASK each on a copy of one
    bulk-built state (the base and one working copy on the card at a time),
    ``steps`` steps of deleting the oldest cluster span and inserting the
    next one, 1,000 queries after each step."""
    import numpy as np

    from repro_torch.core import Session
    from repro_torch.core.graph import DATA_FIELDS, NULL
    from repro_torch.core.rebuild import bulk_knn_build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.data.workload import make_workload
    from repro_torch.kernels import ops as kops

    t = time.perf_counter()
    wl = make_workload("sift", n_base=n_base, n_steps=steps, batch_size=per_step,
                       n_queries=n_queries, pattern="clustered", seed=0)
    extra = make_dataset("sift", per_step, seed=7)    # the step after the grow
    out = {"n_base": n_base, "per_step": per_step, "steps": steps,
           "n_queries": n_queries, "data_s": time.perf_counter() - t}
    capacity = sift_capacity(n_base, steps * per_step)
    base_params = sift_params(capacity)
    Q = wl.queries
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()                       # the maint path starts here
    t = time.perf_counter()
    base = bulk_knn_build(wl.base, np.ones(n_base, bool), base_params, k_nn=64)
    sync()
    out["build_s"] = time.perf_counter() - t
    n_items = steps * per_step
    per_strategy = {}
    for name in MAINT_ORDER:
        strategy = "pure" if name == "rebuild" else name
        params = dataclasses.replace(base_params, maintenance=dataclasses.replace(
            base_params.maintenance, strategy=strategy))
        sess = Session(params, state=_clone_state(base), seed=0)
        id_map = list(range(n_base))            # pool position -> graph id
        acked = {}
        rec = {"delete_s": 0.0, "insert_s": 0.0, "query_s": 0.0, "recall10": []}
        for step in range(steps):
            gids = np.asarray([id_map[p] for p in wl.step_deletes[step]], np.int32)
            sync()
            t = time.perf_counter()
            sess.delete(gids)
            sess.flush()
            rec["delete_s"] += time.perf_counter() - t
            for j in gids.tolist():
                acked.pop(j, None)
            t = time.perf_counter()
            new = sess.insert(wl.step_inserts[step]).result()
            rec["insert_s"] += time.perf_counter() - t
            check(bool((new != NULL).all()), f"{name}: an insert was refused")
            id_map += new.tolist()
            acked.update(zip(new.tolist(), wl.step_inserts[step]))
            if name == "rebuild":
                before = torch.nonzero(sess.state.alive).flatten().cpu().numpy()
                sess.rebuild_from_alive()
                remap = np.full(sess.state.capacity, NULL, np.int64)
                remap[before] = np.arange(before.shape[0])
                id_map = [int(remap[j]) if j >= 0 else NULL for j in id_map]
                acked = {int(remap[j]): v for j, v in acked.items()}
            _query_step(torch, sess, Q, rec, name)
        _verify_session(torch, sess, acked, name)
        if name == "mask":
            check(int(sess.state.masked.sum()) == n_items,
                  "mask: tombstones before consolidation")
            sync()
            t = time.perf_counter()
            rec["n_consolidated"] = sess.consolidate()
            sess.flush()
            rec["consolidate_s"] = time.perf_counter() - t
            check(int(sess.state.masked.sum()) == 0, "mask: a tombstone survived consolidation")
            _verify_session(torch, sess, acked, "mask after consolidate")
            _query_step(torch, sess, Q, rec, name)
            del base                            # the grow holds old and new
            torch.cuda.empty_cache()
            old = sess.state
            t = time.perf_counter()
            sess.grow(2 * capacity)
            sync()
            rec["grow_s"] = time.perf_counter() - t
            # old slots byte-equal; the new ones are held empty by the
            # health checks that follow the next insert
            grown = sess.state
            for f in DATA_FIELDS:
                a, b = getattr(old, f), getattr(grown, f)
                check(torch.equal(b[:capacity] if a.dim() else b, a),
                      f"grow: {f} changed in the old slots")
            del old, grown, a, b
            torch.cuda.empty_cache()
            t = time.perf_counter()
            new = sess.insert(extra).result()
            rec["insert_after_grow_s"] = time.perf_counter() - t
            check(bool((new != NULL).all()), "mask: an insert after the grow was refused")
            acked.update(zip(new.tolist(), extra))
            _query_step(torch, sess, Q, rec, name)
            _verify_session(torch, sess, acked, "mask after grow")
            rec["capacity_after_grow"] = sess.state.capacity
        if name == "local":
            sync()
            t = time.perf_counter()
            rec["n_refined"] = sess.refine(n=4096)
            sess.flush()
            rec["refine_s"] = time.perf_counter() - t
            _verify_session(torch, sess, acked, "local after refine")
            _query_step(torch, sess, Q, rec, name)
        rec["items_per_s"] = {op: n_items / rec[f"{op}_s"]
                              for op in ("delete", "insert")}
        rec["items_per_s"]["query"] = len(rec["recall10"]) * Q.shape[0] / rec["query_s"]
        rec["rebuild_s"] = sess.timers.rebuild_s
        per_strategy[name] = rec
        emit({"maint_strategy": name, **rec})
        del sess
        torch.cuda.empty_cache()
    sync()
    out["launches"] = dict(kops.launches)      # the maint path ends here
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["strategies"] = per_strategy
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for kname in ("gather_scores", "score_topk", "score_matrix"):
        check(out["launches"][kname] > 0, f"kernel {kname} was not launched on the maint path")
    return out


# ---------------------------------------------------------------------------
# durability and the two-tier index at SIFT1M scale
# ---------------------------------------------------------------------------

CHILD_BATCH = 256          # rows inserted and ids deleted per child batch
CHILD_MAX_BATCHES = 64     # the parent kills the child long before this


def peak_gib(torch) -> float | None:
    return (torch.cuda.max_memory_allocated() / 2**30
            if torch.cuda.is_available() else None)


def scratch_dir(prefix: str) -> Path:
    """A fresh directory on the local disk, inside the checkout's build/."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=ROOT / "build"))


def fs_type(path: Path) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", str(path)],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"unknown ({out.stderr.strip()})"


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def same_session_state(torch, a, b) -> list[str]:
    """What differs between two sessions: GraphState arrays (torch.equal on
    the card), capacity, the op counter and the registry counters."""
    from repro_torch.core import maint
    from repro_torch.core.graph import DATA_FIELDS
    bad = [f for f in DATA_FIELDS
           if not torch.equal(getattr(a.state, f), getattr(b.state, f))]
    attrs = ["_op_counter"] + [m.counter_attr for m in maint.SESSION_OPS
                               if m.counter_attr] + [
        attr for m in maint.SESSION_OPS for attr, _ in m.state_attrs]
    bad += [name for name in attrs if getattr(a, name) != getattr(b, name)]
    if a.state.capacity != b.state.capacity:
        bad.append("capacity")
    return bad


def child_rows(batch: int):
    from repro_torch.data.synthetic import make_dataset
    return make_dataset("sift", CHILD_BATCH, seed=5000 + batch)


def durable_child(directory: str, capacity: int, device: str) -> int:
    """The process the durable phase kills: recover, then stream batches of
    inserts and deletes with a flush after each, printing what each flush
    acknowledged. It never deletes an id it inserted itself."""
    import numpy as np

    sys.path.insert(0, str(SRC))
    from repro_torch.core import Session
    sess = Session.recover(directory, sift_params(capacity, strategy="local"),
                           strategy="local", device=device)
    print(json.dumps({"recovered": sess.recovery_info}), flush=True)
    mine: set[int] = set()
    for b in range(CHILD_MAX_BATCHES):
        ins = sess.insert(child_rows(b)).result()
        mine |= set(ins.tolist())
        alive = np.flatnonzero(sess.state.alive.cpu().numpy())
        pool = np.setdiff1d(alive, np.fromiter(mine, np.int64, len(mine)))
        dels = np.random.default_rng(6000 + b).choice(
            pool, CHILD_BATCH, replace=False).astype(np.int32)
        sess.delete(dels)
        sess.flush()
        print(json.dumps({"ack": b, "inserted": ins.tolist(),
                          "deleted": dels.tolist()}), flush=True)
    return 0


def kill_child_after(proc, n_acks: int, timeout_s: float) -> list[dict]:
    """Read the child's acknowledgements; SIGKILL it after the n-th."""
    import queue
    import signal
    import threading

    lines: queue.Queue = queue.Queue()

    def read():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)                     # the child closed its stdout

    threading.Thread(target=read, daemon=True).start()
    acks, deadline = [], time.monotonic() + timeout_s
    try:
        while len(acks) < n_acks:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise SmokeFailure(f"durable: child acknowledged {len(acks)} batches "
                                   f"in {timeout_s} s")
            if line is None:
                raise SmokeFailure(f"durable: the child exited after {len(acks)} "
                                   f"acknowledgements (exit code {proc.wait(60)})")
            msg = json.loads(line)
            if "ack" in msg:
                acks.append(msg)
        check(proc.poll() is None, "durable: the child exited before the kill")
        proc.send_signal(signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
    check(proc.returncode == -signal.SIGKILL,
          f"durable: child ended with {proc.returncode}, not SIGKILL")
    return acks


def phase_durable(torch, n_base: int, per_round: int, rounds: int = 2,
                  device: str = "cuda") -> dict:
    """Cell sift1m-durable: a journaled LOCAL session at 10^6 vectors; a
    control stream, the same stream crashed after a journal append and
    recovered (bit-exact against the control), then a child process killed
    with SIGKILL mid-stream and recovered from disk."""
    import gc
    import shutil

    import numpy as np

    from repro_torch.core import Session
    from repro_torch.core.health import check_health
    from repro_torch.core.rebuild import bulk_knn_build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ops as kops
    from repro_torch.testing import faults

    n_ins = rounds * per_round
    data = make_dataset("sift", n_base + n_ins, seed=0)
    base, fresh = data[:n_base], data[n_base:]
    stream_q = make_dataset("sift", n_ins, seed=1)
    capacity = sift_capacity(n_base, n_ins + CHILD_MAX_BATCHES * CHILD_BATCH)
    params = sift_params(capacity, strategy="local")
    root = scratch_dir("durable-")
    out = {"n_base": n_base, "capacity": capacity, "rounds": rounds,
           "per_round": per_round, "checkpoint_dir_fs": fs_type(root)}
    t_phase = time.perf_counter()
    try:
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        kops.reset_launches()                   # the durable path starts here
        t = time.perf_counter()
        state = bulk_knn_build(base, np.ones(n_base, bool), params, k_nn=64,
                               device=device)
        sync()
        out["build_s"] = time.perf_counter() - t

        def run(sess, first_op: int, plan=None):
            """Ops first_op.. of the stream (query, insert, delete per round,
            a flush after each round and save(1) after round 1); a resumed
            run re-runs the flush and save that end the round before
            first_op, which the kill may have cut. With ``plan`` (the
            control) it records the journal appends at each round's start,
            the journal bytes of each round and the save times."""
            for rnd in range(rounds):
                sl = slice(rnd * per_round, (rnd + 1) * per_round)
                if plan is not None:
                    round_hits.append(plan.hits.get("post-journal-append", 0))
                for op in range(3):
                    if 3 * rnd + op < first_op:
                        continue
                    if op == 0:
                        sess.query(stream_q[sl], k=10).result()
                    elif op == 1:
                        check(bool((sess.insert(fresh[sl]).result() >= 0).all()),
                              "durable: an insert was refused")
                    else:
                        alive = np.flatnonzero(sess.state.alive.cpu().numpy())
                        sess.delete(np.random.default_rng(100 + rnd).choice(
                            alive, per_round, replace=False).astype(np.int32))
                if 3 * rnd + 3 >= first_op:
                    sess.flush()
                    if plan is not None:
                        out["journal_bytes_per_round"].append(
                            sess._journal.path.stat().st_size)
                    if rnd == 0:
                        t = time.perf_counter()
                        sess.save(1)
                        if plan is not None:
                            out["save_s"].append(time.perf_counter() - t)

        # the control: save(0), the whole stream uninterrupted
        # (each round's journal holds one META record, the round's three op
        # records and its JR_FLUSH: save(0) and save(1) reset it)
        ctrl_dir = root / "control"
        probe = faults.FaultPlan()
        round_hits: list = []
        out["journal_bytes_per_round"] = []
        with faults.inject(probe):
            ctrl = Session(params, state=state, seed=0, checkpoint_dir=ctrl_dir,
                           journal_fsync="flush")
            t = time.perf_counter()
            ctrl.save(0)
            out["save_s"] = [time.perf_counter() - t]
            out["save_steps_s"] = dict(ctrl._ckpt.timings)
            hits_after_save0 = probe.hits.get("post-journal-append", 0)
            run(ctrl, 0, probe)
        ctrl.flush()
        out["checkpoint_bytes"] = dir_bytes(ctrl_dir / "step_000000000000")

        # the same stream from a copy of step 0, killed at the journal append
        # of the last round's insert, then recovered and finished
        crash_dir = root / "crash"
        crash_dir.mkdir()
        shutil.copytree(ctrl_dir / "step_000000000000",
                        crash_dir / "step_000000000000")
        shutil.copy(ctrl_dir / "LATEST", crash_dir / "LATEST")
        shutil.rmtree(ctrl_dir)
        t = time.perf_counter()
        sess = Session.recover(crash_dir, params, strategy="local", device=device)
        out["restore_s"] = time.perf_counter() - t
        out["restore_steps_s"] = dict(sess._ckpt.timings)
        check(sess.recovery_info["step"] == 0, "durable: step 0 did not restore")
        hit = round_hits[-1] - hits_after_save0 + 2
        plan = faults.crash_once("post-journal-append", hit=hit)
        crashed = False
        try:
            with faults.inject(plan):
                run(sess, 0)
        except faults.SimulatedCrash:
            crashed = True
        check(crashed and plan.log == [f"crash:post-journal-append#{hit}"],
              f"durable: the armed crash did not fire ({plan.log})")
        sess._journal.close()
        del sess
        gc.collect()
        t = time.perf_counter()
        rec = Session.recover(crash_dir, params, strategy="local", device=device)
        out["recover_s"] = time.perf_counter() - t
        out["recovery"] = dict(rec.recovery_info)
        check(rec.recovery_info["step"] == 1, "durable: step 1 did not restore")
        run(rec, rec._op_counter)
        rec.flush()
        diff = same_session_state(torch, rec, ctrl)
        check(not diff, f"durable: recovered session differs from the control in {diff}")
        out["bit_exact_vs_control"] = True
        del ctrl
        rec.save(2)
        rec._journal.close()
        del rec, state
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

        # a real process, killed with SIGKILL after its second acknowledgement
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--durable-child",
             str(crash_dir), "--child-capacity", str(capacity), "--child-device",
             device], stdout=subprocess.PIPE, text=True)
        acks = kill_child_after(proc, 2, timeout_s=600)
        out["child_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rec = Session.recover(crash_dir, params, strategy="local", device=device)
        out["recover_after_kill_s"] = time.perf_counter() - t
        out["recovery_after_kill"] = dict(rec.recovery_info)
        st = rec.state
        alive = st.alive.cpu().numpy()
        for a in acks:
            ids = np.asarray(a["inserted"], np.int64)
            check(bool((ids >= 0).all() and alive[ids].all()),
                  "durable: an acknowledged insert is not alive")
            rows = st.vectors[torch.as_tensor(ids, device=st.device)].cpu().numpy()
            check(np.array_equal(rows, child_rows(a["ack"])),
                  "durable: an acknowledged insert's row differs")
        for a in acks:
            dels = np.asarray(a["deleted"], np.int64)
            back = dels[alive[dels]]
            # an alive acknowledged delete must be its slot reused by a later
            # batch's insert: its row is one of that batch's rows
            later = np.concatenate([child_rows(b) for b in range(
                a["ack"] + 1, len(acks) + 2)])
            rows = st.vectors[torch.as_tensor(back, device=st.device)].cpu().numpy()
            reused = [bool((later == r).all(axis=1).any()) for r in rows]
            check(all(reused), "durable: an acknowledged delete is alive")
            out.setdefault("acked_deletes_slot_reused", 0)
            out["acked_deletes_slot_reused"] += len(back)
        errs = check_health(st)
        check(not errs, f"durable: health check after the kill: {errs}")
        out["acked_batches"] = len(acks)
        rec._journal.close()
        del rec, st
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sync()
    out["launches"] = dict(kops.launches)       # the durable path ends here
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["peak_mem_gib"] = peak_gib(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def residency(ts) -> dict:
    """External ids by the tier that holds them ("both": mid-drain)."""
    import numpy as np
    out = {"fresh": [], "main": [], "both": []}
    for e, loc in ts._loc.items():
        out[loc[0]].append(e)
    return {k: np.asarray(v, np.int64) for k, v in out.items()}


def phase_tiered(torch, n_base: int, per_round: int, rounds: int = 2,
                 sub: int = 8, device: str = "cuda") -> dict:
    """Cell sift1m-tiered: a TieredSession whose main tier is the bulk-built
    10^6 index; rounds of inserts (some upserts), deletes (half on main-
    resident, half on fresh ids) and queries in ``sub`` batches each, an
    auto-merge during the stream and an explicit one at the end; every query
    result held to the host's book; recall before and after; save and
    recover bit-exact."""
    import gc
    import shutil

    import numpy as np

    from repro_torch.core import TieredSession
    from repro_torch.core.graph import DATA_FIELDS, NULL
    from repro_torch.core.rebuild import bulk_knn_build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ops as kops

    bs = per_round // sub                   # rows per op
    n_up = bs // 16                         # upserts of main-resident ids per insert
    n_new = rounds * sub * bs
    data = make_dataset("sift", n_base + n_new, seed=0)
    base = data[:n_base]
    stream_q = make_dataset("sift", rounds * per_round, seed=1)
    held = make_dataset("sift", 1000, seed=2)
    capacity = sift_capacity(n_base, 0)
    fresh_capacity = capacity // 8
    # the merge fires once the fresh tier holds half a round of items
    # (2^10 of 2^17 slots: mid round 1)
    params = sift_params(capacity, strategy="mask", consolidate_strategy="local",
                         merge_fresh_threshold=(per_round // 2) / fresh_capacity,
                         merge_chunk=128)
    qsearch = dataclasses.replace(params.search, quantized=True, rerank_depth=64)
    root = scratch_dir("tiered-")
    out = {"n_base": n_base, "capacity": capacity, "fresh_capacity": fresh_capacity,
           "rounds": rounds, "per_round": per_round, "ops_per_round": sub,
           "checkpoint_dir_fs": fs_type(root)}
    t_phase = time.perf_counter()
    try:
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        kops.reset_launches()                   # the tiered path starts here
        t = time.perf_counter()
        state = bulk_knn_build(base, np.ones(n_base, bool), params, k_nn=64,
                               device=device)
        sync()
        out["build_s"] = time.perf_counter() - t
        ts = TieredSession(params, fresh_strategy="global", seed=0,
                           main_state=state, checkpoint_dir=root, device=device)
        del state
        check(ts.fresh_capacity == fresh_capacity, "tiered: fresh capacity")
        book = np.concatenate([base, np.zeros((n_new, 128), np.float32)])
        live = np.zeros(n_base + n_new, bool)
        live[:n_base] = True
        next_id = n_base

        def recalls(tag):
            r32 = ts.recall(held, 10)
            main = ts.main
            fp32 = main.params
            main.params = dataclasses.replace(fp32, search=qsearch)
            try:
                rq = ts.recall(held, 10)
            finally:
                main.params = fp32
            out[f"recall10_fp32_{tag}"] = r32
            out[f"recall10_q8_rerank64_{tag}"] = rq

        def check_query(ids, scores, q):
            got = ids[ids != NULL]
            check(bool(live[got].all()), "tiered: a query returned a deleted id")
            # stale: every score is the score of the id's current vector
            x = book[np.where(ids != NULL, ids, 0)].astype(np.float64)
            want = 2.0 * np.einsum("bkd,bd->bk", x, q.astype(np.float64)) - (
                x * x).sum(-1)
            ok = np.abs(scores - want) <= 1e-4 * np.abs(want) + 1e-2
            check(bool(ok[ids != NULL].all()),
                  "tiered: a score differs from the id's current vector (stale)")

        recalls("before")
        rng = np.random.default_rng(7)
        op_s = {"query": 0.0, "insert": 0.0, "delete": 0.0}
        n_q = 0
        for rnd in range(rounds):
            for s in range(sub):
                j = rnd * sub + s
                where = residency(ts)
                ups = rng.choice(where["main"][where["main"] < n_base], n_up,
                                 replace=False)
                ids = np.concatenate([np.arange(next_id, next_id + bs - n_up), ups])
                rows = data[n_base + j * bs:n_base + (j + 1) * bs]
                t = time.perf_counter()
                acked = ts.insert(rows, ids=ids).result()
                op_s["insert"] += time.perf_counter() - t
                check(np.array_equal(acked, ids), "tiered: an insert was not acked")
                book[ids] = rows
                live[ids] = True
                next_id += bs - n_up
                where = residency(ts)
                dels = np.concatenate([
                    rng.choice(where["main"], bs // 2, replace=False),
                    rng.choice(where["fresh"], bs // 2, replace=False)]).astype(np.int32)
                t = time.perf_counter()
                ts.delete(dels).result()
                op_s["delete"] += time.perf_counter() - t
                live[dels] = False
                q = stream_q[j * bs:(j + 1) * bs]
                t = time.perf_counter()
                qi, qs = ts.query(q, k=10).result()
                op_s["query"] += time.perf_counter() - t
                n_q += len(q)
                check_query(qi, qs, q)
                out.setdefault("merge_active_after_op", []).append(
                    ts.active_merge is not None)
            ts.flush()
        out["n_merges_auto"] = ts.timers.n_merges
        check(any(out["merge_active_after_op"]), "tiered: no auto-merge started")
        t = time.perf_counter()
        out["explicit_merge_drained"] = ts.merge()
        ts.flush()
        out["explicit_merge_s"] = time.perf_counter() - t
        ts.check_mirrors()
        check(set(ts._loc) == set(np.flatnonzero(live).tolist()),
              "tiered: the live set differs from the host's book")
        t = time.perf_counter()
        qi, qs = ts.query(held, k=10).result()
        out["held_query_s"] = time.perf_counter() - t
        check_query(qi, qs, held)
        t = time.perf_counter()
        ts._fresh_topk(held, 10)
        out["held_fresh_scan_s"] = time.perf_counter() - t
        recalls("after")
        for tag in ("before", "after"):
            gap = out[f"recall10_fp32_{tag}"] - out[f"recall10_q8_rerank64_{tag}"]
            check(gap <= 0.02, f"tiered: quantized+rerank recall trails fp32 by {gap}")
        out["items_per_s"] = {"query": n_q / op_s["query"],
                              "insert": rounds * per_round / op_s["insert"],
                              "delete": rounds * per_round / op_s["delete"]}
        out["merge_s"] = ts.timers.merge_s
        out["n_merges"] = ts.timers.n_merges
        out["n_merged"] = ts.timers.n_merged
        out["stats"] = ts.stats()

        # save and recover once, bit-exact against the saved state
        t = time.perf_counter()
        ts.save(1)
        out["save_s"] = time.perf_counter() - t
        out["save_steps_s"] = dict(ts._ckpt.timings)
        out["checkpoint_bytes"] = dir_bytes(root / "step_000000000001")
        ts._journal.close()
        t = time.perf_counter()
        rec = TieredSession.recover(root, params, fresh_strategy="global", seed=0,
                                    device=device)
        out["recover_s"] = time.perf_counter() - t
        out["recovery"] = dict(rec.recovery_info)
        out["restore_steps_s"] = dict(rec._ckpt.timings)
        for name, a, b in (("fresh", rec.fresh, ts.fresh), ("main", rec.main, ts.main)):
            bad = [f for f in DATA_FIELDS
                   if not torch.equal(getattr(a.state, f), getattr(b.state, f))]
            check(not bad and a._op_counter == b._op_counter,
                  f"tiered: recovered {name} tier differs in {bad}")
        check(rec._loc == ts._loc and (rec._op_counter, rec._merge_counter,
                                       rec._merges_done, rec._next_ext) == (
            ts._op_counter, ts._merge_counter, ts._merges_done, ts._next_ext),
              "tiered: recovered counters or locations differ")
        for a, b in ((rec._fm, ts._fm), (rec._mm, ts._mm)):
            check(np.array_equal(a.ext, b.ext) and np.array_equal(a.present, b.present),
                  "tiered: recovered mirrors differ")
        out["bit_exact_after_recover"] = True
        rec._journal.close()
        del rec, ts
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sync()
    out["launches"] = dict(kops.launches)       # the tiered path ends here
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["peak_mem_gib"] = peak_gib(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# the serving front end: cell sift1m-serve
# ---------------------------------------------------------------------------

SERVE_CFG = dict(max_batch=64, max_wait_s=0.005, k=10)
SERVE_CLI_SCALE = 10_000        # the CLI builds its base by Session.insert


def drive_server(srv, Q, arrivals) -> dict:
    """One loop over a request schedule (seconds from the start): submit
    every request whose arrival time has passed, then ``step()``; sleep
    only while nothing is queued. A request's latency runs from its
    scheduled arrival (and, for the deadline check, from its admission) to
    the return of the step that served it."""
    import numpy as np

    from repro_torch.core.graph import NULL
    from repro_torch.serving import ServerOverloadError

    n = len(arrivals)
    lat = np.full(n, np.nan)
    lat_admitted = np.full(n, np.nan)
    ids = np.full((n, srv.cfg.k), NULL, np.int32)
    admitted: dict[int, tuple[int, float]] = {}     # rid → (request, t)
    open_rids: set[int] = set()
    step_s = []
    nxt = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while nxt < n and arrivals[nxt] <= now:
            try:
                rid = srv.submit(Q[nxt])
                admitted[rid] = (nxt, time.perf_counter() - t0)
                open_rids.add(rid)
            except ServerOverloadError:
                pass
            nxt += 1
        open_rids -= srv.failed.keys()
        if not open_rids:
            if nxt == n:
                break
            time.sleep(max(0.0, arrivals[nxt] - (time.perf_counter() - t0)))
            continue
        ts = time.perf_counter()
        served = srv.step()
        te = time.perf_counter()
        step_s.append(te - ts)
        for rid, (got, _) in served.items():
            i, t_adm = admitted[rid]
            lat[i] = te - t0 - arrivals[i]
            lat_admitted[i] = te - t0 - t_adm
            ids[i] = got
            open_rids.discard(rid)
    return dict(wall_s=time.perf_counter() - t0, lat=lat,
                lat_admitted=lat_admitted, ids=ids, step_s=np.array(step_s))


def serve_report(torch, srv, run: dict, true_ids, alive) -> dict:
    """Requests/s, latency percentiles, batch fill, shed counts and the
    served answers' recall@10; no served id may be non-alive."""
    import numpy as np

    from repro_torch.core import metrics
    from repro_torch.core.graph import NULL
    done = ~np.isnan(run["lat"])
    ids = run["ids"][done]
    rep = ids[ids != NULL]
    check(bool(alive[rep].all()), "serve: a served id is not alive")
    ms = run["lat"][done] * 1e3
    st = srv.stats
    found = torch.as_tensor(ids).to(true_ids.device)
    return {
        "requests": len(run["lat"]), "served": int(done.sum()),
        "requests_per_s": float(done.sum() / run["wall_s"]),
        "wall_s": run["wall_s"],
        "p50_ms": float(np.percentile(ms, 50)),
        "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms.max()),
        "batches": st["batches"],
        "mean_batch_fill": 1.0 - st["pad_waste"] / max(st["batches"], 1),
        "step_ms_median": float(np.median(run["step_s"]) * 1e3),
        "step_ms_max": float(run["step_s"].max() * 1e3),
        "shed_overload": st["shed_overload"],
        "shed_deadline": st["shed_deadline"],
        "recall10": float(metrics.recall_at_k(
            found, true_ids[torch.as_tensor(done, device=true_ids.device)], 10)),
    }


def run_serve_cli(scale: int, steps: int, root: Path, device: str) -> dict:
    """``python -m repro_torch.launch.serve`` as subprocesses: plain,
    ``--tiered`` and checkpointed (every step) in parallel, then
    ``--recover`` from the checkpointed run's directory."""
    import os
    import re

    # three processes share the host's cores: cap each one's CPU threads
    threads = str(max(1, (os.cpu_count() or 3) // 3))
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": threads}
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--scale",
            str(scale), "--steps", str(steps), "--device", device]
    ckpt = ["--checkpoint-dir", str(root / "ckpt")]
    modes = {"plain": [], "tiered": ["--tiered"],
             "checkpointed": ckpt + ["--checkpoint-every", "1"]}

    def start(extra):
        return subprocess.Popen(base + extra, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def finish(name, proc, t0, out):
        text, _ = proc.communicate(timeout=600)
        recalls = [float(r) for r in re.findall(r"recall@10=([0-9.]+)", text)]
        out[name] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                     "recall10_per_step": recalls}
        check(proc.returncode == 0,
              f"serve CLI {name} exited {proc.returncode}: {text[-2000:]}")
        check(len(recalls) == steps, f"serve CLI {name}: {len(recalls)} steps")
        return text

    out = {"scale": scale, "steps": steps}
    t0 = time.perf_counter()
    procs = {name: start(extra) for name, extra in modes.items()}
    try:
        for name, proc in procs.items():
            finish(name, proc, t0, out)
        t1 = time.perf_counter()
        text = finish("recover", start(ckpt + ["--recover"]), t1, out)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    found = re.search(r"recovered from .*: step=(\d+)", text)
    out["recover"]["recovered_step"] = int(found.group(1)) if found else None
    check(out["recover"]["recovered_step"] == steps - 1,
          f"serve CLI recover: recovered step {out['recover']['recovered_step']}")
    out["seconds"] = time.perf_counter() - t0
    return out


def pad_lane_cost(torch, params, state, Q, n_real: int, reps: int = 3
                  ) -> dict:
    """What a partly filled step pays for its padding. The server pads a
    step to ``max_batch`` with zero rows, which the engine walks like any
    query; the session's own padding (the same op shape) makes invalid
    lanes, which draw no entry points and never walk. Both from fresh
    sessions with the same seed, so the real rows' answers must be equal;
    median op seconds of each, and the mean hop count of real and zero
    lanes."""
    import numpy as np

    from repro_torch.core import Session, prng, search
    B, k = SERVE_CFG["max_batch"], SERVE_CFG["k"]
    padded = np.zeros((B, Q.shape[1]), np.float32)
    padded[:n_real] = Q[:n_real]
    times = {"zero_rows": [], "invalid_lanes": []}
    for r in range(reps):
        answers = []
        for name, rows in (("zero_rows", padded), ("invalid_lanes",
                                                   Q[:n_real])):
            sess = Session(params, state=state, seed=r)
            sync()
            t = time.perf_counter()
            ids, scores = sess.query(rows, k=k, chunk=B).result()
            times[name].append(time.perf_counter() - t)
            answers.append((ids[:n_real], scores[:n_real]))
        check(all(np.array_equal(a, b) for a, b in zip(*answers)),
              "serve: padding changed the real rows' answers")
    res = search.search_batch(state, padded, prng.prng_key(0), params.search)
    hops = res.n_expanded.cpu().numpy()
    return {"n_real": n_real, "max_batch": B,
            "op_s_zero_rows": float(np.median(times["zero_rows"])),
            "op_s_invalid_lanes": float(np.median(times["invalid_lanes"])),
            "hops_real_mean": float(hops[:n_real].mean()),
            "hops_zero_mean": float(hops[n_real:].mean())}


def phase_serve(torch, n_base: int, n_closed: int = 2048, n_open: int = 2048,
                n_burst: int = 1024, seed: int = 0, device: str = "cuda",
                cli_scale: int = SERVE_CLI_SCALE, cli_steps: int = 2) -> dict:
    """Cell sift1m-serve: a ``BatchedServer`` (max_batch 64, max_wait 5 ms,
    k 10) over a GLOBAL session on the bulk-built 10^6 index, fed held-out
    queries by :func:`drive_server`: a closed loop (every request queued at
    once) gives the capacity C; Poisson arrivals at 0.5·C and 0.9·C; a
    burst at 4·C against max_queue 256 and a 1 s deadline; the readiness
    gate; then the ``serve_online`` CLI in its three modes."""
    import shutil

    import numpy as np

    from repro_torch.core import Session
    from repro_torch.core.rebuild import bulk_knn_build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import BatchedServer, ServeConfig, ServerNotReadyError

    n_q = n_closed + 2 * n_open + n_burst
    base = make_dataset("sift", n_base, seed=0)
    Q = make_dataset("sift", n_q, seed=3)       # held out: not in the base
    capacity = sift_capacity(n_base, 0)
    params = sift_params(capacity, strategy="global")
    rng = np.random.default_rng(seed)
    out = {"n_base": n_base, "capacity": capacity, "config": SERVE_CFG,
           "seed": seed}
    t_phase = time.perf_counter()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()                       # the serve path starts here
    t = time.perf_counter()
    state = bulk_knn_build(base, np.ones(n_base, bool), params, k_nn=64,
                           device=device)
    sync()
    out["build_s"] = time.perf_counter() - t
    sess = Session(params, state=state, strategy="global", seed=seed)
    alive = sess.state.alive.cpu().numpy()
    _, true_ids = sess.ground_truth(Q, 10)

    def serve(name, lo, n, arrivals, **cfg):
        srv = BatchedServer(sess, ServeConfig(**{**SERVE_CFG, **cfg}))
        run = drive_server(srv, Q[lo:lo + n], arrivals)
        rep = serve_report(torch, srv, run, true_ids[lo:lo + n], alive)
        out[name] = rep
        return srv, run, rep

    # warm-up: one full op, so no run pays for first-call costs
    sess.query(Q[:SERVE_CFG["max_batch"]], k=10, chunk=SERVE_CFG["max_batch"]
               ).result()
    _, _, closed = serve("closed", 0, n_closed, np.zeros(n_closed))
    cap = closed["requests_per_s"]
    out["capacity_C"] = cap
    lo = n_closed
    for frac in (0.5, 0.9):
        arrivals = np.cumsum(rng.exponential(1.0 / (frac * cap), n_open))
        serve(f"open_{frac}C", lo, n_open, arrivals)
        lo += n_open
    deadline = 1.0
    arrivals = np.cumsum(rng.exponential(1.0 / (4 * cap), n_burst))
    _, run, rep = serve("overload_4C", lo, n_burst, arrivals, max_queue=256,
                        deadline_s=deadline)
    bound = deadline + run["step_s"].max()
    worst = float(np.nanmax(run["lat_admitted"]))
    check(worst <= bound, f"serve: an admitted request waited {worst:.3f} s, "
          f"more than the deadline plus one step ({bound:.3f} s)")
    check(rep["served"] + rep["shed_overload"] + rep["shed_deadline"]
          == n_burst, "serve: overload requests neither served nor shed")
    rep["max_admitted_latency_ms"] = worst * 1e3

    # readiness: a recovering session holds traffic, then serves again
    srv = BatchedServer(sess, ServeConfig(**SERVE_CFG))
    sess.recovering = True
    try:
        srv.submit(Q[0])
        refused = False
    except ServerNotReadyError:
        refused = True
    sess.recovering = False
    srv.submit(Q[0])
    check(refused and len(srv.step()) == 1,
          "serve: the readiness gate did not hold and release traffic")
    out["readiness_gate"] = "held while recovering, served after"
    sync()
    out["launches"] = dict(kops.launches)       # the serve path ends here
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["peak_mem_gib"] = peak_gib(torch)
    out["pad_lanes"] = pad_lane_cost(torch, params, sess.state, Q,
                                     SERVE_CFG["max_batch"] // 2)
    del sess, state
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    root = scratch_dir("serve-")
    try:
        out["cli"] = run_serve_cli(cli_scale, cli_steps, root, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# the sharded index: 10^6 vectors in 8 shards, on one card or one rank a card
# ---------------------------------------------------------------------------

SHARD_MESH = ((4, 2), ("data", "model"))
SHARD_QUERY_OPS, SHARD_QUERY_BATCH = 4, 256
SHARD_RANKS = 4                 # the sharded4 and pods4 phases: one rank a card
SHARD_PODS = 2                  # the pods4 phase: 2 replicas of the 8 shards
RANK_TIMEOUT_S = 900            # every group's deadline: NCCL's and the join's
SHARDED_KERNELS = ("gather_scores_bf16", "gather_scores", "score_topk", "score_matrix",
                   "entry_draw")


def shard_capacity(n_base: int, per_round: int, n_shards: int) -> int:
    """Slots per shard: the smallest power of two over a shard's share of
    the base plus one round of inserts (2^17 at 10^6 in 8 shards)."""
    return 1 << max(10, (-(-n_base // n_shards) + per_round).bit_length())


def state_digest(torch, st) -> dict:
    """sha256 of every field's bytes, with its shape and dtype."""
    import hashlib

    from repro_torch.core.graph import DATA_FIELDS

    out = {}
    for f in DATA_FIELDS:
        t = getattr(st, f).contiguous()
        h = hashlib.sha256(f"{tuple(t.shape)} {t.dtype}".encode())
        h.update(memoryview(t.view(torch.uint8).cpu().numpy()))
        out[f] = h.hexdigest()
    return out


def busy_of(prof, wall: float) -> dict:
    """The card's busy share of ``wall`` seconds from a profile: compute
    kernels, and NCCL's kernels (which spin while a peer is late) apart."""
    from repro_torch.launch.analysis import device_kernels

    busy = nccl = 0.0
    launches = 0
    for dev_us, count, key in device_kernels(prof):
        if "nccl" in key.lower():
            nccl += dev_us / 1e6
        else:
            busy += dev_us / 1e6
            launches += count
    return {"wall_s": wall, "busy_share": busy / wall, "nccl_share": nccl / wall,
            "kernel_launches": launches}


def sharded_stream(torch, n_base: int, per_round: int, rounds: int = 2,
                   device: str = "cuda", group=None, *, record: bool = False,
                   pods: int = 1) -> dict:
    """Cell sift1m-sharded's stream on this process's block of the 8 shards
    of a (4, 2) mesh (all of them when ``group`` is None), rows in bf16; with
    ``pods`` > 1 on a (pods, 4, 2) mesh, each pod a replica of the 8 shards
    (on its own ranks with a group of two or more; the pod loop on one
    replica without), each query op split over the pods. The
    base placed by ``elastic.reshard`` (hash routing; each process links
    only its own shards); ``rounds`` rounds of ``per_round`` routed
    inserts, 4 fan-out query ops of 256, ``per_round`` GLOBAL deletes and a
    flush; a MASK stretch of 4·``per_round`` deletes and ``consolidate``; a
    lockstep grow to twice the per-shard capacity and one more insert
    round; ``reshard`` to 4 shards and a query op. Checks acked inserts
    (unique gid, owner ``route % 8``, alive with their row, also through
    the grow and the reshard remap), no answer non-alive, I1–I7 per shard
    after every round, no tombstone left, nothing refused, and the first
    query op of each round bit-equal between the folded fan-out and the
    per-shard loop plus merge; with a group each process checks its own
    shards. ``record`` adds one query op and one insert round under the
    profiler (the busy share) and returns every answer and gid and the
    gathered state's digests before and after the reshard (on the first
    rank of each pod: one replica's)."""
    import numpy as np

    from repro_torch.core import metrics, prng
    from repro_torch.core.graph import NULL
    from repro_torch.core.health import check_health
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.distributed import (DistParams, ShardedSession, ShardMesh,
                                         init_sharded_state, make_query_step,
                                         pod_groups, pod_of, reshard,
                                         shard_block, topk_union)
    from repro_torch.distributed.ann import bf16_rows, shard_view
    from repro_torch.kernels import ops as kops

    t_phase = time.perf_counter()
    dev = group.device if group is not None else torch.device(device)
    on_card = dev.type == "cuda"

    def wait():
        if on_card:
            torch.cuda.synchronize()

    pod_axes = ((pods,), ("pod",)) if pods > 1 else ((), ())

    def shard_mesh(shape):
        return ShardMesh(pod_axes[0] + shape, pod_axes[1] + ("data", "model"))

    mesh = shard_mesh(SHARD_MESH[0])
    S = 8
    n_ins = (rounds + 1 + record) * per_round
    n_mask = 4 * per_round
    data = make_dataset("sift", n_base + n_ins + 1000, seed=0)
    base, fresh, held = data[:n_base], data[n_base:n_base + n_ins], data[n_base + n_ins:]
    stream_q = make_dataset("sift", rounds * SHARD_QUERY_OPS * SHARD_QUERY_BATCH
                            + (1 + record) * SHARD_QUERY_BATCH, seed=1)
    cap = shard_capacity(n_base, per_round, S)
    params = sift_params(cap, strategy="global", max_capacity=2 * cap)
    pod_axis = "pod" if pods > 1 else None
    dp = DistParams(index=params, vec_dtype="bfloat16", pod_axis=pod_axis)
    stride = dp.gid_stride()
    block = shard_block(dp, mesh, group)
    # the collectives' groups: the replica's ranks, and with pods on their
    # own ranks the ranks holding the same block in every pod
    replica, peers = pod_groups(dp, mesh, group)

    def coll_s():
        return np.array([g.collective_s if g is not None else 0.0
                         for g in (replica, peers)])
    rng = np.random.default_rng(0)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"n_base": n_base, "shards": S, "mesh": list(mesh.shape),
           "pod": pod_of(dp, mesh, group), "shards_here": [block.start, block.stop],
           "capacity_per_shard": cap, "gid_stride": stride,
           "vec_dtype": dp.vec_dtype}
    rec = {"queries": [], "inserts": []}
    excluded = dict.fromkeys(kops.launches, 0)   # launches of the comparisons
    kops.reset_launches()                       # the sharded path starts here

    # ---- placement: the base as one shard, re-sharded by hash to 8 ----
    t0 = time.perf_counter()
    src_params = sift_params(1 << max(10, (n_base - 1).bit_length()))
    src = init_sharded_state(DistParams(index=src_params),
                             ShardMesh((1, 1), ("data", "model")), device=dev)
    src.vectors[0, :n_base] = torch.from_numpy(base).to(dev)
    src.alive[0, :n_base] = True
    placed, remap = reshard(src, src_params, params, S, shards=block)
    del src
    state = bf16_rows(placed)
    del placed
    wait()
    out["place_s"] = time.perf_counter() - t0
    base_gid = remap[:n_base]
    check(bool((base_gid >= 0).all()), "sharded: a base row was not placed")
    check(bool((base_gid // stride == np.arange(n_base) % S).all()),
          "sharded: a base row was placed off its hash owner")
    sess = ShardedSession(dp, mesh, seed=0, state=state, group=group)
    del state
    live = np.zeros(S * stride, bool)           # host book of alive gids
    live[base_gid] = True
    acked = {}                                  # gid → row of ``fresh``

    def owned(g, str_x):
        """Which gids of ``g`` lie on this process's shards, and the global
        index of its first shard."""
        blk = shard_block(sess.dp, sess.mesh, group)
        return (g // str_x >= blk.start) & (g // str_x < blk.stop), blk.start

    def verify(tag):
        st = sess.state
        capx = st.vectors.shape[1]
        str_x = sess.dp.gid_stride()
        alive = st.alive.cpu().numpy()
        gl = np.flatnonzero(live)
        own, s0 = owned(gl, str_x)
        gl = gl[own]
        check(int(alive.sum()) == gl.size
              and bool(alive[gl // str_x - s0, gl % str_x].all()),
              f"sharded {tag}: the alive set differs from the host's book")
        keep = np.array(sorted(acked), np.int64)
        keep = keep[owned(keep, str_x)[0]]
        sh = torch.as_tensor(keep // str_x - s0, device=dev)
        lid = torch.as_tensor(keep % str_x, device=dev)
        check(bool(st.alive[sh, lid].all()), f"sharded {tag}: an acked insert is not alive")
        want = torch.from_numpy(fresh[[acked[g] for g in keep.tolist()]]).to(dev)
        check(torch.equal(st.vectors[sh, lid], want.bfloat16().to(st.vectors.dtype)),
              f"sharded {tag}: an acked insert's row differs from the inserted one")
        for s_ in range(st.vectors.shape[0]):
            errs = check_health(shard_view(st, s_))
            check(not errs, f"sharded {tag}: shard {s_} health: {errs}")
        check(capx == sess.dp.index.capacity, f"sharded {tag}: capacity book")

    def answers_alive(gids, tag):
        g = gids.cpu().numpy()
        g = g[g != NULL]
        str_x = sess.dp.gid_stride()
        own, s0 = owned(g, str_x)
        dev_alive = sess.state.alive[torch.as_tensor(g[own] // str_x - s0, device=dev),
                                     torch.as_tensor(g[own] % str_x, device=dev)]
        check(bool(live[g].all()) and bool(dev_alive.all()),
              f"sharded {tag}: an answer holds a deleted or non-alive gid")

    def query(q, tag):
        """One timed fan-out op; answers checked and recorded."""
        wait()
        c0, t = coll_s(), time.perf_counter()
        gids, scores = sess.query(q)
        wait()
        dt = time.perf_counter() - t
        answers_alive(gids, tag)
        rec["queries"].append((gids.cpu().numpy(), scores.cpu().numpy()))
        return gids, scores, dt, coll_s() - c0

    def recall(tag):
        """recall@10 of one fan-out op of the held-out queries against the
        exact top-10 over every alive row: score_topk over each process's
        alive rows, the lists gathered and merged."""
        st = sess.state
        capx = st.vectors.shape[1]
        str_x = sess.dp.gid_stride()
        s0 = shard_block(sess.dp, sess.mesh, group).start
        idx = torch.nonzero(st.alive.reshape(-1)).flatten()
        x = st.vectors.reshape(-1, st.dim)[idx].float().contiguous()
        xsq = st.sqnorms.reshape(-1)[idx].contiguous()
        qh = torch.from_numpy(held).to(dev)
        top_s, pos = kops.score_topk(x, xsq, qh, 10, metric=st.metric)
        flat = idx[pos.long()]
        true_gid = ((s0 + torch.div(flat, capx, rounding_mode="floor")) * str_x
                    + flat % capx)
        if replica is not None:
            B = qh.shape[0]
            cat_s = replica.all_gather(top_s[None]).permute(1, 0, 2).reshape(B, -1)
            cat_g = replica.all_gather(true_gid[None]).permute(1, 0, 2).reshape(B, -1)
            _, true_gid = topk_union(cat_s.contiguous(), cat_g.contiguous(), 10)
        del x, xsq
        found, _, dt, _ = query(held, f"recall {tag}")
        out[f"held_query_s_{tag}"] = dt
        out[f"recall10_{tag}"] = float(metrics.recall_at_k(
            found[:, :10].long(), true_gid, 10))

    def insert_round(lo, tag, timed_as="insert"):
        rows = fresh[lo:lo + per_round]
        route = n_base + lo + np.arange(per_round)
        wait()
        c0, t = coll_s(), time.perf_counter()
        g = sess.insert(rows, route).cpu().numpy()
        op_s[timed_as] += time.perf_counter() - t
        op_coll[timed_as] += coll_s() - c0
        check(bool((g != NULL).all()), f"sharded {tag}: an insert was refused")
        check(bool((g // sess.dp.gid_stride() == route % S).all()),
              f"sharded {tag}: an insert landed off its owner route % 8")
        check(np.unique(g).size == g.size and not bool(live[g].any()),
              f"sharded {tag}: a gid was handed out twice")
        live[g] = True
        acked.update(zip(g.tolist(), range(lo, lo + per_round)))
        rec["inserts"].append(g)

    recall("before")
    op_s = {"query": 0.0, "insert": 0.0, "insert_after_grow": 0.0, "delete": 0.0,
            "traced": 0.0}
    op_coll = {k: np.zeros(2) for k in op_s}
    fold_checked = 0
    qi = 0
    for rnd in range(rounds):
        insert_round(rnd * per_round, f"round {rnd}")
        for j in range(SHARD_QUERY_OPS):
            q = stream_q[qi:qi + SHARD_QUERY_BATCH]
            qi += SHARD_QUERY_BATCH
            gids, scores, dt, dc = query(q, f"round {rnd}")
            op_s["query"] += dt
            op_coll["query"] += dc
            if j == 0:
                # the plain version: one beam_search per shard, then the merge
                before = dict(kops.launches)
                # the session's op key: its seed chain at the op's index
                key = prng.fold_in(prng.prng_key(0, device=dev),
                                   sess._op_counter - 1)
                pi, ps = make_query_step(sess.dp, mesh, fold=False, group=group)(
                    sess.state, q, key)
                for k in kops.launches:
                    excluded[k] += kops.launches[k] - before[k]
                check(torch.equal(pi, gids) and torch.equal(ps, scores),
                      f"sharded round {rnd}: the folded fan-out differs from "
                      f"the per-shard loop")
                fold_checked += 1
        dels = rng.choice(np.flatnonzero(live), per_round, replace=False).astype(np.int32)
        wait()
        c0, t = coll_s(), time.perf_counter()
        sess.delete(dels)
        sess.flush()
        op_s["delete"] += time.perf_counter() - t
        op_coll["delete"] += coll_s() - c0
        live[dels] = False
        for g in dels.tolist():
            acked.pop(g, None)
        verify(f"round {rnd}")

    if record:
        # one query op and one insert round under the profiler
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        wait()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            query(stream_q[qi:qi + SHARD_QUERY_BATCH], "traced")
            qi += SHARD_QUERY_BATCH
            insert_round(rounds * per_round, "traced", timed_as="traced")
            wait()
            wall = time.perf_counter() - t
        out["busy"] = busy_of(prof, wall)
        del prof

    # ---- MASK stretch, then consolidation ----
    sess.strategy = "mask"
    dels = rng.choice(np.flatnonzero(live), n_mask, replace=False).astype(np.int32)
    wait()
    t = time.perf_counter()
    sess.delete(dels)
    sess.flush()
    out["mask_deletes_per_s"] = n_mask / (time.perf_counter() - t)
    live[dels] = False
    for g in dels.tolist():
        acked.pop(g, None)
    check(sess.n_masked() == n_mask, "sharded: MASK left no tombstones")
    t = time.perf_counter()
    n_cons = sess.consolidate()
    sess.flush()
    out["consolidate_s"] = time.perf_counter() - t
    check(n_cons == n_mask and sess.n_masked() == 0,
          "sharded: a tombstone remains after consolidate")
    sess.strategy = "global"
    verify("consolidate")

    # ---- lockstep grow, then one more insert round at the new tier ----
    t = time.perf_counter()
    sess.grow(2 * cap)
    wait()
    out["grow_s"] = time.perf_counter() - t
    check(sess.state.vectors.shape[:2] == (len(block), 2 * cap), "sharded: grow")
    insert_round((rounds + record) * per_round, "after grow",
                 timed_as="insert_after_grow")
    sess.flush()
    verify("grow")
    check(sess.timers.n_refused == 0, "sharded: inserts were refused")
    timers = sess.timers.to_dict()
    out["peak_mem_gib_stream"] = peak_gib(torch) if on_card else None

    # ---- reshard 8 → 4 shards at 2·cap slots each ----
    new_params = sift_params(2 * cap, strategy="global", max_capacity=2 * cap)
    new_dp = DistParams(index=new_params, pod_axis=pod_axis)
    new_mesh = shard_mesh((2, 2))
    t = time.perf_counter()
    whole = sess.gather_state()
    if record and (replica is None or replica.rank == 0):
        rec["digest_before_reshard"] = state_digest(torch, whole)
    new_state, remap = reshard(whole, sess.dp.index, new_params, 4,
                               shards=shard_block(new_dp, new_mesh, group))
    del whole
    wait()
    out["reshard_s"] = time.perf_counter() - t
    old_live = np.flatnonzero(live)
    new_gid = remap[old_live]
    check(bool((new_gid >= 0).all()), "sharded: an alive gid has no remap")
    live[:] = False
    live[new_gid] = True
    acked = {int(remap[g]): row for g, row in acked.items()}
    sess = ShardedSession(new_dp, new_mesh, seed=1, state=new_state, group=group)
    del new_state
    verify("reshard")
    _, _, out["resharded_query_s"], _ = query(stream_q[qi:qi + SHARD_QUERY_BATCH],
                                               "after reshard")
    recall("after")
    wait()
    launches = {k: kops.launches[k] - excluded[k] for k in kops.launches}
    out["launches"] = launches                  # the sharded path ends here
    out["launches_excluded_comparisons"] = excluded
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["fold_equal_ops"] = fold_checked
    if record:
        whole = sess.gather_state()
        if replica is None or replica.rank == 0:
            rec["digest_after_reshard"] = state_digest(torch, whole)
        del whole
        out["record"] = rec
    n_q = rounds * SHARD_QUERY_OPS * SHARD_QUERY_BATCH
    n_ops = {"query": rounds * SHARD_QUERY_OPS, "insert": rounds, "delete": rounds}
    out["items_per_s"] = {"query": n_q / op_s["query"],
                          "insert": rounds * per_round / op_s["insert"],
                          "insert_after_grow": per_round / op_s["insert_after_grow"],
                          "delete_global": rounds * per_round / op_s["delete"]}
    if group is not None:
        out["group"] = {"backend": "nccl" if on_card else "gloo", "world": group.world,
                        "rank": group.rank, "collective_s": group.collective_s,
                        "n_collectives": group.n_collectives,
                        "collective_ms_per_op": {k: float(op_coll[k].sum()) / n * 1e3
                                                 for k, n in n_ops.items()}}
        if peers is not None:
            # the replica group's collectives and the pod-peer group's apart
            out["group"]["subgroups"] = {
                name: {"world": g.world, "rank": g.rank, "collective_s": g.collective_s,
                       "n_collectives": g.n_collectives,
                       "collective_ms_per_op": {k: float(op_coll[k][i]) / n * 1e3
                                                for k, n in n_ops.items()}}
                for i, (name, g) in enumerate((("replica", replica), ("pod_peer", peers)))}
    out["timers"] = timers
    out["peak_mem_gib"] = peak_gib(torch) if on_card else None
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def phase_sharded(torch, n_base: int, per_round: int, rounds: int = 2,
                  device: str = "cuda") -> dict:
    """Cell sift1m-sharded on one card: ``sharded_stream`` over all 8
    shards, in a one-rank group (NCCL on the card, gloo on the CPU), so
    the rank path's collectives and NCCL's start run on one card."""
    from repro_torch.launch.mesh import one_rank

    t0 = time.perf_counter()
    with one_rank(device, timeout_s=RANK_TIMEOUT_S) as group:
        group_up_s = time.perf_counter() - t0
        out = sharded_stream(torch, n_base, per_round, rounds, device, group)
    out["group"]["group_up_s"] = group_up_s
    if torch.device(device).type == "cuda":
        for name in SHARDED_KERNELS:
            check(out["launches"][name] > 0,
                  f"kernel {name} was not launched on the sharded path")
    return out


def sharded_rank(group, n_base: int, per_round: int, rounds: int, pods: int = 1) -> dict:
    """One rank of the sharded4 or pods4 phase (started by ``run_on_ranks``)."""
    import torch

    out = sharded_stream(torch, n_base, per_round, rounds, group=group, record=True,
                         pods=pods)
    out["card"] = torch.cuda.get_device_name(group.device) if group.device.type == "cuda" else "cpu"
    return out


def phase_ranked(torch, name: str, n_base: int, per_round: int, rounds: int = 2,
                 device: str = "cuda", pods: int = 1) -> dict:
    """``sharded_stream`` on 4 ranks, one a card (NCCL; gloo with
    ``device="cpu"``), then the same stream stacked on one device
    (``cuda:0``) as the control. Every rank's query answers and insert
    gids, and each pod's gathered state before and after the reshard,
    must be byte-equal to the control's; every kernel of the path
    launched on every rank."""
    import numpy as np

    from repro_torch.launch.mesh import run_on_ranks

    if torch.device(device).type == "cuda" and torch.cuda.device_count() < SHARD_RANKS:
        raise SmokeFailure(f"{name} needs {SHARD_RANKS} cards, "
                           f"{torch.cuda.device_count()} found")
    t0 = time.perf_counter()
    per_rank = run_on_ranks(sharded_rank, SHARD_RANKS, device=device,
                            timeout_s=RANK_TIMEOUT_S,
                            args=(n_base, per_round, rounds, pods))
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    control = sharded_stream(torch, n_base, per_round, rounds, device, record=True,
                             pods=pods)
    control_s = time.perf_counter() - t0
    want = control.pop("record")
    digests = 0
    for r, got in enumerate(per_rank):
        rec = got.pop("record")
        check(len(rec["queries"]) == len(want["queries"])
              and all(np.array_equal(a[0], b[0]) and a[1].tobytes() == b[1].tobytes()
                      for a, b in zip(rec["queries"], want["queries"])),
              f"{name}: rank {r}'s answers differ from the one-card control")
        check(len(rec["inserts"]) == len(want["inserts"])
              and all(np.array_equal(a, b) for a, b in zip(rec["inserts"], want["inserts"])),
              f"{name}: rank {r}'s insert gids differ from the one-card control")
        for tag in ("digest_before_reshard", "digest_after_reshard"):
            if tag in rec:              # the first rank of each pod
                diff = [f for f in want[tag] if rec[tag][f] != want[tag][f]]
                check(not diff, f"{name}: pod {got['pod']}'s gathered state ({tag}) "
                                f"differs from the one-card control in {diff}")
                digests += 1
        if torch.device(device).type == "cuda":
            for kname in SHARDED_KERNELS:
                check(got["launches"][kname] > 0,
                      f"kernel {kname} was not launched on rank {r} of the {name} path")
    check(digests == 2 * pods, f"{name}: {digests} gathered states compared, "
                               f"not 2 of each of the {pods} pods")
    return {"ranks": per_rank, "control": control, "ranks_s": ranks_s,
            "control_s": control_s, "equal_query_ops": len(want["queries"]),
            "equal_replica_states": digests,
            "launches": {k: sum(got["launches"][k] for got in per_rank)
                         for k in per_rank[0]["launches"]}}


def phase_sharded4(torch, n_base: int, per_round: int, rounds: int = 2,
                   device: str = "cuda") -> dict:
    """Cell sift1m-sharded-4: ``phase_ranked`` on a (4, 2) mesh, each rank
    holding 2 of the 8 shards and linking only those."""
    return phase_ranked(torch, "sharded4", n_base, per_round, rounds, device)


def phase_pods4(torch, n_base: int, per_round: int, rounds: int = 2,
                device: str = "cuda") -> dict:
    """Cell sift1m-pods-4: ``phase_ranked`` on a (2, 4, 2) mesh, 2 pods of
    2 ranks, each pod a replica of the 8 shards and each rank holding and
    linking 4 of its pod's; each query op of 256 split into 128 a pod; the
    control is the pod loop on the same mesh, one replica on ``cuda:0``."""
    return phase_ranked(torch, "pods4", n_base, per_round, rounds, device,
                        pods=SHARD_PODS)


# ---------------------------------------------------------------------------
# the model zoo's serving path
# ---------------------------------------------------------------------------

# (arch, layers kept or None for all, batch, prompt, decode steps): qwen3 at
# full depth; the others at full width with one layer period (at least 2
# layers). gemma2's and llama4's prompts pass their local windows (4,096 and
# 8,192), so the window masks and the kv-block skipping run.
LM_CELLS = (("qwen3-1.7b", None, 4, 2048, 32),
            ("mistral-nemo-12b", 2, 2, 2048, 8),
            ("gemma2-27b", 2, 1, 4608, 8),
            ("phi3.5-moe-42b-a6.6b", 2, 2, 2048, 8),
            ("llama4-scout-17b-a16e", 4, 1, 8704, 8))
# decode logits against forward over the same prefix, as the largest
# relative L2 error of a step: bf16 rounding of ~2 matmul outputs a layer
# (2^-9 each) gave 0.006 at 4 layers on the CPU, where a cache one position
# off gave 0.11-0.39 (tools/torch_models_cpu_checks.py)
LM_REL_TOL_BF16 = 0.05
LM_REL_TOL_FP32 = 1e-3
# an MoE model's bf16 forward over the prompt against fp32 forward at the
# same capacity factor, as the median relative L2 error of the logits at
# every 8th position: 0.012-0.039 on the CPU at d_model 256-2,048, where a
# reference with no token dropped gave 0.07-0.68; a route flipped by bf16
# rounding moves single positions by up to 0.24, so the median is held
# (tools/torch_models_cpu_checks.py)
LM_MOE_MEDIAN_REL_TOL_BF16 = 0.05
DLRM_SERVE_P99, DLRM_SERVE_BULK = 512, 262_144
# the DLRM × IPGM flow at 10^6 items, bulk-built as the sift1m phase builds
# its index; the flow also runs at the example's own size, inserted
DLRM_FLOW = dict(n_items=1_000_000, n_churn=256, n_queries=1000,
                 capacity=1 << 20, d_out=32, pool=64, max_steps=128, build="bulk")


def dlrm_reference(torch, model, batch):
    """DLRM's forward in float64 with a loop per sample and field, JAX's
    index reading written out (negatives from the end, then clamped), and
    the interaction pairs listed row by row."""
    tables = model.tables
    F, R, _ = tables.shape
    out = []
    for b in range(batch["dense"].shape[0]):
        x = batch["dense"][b].double()
        for i, w in enumerate(model.bot):
            x = torch.relu(x @ w.double())
        z = [x]
        for f in range(F):
            rows = [tables[f, min(max(i + R if i < 0 else i, 0), R - 1)].double()
                    for i, m in zip(batch["sparse_ids"][b, f].tolist(),
                                    batch["sparse_mask"][b, f].tolist()) if m]
            z.append(sum(rows) / len(rows) if rows else torch.zeros_like(x))
        inter = [z[i] @ z[j] for i in range(len(z)) for j in range(i)]
        y = torch.cat([torch.stack(inter), x])
        for i, w in enumerate(model.top):
            y = y @ w.double()
            if i < len(model.top) - 1:
                y = torch.relu(y)
        out.append(y[0])
    return torch.stack(out)


def dlrm_cell(torch, kops, kref, dev, flow_cfg: dict) -> dict:
    """Cell dlrm-rm2-serve: the full config (26 tables × 2^20 rows × 64,
    fp32) drawn on the card; the serve step at B 512 and 262,144, held to a
    float64 reference on 16 samples; retrieval_cand through the score_topk
    kernel, held to its plain version; then the DLRM × IPGM flow of
    tools/torch_dlrm_retrieval.py at the example's size (1,500 items
    inserted, the tool's defaults) and with ``flow_cfg`` (DLRM_FLOW)."""
    import importlib.util

    from repro_torch.configs import dlrm_rm2
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.train import steps

    cfg = dlrm_rm2.config()
    g = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dlrm_mod.init_params(cfg, g, dev)
    sync()
    out = {"init_s": time.perf_counter() - t0,
           "table_bytes": model.tables.numel() * model.tables.element_size()}

    def batch(B):
        shape = (B, cfg.n_sparse, cfg.nnz)
        return {"dense": torch.randn((B, cfg.n_dense), generator=g, device=dev),
                "sparse_ids": torch.randint(0, cfg.n_rows, shape, generator=g,
                                            device=dev, dtype=torch.int32),
                "sparse_mask": torch.rand(shape, generator=g, device=dev) > 0.3}

    serve = steps.make_dlrm_serve_step(cfg)
    b = batch(16)
    b["sparse_ids"][:, :, -1] = torch.tensor([-1, cfg.n_rows + 5], device=dev).repeat(8)[:, None]
    logits = dlrm_mod.forward(model, b, cfg)
    ref = dlrm_reference(torch, model, b)
    check(bool(torch.isfinite(logits).all()) and logits.shape == (16,),
          "dlrm: serve logits not finite or misshapen")
    err = float((logits.double() - ref).abs().max())
    check(err <= 1e-5 + 1e-4 * float(ref.abs().max()),
          f"dlrm: logits off the float64 reference by {err}")
    out["ref_max_abs_err"] = err
    for name, B, runs in (("serve_p99", DLRM_SERVE_P99, 20),
                          ("serve_bulk", DLRM_SERVE_BULK, 5)):
        bb = batch(B)
        p = serve(model, bb)
        check(p.shape == (B,) and bool(((p >= 0) & (p <= 1)).all()),
              f"dlrm {name}: probabilities out of [0, 1]")
        ms = median_ms(lambda: serve(model, bb), runs=runs, warmup=1)
        out[name] = {"batch": B, "ms_per_step": ms, "samples_per_s": B / ms * 1e3}
        del bb, p
    # retrieval_cand: 1 query × 10^6 item embeddings of the bottom tower
    step = steps.make_dlrm_retrieval_step(cfg)            # k = 100
    items = dlrm_mod._mlp(model.bot, torch.randn((RETRIEVAL_M, cfg.n_dense), generator=g,
                                                 device=dev), final_act=True)
    rb = {"dense": torch.randn((1, cfg.n_dense), generator=g, device=dev),
          "candidates": items.contiguous()}
    n0 = kops.launches["score_topk"]
    s, i = step(model, rb)
    launched = kops.launches["score_topk"] - n0
    check(launched == 1, "dlrm retrieval_cand did not launch score_topk once")
    q = dlrm_mod._mlp(model.bot, rb["dense"], final_act=True)
    ws, wi = kref.score_topk(items, items.square().sum(1), q, RETRIEVAL_K + 1, "ip")
    near = _topk_gap_ok(s, i, ws, wi, RETRIEVAL_K)
    out["retrieval_cand"] = {
        "n_candidates": RETRIEVAL_M, "k": RETRIEVAL_K,
        "ms_per_query": median_ms(lambda: step(model, rb)),
        "score_topk_launches_per_query": launched, "near_tie_cut": near,
        "max_abs_err": float((s - ws[:, :RETRIEVAL_K]).abs().max())}
    del items, rb
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "torch_dlrm_retrieval", ROOT / "tools" / "torch_dlrm_retrieval.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name, kw in (("ipgm_flow_example", {}), ("ipgm_flow", flow_cfg)):
        flow = tool.run(model=model, device=dev, seed=0, **kw)
        check(flow["graph_ids_alive"], f"dlrm {name}: a query returned an expired item")
        check(flow["inserted"] == flow["n_churn"] and flow["alive"] == flow["n_items"],
              f"dlrm {name}: an insert was refused or the alive count is off")
        out[name] = flow
    out["peak_mem_gib"] = peak_gib(torch)
    return out


def _decode_check(torch, tfm, steps, model, cfg, tokens, n_steps: int):
    """Prefill, ``n_steps`` greedy decode steps, and forward over the prompt
    and the fed tokens: (prefill s, decode s, the largest relative L2 error
    of a step's logits against forward's at its position, finite)."""
    B, S = tokens.shape
    prefill = steps.make_lm_prefill_step(cfg, S + n_steps)
    decode = steps.make_lm_decode_step(cfg)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": tokens})
    sync()
    prefill_s = time.perf_counter() - t0
    got, fed = [logits], []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        fed.append(got[-1].argmax(-1, keepdim=True))
        logits, cache = decode(model, cache, {"tokens": fed[-1]})
        got.append(logits)
    sync()
    decode_s = time.perf_counter() - t0
    del cache
    h, _, _ = tfm.forward(model, torch.cat([tokens, *fed], 1), cfg)
    ref = tfm.logits_from_hidden(model, h[:, S - 1:], cfg)      # [B, steps + 1, V]
    got = torch.stack(got, 1)
    rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).amax(0)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    return prefill_s, decode_s, [float(r) for r in rel], finite


def lm_cell(torch, dev, arch: str, n_layers, B: int, S: int, n_steps: int) -> dict:
    """One LM at full width with bf16 serving weights: a warm-up prefill,
    then a timed prefill of B × S and ``n_steps`` greedy decode steps; each
    decode step's logits held to forward over the same prefix. An MoE
    model's cache check runs apart in fp32 with no token dropped, and its
    configured routing and drops in bf16 are held to fp32 (below)."""
    from repro_torch.configs import registry as reg
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm
    from repro_torch.train import steps

    full = reg.get_arch(arch).config_for_shape("prefill_32k")
    cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
    g = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = L.cast_weights_(tfm.init_params(cfg, g, dev), torch.bfloat16)
    sync()
    out = {"layers": cfg.n_layers, "of_layers": full.n_layers, "batch": B,
           "prompt": S, "decode_steps": n_steps, "init_s": time.perf_counter() - t0,
           "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    steps.make_lm_prefill_step(cfg, S)(model, {"tokens": tokens})      # warm-up
    prefill_s, decode_s, rel, finite = _decode_check(torch, tfm, steps, model, cfg,
                                                     tokens, n_steps)
    check(finite, f"{arch}: non-finite logits")
    out.update(prefill_s=prefill_s, prefill_tokens_per_s=B * S / prefill_s,
               decode_s=decode_s, decode_tokens_per_s=B * n_steps / decode_s,
               decode_ms_per_step=decode_s / n_steps * 1e3)
    if cfg.moe is None:
        out["decode_vs_forward_rel_err"] = rel
        check(max(rel) <= LM_REL_TOL_BF16,
              f"{arch}: decode logits off forward by {max(rel)} (bf16 tol {LM_REL_TOL_BF16})")
    else:
        # At capacity factor 1.25 a decode step of B tokens has capacity
        # max(1, int(1.25·B·K) // E) = 1 and drops tokens that the full
        # forward keeps (JAX's semantics, not a cache fault), and bf16
        # rounding can flip near-tied routes. So the cache is checked on the
        # same weights in fp32 with capacity N (capacity factor E / K).
        m = cfg.moe
        cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        tok = torch.randint(0, cfg.vocab, (2, 256), generator=g, device=dev)
        _, _, rel32, finite = _decode_check(torch, tfm, steps, model, cfg32, tok, 4)
        check(finite, f"{arch}: non-finite fp32 logits")
        out["decode_vs_forward_rel_err_fp32_no_drop"] = rel32
        check(max(rel32) <= LM_REL_TOL_FP32,
              f"{arch}: fp32 decode logits off forward by {max(rel32)}")
        # the configured routing and drops: bf16 forward over the prompt
        # (prefill's path and its N = B·S) against fp32 forward at the same
        # capacity factor
        cfg_f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        rel = []
        for c in (cfg, cfg_f32):
            h, _, _ = tfm.forward(model, tokens, c)
            rel.append(tfm.logits_from_hidden(model, h[:, 7::8], c).float())
            del h
        got, ref = rel
        rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).flatten()
        check(bool(torch.isfinite(got).all()), f"{arch}: non-finite bf16 logits")
        out["prefill_bf16_vs_fp32_rel_err"] = {"median": float(rel.median()),
                                               "max": float(rel.max())}
        check(float(rel.median()) <= LM_MOE_MEDIAN_REL_TOL_BF16,
              f"{arch}: bf16 logits off fp32 forward by a median {float(rel.median())} "
              f"(tol {LM_MOE_MEDIAN_REL_TOL_BF16})")
        del got, ref
    out["peak_mem_gib"] = peak_gib(torch)
    return out


def phase_models(torch, kops, kref, dev, flow_cfg=DLRM_FLOW, lm_cells=LM_CELLS) -> dict:
    """Cells dlrm-rm2-serve and the LM serving cells (PERF.md §4), with the
    launch counts of the models path."""
    t_phase = time.perf_counter()
    out = {}
    kops.reset_launches()                       # the models path starts here
    out["dlrm-rm2-serve"] = dlrm_cell(torch, kops, kref, dev, flow_cfg)
    torch.cuda.empty_cache()
    for arch, n_layers, B, S, n_steps in lm_cells:
        out[arch] = lm_cell(torch, dev, arch, n_layers, B, S, n_steps)
        torch.cuda.empty_cache()
    sync()
    out["launches"] = dict(kops.launches)       # the models path ends here
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["phase_s"] = time.perf_counter() - t_phase
    for name in ("gather_scores", "score_topk", "score_matrix"):
        check(out["launches"][name] > 0, f"kernel {name} was not launched on the models path")
    return out


# ---------------------------------------------------------------------------
# the GNN family: forward and train steps
# ---------------------------------------------------------------------------

GNN_WARMUP, GNN_STEPS, GNN_FORWARDS = 2, 10, 3
# the cells' AdamW: a short warm-up, so the loss falls within the timed steps;
# at 1e-3 GatedGCN's and DimeNet's losses on random labels and targets jumped
# between steps (CPU rehearsal at the molecule cell)
GNN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
# the reddit-scale graph of graphsage-reddit-sampled (random_graph(232,965,
# 492, 602, 41): 114.6 M edges, Reddit's size) and ogbn-products' sizes
REDDIT = dict(n_nodes=232_965, degree=492, d_feat=602, n_classes=41)
PRODUCTS = dict(n_nodes=2_449_029, n_edges=61_859_140)
GNN_SAMPLER_BATCHES = 5         # batches whose host time is taken
PRODUCTS_CHECK_NODES = 64       # products logits held to a float64 reference
# card against CPU, as the largest relative L2 error of an array: the
# summation order of index_add_'s atomics moves fp32 sums by ~1e-7
GNN_CARD_CPU_REL_TOL = 1e-4
GNN_PARITY_REL_TOL = {"logits": 1e-5, "loss": 1e-5, "grads": 1e-4, "params": 1e-6}


def _pad_to(a, n: int):
    import numpy as np
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])


def padded_graph(rng, dev, *, n_graphs: int, nodes: int, edges: int, d_feat: int,
                 n_classes: int):
    """``n_graphs`` random graphs of ``nodes`` nodes and ``edges`` edges
    each, without self-loops (drawn as tests/test_models_smoke.py draws
    them), merged and padded to 512 multiples: padded edges 0 → 0 and
    padded nodes masked. Features, 3-D positions, edge attributes, labels and
    per-graph targets are normal draws. → (GraphData, real senders, real
    receivers)."""
    import numpy as np

    from repro_torch.configs.gnn_common import D_EDGE, _pad512
    from repro_torch.models.gnn.common import make_graph

    N, E = n_graphs * nodes, n_graphs * edges
    Np, Ep = _pad512(N), _pad512(E)
    s = rng.integers(0, nodes, (n_graphs, edges))
    r = (s + 1 + rng.integers(0, nodes - 1, (n_graphs, edges))) % nodes
    off = (np.arange(n_graphs) * nodes)[:, None]
    s, r = (s + off).ravel().astype(np.int32), (r + off).ravel().astype(np.int32)
    g = make_graph(
        _pad_to(rng.normal(size=(N, d_feat)).astype(np.float32), Np),
        _pad_to(s, Ep), _pad_to(r, Ep),
        node_mask=np.arange(Np) < N, edge_mask=np.arange(Ep) < E,
        labels=_pad_to(rng.integers(0, n_classes, N).astype(np.int32), Np),
        label_mask=np.arange(Np) < N,
        positions=_pad_to(rng.normal(size=(N, 3)).astype(np.float32) * 1.5, Np),
        edge_attr=_pad_to(rng.normal(size=(E, D_EDGE)).astype(np.float32), Ep),
        graph_ids=_pad_to(np.repeat(np.arange(n_graphs, dtype=np.int32), nodes), Np),
        targets=rng.normal(size=n_graphs).astype(np.float32), n_graphs=n_graphs,
        device=dev)
    return g, s, r


def reset_peak(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def host_ms(fn, runs: int, warmup: int) -> tuple[float, list]:
    """Median wall time of ``runs`` calls of ``fn`` after ``warmup``, each
    ended by a synchronise; and every result."""
    outs = []
    for _ in range(warmup):
        outs.append(fn())
    times = []
    for _ in range(runs):
        sync()
        t = time.perf_counter()
        outs.append(fn())
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2], outs


def _rel_err(torch, got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def gnn_model(arch_id: str, cfg, seed: int, dev):
    import torch

    from repro_torch.configs.gnn_common import GNN_ARCH
    from repro_torch.models.gnn import dimenet, gat, gatedgcn, graphsage
    mod = {"graphsage": graphsage, "gat": gat, "gatedgcn": gatedgcn,
           "dimenet": dimenet}[GNN_ARCH[arch_id]]
    return mod.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)


def train_timed(torch, step, model, batch, runs: int = GNN_STEPS,
                warmup: int = GNN_WARMUP) -> dict:
    """``warmup`` + ``runs`` train steps on one batch: the median step time,
    the timed steps' losses (finite, the last below the first), grad_norm
    and lr of the last."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    state = [adamw_init(model.leaves())]

    def one():
        _, state[0], m = step(model, state[0], batch)
        return m

    ms, metrics = host_ms(one, runs, warmup)
    losses = [float(m["loss"]) for m in metrics[warmup:]]
    check(all(math.isfinite(v) for v in losses), "gnn: a non-finite loss")
    check(losses[-1] < losses[0], f"gnn: the loss did not fall over the timed steps {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in model.leaves()),
          "gnn: non-finite parameters after the steps")
    return {"ms_per_step": ms, "losses": losses, "grad_norm": float(metrics[-1]["grad_norm"]),
            "lr": float(metrics[-1]["lr"])}


def gnn_full_cell(torch, dev, arch_id: str, shape: str, seed: int, **graph) -> dict:
    """One full-graph cell at full width: forward (median of GNN_STEPS after
    GNN_WARMUP) held to the CPU's forward of the same weights and graph,
    then GNN_WARMUP + GNN_STEPS train steps."""
    import copy

    import numpy as np

    from repro_torch.configs import registry as reg
    from repro_torch.configs.gnn_common import GNN_ARCH, max_triplets
    from repro_torch.models.gnn.dimenet import build_triplets
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig

    arch = GNN_ARCH[arch_id]
    cfg = reg.get_arch(arch_id).config_for_shape(shape)
    reset_peak(torch)
    rng = np.random.default_rng(seed)
    g, s, r = padded_graph(rng, dev, d_feat=cfg.d_in,
                           n_classes=getattr(cfg, "n_classes", 2), **graph)
    batch = {"graph": g}
    out = {"config": shape, "nodes": int(g.node_mask.sum()), "edges": int(g.edge_mask.sum()),
           "padded_nodes": g.n_nodes, "padded_edges": g.n_edges}
    if arch == "dimenet":
        t = time.perf_counter()
        trip = build_triplets(s, r, len(s), max_triplets(shape))
        out["triplets_build_s"] = time.perf_counter() - t
        out["triplets"] = int(trip["mask"].sum())
        batch["triplets"] = steps.batch_to(trip, dev)
    model = gnn_model(arch_id, cfg, seed, dev)
    model_cpu = copy.deepcopy(model).to("cpu")
    fwd = steps.make_gnn_forward(arch, cfg, dev)
    ms, outs = host_ms(lambda: fwd(model, batch), GNN_STEPS, GNN_WARMUP)
    logits = outs[-1]
    check(bool(torch.isfinite(logits).all()), f"{arch_id}: non-finite forward")
    want = steps.make_gnn_forward(arch, cfg, "cpu")(model_cpu, steps.batch_to(batch, "cpu"))
    err = _rel_err(torch, logits, want)
    check(err <= GNN_CARD_CPU_REL_TOL, f"{arch_id}: forward off the CPU's by {err}")
    out.update(forward_ms=ms, nodes_per_s_forward=out["nodes"] / ms * 1e3,
               edges_per_s_forward=out["edges"] / ms * 1e3, output_shape=list(logits.shape),
               card_vs_cpu_rel_err=err)
    del model_cpu, want, outs
    step = steps.make_gnn_train_step(arch, cfg, AdamWConfig(**GNN_OPT), dev)
    tr = train_timed(torch, step, model, batch)
    out["train"] = dict(tr, nodes_per_s=out["nodes"] / tr["ms_per_step"] * 1e3,
                        edges_per_s=out["edges"] / tr["ms_per_step"] * 1e3)
    out["peak_mem_gib"] = peak_gib(torch)
    return out


def gnn_sampled_cell(torch, dev, seed: int, reddit: dict) -> dict:
    """graphsage-reddit-sampled: the CSR build of the reddit-scale graph on
    the host, the sampler's host time a batch, the batch's copy to the
    card, forward_sampled (held to the CPU's) and train steps on one batch,
    then steps that each sample a fresh batch first."""
    import copy

    from repro_torch.configs import graphsage_reddit
    from repro_torch.configs.gnn_common import BATCH_NODES
    from repro_torch.data.graph_sampler import NeighborSampler, random_graph
    from repro_torch.models.gnn import graphsage
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = graphsage_reddit.config_for_shape("minibatch_lg")
    reset_peak(torch)
    t = time.perf_counter()
    csr = random_graph(reddit["n_nodes"], reddit["degree"], reddit["d_feat"],
                       reddit["n_classes"], seed=seed)
    out = {"config": "minibatch_lg", "nodes": csr.n_nodes, "edges": int(csr.indices.shape[0]),
           "fanout": list(cfg.sample_sizes), "batch_nodes": BATCH_NODES,
           "csr_build_s": time.perf_counter() - t}
    sampler = NeighborSampler(csr, cfg.sample_sizes, BATCH_NODES, seed=seed)
    sample_ms, host = host_ms(sampler.next_batch, GNN_SAMPLER_BATCHES, 0)
    out["sampler_ms_per_batch"] = sample_ms
    out["sampled_nodes_per_batch"] = int(sum(m.sum() for m in host[0]["blocks"]["masks"]))
    copy_ms, dev_batches = host_ms(lambda: steps.batch_to(host[0], dev), 3, 0)
    out["host_to_device_ms"] = copy_ms
    batch = dev_batches[-1]
    model = gnn_model("graphsage-reddit", cfg, seed, dev)
    model_cpu = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        ms, outs = host_ms(lambda: graphsage.forward_sampled(model, batch["blocks"], cfg),
                           GNN_STEPS, GNN_WARMUP)
        want = graphsage.forward_sampled(model_cpu, steps.batch_to(host[0], "cpu")["blocks"], cfg)
    check(bool(torch.isfinite(outs[-1]).all()) and tuple(outs[-1].shape) == (BATCH_NODES,
                                                                              cfg.n_classes),
          "graphsage-reddit-sampled: forward not finite or misshapen")
    err = _rel_err(torch, outs[-1], want)
    check(err <= GNN_CARD_CPU_REL_TOL, f"graphsage-reddit-sampled: forward off the CPU's by {err}")
    out.update(forward_ms=ms, targets_per_s_forward=BATCH_NODES / ms * 1e3,
               card_vs_cpu_rel_err=err)
    del model_cpu, outs, want
    step = steps.make_gnn_train_step("graphsage", cfg, AdamWConfig(**GNN_OPT), dev)
    tr = train_timed(torch, step, model, batch)
    out["train_one_batch"] = dict(tr, targets_per_s=BATCH_NODES / tr["ms_per_step"] * 1e3)
    # the pipeline as training runs it: sample on the host, copy, step
    state = [adamw_init(model.leaves())]

    def sampled_step():
        _, state[0], m = step(model, state[0], sampler.next_batch())
        return m
    ms, metrics = host_ms(sampled_step, 3, 0)
    check(all(bool(torch.isfinite(m["loss"])) for m in metrics),
          "graphsage-reddit-sampled: a non-finite loss on a fresh batch")
    out["train_fresh_batches"] = {"ms_per_step": ms, "targets_per_s": BATCH_NODES / ms * 1e3,
                                  "sampler_share": sample_ms / ms}
    out["peak_mem_gib"] = peak_gib(torch)
    return out


def sage_rows_reference(torch, model, g, nodes):
    """GraphSAGE's full-graph logits of ``nodes`` in float64, from their
    two-hop in-neighbourhood alone (the layers' means written out over the
    edges that reach each node)."""
    s, r, m = g.senders.long(), g.receivers.long(), g.edge_mask
    N = g.n_nodes

    def layer(lp, h, h_ids, targets, relu):
        pos = torch.full((N,), -1, dtype=torch.long, device=h.device)
        pos[h_ids] = torch.arange(h_ids.shape[0], device=h.device)
        tpos = torch.full((N,), -1, dtype=torch.long, device=h.device)
        tpos[targets] = torch.arange(targets.shape[0], device=h.device)
        sel = m & (tpos[r] >= 0)
        es, er = s[sel], r[sel]
        tot = torch.zeros((targets.shape[0], h.shape[1]), dtype=h.dtype, device=h.device)
        tot.index_add_(0, tpos[er], h[pos[es]])
        cnt = torch.zeros(targets.shape[0], dtype=h.dtype, device=h.device)
        cnt.index_add_(0, tpos[er], torch.ones_like(er, dtype=h.dtype))
        out = h[pos[targets]] @ lp.w_self.double() + (tot / cnt.clamp(min=1)[:, None]) @ lp.w_nbr.double()
        out = torch.relu(out) if relu else out
        return out * g.node_mask[targets, None]

    l1, l2 = model.layers[0], model.layers[1]
    sel = m & torch.isin(r, nodes)
    hop1 = torch.unique(torch.cat([nodes, s[sel]]))
    sel = m & torch.isin(r, hop1)
    hop2 = torch.unique(torch.cat([hop1, s[sel]]))
    h1 = layer(l1, g.x[hop2].double(), hop2, hop1, True)
    return layer(l2, h1, hop1, nodes, False)


def products_graph(torch, dev, gen, products: dict, d_feat: int):
    """An ogbn-products-sized graph drawn on ``dev`` from ``gen``: uniform
    random edges and normal features, padded to 512 multiples (padded edges
    0 → 0 and padded nodes masked); no edge attributes."""
    from repro_torch.configs.gnn_common import _pad512
    from repro_torch.models.gnn.common import GraphData

    N, E = products["n_nodes"], products["n_edges"]
    Np, Ep = _pad512(N), _pad512(E)

    def ids():
        a = torch.zeros(Ep, dtype=torch.int32, device=dev)
        a[:E] = torch.randint(0, N, (E,), generator=gen, device=dev, dtype=torch.int32)
        return a

    x = torch.zeros((Np, d_feat), device=dev)
    x[:N] = torch.randn((N, d_feat), generator=gen, device=dev)
    return GraphData(
        x=x, senders=ids(), receivers=ids(),
        node_mask=torch.arange(Np, device=dev) < N, edge_mask=torch.arange(Ep, device=dev) < E,
        labels=torch.zeros(Np, dtype=torch.int32, device=dev),
        label_mask=torch.zeros(Np, dtype=torch.bool, device=dev),
        positions=torch.zeros((Np, 3), device=dev),
        edge_attr=torch.zeros((Ep, 0), device=dev),
        graph_ids=torch.zeros(Np, dtype=torch.int32, device=dev),
        targets=torch.zeros(1, device=dev))


def gnn_products_cell(torch, dev, seed: int, products: dict) -> dict:
    """graphsage-products-full: the graph drawn on the card
    (:func:`products_graph`), GNN_FORWARDS forwards after GNN_WARMUP,
    PRODUCTS_CHECK_NODES rows of the logits held to a float64 reference."""
    from repro_torch.configs import graphsage_reddit
    from repro_torch.train import steps

    cfg = graphsage_reddit.config_for_shape("ogb_products")
    reset_peak(torch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = time.perf_counter()
    g = products_graph(torch, dev, gen, products, cfg.d_in)
    sync()
    N, E = products["n_nodes"], products["n_edges"]
    out = {"config": "ogb_products", "nodes": N, "edges": E, "padded_nodes": g.n_nodes,
           "padded_edges": g.n_edges, "graph_build_s": time.perf_counter() - t}
    model = gnn_model("graphsage-reddit", cfg, seed, dev)
    fwd = steps.make_gnn_forward("graphsage", cfg, dev)
    ms, outs = host_ms(lambda: fwd(model, {"graph": g}), GNN_FORWARDS, GNN_WARMUP)
    logits = outs[-1]
    del outs
    check(tuple(logits.shape) == (g.n_nodes, cfg.n_classes)
          and bool(torch.isfinite(logits).all()),
          "graphsage-products-full: logits not finite or misshapen")
    nodes = torch.unique(torch.randint(0, N, (PRODUCTS_CHECK_NODES,), generator=gen,
                                       device=dev))
    with torch.no_grad():
        ref = sage_rows_reference(torch, model, g, nodes)
    got = logits[nodes].double()
    err = float((got - ref).abs().max())
    check(err <= 1e-5 + 1e-4 * float(ref.abs().max()),
          f"graphsage-products-full: logits off the float64 reference by {err}")
    out.update(forward_ms=ms, nodes_per_s_forward=N / ms * 1e3, edges_per_s_forward=E / ms * 1e3,
               ref_rows=int(ref.shape[0]), ref_max_abs_err=err,
               peak_mem_gib=peak_gib(torch))
    return out


def phase_gnn(torch, kops, seed: int = 0, reddit=REDDIT, products=PRODUCTS,
              device: str = "cuda") -> dict:
    """The gnn phase's five cells (PERF.md §4), with the launch counts of
    the GNN path (its message passing reaches no kernel of the port)."""
    dev = torch.device(device)
    t_phase = time.perf_counter()
    kops.reset_launches()                       # the GNN path starts here
    out = {"gat-cora-full": gnn_full_cell(torch, dev, "gat-cora", "full_graph_sm", seed,
                                          n_graphs=1, nodes=2_708, edges=10_556),
           "graphsage-reddit-sampled": gnn_sampled_cell(torch, dev, seed, reddit),
           "graphsage-products-full": gnn_products_cell(torch, dev, seed, products)}
    for arch_id in ("gatedgcn", "dimenet"):
        out[f"{arch_id}-molecule"] = gnn_full_cell(torch, dev, arch_id, "molecule", seed,
                                                   n_graphs=128, nodes=30, edges=64)
    sync()
    out["launches"] = dict(kops.launches)       # the GNN path ends here
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run_parity_gnn(device: str) -> dict:
    """The four GNN archs at their smoke configs and the sampled GraphSAGE,
    from weights drawn on the CPU: forward, the loss's gradients, and one
    AdamW train step (loss, parameters after it)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry as reg
    from repro_torch.configs.gnn_common import GNN_ARCH
    from repro_torch.data.graph_sampler import NeighborSampler, random_graph
    from repro_torch.models.gnn import graphsage
    from repro_torch.models.gnn.dimenet import build_triplets
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    opt = AdamWConfig(**GNN_OPT)
    out = {}
    cases = [(a, a) for a in GNN_ARCH] + [("graphsage-reddit", "graphsage-sampled")]
    for i, (arch_id, name) in enumerate(cases):
        arch, cfg = GNN_ARCH[arch_id], reg.get_arch(arch_id).smoke_config()
        rng = np.random.default_rng(11 + i)
        if name == "graphsage-sampled":
            csr = random_graph(300, 6, cfg.d_in, cfg.n_classes, seed=i)
            batch = steps.batch_to(NeighborSampler(csr, cfg.sample_sizes, 16, seed=i)
                                   .next_batch(), device)
        else:
            g, s, r = padded_graph(rng, device, n_graphs=2, nodes=20, edges=60,
                                   d_feat=cfg.d_in, n_classes=getattr(cfg, "n_classes", 2))
            batch = {"graph": g}
            if arch == "dimenet":
                batch["triplets"] = steps.batch_to(build_triplets(s, r, len(s), 512), device)
        model = gnn_model(arch_id, cfg, i, "cpu").to(device)
        res = {}
        if name == "graphsage-sampled":
            with torch.no_grad():
                res["logits"] = graphsage.forward_sampled(model, batch["blocks"], cfg)
        else:
            res["logits"] = steps.make_gnn_forward(arch, cfg, device)(model, batch)
        loss, _ = steps.gnn_loss(model, batch, arch, cfg)
        grads = torch.autograd.grad(loss, list(model.leaves()))
        res["grads"] = {str(j): gr for j, gr in enumerate(grads)}
        _, _, m = steps.make_gnn_train_step(arch, cfg, opt, device)(
            model, adamw_init(model.leaves()), batch)
        res["loss"] = m["loss"]
        res["params"] = {str(j): p.detach() for j, p in enumerate(model.leaves())}
        out[name] = res
    return {k: v.cpu() for k, v in _flatten(out)}


def gnn_parity() -> dict:
    """run_parity_gnn on the card against the CPU: the largest relative L2
    error of logits, loss, gradients and parameters after the step, each
    within GNN_PARITY_REL_TOL."""
    import torch
    gpu, cpu = run_parity_gnn("cuda"), run_parity_gnn("cpu")
    check(gpu.keys() == cpu.keys(), "parity: GNN result keys differ")
    worst = dict.fromkeys(GNN_PARITY_REL_TOL, 0.0)
    for k in gpu:
        kind = k.split(".")[1]
        check(bool(torch.isfinite(gpu[k]).all()), f"parity: GNN {k} not finite")
        worst[kind] = max(worst[kind], _rel_err(torch, gpu[k], cpu[k]))
    for kind, tol in GNN_PARITY_REL_TOL.items():
        check(worst[kind] <= tol, f"parity: GNN {kind} off the CPU's by {worst[kind]} "
                                  f"(tol {tol})")
    return {"gnn_compared": len(gpu), "gnn_max_rel_err": worst}


# ---------------------------------------------------------------------------
# train phase: the LM and DLRM train steps and the training driver
# ---------------------------------------------------------------------------

LM_ARCHS = ("qwen3-1.7b", "mistral-nemo-12b", "gemma2-27b", "phi3.5-moe-42b-a6.6b",
            "llama4-scout-17b-a16e")
# the parity entries' AdamW: the gnn phase's, at eps 1e-4. At eps 1e-8 a
# summation-order difference δ in a gradient near eps moves its element by
# up to lr·δ/(4·eps), and one whose gradient is below δ flips sign (2·lr),
# so the parameters after a step would measure the gradients' noise, not
# the step (tests/test_torch_train.py shows it against JAX)
TRAIN_PARITY_OPT = dict(GNN_OPT, eps=1e-4)
# the LM entries' norm scales are drawn from N(0, 0.1²), not JAX's zeros: a
# zero scale after one step is -lr·update, so its relative L2 error is the
# update's own, a gradient's relative error per element (8.9e-6 with zero
# scales at eps 1e-4 on an H100), not the step's error against the
# parameter's size
TRAIN_PARITY_NORM_STD = 0.1
TRAIN_PARITY_REL_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-4, "params": 1e-6}
# the full-width cells: AdamW as the gnn phase's, on one repeated batch
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
TRAIN_WARMUP, TRAIN_STEPS = 1, 5
LM_TRAIN_SEQ = 4096             # train_4k's S; its B 256 does not fit one card
LM_TRAIN_MEM_FRACTION = 0.9     # of the card's memory the chosen B may fill
DLRM_TRAIN_B = 65_536           # dlrm_rm2's train_batch
RESUME_RTOL = 1e-4              # JAX's bound (tests/test_checkpoint.py)


def run_parity_train(device: str) -> dict:
    """The five LM smoke configs (norm scales drawn from N(0, 0.1²)) and the
    DLRM smoke config, from weights drawn on the CPU and numpy batches: the
    loss's gradients, then one train step (loss, grad_norm, the parameters
    after it)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry as reg
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    opt = AdamWConfig(**TRAIN_PARITY_OPT)
    out = {}
    for i, arch in enumerate(LM_ARCHS + ("dlrm-rm2",)):
        cfg = reg.get_arch(arch).smoke_config()
        rng = np.random.default_rng(40 + i)
        gen = torch.Generator().manual_seed(i)
        if arch == "dlrm-rm2":
            model = dlrm_mod.init_params(cfg, gen).to(device)
            shape = (128, cfg.n_sparse, cfg.nnz)
            batch = {"dense": rng.normal(size=(128, cfg.n_dense)).astype(np.float32),
                     "sparse_ids": rng.integers(-3, cfg.n_rows + 3, shape).astype(np.int32),
                     "sparse_mask": rng.random(shape) > 0.3,
                     "labels": (rng.random(128) > 0.5).astype(np.int32)}
            step = steps.make_dlrm_train_step(cfg, opt, device)

            def loss_fn(m, b, cfg=cfg):
                return dlrm_mod.bce_loss(m, b, cfg)
        else:
            model = tfm.init_params(cfg, gen)
            with torch.no_grad():
                for p in model.parameters():
                    if p.dim() == 1:
                        p.copy_(torch.randn(p.shape, generator=gen) * TRAIN_PARITY_NORM_STD)
            model = model.to(device)
            batch = TokenStream(cfg.vocab, 2, 32, seed=i).next_batch()
            batch["mask"] = rng.random((2, 32)) > 0.2
            step = steps.make_lm_train_step(cfg, opt, device=device)

            def loss_fn(m, b, cfg=cfg):
                return steps.lm_loss(m, b, cfg)[0]
        leaves = list(model.parameters())
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(loss_fn(model, steps.batch_to(batch, device)), leaves,
                                    allow_unused=True, materialize_grads=True)
        _, _, m = step(model, adamw_init(leaves), batch)
        out[arch.replace(".", "_")] = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                     "grads": {str(j): g for j, g in enumerate(grads)},
                     "params": {str(j): p.detach() for j, p in enumerate(leaves)}}
    return {k: v.cpu() for k, v in _flatten(out)}


def train_parity() -> dict:
    """run_parity_train on the card against the CPU: the largest relative
    L2 error of loss, grad_norm, gradients and parameters after the step,
    each within TRAIN_PARITY_REL_TOL."""
    import torch
    gpu, cpu = run_parity_train("cuda"), run_parity_train("cpu")
    check(gpu.keys() == cpu.keys(), "train: parity result keys differ")
    worst = {kind: (0.0, "") for kind in TRAIN_PARITY_REL_TOL}
    for k in gpu:
        kind = k.split(".")[1]
        check(bool(torch.isfinite(gpu[k]).all()), f"train: parity {k} not finite")
        worst[kind] = max(worst[kind], (_rel_err(torch, gpu[k], cpu[k]), k))
    for kind, tol in TRAIN_PARITY_REL_TOL.items():
        check(worst[kind][0] <= tol, f"train: parity {worst[kind][1]} off the CPU's by "
                                     f"{worst[kind][0]} (tol {tol})")
    return {"compared": len(gpu), "max_rel_err": {k: v[0] for k, v in worst.items()},
            "worst": {k: v[1] for k, v in worst.items()}}


def train_losses(torch, step, model, state, batch, what: str) -> tuple[float, list]:
    """TRAIN_WARMUP + TRAIN_STEPS train steps on one batch: the median time
    of the last TRAIN_STEPS and every step's loss (finite, the last below
    the first; every parameter finite after)."""
    st = [state]

    def one():
        _, st[0], m = step(model, st[0], batch)
        return m
    ms, metrics = host_ms(one, TRAIN_STEPS, TRAIN_WARMUP)
    losses = [float(m["loss"]) for m in metrics]
    check(all(math.isfinite(v) for v in losses), f"{what}: a non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{what}: the loss did not fall {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          f"{what}: non-finite parameters after the steps")
    return ms, losses


def lm_train_cell(torch, dev, seed: int) -> dict:
    """qwen3-1.7b's train_4k config at full width (28 layers, d 2,048, vocab
    151,936, bf16 compute, fp32 masters and AdamW state) at S 4,096 and the
    largest B that fits: one step each at B 1 and B 2 gives the peak
    memory as a + b·B, and B is the largest with a + b·B within
    LM_TRAIN_MEM_FRACTION of the card. Then a fresh model takes TRAIN_WARMUP
    + TRAIN_STEPS steps on one repeated TokenStream batch."""
    from repro_torch.configs import registry as reg
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    spec = reg.get_arch("qwen3-1.7b")
    cfg = spec.config_for_shape("train_4k")
    step = steps.make_lm_train_step(cfg, AdamWConfig(**TRAIN_OPT), device=dev)

    def fresh():
        model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        return model, adamw_init(model.parameters())

    def batch(B):
        return steps.batch_to(TokenStream(cfg.vocab, B, LM_TRAIN_SEQ, seed=seed).next_batch(),
                              dev)

    reset_peak(torch)
    t = time.perf_counter()
    model, state = fresh()
    sync()
    out = {"config": "train_4k", "n_params": cfg.n_params(), "seq": LM_TRAIN_SEQ,
           "init_s": time.perf_counter() - t}
    peaks = {}
    for B in (1, 2):
        reset_peak(torch)
        _, state, _ = step(model, state, batch(B))
        sync()
        peaks[B] = torch.cuda.max_memory_allocated()
    per_seq = peaks[2] - peaks[1]
    check(per_seq > 0, f"qwen3-1.7b train: the peak did not grow with B {peaks}")
    limit = LM_TRAIN_MEM_FRACTION * torch.cuda.get_device_properties(dev).total_memory
    B = max(1, min(spec.shapes["train_4k"].sizes["batch"],
                   int((limit - (peaks[1] - per_seq)) // per_seq)))
    out.update(probe_peak_gib={b: p / 2**30 for b, p in peaks.items()},
               per_sequence_gib=per_seq / 2**30, batch=B)
    del model, state
    reset_peak(torch)
    model, state = fresh()
    b = batch(B)
    ms, losses = train_losses(torch, step, model, state, b, "qwen3-1.7b train")
    tokens = B * LM_TRAIN_SEQ
    out.update(losses=losses, ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
               model_tflops_per_s_6N=6 * cfg.n_params() * tokens / ms * 1e-9,
               peak_mem_gib=peak_gib(torch))
    return out


def dlrm_loss_reference(torch, model, batch) -> float:
    """bce_loss in float64 on the CPU: the batch's rows gathered on the card
    as JAX reads them (negatives from the end, then clamped), every sum and
    product after that in float64."""
    tables = model.tables.detach()
    F, R, _ = tables.shape
    ids = batch["sparse_ids"].long()
    ids = torch.where(ids < 0, ids + R, ids).clamp(0, R - 1)
    rows = tables[torch.arange(F, device=ids.device)[None, :, None], ids].cpu().double()
    mask = batch["sparse_mask"].cpu()
    emb = (rows * mask[..., None]).sum(2) / mask.sum(-1, keepdim=True).clamp(min=1)
    del rows
    x = batch["dense"].cpu().double()
    for w in model.bot:
        x = torch.relu(x @ w.detach().cpu().double())
    z = torch.cat([x[:, None, :], emb], dim=1)
    zz = torch.bmm(z, z.transpose(1, 2))
    iu, ju = torch.tril_indices(z.shape[1], z.shape[1], -1)
    y = torch.cat([zz[:, iu, ju], x], dim=1)
    for i, w in enumerate(model.top):
        y = y @ w.detach().cpu().double()
        if i < len(model.top) - 1:
            y = torch.relu(y)
    zl, lab = y[:, 0], batch["labels"].cpu().double()
    return float(torch.mean(torch.clamp(zl, min=0) - zl * lab + torch.log1p(torch.exp(-zl.abs()))))


def dlrm_train_cell(torch, dev, seed: int) -> dict:
    """DLRM-RM2's train_batch at full size (26 tables of 2^20 × 64 fp32, B
    65,536, dense table gradients): the first step's loss against a float64
    CPU forward of the same parameters and batch (1e-5 relative), then
    TRAIN_WARMUP + TRAIN_STEPS steps on the repeated batch."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = dlrm_rm2.config()
    g = torch.Generator(device=dev).manual_seed(seed)
    reset_peak(torch)
    model = dlrm_mod.init_params(cfg, g, dev)
    B = DLRM_TRAIN_B
    shape = (B, cfg.n_sparse, cfg.nnz)
    batch = {"dense": torch.randn((B, cfg.n_dense), generator=g, device=dev),
             "sparse_ids": torch.randint(0, cfg.n_rows, shape, generator=g, device=dev,
                                         dtype=torch.int32),
             "sparse_mask": torch.rand(shape, generator=g, device=dev) > 0.3,
             "labels": (torch.rand((B,), generator=g, device=dev) > 0.5).to(torch.int32)}
    t = time.perf_counter()
    ref = dlrm_loss_reference(torch, model, batch)
    out = {"batch": B, "table_bytes": model.tables.numel() * model.tables.element_size(),
           "reference_s": time.perf_counter() - t}
    step = steps.make_dlrm_train_step(cfg, AdamWConfig(**TRAIN_OPT), dev)
    ms, losses = train_losses(torch, step, model, adamw_init(model.parameters()), batch,
                              "dlrm-rm2 train")
    err = abs(losses[0] - ref) / abs(ref)
    check(err <= 1e-5, f"dlrm-rm2 train: first loss {losses[0]} off the float64 "
                       f"reference {ref} by {err}")
    out.update(losses=losses, reference_loss=ref, first_loss_rel_err=err, ms_per_step=ms,
               samples_per_s=B / ms * 1e3, peak_mem_gib=peak_gib(torch))
    return out


def train_resume_cell(torch, dev) -> dict:
    """repro_torch.launch.train.train_lm at qwen3's smoke config on the
    card: 30 steps straight, then 20 steps, a simulated preemption and a
    resume for the last 10 from the checkpoint (under build/, removed
    after); the final losses within RESUME_RTOL."""
    import contextlib
    import io
    import shutil

    from repro_torch.launch.train import train_lm

    kw = dict(smoke=True, steps=30, batch=2, seq=16, log_every=100, device=dev)
    d = scratch_dir("train-")
    log = io.StringIO()
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(log):
            full = train_lm("qwen3-1.7b", **kw)
            cut = train_lm("qwen3-1.7b", ckpt_dir=str(d), ckpt_every=10, preempt_at=20, **kw)
            resumed = train_lm("qwen3-1.7b", ckpt_dir=str(d), resume=True, **kw)
        seconds = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(cut.get("preempted_at") == 20 and "resumed from step 20" in log.getvalue()
          and len(resumed["losses"]) == 10, "train: the preemption or the resume went wrong")
    a, b = full["losses"][-1], resumed["losses"][-1]
    err = abs(a - b) / abs(a)
    check(err <= RESUME_RTOL, f"train: resumed final loss {b} off the straight run's {a}")
    params_err = max(_rel_err(torch, p, q) for p, q in
                     zip(full["params"].parameters(), resumed["params"].parameters()))
    return {"final_loss": a, "resumed_final_loss": b, "final_loss_rel_err": err,
            "final_params_max_rel_err": params_err,
            "bitwise": a == b and params_err == 0.0, "seconds": seconds}


def phase_train(torch, kops, seed: int = 0, device: str = "cuda") -> dict:
    """The train phase (PERF.md §4): card-against-CPU parity of the train
    steps, qwen3-1.7b and DLRM-RM2 at full width, preemption and resume;
    with the launch counts of the training path (it reaches no kernel of
    the port)."""
    dev = torch.device(device)
    t_phase = time.perf_counter()
    t = time.perf_counter()
    out = {"parity": train_parity()}
    out["parity"]["seconds"] = time.perf_counter() - t
    kops.reset_launches()                       # the training path starts here
    out["qwen3-1.7b-train"] = lm_train_cell(torch, dev, seed)
    torch.cuda.empty_cache()
    out["dlrm-rm2-train"] = dlrm_train_cell(torch, dev, seed)
    torch.cuda.empty_cache()
    out["resume"] = train_resume_cell(torch, dev)
    sync()
    out["launches"] = dict(kops.launches)       # the training path ends here
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# dryrun: every registry cell planned for one and four cards, and run on
# the card where it fits one
# ---------------------------------------------------------------------------

DRYRUN_KERNELS = ("gather_scores_bf16", "score_matrix", "score_topk")
DRYRUN_MANIFEST = ROOT / "build" / "dryrun_manifest.json"      # the CLI's default
# shapes planned outside the phase: an LM's prefill_32k trace walks 2,080
# q/kv tile pairs a layer, 30-75 s a cell on the card's host, past the
# phase's 90 s (python -m repro_torch.launch.dryrun --shape prefill_32k)
DRYRUN_CUT = ("prefill_32k",)


class LaunchAudit:
    """While entered: the kernel wrappers that the registry cells call
    (``gather_scores``, ``score_topk``, ``score_matrix``) tally their
    launches by full shape (``by_shape``), and the first launch of each
    shape, outside a counted trace, is held against the plain version on
    the same inputs (``max_err``): the gathers within rtol 1e-4 / atol
    1e-3, score_topk's scores so and its ids equal except inside a
    near-tie, score_matrix within ``matrix_tol``. The checks launch
    nothing; a cell's shapes first launch in its build and warm step,
    which its measured peak leaves out (``launch/dryrun.py::run_cell``).
    ``unchecked()`` lists the shapes that launched unchecked."""

    def __init__(self, kops, kref):
        self.kops, self.kref = kops, kref
        self.by_shape: dict = {}
        self.max_err: dict = {}
        self._orig: dict = {}

    def _call(self, fn, args, kw, key, hold):
        launches = self.kops.launches
        before = dict(launches)
        out = fn(*args, **kw)
        for name, n in launches.items():
            if n != before[name]:
                shapes = self.by_shape.setdefault(name, {})
                shapes[key()] = shapes.get(key(), 0) + n - before[name]
                if self.kops.observer is None and key() not in self.max_err:
                    self.max_err[key()] = hold(out)
        return out

    def __enter__(self):
        kops, kref = self.kops, self.kref
        self._orig = orig = {n: getattr(kops, n)
                             for n in ("gather_scores", "score_topk", "score_matrix")}

        def gather_scores(table, tsq, ids, q, *, metric="l2"):
            return self._call(
                orig["gather_scores"], (table, tsq, ids, q), dict(metric=metric),
                lambda: (f"gather B{ids.shape[0]} C{ids.shape[1]} d{table.shape[1]} "
                         f"{str(table.dtype)[6:]} {metric}"),
                lambda out: _close(out, kref.gather_scores(table, tsq, ids, q, metric)))

        def hold_topk(x, xsq, q, k, metric, n_valid, out):
            gs, gi = out
            ws, wi = kref.score_topk(x, xsq, q, k, metric, n_valid)
            err = _close(gs, ws)
            _topk_ids_ok(gs, gi, ws, wi)
            return err

        def score_topk(x, xsq, q, k, *, metric="l2", n_valid=None):
            return self._call(
                orig["score_topk"], (x, xsq, q, k), dict(metric=metric, n_valid=n_valid),
                lambda: (f"topk B{q.shape[0]} M{x.shape[0]} d{x.shape[1]} k{k} {metric}"
                         + ("" if n_valid is None else f" n_valid{n_valid}")),
                lambda out: hold_topk(x, xsq, q, k, metric, n_valid, out))

        def score_matrix(x, xsq, q, *, metric="l2"):
            return self._call(
                orig["score_matrix"], (x, xsq, q), dict(metric=metric),
                lambda: (f"matrix R{x.shape[0] if x.dim() == 3 else 1} B{q.shape[-2]} "
                         f"M{x.shape[-2]} d{x.shape[-1]} {str(x.dtype)[6:]} {metric}"
                         + (" self" if kops.is_self_pair(x, q) else "")),
                lambda out: _close(out, kref.score_matrix(x, xsq, q, metric),
                                   **matrix_tol(x.dtype, x.shape[-1])))

        kops.gather_scores, kops.score_topk, kops.score_matrix = (
            gather_scores, score_topk, score_matrix)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.kops, name, fn)

    def unchecked(self) -> list:
        return sorted(k for shapes in self.by_shape.values() for k in shapes
                      if k not in self.max_err)


def phase_dryrun(torch, kops, kref, device: str = "cuda", cells=None,
                 jobs: int | None = None, manifest: Path = DRYRUN_MANIFEST) -> dict:
    """The dryrun phase (PERF.md §4): ``launch.dryrun.plan_cell`` for every
    non-skipped registry cell at one and four cards, in ``jobs`` processes
    (traces on ``meta``, no card); as each plan comes in, every cell
    planned to fit one card runs on the card in this process
    (``run_cell(..., run=True)``: the index cells at both layouts, their
    shards stacked), under a ``LaunchAudit``. Checks that every such cell
    ran, within the card's memory, that the bf16-row gather, score_matrix
    and score_topk were launched, and that each shape they launched at was
    held against the plain version; writes the whole manifest to
    ``build/``."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor, as_completed

    from repro_torch.configs import registry as reg
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch.cells import all_cells

    t_phase = time.perf_counter()
    dev = torch.device(device)
    todo = cells or [(a, s) for a, s, skip in all_cells()
                     if not skip and s not in DRYRUN_CUT]
    # the plans that lead to runs on the card first; the LM plans (none
    # fits one card) behind them, overlapping the runs
    todo = sorted(todo, key=lambda c: reg.get_arch(c[0]).family == "lm")
    jobs = jobs or max(1, (os.cpu_count() or 2) // 2)
    records, ran, plan_s, run_s = {}, [], {}, {}
    card_bytes = (torch.cuda.get_device_properties(dev).total_memory
                  if dev.type == "cuda" else None)
    kops.reset_launches()                       # the dryrun path starts here
    pool = ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                               initializer=torch.set_num_threads, initargs=(1,))
    try:
        with LaunchAudit(kops, kref) as audit:
            futures = {pool.submit(dryrun.plan_cell, a, s): (a, s) for a, s in todo}
            # while the first plans come: the counter's and the profiler's
            # one-time start (~10 s on the card's host) off the first run, and
            # cuBLAS's workspaces allocated before any cell counts from them
            x = torch.ones((8, 8), device=dev)
            analysis.trace(torch.mm, x, x)
            del x
            for fut in as_completed(futures):
                arch, shape = futures[fut]
                plan = fut.result()
                plan_s[f"{arch}|{shape}"] = plan["one"]["trace_s"]
                ipgm = reg.get_arch(arch).family == "ipgm"
                for layout, rec in plan.items():
                    if plan["one"]["fits"] and (layout == "one" or ipgm):
                        t = time.perf_counter()
                        rec = dryrun.run_cell(arch, shape, layout, run=True, device=dev,
                                              plan=plan)
                        if dev.type == "cuda":
                            torch.cuda.empty_cache()
                        run = rec["run"]
                        run_s[f"{arch}|{shape}|{layout}"] = time.perf_counter() - t
                        check(card_bytes is None or run["peak_allocated_bytes"] < card_bytes,
                              f"dryrun: {arch}|{shape}|{layout} ran out of the card's memory")
                        ran.append(f"{arch}|{shape}|{layout}")
                    records[f"{arch}|{shape}|{layout}"] = rec
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    sync()
    launches = dict(kops.launches)              # the dryrun path ends here
    dryrun.save_manifest(records, manifest)
    planned_one = sorted(k for k, r in records.items() if r["layout"] == "one" and r["fits"])
    check(sorted(k for k in ran if k.endswith("|one")) == planned_one,
          "dryrun: a cell planned to fit one card did not run")
    for name in DRYRUN_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the dryrun path")
    check(not audit.unchecked(), f"dryrun: launched at shapes never held against the "
          f"plain version: {audit.unchecked()}")

    def gib(b):
        return None if b is None else b / 2**30

    table = {k: {"fits": r["fits"], "planned_gib": gib(r["planned_peak_bytes"]),
                 "dominant": (r["roofline_s"] or {}).get("dominant"),
                 # the peak over what the process held before the cell
                 **({"ms": r["run"]["ms_median"],
                     "measured_gib": gib(r["run"]["peak_allocated_bytes"]
                                         - r["run"]["allocated_before_bytes"])
                     if dev.type == "cuda" else None,
                     "planned_over_measured": r["run"]["planned_over_measured"],
                     "launches": r["run"]["launches"],
                     **{k: r["run"][k] for k in ("beam_trips", "beam_searches")
                        if k in r["run"]}} if "run" in r else {})}
             for k, r in sorted(records.items())}
    return {"cells": len(todo), "plans": len(records), "ran": len(ran),
            "fits_one": len(planned_one),
            "fits_four": sum(1 for r in records.values() if r["layout"] == "four" and r["fits"]),
            "jobs": jobs, "plan_s": plan_s, "run_s": run_s, "table": table,
            "launches": launches, "launches_by_shape": audit.by_shape,
            "max_abs_err_by_shape": audit.max_err,
            "manifest": str(manifest),
            "phase_s": time.perf_counter() - t_phase}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernels,parity,sift1m,maint,durable,tiered,serve,sharded,"
                            "models,gnn,train,dryrun")
    ap.add_argument("--n-base", type=int, default=1_000_000)
    # 2 of the cell's 4 rounds: with the maint phase the full smoke must stay
    # near half its time limit (PERF.md §4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--per-round", type=int, default=2048)
    ap.add_argument("--maint-steps", type=int, default=2)
    ap.add_argument("--maint-queries", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve phase's arrival times and the gnn phase's "
                         "graphs and weights")
    # the durable phase's child process (started by the phase itself)
    ap.add_argument("--durable-child", help=argparse.SUPPRESS)
    ap.add_argument("--child-capacity", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--child-device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.durable_child:
        return durable_child(args.durable_child, args.child_capacity,
                             args.child_device)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.cells import all_cells

    phases = set(args.phases.split(","))
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    kernel_rows = {}
    sift, maint, durable, tiered, serve, sharded, models, gnn, train, dry = (
        {}, {}, {}, {}, {}, {}, {}, {}, {}, {})
    sharded4, pods4 = {}, {}
    try:
        t0 = time.perf_counter()
        kbuild.build_all()
        ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                 for n, log in kbuild.build_log.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})
        if "kernels" in phases:
            kernel_rows = phase_kernels(torch, kops, kref, dev)
            emit({"phase": "kernels", "card": smi, **kernel_rows})
            torch.cuda.empty_cache()
        if "parity" in phases:
            emit({"phase": "parity", **phase_parity()})
        if "sift1m" in phases:
            if args.n_base != 1_000_000 or args.rounds != 4 or args.per_round != 2048:
                emit({"reduced": {"n_base": args.n_base, "rounds": args.rounds,
                                  "per_round": args.per_round,
                                  "of": {"n_base": 1_000_000, "rounds": 4,
                                         "per_round": 2048}}})
            sift = phase_sift1m(torch, args.n_base, args.rounds, args.per_round)
            emit({"phase": "sift1m", "card": smi, **sift})
            torch.cuda.empty_cache()
        if "maint" in phases:
            if (args.n_base != 1_000_000 or args.per_round != 2048
                    or args.maint_steps != 2 or args.maint_queries != 1000):
                emit({"reduced": {"n_base": args.n_base, "per_step": args.per_round,
                                  "maint_steps": args.maint_steps,
                                  "maint_queries": args.maint_queries}})
            maint = phase_maint(torch, args.n_base, args.per_round, args.maint_steps,
                                args.maint_queries)
            emit({"phase": "maint", "card": smi, **maint})
            torch.cuda.empty_cache()
        if phases & {"durable", "tiered"} and (
                args.n_base != 1_000_000 or args.per_round != 2048):
            emit({"reduced": {"durable_tiered": {
                "n_base": args.n_base, "per_round": args.per_round,
                "of": {"n_base": 1_000_000, "per_round": 2048}}}})
        if "durable" in phases:
            durable = phase_durable(torch, args.n_base, args.per_round)
            emit({"phase": "durable", "card": smi, **durable})
            for name in ("gather_scores", "score_matrix", "score_topk"):
                check(durable["launches"][name] > 0,
                      f"kernel {name} was not launched on the durable path")
            torch.cuda.empty_cache()
        if "tiered" in phases:
            tiered = phase_tiered(torch, args.n_base, args.per_round)
            emit({"phase": "tiered", "card": smi, **tiered})
            for name in F32_PATH_KERNELS:
                check(tiered["launches"][name] > 0,
                      f"kernel {name} was not launched on the tiered path")
            torch.cuda.empty_cache()
        if "serve" in phases:
            # --per-round requests per closed and open run, half as many
            # in the overload burst
            n_req = args.per_round
            emit({"reduced": {"serve_cli": {
                "scale": SERVE_CLI_SCALE, "steps": 2,
                "of": {"scale": 1_000_000, "steps": 2}}}})
            if args.n_base != 1_000_000 or n_req != 2048:
                emit({"reduced": {"serve": {"n_base": args.n_base,
                                            "requests": n_req,
                                            "of": {"n_base": 1_000_000,
                                                   "requests": 2048}}}})
            serve = phase_serve(torch, args.n_base, n_req, n_req, n_req // 2,
                                seed=args.seed)
            emit({"phase": "serve", "card": smi, **serve})
            for name in ("gather_scores", "score_topk"):
                check(serve["launches"][name] > 0,
                      f"kernel {name} was not launched on the serve path")
        if "sharded" in phases:
            # 512 inserts and deletes a round at the default --per-round
            shard_round = max(1, args.per_round // 4)
            if args.n_base != 1_000_000 or shard_round != 512:
                emit({"reduced": {"sharded": {"n_base": args.n_base,
                                              "per_round": shard_round,
                                              "of": {"n_base": 1_000_000,
                                                     "per_round": 512}}}})
            torch.cuda.empty_cache()
            sharded = phase_sharded(torch, args.n_base, shard_round)
            emit({"phase": "sharded", "card": smi, **sharded})
            torch.cuda.empty_cache()
        for name, run in (("sharded4", phase_sharded4), ("pods4", phase_pods4)):
            if name not in phases:
                continue
            shard_round = max(1, args.per_round // 4)
            if args.n_base != 1_000_000 or shard_round != 512:
                emit({"reduced": {name: {"n_base": args.n_base,
                                         "per_round": shard_round,
                                         "of": {"n_base": 1_000_000,
                                                "per_round": 512}}}})
            out = run(torch, args.n_base, shard_round)
            emit({"phase": name, "card": smi, "nvidia_smi_all": nvidia_smi_line(all_cards=True),
                  **out})
            if name == "sharded4":
                sharded4 = out
            else:
                pods4 = out
            torch.cuda.empty_cache()
        if "models" in phases:
            emit({"reduced": {"models": {
                arch: {"layers": n or "all", "batch": B, "prompt": S, "decode_steps": n_steps,
                       "of": "prefill_32k B 32 × S 32,768; decode_32k B 128 at S 32,768"
                             + ("" if n is None else "; every layer")}
                for arch, n, B, S, n_steps in LM_CELLS}}})
            models = phase_models(torch, kops, kref, dev)
            emit({"phase": "models", "card": smi, **models})
            torch.cuda.empty_cache()
        if "gnn" in phases:
            emit({"reduced": {"gnn": {"graphsage-products-full": {
                "train_step": "cut: forward only; JAX shards this cell's train step over a "
                              "mesh (src/repro/launch/sharding.py:141-152)"}}}})
            gnn = phase_gnn(torch, kops, args.seed)
            emit({"phase": "gnn", "card": smi, **gnn})
            torch.cuda.empty_cache()
        if "train" in phases:
            emit({"reduced": {"train": {"qwen3-1.7b": {
                "batch": "the largest B that fits one card at S 4,096 (printed in the phase "
                         "line), of train_4k's B 256",
                "steps": TRAIN_WARMUP + TRAIN_STEPS}}}})
            train = phase_train(torch, kops, args.seed)
            emit({"phase": "train", "card": smi, **train})
            torch.cuda.empty_cache()
        if "dryrun" in phases:
            emit({"reduced": {"dryrun": {
                "planned_outside_the_phase": [f"{a}|{s}" for a, s, skip in all_cells()
                                              if not skip and s in DRYRUN_CUT],
                "by": "python -m repro_torch.launch.dryrun --shape prefill_32k"}}})
            dry = phase_dryrun(torch, kops, kref)
            emit({"phase": "dryrun", "card": smi, **dry})
            torch.cuda.empty_cache()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    table = []
    for name, meta in KERNELS.items():
        row = kernel_rows.get(name, {})
        table.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "tpu_source": meta["replaces"],
            "launches": sift.get("launches", {}).get(name, 0),
            "launches_maint": maint.get("launches", {}).get(name, 0),
            "launches_durable": durable.get("launches", {}).get(name, 0),
            "launches_tiered": tiered.get("launches", {}).get(name, 0),
            "launches_serve": serve.get("launches", {}).get(name, 0),
            "launches_sharded": sharded.get("launches", {}).get(name, 0),
            "launches_sharded4": sharded4.get("launches", {}).get(name, 0),
            "launches_pods4": pods4.get("launches", {}).get(name, 0),
            "launches_models": models.get("launches", {}).get(name, 0),
            "launches_gnn": gnn.get("launches", {}).get(name, 0),
            "launches_train": train.get("launches", {}).get(name, 0),
            "launches_dryrun": dry.get("launches", {}).get(name, 0),
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": row.get("library_ms"),
            **({"retrieval_b1": row["retrieval_b1"]} if "retrieval_b1" in row else {}),
        })
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
