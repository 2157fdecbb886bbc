#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # every phase, at SIFT1M scale
    python3 chip_smoke.py --phases build,kernels,maint
    python3 chip_smoke.py --phases build,kernels,sharded --n-base 100000

Phases, each printing one JSON line:
  device   the card's name and power limit;
  build    nvcc builds every kernel of ``src/repro_torch/kernels/csrc``;
  kernels  each kernel against its plain PyTorch version on the card, at the
           main paths' shapes, edge ids and grown-tier table sizes: exact on
           integer-valued data, within the Pallas tests' tolerances on
           Gaussian data (rtol 1e-4 / atol 1e-3; score_matrix 2e-4 / 2e-4·d
           in fp32, 2e-2 / 2e-2·d in bf16); score_topk at k = 1, 10, 65 and
           128, B no multiple of its query tile, n_valid inside a row tile,
           in its single- and multi-split forms; score_matrix's self path
           (q is x) against its general path and the plain version at
           n = 1..128; the gathers at d = 8, 32, 100, 128, 130 and on
           offset table views, at B 64 and 4,096 × C 32, and one
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
  parity   small sessions (GLOBAL, LOCAL, RWALK, MASK with consolidation
           and a refine pass, an armed session that grows, LOCAL_REFERENCE
           and GLOBAL_REFERENCE), a bulk build, the reference engine (equal
           to the batched engine at W = 1 on each device),
           consolidate_reference, one BatchedServer step and a small
           sharded stream (8 shards of 64 slots, f32 and bf16 rows: routed
           inserts, fan-out queries, GLOBAL, LOCAL and MASK deletes,
           consolidate, grow) run on the card and on the CPU must leave
           byte-equal state and results;
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
           card, rows in bf16 (the sharded config's vec_dtype); 2 rounds of
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
           score_topk over every alive row, peak memory, launches.
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
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 on the CUDA cores
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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


# widths the gathers are held at: fp32 rows take float4 pieces at 8, 32, 100
# and 128 and single floats at 130; codes take 16-byte pieces at 32 and 128
# and single bytes at 8, 100 and 130
GATHER_WIDTHS = (8, 32, 100, 128, 130)
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


def gather_byte_bound_ms(B: int, C: int, d: int, row_bytes: int) -> float:
    """Each row (4d bytes fp32, 2d bf16, d q8), id, norm or scale and score
    once, and q once, over 3.35 TB/s."""
    return (B * C * (row_bytes + 12) + B * d * 4) / PEAK_BYTES_PER_S * 1e3


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
            bound_ms=gather_byte_bound_ms(B, C, d, row_bytes),
            bound_by="bytes",
            max_abs_err=max(errs),
            device_ms=graph_ms_rotating(lambda i: kfn(table, aux, rot[i], q, metric="l2"), n),
            ms_B64=median_ms_rotating(lambda i: kfn(table, aux, rot64[i], q64), n64),
            device_ms_B64=graph_ms_rotating(lambda i: kfn(table, aux, rot64[i], q64), n64),
            plain_ms_B64=median_ms_rotating(lambda i: pfn(table, aux, rot64[i], q64, "l2"), n64),
            library_ms_B64=median_ms_rotating(lambda i: lib(rot64[i], q64), n64),
            bound_ms_B64=gather_byte_bound_ms(64, C, d, row_bytes),
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

    flops = 2.0 * Bq * N * d
    results["score_topk"] = dict(
        ms=median_ms(lambda: kops.score_topk(xg, tsq, qg, k)),
        plain_ms=median_ms(lambda: kref.score_topk(xg, tsq, qg, k, "l2"), runs=20, warmup=1),
        library_ms=median_ms(lib_topk, runs=20, warmup=1),
        bound_ms=max(flops / PEAK_FP32_FLOPS,
                     ((N * d + N + Bq * d) * 4 + Bq * k * 8) / PEAK_BYTES_PER_S) * 1e3,
        bound_by="operations", max_abs_err=err, id_swaps_near_ties=swaps,
        shape=dict(B=Bq, M=N, d=d, k=k))
    # the bulk build's block (no single library call: its [16384, 2^20]
    # score matrix would be 64 GiB)
    Bb, kb = 16384, 65
    qb = torch.randn((Bb, d), generator=g, device=dev)
    results["score_topk"]["ms_build_block"] = median_ms(
        lambda: kops.score_topk(xg, tsq, qb, kb), runs=5, warmup=1)
    results["score_topk"]["bound_ms_build_block"] = max(
        2.0 * Bb * N * d / PEAK_FP32_FLOPS,
        ((N * d + N + Bb * d) * 4 + Bb * kb * 8) / PEAK_BYTES_PER_S) * 1e3
    del qb
    results["score_matrix"] = score_matrix_case(torch, kops, kref, dev, g, xg)
    return results


def score_matrix_case(torch, kops, kref, dev, g, xg) -> dict:
    """score_matrix against its plain version: byte-equal on integer data,
    within the Pallas tolerances on Gaussian fp32 and bf16 data, at the
    select shapes (x and q one tensor, as select calls it), the Pallas test
    shapes and the grown-tier row counts at B = 13."""
    d = 128
    errs = []

    def sq(x):
        return (x.float() * x.float()).sum(-1)

    def tol(dtype, dd):
        t = 2e-2 if dtype == torch.bfloat16 else 2e-4
        return dict(rtol=t, atol=t * dd)

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
                       kref.score_matrix(x, sq(x), x), **tol(dtype, d))
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
                               **tol(torch.float32, d)))
            gen = kops.score_matrix(xg3, sq(xg3), xg3.clone(), metric=metric)
            _close(got, gen, **tol(torch.float32, d))
            self_equals_general &= bool(torch.equal(got, gen))
    for M, B, dd in ((300, 50, 200), (512, 128, 128), (1000, 17, 960),
                     (257, 33, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            for metric in ("l2", "ip"):
                x = torch.randn((M, dd), generator=g, device=dev).to(dtype)
                q = torch.randn((B, dd), generator=g, device=dev).to(dtype)
                e = _close(kops.score_matrix(x, sq(x), q, metric=metric),
                           kref.score_matrix(x, sq(x), q, metric), **tol(dtype, dd))
                if dtype == torch.float32:
                    errs.append(e)
    for M in (1 << 10, (1 << 10) + 1, 3 << 10, 1 << 17, (1 << 17) + 1, 3 << 17):
        x = xg[:M].contiguous()
        q = torch.randn((13, d), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xx, qq = x.to(dtype), q.to(dtype)
            got = kops.score_matrix(xx, sq(xx), qq)
            check(got.shape == (13, M), "score_matrix output not cropped to [B, M]")
            e = _close(got, kref.score_matrix(xx, sq(xx), qq, "l2"), **tol(dtype, d))
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
        bound_ms_by_shape[key] = max(
            2.0 * R * n * n * d / PEAK_FP32_FLOPS,
            (R * n * d + R * n + R * n * n) * 4 / PEAK_BYTES_PER_S) * 1e3
    R, n = 4096, 64                      # the GLOBAL-repair select
    x = torch.randn((R, n, d), generator=g, device=dev)
    xsq = sq(x)
    flops = 2.0 * R * n * n * d
    nbytes = (R * n * d + R * n + R * n * n) * 4      # x read once: q is x
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(
        ms=median_ms(lambda: kops.score_matrix(x, xsq, x)),
        plain_ms=median_ms(lambda: kref.score_matrix(x, xsq, x, "l2")),
        library_ms=median_ms(lambda: torch.baddbmm(
            -xsq[:, None, :], x, x.transpose(1, 2), alpha=2.0)),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
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
    return dict(compared=len(gpu), cuda_s=t1 - t0, cpu_s=t2 - t1)


def gather_shape_split(kops) -> dict:
    """The gathers' launches by (B, C), most launched first."""
    return {name: {f"B{b}xC{c}": n for (b, c), n in sorted(
        by_shape.items(), key=lambda kv: -kv[1])}
        for name, by_shape in kops.launches_by_shape.items()}


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
# the sharded index: 10^6 vectors in 8 shards on one card
# ---------------------------------------------------------------------------

SHARD_MESH = ((4, 2), ("data", "model"))
SHARD_QUERY_OPS, SHARD_QUERY_BATCH = 4, 256


def shard_capacity(n_base: int, per_round: int, n_shards: int) -> int:
    """Slots per shard: the smallest power of two over a shard's share of
    the base plus one round of inserts (2^17 at 10^6 in 8 shards)."""
    return 1 << max(10, (-(-n_base // n_shards) + per_round).bit_length())


def bf16_rows(torch, state):
    """The stacked state with its rows kept in bf16, as the sharded config
    stores them (``DistParams(vec_dtype="bfloat16")``): each present row cast
    to bf16, its sqnorm and int8 codes taken from the cast row — the bytes
    the insert path writes for a bf16 row; the graph is the one bulk-built
    over the f32 rows (``reshard`` builds f32 states, as JAX's does)."""
    from repro_torch.core.distances import sqnorm
    from repro_torch.core.quantize import quantize_rows
    vb = state.vectors.bfloat16()
    p = state.present
    codes, scales = quantize_rows(vb)
    return dataclasses.replace(
        state, vectors=vb, sqnorms=torch.where(p, sqnorm(vb), 0.0),
        codes=torch.where(p[..., None], codes, 0),
        scales=torch.where(p, scales, 0.0))


def phase_sharded(torch, n_base: int, per_round: int, rounds: int = 2,
                  device: str = "cuda") -> dict:
    """Cell sift1m-sharded: the base placed by ``elastic.reshard`` (hash
    routing) into 8 shards of a (4, 2) mesh stacked on one card, rows in
    bf16; ``rounds`` rounds of ``per_round`` routed inserts, 4 fan-out query
    ops of 256, ``per_round`` GLOBAL deletes and a flush; a MASK stretch of
    4·``per_round`` deletes and ``consolidate``; a lockstep grow to twice the
    per-shard capacity and one more insert round; ``reshard`` to 4 shards
    and a query op. Checks acked inserts (unique gid, owner ``route % 8``,
    alive with their row, also through the grow and the reshard remap), no
    answer non-alive, I1–I7 per shard after every round, no tombstone left,
    nothing refused, and the first query op of each round bit-equal between
    the folded fan-out and the per-shard loop plus merge."""
    import numpy as np

    from repro_torch.core import metrics, prng
    from repro_torch.core.graph import NULL
    from repro_torch.core.health import check_health
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.distributed import (DistParams, ShardedSession, ShardMesh,
                                         init_sharded_state, make_query_step,
                                         reshard)
    from repro_torch.distributed.ann import shard_view
    from repro_torch.kernels import ops as kops

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def wait():
        if on_card:
            torch.cuda.synchronize()

    mesh = ShardMesh(*SHARD_MESH)
    S = 8
    n_ins = (rounds + 1) * per_round
    n_mask = 4 * per_round
    data = make_dataset("sift", n_base + n_ins + 1000, seed=0)
    base, fresh, held = data[:n_base], data[n_base:n_base + n_ins], data[n_base + n_ins:]
    stream_q = make_dataset("sift", rounds * SHARD_QUERY_OPS * SHARD_QUERY_BATCH
                            + SHARD_QUERY_BATCH, seed=1)
    cap = shard_capacity(n_base, per_round, S)
    params = sift_params(cap, strategy="global", max_capacity=2 * cap)
    dp = DistParams(index=params, vec_dtype="bfloat16")
    stride = dp.gid_stride()
    rng = np.random.default_rng(0)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"n_base": n_base, "shards": S, "mesh": list(SHARD_MESH[0]),
           "capacity_per_shard": cap, "gid_stride": stride,
           "vec_dtype": dp.vec_dtype}
    excluded = dict.fromkeys(kops.launches, 0)   # launches of the comparisons
    kops.reset_launches()                       # the sharded path starts here

    # ---- placement: the base as one shard, re-sharded by hash to 8 ----
    t0 = time.perf_counter()
    src_params = sift_params(1 << max(10, (n_base - 1).bit_length()))
    src = init_sharded_state(DistParams(index=src_params),
                             ShardMesh((1, 1), ("data", "model")), device=dev)
    src.vectors[0, :n_base] = torch.from_numpy(base).to(dev)
    src.alive[0, :n_base] = True
    placed, remap = reshard(src, src_params, params, S)
    del src
    state = bf16_rows(torch, placed)
    del placed
    wait()
    out["place_s"] = time.perf_counter() - t0
    base_gid = remap[:n_base]
    check(bool((base_gid >= 0).all()), "sharded: a base row was not placed")
    check(bool((base_gid // stride == np.arange(n_base) % S).all()),
          "sharded: a base row was placed off its hash owner")
    sess = ShardedSession(dp, mesh, seed=0, state=state)
    del state
    live = np.zeros(S * stride, bool)           # host book of alive gids
    live[base_gid] = True
    acked = {}                                  # gid → row of ``fresh``

    def verify(tag):
        st = sess.state
        capx = st.vectors.shape[1]
        str_x = sess.dp.gid_stride()
        alive = st.alive.cpu().numpy()
        gl = np.flatnonzero(live)
        check(int(alive.sum()) == gl.size and bool(alive[gl // str_x, gl % str_x].all()),
              f"sharded {tag}: the alive set differs from the host's book")
        keep = np.array(sorted(acked), np.int64)
        sh = torch.as_tensor(keep // str_x, device=dev)
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
        dev_alive = sess.state.alive[torch.as_tensor(g // str_x, device=dev),
                                     torch.as_tensor(g % str_x, device=dev)]
        check(bool(live[g].all()) and bool(dev_alive.all()),
              f"sharded {tag}: an answer holds a deleted or non-alive gid")

    def recall(tag):
        """recall@10 of one fan-out op of the held-out queries against the
        exact top-10 over every alive row (score_topk on the flat table)."""
        st = sess.state
        capx = st.vectors.shape[1]
        str_x = sess.dp.gid_stride()
        idx = torch.nonzero(st.alive.reshape(-1)).flatten()
        x = st.vectors.reshape(-1, st.dim)[idx].float().contiguous()
        xsq = st.sqnorms.reshape(-1)[idx].contiguous()
        qh = torch.from_numpy(held).to(dev)
        _, pos = kops.score_topk(x, xsq, qh, 10, metric=st.metric)
        flat = idx[pos.long()]
        true_gid = torch.div(flat, capx, rounding_mode="floor") * str_x + flat % capx
        del x, xsq
        wait()
        t = time.perf_counter()
        found, _ = sess.query(held)
        wait()
        out[f"held_query_s_{tag}"] = time.perf_counter() - t
        answers_alive(found, f"recall {tag}")
        out[f"recall10_{tag}"] = float(metrics.recall_at_k(
            found[:, :10].long(), true_gid, 10))

    def insert_round(lo, tag, timed_as="insert"):
        rows = fresh[lo:lo + per_round]
        route = n_base + lo + np.arange(per_round)
        wait()
        t = time.perf_counter()
        g = sess.insert(rows, route).cpu().numpy()
        op_s[timed_as] += time.perf_counter() - t
        check(bool((g != NULL).all()), f"sharded {tag}: an insert was refused")
        check(bool((g // sess.dp.gid_stride() == route % S).all()),
              f"sharded {tag}: an insert landed off its owner route % 8")
        check(np.unique(g).size == g.size and not bool(live[g].any()),
              f"sharded {tag}: a gid was handed out twice")
        live[g] = True
        acked.update(zip(g.tolist(), range(lo, lo + per_round)))

    recall("before")
    op_s = {"query": 0.0, "insert": 0.0, "insert_after_grow": 0.0, "delete": 0.0}
    fold_checked = 0
    qi = 0
    for rnd in range(rounds):
        insert_round(rnd * per_round, f"round {rnd}")
        for j in range(SHARD_QUERY_OPS):
            q = stream_q[qi:qi + SHARD_QUERY_BATCH]
            qi += SHARD_QUERY_BATCH
            wait()
            t = time.perf_counter()
            gids, scores = sess.query(q)
            wait()
            op_s["query"] += time.perf_counter() - t
            answers_alive(gids, f"round {rnd}")
            if j == 0:
                # the plain version: one beam_search per shard, then the merge
                before = dict(kops.launches)
                # the session's op key: its seed chain at the op's index
                key = prng.fold_in(prng.prng_key(0, device=device),
                                   sess._op_counter - 1)
                pi, ps = make_query_step(sess.dp, mesh, fold=False)(
                    sess.state, q, key)
                for k in kops.launches:
                    excluded[k] += kops.launches[k] - before[k]
                check(torch.equal(pi, gids) and torch.equal(ps, scores),
                      f"sharded round {rnd}: the folded fan-out differs from "
                      f"the per-shard loop")
                fold_checked += 1
        dels = rng.choice(np.flatnonzero(live), per_round, replace=False).astype(np.int32)
        wait()
        t = time.perf_counter()
        sess.delete(dels)
        sess.flush()
        op_s["delete"] += time.perf_counter() - t
        live[dels] = False
        for g in dels.tolist():
            acked.pop(g, None)
        verify(f"round {rnd}")

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
    check(int(sess.state.masked.sum()) == n_mask, "sharded: MASK left no tombstones")
    t = time.perf_counter()
    n_cons = sess.consolidate()
    sess.flush()
    out["consolidate_s"] = time.perf_counter() - t
    check(n_cons == n_mask and int(sess.state.masked.sum()) == 0,
          "sharded: a tombstone remains after consolidate")
    sess.strategy = "global"
    verify("consolidate")

    # ---- lockstep grow, then one more insert round at the new tier ----
    t = time.perf_counter()
    sess.grow(2 * cap)
    wait()
    out["grow_s"] = time.perf_counter() - t
    check(sess.state.vectors.shape[:2] == (S, 2 * cap), "sharded: grow")
    insert_round(rounds * per_round, "after grow", timed_as="insert_after_grow")
    sess.flush()
    verify("grow")
    check(sess.timers.n_refused == 0, "sharded: inserts were refused")
    timers = sess.timers.to_dict()

    # ---- reshard 8 → 4 shards at 2·cap slots each ----
    new_params = sift_params(2 * cap, strategy="global", max_capacity=2 * cap)
    t = time.perf_counter()
    new_state, remap = reshard(sess.state, sess.dp.index, new_params, 4)
    wait()
    out["reshard_s"] = time.perf_counter() - t
    old_live = np.flatnonzero(live)
    new_gid = remap[old_live]
    check(bool((new_gid >= 0).all()), "sharded: an alive gid has no remap")
    live[:] = False
    live[new_gid] = True
    acked = {int(remap[g]): row for g, row in acked.items()}
    sess = ShardedSession(DistParams(index=new_params), ShardMesh((2, 2), ("data", "model")),
                          seed=1, state=new_state)
    del new_state
    verify("reshard")
    q = stream_q[qi:qi + SHARD_QUERY_BATCH]
    wait()
    t = time.perf_counter()
    gids, _ = sess.query(q)
    wait()
    out["resharded_query_s"] = time.perf_counter() - t
    answers_alive(gids, "after reshard")
    recall("after")
    wait()
    launches = {k: kops.launches[k] - excluded[k] for k in kops.launches}
    out["launches"] = launches                  # the sharded path ends here
    out["launches_excluded_comparisons"] = excluded
    out["gather_launches_by_shape"] = gather_shape_split(kops)
    out["fold_equal_ops"] = fold_checked
    n_q = rounds * SHARD_QUERY_OPS * SHARD_QUERY_BATCH
    out["items_per_s"] = {"query": n_q / op_s["query"],
                          "insert": rounds * per_round / op_s["insert"],
                          "insert_after_grow": per_round / op_s["insert_after_grow"],
                          "delete_global": rounds * per_round / op_s["delete"]}
    out["timers"] = timers
    out["peak_mem_gib"] = peak_gib(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    if on_card:
        for name in ("gather_scores_bf16", "gather_scores", "score_topk", "score_matrix"):
            check(launches[name] > 0, f"kernel {name} was not launched on the sharded path")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernels,parity,sift1m,maint,durable,tiered,serve,sharded")
    ap.add_argument("--n-base", type=int, default=1_000_000)
    # 2 of the cell's 4 rounds: with the maint phase the full smoke must stay
    # near half its time limit (PERF.md §4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--per-round", type=int, default=2048)
    ap.add_argument("--maint-steps", type=int, default=2)
    ap.add_argument("--maint-queries", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve phase's arrival times")
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

    phases = set(args.phases.split(","))
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    kernel_rows = {}
    sift, maint, durable, tiered, serve, sharded = {}, {}, {}, {}, {}, {}
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
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": row.get("library_ms"),
        })
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
