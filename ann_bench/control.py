"""The control of ``correct``: the reference put in the program's place, in
the precision just below the one the configuration states.

    python3 ann_bench/control.py --workload sift1m-search --seeds 1 2 3 --rounds 8

runs a cell's stream (its data, its ops, the same number of rounds as a
window holds) with no index at all: every query lane is answered by the
exact top-k among the rows alive at its time, scored in the configuration's
``control`` precision (``"tf32"`` for a float32 configuration, ``"fp8"``
for bfloat16 rows), and every write is acknowledged with the row's own
number as its id; the bulk build's edges are the sampled rows' nearest
neighbours in that precision. The judge then reads these answers as it
reads the program's, and the numbers must come out past their limits:
the check that ``correct`` can fail. ``--precision tf32`` scores a
bfloat16-row cell with its queries rounded to TF32 too (TF32 holds bf16
rows exactly): the tensor-core step below its float32 products. ``--fault half_rows`` answers in
full precision from half the rows (four of every eight, as a replica
that kept half its shards' lists would): the reading of a fault that
only recall sees. One JSON line per seed. Not run by the benchmark's own
runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ann_bench.data.streams import Plan  # noqa: E402
from ann_bench.data.surrogate import Law  # noqa: E402
from ann_bench.deployments.session import build_sample  # noqa: E402
from ann_bench.harness import judge_checks, load_bench, load_cell  # noqa: E402
from ann_bench.reference import judge  # noqa: E402
from ann_bench.reference.exact import Rows, topk_alive  # noqa: E402


def simulate(cell, seed: int, rounds: int, device, fault: str = "none",
             precision: str | None = None) -> dict:
    """The judge's numbers for the control's answers to ``rounds`` rounds,
    in ``precision`` (by default the configuration's ``control``)."""
    import torch

    cfg = cell.config
    precision = (precision or cfg["control"]) if fault == "none" else "float64"
    dev = torch.device(device)
    n_base = cfg["data"]["n_base"]
    plan = Plan(cell.traffic, Law.from_config(cfg["data"], seed, dev), n_base, seed)
    base = plan.base()
    plan.release_base()
    ops = plan.warmup()
    for _ in range(rounds):
        ops += plan.next_round()
    n_rows = n_base + sum(op.n for op in ops if op.kind == "insert")
    t_in = np.full(n_rows, judge.NEVER, np.int64)
    t_in[:n_base] = -1
    t_out = np.full(n_rows, judge.NEVER, np.int64)
    on_dev, events = [base], []
    for op in ops:
        ev = {"kind": op.kind, "t": op.index, "n": op.n}
        if op.kind == "insert":
            x = plan.insert_rows(op)
            on_dev.append(x)
            t_in[op.rows] = op.index
            ev.update(rows=op.rows, x=x.cpu().numpy(), ids=op.rows)
        elif op.kind == "delete":
            t_out[op.rows] = op.index
            ev.update(rows=op.rows, ids=op.rows)
        else:
            q = plan.queries(op)
            grp = None
            if fault == "half_rows":
                grp = (np.arange(n_rows) % 8 < 4, np.ones(op.n, bool))
            s, r = topk_alive(Rows(on_dev), t_in, t_out, q,
                              np.full(op.n, op.index), plan.k, dev,
                              row_dtype=cfg["rows"], precision=precision, groups=grp)
            s = s.float().cpu().numpy()
            ev.update(ids=r.cpu().numpy(), sample=op.sample,
                      q=q.cpu().numpy()[op.sample], s=s[op.sample])
        events.append(ev)
    rows = judge.rows_of(base.cpu(), events)
    rep = judge.replay(events, np.arange(n_base, dtype=np.int64), n_rows, rows.n, plan.k)
    out = judge.answer_checks(rep, rows, plan.k, dev, row_dtype=cfg["rows"])
    out.update(bad_answers=rep.bad_answers, lost_writes=rep.lost_writes)
    if fault == "none":
        sample = build_sample(seed, n_base, cfg["build_sample"])
        shards = None
        if "mesh" in cfg:
            n_shards = int(np.prod([n for n, a in zip(cfg["mesh"]["shape"], cfg["mesh"]["axes"])
                                    if a != "pod"]))
            shards = np.arange(rows.n) % n_shards
        k_nn = cfg["index"]["k_nn"]
        _, edges = judge.knn_rows(rows, sample, n_base, k_nn, dev, groups=shards,
                                  precision=precision)
        out["build_gap"] = judge.build_gap(sample, edges, rows, n_base, k_nn, dev,
                                           groups=shards)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("none", "half_rows"), default="none")
    ap.add_argument("--precision", choices=("tf32", "fp8"), default=None)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = load_cell(args.workload, bench)
    for seed in args.seeds:
        nums = simulate(cell, seed, args.rounds, args.device, args.fault, args.precision)
        ok, checks = judge_checks(nums, {k: v for k, v in cell.config["limits"].items()
                                         if k in nums})
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "control": args.precision or cell.config["control"],
                          "correct": ok, "numbers": nums, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
