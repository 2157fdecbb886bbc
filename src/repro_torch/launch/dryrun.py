"""Dry-run planner (``repro.launch.dryrun``): every (architecture × input
shape) cell planned for one H100 and for four, and run on the card where
it fits one.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--layout one|four|both] [--run] [--list] [--out PATH]

JAX compiles each cell on 256 and 512 forced host devices and reads XLA's
memory and cost analyses. The port plans from its own trace instead
(``launch/analysis.py``): each cell's step runs once on ``meta`` tensors
under the counter, which gives its FLOPs and bytes and the high-water mark
of its live tensor bytes. Per layout (``launch/mesh.py``) a record holds:

  bytes_per_device   the arguments (params, optimizer state, batch, cache,
                     index state) at the sharding rules' placement;
  planned_peak_bytes the per-device peak: the arguments' bytes per device
                     plus the trace's transient bytes (peak less arguments)
                     split evenly over the devices;
  cost, roofline_s   the traced cost, the three roofline terms per device
                     at the card's peaks and the dominant one;
  collectives        the analytic per-device bytes (``collectives.py``);
  fits               planned_peak_bytes within 0.9 of the card's 80 GB.

An LM's step loops over its layers, so the trace runs two and three layer
periods and extrapolates linearly to the config's depth (the counterpart
of JAX multiplying a scan body by its trip count; a test holds it equal to
the full trace at smoke size). The index cells walk a real graph: their
beam loop and slot allocation depend on the data and cannot run on
``meta``, so their plan holds the arguments only and ``--run`` costs them
from the counted run on the card, with the beam loop's real trip count
beside JAX's ``max_steps`` bound.

``--run`` builds every cell planned to fit one card on the card (seeded
weights and inputs; the index as one shard, or four stacked as
``ShardedSession`` stacks them for the four-card layout) and times 1 warm
and 3 timed steps, then one counted step: ms, the timed steps' peak
``torch.cuda.max_memory_allocated``, kernel launches, and the planned
peak over the measured one. The four-card layout of the other families is
planned, not run. JAX's manifest also parses the optimized HLO for
collective bytes (``collective_bytes``); one process has no HLO and runs
no collective, so the analytic bytes stand alone.

The manifest (``build/dryrun_manifest.json`` by default) is written after
every cell, atomically.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry as reg
from repro_torch.core import search
from repro_torch.launch import analysis
from repro_torch.launch import sharding as shr
from repro_torch.launch.cells import all_cells, build_cell
from repro_torch.launch.collectives import collectives_for
from repro_torch.launch.mesh import LAYOUTS

MANIFEST = Path(__file__).resolve().parents[3] / "build" / "dryrun_manifest.json"
TIMED_STEPS = 3                 # after 1 warm step; then 1 counted step
FIT_BYTES = analysis.FIT_FRACTION * analysis.CARD_BYTES


def load_manifest(path: Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def save_manifest(m: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(m, indent=1, sort_keys=True))
    tmp.replace(path)


def _lm_trace(arch_id: str, shape: str, mesh) -> tuple[analysis.Cost, int, str]:
    """Two and three layer periods traced, extrapolated linearly to the
    full depth. (From one period the peak is not linear yet: the first
    layer's peak can fall in another phase of the step.)"""
    spec = reg.get_arch(arch_id)
    cfg = spec.config_for_shape(shape)
    p = cfg.period
    groups = cfg.n_layers // p
    if groups * p != cfg.n_layers or groups < 2:
        raise ValueError(f"{arch_id}: {cfg.n_layers} layers are not 2+ periods of {p}")
    t2, t3 = (analysis.trace(c.fn, *c.args) for c in (
        build_cell(arch_id, shape, mesh, layers=n) for n in (2 * p, 3 * p)))
    cost = t2.cost + (t3.cost - t2.cost).scale(groups - 2)
    peak = t2.peak_bytes + (groups - 2) * (t3.peak_bytes - t2.peak_bytes)
    return cost, peak, f"{2 * p} and {3 * p} layers, extrapolated to {cfg.n_layers}"


def plan_cell(arch_id: str, shape: str) -> dict:
    """{layout: record} of one cell at one card and at four; the trace is
    made once for both."""
    spec = reg.get_arch(arch_id)
    cfg, sc = spec.config_for_shape(shape), spec.shapes[shape]
    t0 = time.perf_counter()
    one = LAYOUTS["one"]()
    full = build_cell(arch_id, shape, one)
    arg_bytes = sum(shr.sharded_bytes_per_dev(a, s, one)
                    for a, s in zip(full.args, full.arg_specs))
    if spec.family == "lm":
        cost, peak, traced = _lm_trace(arch_id, shape, one)
    elif spec.family == "ipgm":
        cost, peak, traced = None, arg_bytes, "not on meta (data-dependent loop): --run"
    else:
        t = analysis.trace(full.fn, *full.args)
        cost, peak, traced = t.cost, t.peak_bytes, "full"
    trace_s = time.perf_counter() - t0
    out = {}
    for layout, make_mesh in LAYOUTS.items():
        mesh = make_mesh()
        cell = full if layout == "one" else build_cell(arch_id, shape, mesh)
        n_dev = mesh.n_devices
        by_arg = {n: shr.sharded_bytes_per_dev(a, s, mesh)
                  for n, a, s in zip(cell.arg_names, cell.args, cell.arg_specs)}
        planned = sum(by_arg.values()) + (peak - arg_bytes) / n_dev
        coll = collectives_for(spec.family, cfg, sc, mesh, cell.args[0], cell.param_specs)
        out[layout] = {
            "status": "ok", "kind": cell.kind, "layout": layout,
            "mesh": dict(mesh.axis_sizes), "devices": n_dev, "meta": cell.meta,
            "bytes_per_device": by_arg, "arg_bytes_one_card": arg_bytes,
            "trace_peak_bytes": peak, "planned_peak_bytes": planned,
            "fits": planned <= FIT_BYTES, "fit_limit_bytes": FIT_BYTES,
            "traced": traced, "trace_s": trace_s,
            "cost": None if cost is None else cost.asdict(),
            "collectives": coll,
            "roofline_s": (None if cost is None
                           else analysis.roofline(cost, sum(coll.values()), n_dev)),
        }
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(arch_id: str, shape: str, layout: str, *, run: bool = False,
             device=None, plan: dict | None = None) -> dict:
    """The plan record of one cell at ``layout``; with ``run``, the cell
    also runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``):
    1 warm, ``TIMED_STEPS`` timed and 1 counted step."""
    rec = dict((plan or plan_cell(arch_id, shape))[layout])
    if not run:
        return rec
    spec = reg.get_arch(arch_id)
    dev = resolve_device(device)
    # what this process holds already (library workspaces among it) is
    # not the cell's: the measured peak counts from there
    before = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    cell = build_cell(arch_id, shape, LAYOUTS[layout](), dev)
    cell.fn(*cell.run_args(0))
    _sync(dev)
    # the peak of the timed steps: a step's own, once the warm step has
    # made what a first call makes
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(1, TIMED_STEPS + 1):
        _sync(dev)
        t = time.perf_counter()
        cell.fn(*cell.run_args(i))
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    measured = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    out = {"device": dev.type, "ms": ms, "ms_median": sorted(ms)[len(ms) // 2],
           "peak_allocated_bytes": measured, "allocated_before_bytes": before}
    last = cell.run_args(TIMED_STEPS + 1)
    if spec.family != "ipgm":
        out["launches"] = analysis.count_launches(cell.fn, *last) if dev.type == "cuda" else None
        program_peak = rec["trace_peak_bytes"]        # the meta plan's
    else:
        # the index plans from this counted run: one program of all its
        # shards on this device
        loops = dict(search.loop_counts)
        counted = analysis.trace(cell.fn, *last)
        out.update(
            launches=counted.cost.launches, counted_s=counted.seconds,
            beam_trips=search.loop_counts["trips"] - loops["trips"],
            beam_searches=search.loop_counts["searches"] - loops["searches"],
            while_trip_bound=spec.config_for_shape(shape).search.max_steps)
        n_dev = rec["devices"]
        program_peak = rec["trace_peak_bytes"] = counted.peak_bytes
        rec["planned_peak_bytes"] = (sum(rec["bytes_per_device"].values())
                                     + (counted.peak_bytes - counted.arg_bytes) / n_dev)
        rec["fits"] = rec["planned_peak_bytes"] <= FIT_BYTES
        rec["cost"] = counted.cost.asdict()
        rec["roofline_s"] = analysis.roofline(counted.cost, sum(rec["collectives"].values()),
                                              n_dev)
        rec["traced"] = f"the counted run on {dev.type}"
    out["planned_over_measured"] = program_peak / (measured - before) if measured else None
    rec["run"] = out
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--layout", default="both", choices=["one", "four", "both"])
    ap.add_argument("--run", action="store_true",
                    help="run on the card every cell planned to fit one card")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", type=Path, default=MANIFEST)
    args = ap.parse_args(argv)

    layouts = ("one", "four") if args.layout == "both" else (args.layout,)
    manifest = load_manifest(args.out)
    n_ok = n_skip = n_fail = 0
    for arch_id, shape, skip in all_cells():
        if args.arch and arch_id != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        if skip:
            for layout in layouts:
                manifest[f"{arch_id}|{shape}|{layout}"] = {"status": "skipped",
                                                           "reason": skip}
                print(f"SKIP {arch_id}|{shape}|{layout}: {skip}")
            n_skip += 1
            continue
        if args.list:
            for layout in layouts:
                print(f"CELL {arch_id}|{shape}|{layout}")
            continue
        print(f"PLAN {arch_id}|{shape} ...", flush=True)
        try:
            plan = plan_cell(arch_id, shape)
            for layout in layouts:
                # the index runs at both layouts (its shards stack on the
                # card); the other families' four-card program is planned
                do_run = args.run and plan["one"]["fits"] and (
                    layout == "one" or reg.get_arch(arch_id).family == "ipgm")
                rec = run_cell(arch_id, shape, layout, run=do_run, plan=plan)
                manifest[f"{arch_id}|{shape}|{layout}"] = rec
                r = rec.get("run")
                print(f"  {layout}: fits {rec['fits']} planned "
                      f"{rec['planned_peak_bytes'] / 2**30:.2f} GiB"
                      + (f" dominant {rec['roofline_s']['dominant']}"
                         if rec["roofline_s"] else "")
                      + (f" ran {r['ms_median']:.3f} ms" if r else ""), flush=True)
            n_ok += 1
        except Exception as e:
            for layout in layouts:
                manifest[f"{arch_id}|{shape}|{layout}"] = {
                    "status": "fail", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]}
            n_fail += 1
            print(f"  FAIL: {type(e).__name__}: {e}", flush=True)
        save_manifest(manifest, args.out)
    if not args.list:
        save_manifest(manifest, args.out)
    print(f"\ndone: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
