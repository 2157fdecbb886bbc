"""One run of one cell: find its files by name, drive it, judge it, print it.

``BENCHMARK.json`` names the cell's configuration and traffic mix and the
metrics it reports. ``configs/<config>.json`` holds the deployment as it
is run, the code that runs it (``"deployment"``: ``deployments/<name>.py``)
and the limits of the numbers that decide ``correct``; ``traffic/<traffic>.json``
holds the mix's parameters; ``metrics/<metric>.py`` reads one metric from
a finished run (``read(ctx)``, None where it finds nothing to read). A new
configuration, mix or metric is a new file: nothing here names one.

A deployment's ``run(cell, seed, seconds, trace, device)`` returns a dict:

  ``setup_s``, ``window_s``, ``attempted``, ``items``;
  ``ranks``: one dict per rank (one on one card), with ``latency_s`` (the
  window's query ops), ``untraced_from`` (the first of them after the
  traced rounds; 0 untraced), ``query_ops``, ``items``, ``by_kind``,
  ``collective_query_s``, ``memory_peak_bytes``, ``dim``, ``modules`` (the
  forbidden modules the rank had loaded once its window closed), and in a
  traced run ``trace`` (a ``TraceView`` of the traced rounds) and
  ``traced`` (the runner's counters over those rounds);
  ``checks``: the numbers compared, by name (``recall_at_10`` among them).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BENCHMARK = REPO / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict


def load_bench(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in the benchmark")
    w = found[0]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, traffic)


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_deployment(name: str):
    """``deployments/<name>.py``, imported as a module of the package so that
    the ranks a deployment spawns can import it too."""
    return importlib.import_module(f"ann_bench.deployments.{name}")


def load_reader(name: str, root: Path = ROOT):
    tag = "ann_bench_metric_" + name.replace(".", "_").replace("-", "_")
    return _load(root / "metrics" / f"{name}.py", tag).read


@dataclasses.dataclass
class Context:
    """What a metric reader sees: the cell and the deployment's outcome."""
    cell: Cell
    run: dict

    @property
    def ranks(self) -> list[dict]:
        return self.run["ranks"]


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def judge_checks(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit (``{"max": x}`` or ``{"min": x}``);
    a number that is missing, not finite, or past its limit fails."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        bad = v is None or not math.isfinite(v)
        if not bad:
            bad = v > lim["max"] if "max" in lim else v < lim["min"]
        ok &= not bad
        out[name] = {"value": v, **lim}
    return ok, out


def run_cell(cell: Cell, bench: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT) -> tuple[dict, list[str], list[str]]:
    """The result line of one run, the stderr lines that close it, and the
    forbidden modules that this process or a rank had loaded."""
    out = load_deployment(cell.config["deployment"]).run(cell, seed, seconds, trace, device)
    ok, checks = judge_checks(out["checks"], cell.config["limits"])
    ctx = Context(cell, out)
    metrics = {}
    for m in metrics_for(bench, cell.name, trace):
        v = load_reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    ranks = out["ranks"]
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": out.get("kind", "cpu"), "count": len(ranks),
           "memory_peak_bytes": max(int(r["memory_peak_bytes"]) for r in ranks)}
    line = {"correct": ok, "attempted": int(out["attempted"]),
            "failed": int(out["checks"].get("bad_answers", 0)
                          + out["checks"].get("lost_writes", 0)),
            "metrics": metrics, "device": dev}
    views = [r["trace"] for r in ranks if r.get("trace") is not None and not r["trace"].empty]
    if trace and views:
        dev["busy_s"] = sum(v.busy_s() for v in views) / len(views)
        dev["window_s"] = sum(v.window_s for v in views) / len(views)
        line["breakdown"] = {"device_ops": views[0].top_ops(),
                             "idle_gaps": views[0].idle_gaps()}
    line["checks"] = checks
    tail = [f"check {n}: {c['value']!r} "
            + (f"<= {c['max']!r}" if "max" in c else f">= {c['min']!r}")
            for n, c in checks.items()]
    loaded = set(forbidden_modules())
    for r in ranks:
        loaded |= set(r.get("modules", ()))
    return line, tail, sorted(loaded)
