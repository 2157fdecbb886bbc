"""A copy of the benchmark's files at a size the CPU runs in a second.

``make_root(tmp)`` writes ``configs/``, ``traffic/`` and ``metrics/`` under
``tmp``: each cell's configuration and mix as the benchmark has them, with
the sizes cut (rows, widths, lanes) and nothing else changed, and returns
(root, bench) with the cells renamed ``tiny-<cell>``.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from ann_bench.harness import ROOT, load_bench

DATA = {"n_base": 600, "dim": 32, "rank": 8}
INDEX = {"dim": 32, "d_out": 8, "d_in": 16, "pool_size": 16, "max_steps": 24,
         "k_nn": 16, "insert_chunk": 16, "delete_chunk": 16}
CAPACITY = {"session": 1024, "sharded": 128}
LANES = {"query": 32, "insert": 16, "delete": 16}


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["data"].update(DATA)
    cfg["index"].update(INDEX, capacity=CAPACITY[cfg["deployment"]])
    if cfg["deployment"] == "sharded":      # the placement links each shard with 64 neighbours
        cfg["index"]["k_nn"] = 64
    cfg["build_sample"] = 16
    if "placement_capacity" in cfg:
        cfg["placement_capacity"] = 1024
    return cfg


def tiny_traffic(traffic: dict) -> dict:
    traffic = json.loads(json.dumps(traffic))
    traffic["round"] = [dict(e, n=LANES[e["op"]], repeat=min(e.get("repeat", 1), 2))
                        for e in traffic["round"]]
    if "max_rounds" in traffic:
        traffic["max_rounds"] = 20
    return traffic


def make_root(tmp: Path) -> tuple[Path, dict]:
    bench = load_bench()
    root = Path(tmp)
    for sub in ("configs", "traffic"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "metrics", root / "metrics", dirs_exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads(repo_file(c["file"]).read_text())
        (root / "configs" / f"{c['name']}.json").write_text(json.dumps(tiny_config(cfg)))
    for w in bench["workloads"]:
        t = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
        (root / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tiny_traffic(t)))
    renamed = json.loads(json.dumps(bench))
    for w in renamed["workloads"]:
        w["name"] = f"tiny-{w['name']}"
    for m in renamed["end_to_end"] + renamed["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"tiny-{n}" for n in m["workloads"]]
    return root, renamed


def repo_file(rel: str) -> Path:
    return ROOT.parent / rel
