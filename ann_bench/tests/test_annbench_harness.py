"""The harness is driven by its files: a new configuration, traffic mix or
metric is found by name; ``BENCHMARK.json`` keeps to its character rules;
nothing in the benchmark imports JAX or the JAX package."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

from ann_bench import harness
from ann_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    path, bench = tiny.make_root(tmp_path)
    cfg = json.loads((path / "configs" / "sift1m-global.json").read_text())
    cfg["index"]["num_starts"] = 3
    (path / "configs" / "extra-config.json").write_text(json.dumps(cfg))
    mix = json.loads((path / "traffic" / "random-q512-w64.json").read_text())
    mix["round"] = [{"op": "insert", "n": 16}, {"op": "query", "n": 24, "repeat": 2}]
    (path / "traffic" / "extra-mix.json").write_text(json.dumps(mix))
    (path / "metrics" / "extra.queries.py").write_text(
        'def read(ctx):\n    return ctx.ranks[0]["by_kind"]["query"]\n')
    bench["workloads"].append({"name": "extra-cell", "config": "extra-config",
                               "traffic": "extra-mix", "chips": 1, "why": "a new cell"})
    bench["end_to_end"].append({"name": "extra.queries", "unit": "queries",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["extra-cell"]})
    cell = harness.load_cell("extra-cell", bench, path)
    line, tail, _ = harness.run_cell(cell, bench, 5, 0.0, False, device="cpu", root=path)
    assert line["correct"], line["checks"]
    assert line["metrics"]["extra.queries"]["value"] == 48
    assert list(line)[-1] == "checks" and tail


def test_benchmark_json_keeps_its_rules():
    bench = harness.load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (names, cells, [m["name"] for m in metrics]):
        assert len(set(group)) == len(group)
    for n in names + cells + [m["name"] for m in metrics]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (harness.REPO / c["file"]).is_file()
    for w in bench["workloads"]:
        assert w["config"] in names and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        assert (harness.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert LINE.match(m["layer"]) and m["moves"] in [e["name"] for e in bench["end_to_end"]]
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(harness.ROOT.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_tops(f) & set(harness.FORBIDDEN), f
    assert harness.forbidden_modules(["repro_torch.core", "ann_bench", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy"]) == ["jax", "repro"]


def test_a_fresh_process_running_the_benchmark_loads_no_jax():
    """What the benchmark and the program import, in a process of their
    own (the test process itself holds the JAX package's tests)."""
    code = ("import ann_bench.harness as h, ann_bench.control, ann_bench.run, "
            "ann_bench.deployments.session, ann_bench.deployments.sharded, "
            "repro_torch.core, repro_torch.distributed, repro_torch.kernels.ops; "
            "print(h.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.REPO / "src"), str(harness.REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_trace_view_and_marks_lost_by_the_profiler():
    import numpy as np

    from ann_bench.trace import TraceView, place_marks, union_s

    assert union_s(np.array([0, 5, 30]), np.array([10, 20, 40])) == 30e-9
    host = np.array([0, 2_000_000, 9_000_000, 9_900_000, 20_000_000]) + 10**12
    device = host - 10**12 + 5_000_000 + np.array([7_000, 9_000, 8_000, 12_000, 9_000])
    assert np.array_equal(place_marks(device, host), device)
    for lost in ([0], [2, 3], [4], [0, 4]):
        keep = np.setdiff1d(np.arange(5), lost)
        placed = place_marks(device[keep], host)
        assert np.array_equal(placed[keep], device[keep])
        assert np.abs(placed[lost] - device[lost]).max() < 10_000
    v = TraceView(["a", "nccl_x", "gather_rows_kernel<1>", "a", "Memset (Device)"],
                  [0, 5, 10, 30, 41], [8, 20, 25, 40, 42], [1, 1, 1, 1, 0],
                  {"window": ([0], [50]), "op.query": ([0], [26]), "op.delete": ([28], [45]),
                   "op.insert": ([], [])})
    ns = pytest.approx
    assert v.busy_s() == ns(34e-9) and v.window_s == ns(50e-9) and v.kernels_in_window() == 3
    assert v.in_spans_s("op.query") == ns(23e-9) and v.in_spans_s("op.insert") is None
    assert v.in_spans_s("op.query", v.named("gather_rows")) == ns(15e-9)
    assert v.top_ops(1) == [["a", ns(18e-9)]]
    assert dict(v.idle_gaps()) == {"between ops": ns(13e-9), "op.query": ns(2e-9),
                                   "op.delete": ns(1e-9)}
