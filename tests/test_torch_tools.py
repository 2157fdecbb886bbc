"""Subprocess smoke over the port's counterparts of ``examples/``: each
``tools/torch_*.py`` driver runs as a user runs it, a fresh interpreter on
the CPU (``--device cpu``) at a small size, as ``tests/test_examples.py``
runs the JAX examples. They start together and are read one test each;
the sharded index runs twice, stacked in one process and on two gloo
ranks."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOLS = {
    "torch_quickstart": [],
    "torch_online_ann_serving": ["--scale", "300", "--steps", "2"],
    "torch_distributed_index": [],
    "torch_train_lm": ["--steps", "40"],
}
# run name → (tool, arguments beyond --device cpu)
RUNS = {**{name: (name, args) for name, args in TOOLS.items()},
        "torch_distributed_index_ranks2": ("torch_distributed_index",
                                           ["--ranks", "2"])}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / f"{tool}.py"), "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for name, (tool, args) in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            text, _ = proc.communicate(timeout=600)
            out[name] = (proc.returncode, text)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _ok(runs, name) -> str:
    rc, text = runs[name]
    assert rc == 0, text
    assert "jax" not in text.lower(), text
    return text


def test_quickstart_runs(runs):
    out = _ok(runs, "torch_quickstart")
    # the two-tier quickstart must show recall, merges, growth and no refusal
    assert "recall@10 before churn" in out and "n_refused=0" in out
    assert "main_capacity=4096" in out


def test_online_ann_serving_runs(runs):
    out = _ok(runs, "torch_online_ann_serving")
    assert "strategy: global" in out and "strategy: mask" in out
    assert out.count("step 1: recall@10=") == 2


def test_distributed_index_runs(runs):
    out = _ok(runs, "torch_distributed_index")
    assert "inserted: 400 across 8 shards" in out
    assert "alive after GLOBAL delete of 100: 300" in out


def test_distributed_index_on_two_ranks_prints_what_one_process_does(runs):
    """``--ranks 2`` (two gloo processes, four shards each) prints the same
    inserted count, query ids and alive count as the stacked run."""
    one = _ok(runs, "torch_distributed_index").splitlines()
    two = _ok(runs, "torch_distributed_index_ranks2").splitlines()
    for head in ("inserted:", "query results (global ids):",
                 "alive after GLOBAL delete of 100:"):
        line = [ln for ln in one if ln.startswith(head)]
        assert len(line) == 1 and line == [ln for ln in two if ln.startswith(head)], head
    assert "(rank 0 of 2)" in "\n".join(two)


def test_train_lm_preempts_and_resumes(runs):
    out = _ok(runs, "torch_train_lm")
    assert "simulated preemption at step 20" in out and "resumed from step 20" in out
    assert "final loss:" in out


def test_tools_import_nothing_of_jax():
    for name in TOOLS:
        src = (ROOT / "tools" / f"{name}.py").read_text()
        assert "import jax" not in src and "from repro." not in src and "import repro\n" not in src
