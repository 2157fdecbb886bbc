"""Run one cell of the benchmark once and print its result line.

    python3 ann_bench/run.py --workload sift1m-search --seed 7 --seconds 45 --trace 0

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number that
decides ``correct`` beside its limit); the last lines of standard error
repeat the checks. A run exits non-zero and prints no result when CUDA is
not available or has fewer cards than the cell asks for, when the run
fails, or when JAX or the JAX package was loaded.

The program builds its kernels under ``build/kernels`` in the checkout, at
a fixed path, so only a checkout's first run builds them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    for p in (REPO / "src", REPO):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    from ann_bench import harness

    bench = harness.load_bench()
    cell = harness.load_cell(args.workload, bench)
    if not torch.cuda.is_available():
        print("ann_bench: no CUDA device; the benchmark runs on cards only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"ann_bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line, tail, bad = harness.run_cell(cell, bench, args.seed, args.seconds,
                                       bool(args.trace))
    if bad:
        print(f"ann_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for text in tail:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
