"""Online ANN serving on the port: the full GRAPH-MAINTENANCE workload —
batched deletes, inserts and queries streaming against a live index, with
per-phase latency accounting — for the GLOBAL strategy against MASK on the
same stream. The counterpart of ``examples/online_ann_serving.py``, through
``repro_torch.launch.serve.serve_online``.

    PYTHONPATH=src python tools/torch_online_ann_serving.py --device cpu --scale 300 --steps 2

Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve_online  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=1500)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for strategy in ("global", "mask"):
        print(f"\n=== strategy: {strategy} ===")
        serve_online(dataset="sift", strategy=strategy, n_base=args.scale,
                     n_steps=args.steps, batch_size=max(args.scale // 10, 10),
                     n_queries=min(256, args.scale), device=args.device)


if __name__ == "__main__":
    main()
