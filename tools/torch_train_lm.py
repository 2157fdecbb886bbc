"""Train a registry LM end to end on the port with checkpoint/restart fault
tolerance: train with a simulated preemption halfway, then resume from the
checkpoint. The counterpart of ``examples/train_lm.py``, through
``repro_torch.launch.train.train_lm``. The smoke config trains in seconds on
the CPU; ``--full`` takes the arch's ``train_4k`` config (a card's worth of
memory at full width).

    PYTHONPATH=src python tools/torch_train_lm.py --device cpu --steps 60

Runs on the card unless ``--device cpu``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import train_lm  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(smoke=not args.full, steps=args.steps, device=args.device)
    with tempfile.TemporaryDirectory() as ckpt:
        print("=== phase 1: train with a simulated preemption ===")
        train_lm(args.arch, ckpt_dir=ckpt, ckpt_every=20, preempt_at=args.steps // 2, **kw)
        print("=== phase 2: resume from the checkpoint ===")
        out = train_lm(args.arch, ckpt_dir=ckpt, resume=True, **kw)
        print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
