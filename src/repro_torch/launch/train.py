"""End-to-end LM training driver (``repro.launch.train``): data → step →
checkpoint → restart.

Runs any registry LM arch (smoke or ``train_4k`` config) with AdamW,
periodic atomic checkpoints, a simulated preemption (``--preempt-at``) and
exact resume, on ``cuda`` unless the caller passes ``device="cpu"``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 50 --ckpt-dir /tmp/ckpt [--resume] [--device cpu]

A checkpoint holds ``{"params": {name: tensor}, "opt": {"m": {name: ...},
"v": {name: ...}, "step": int32}}``, the names those of the model's
``named_parameters()`` (the manager writes dict keys in sorted order), and
``extra={"stream": TokenStream.state_dict(), "host_step": N}``. Its layout
is the port's own: JAX's tree stacks the layers per pattern position.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry as reg
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_lm_train_step


def _train_tree(model, opt_state) -> dict:
    """The checkpointed tree: parameters and AdamW state by parameter
    name."""
    names = [n for n, _ in model.named_parameters()]
    return {"params": dict(model.named_parameters()),
            "opt": {"m": dict(zip(names, opt_state["m"])),
                    "v": dict(zip(names, opt_state["v"])),
                    "step": opt_state["step"]}}


@torch.no_grad()
def _load_train_tree(model, opt_state, tree: dict) -> None:
    """Copy a restored tree (numpy leaves) into the model's parameters and
    ``opt_state`` in place."""
    like = _train_tree(model, opt_state)
    for part, key in (("params", None), ("opt", "m"), ("opt", "v")):
        dst = like[part] if key is None else like[part][key]
        src = tree[part] if key is None else tree[part][key]
        for name, t in dst.items():
            t.copy_(torch.from_numpy(src[name]))
    opt_state["step"].fill_(int(tree["opt"]["step"]))


def train_lm(
    arch: str = "qwen3-1.7b",
    *,
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    resume: bool = False,
    preempt_at: int | None = None,
    seed: int = 0,
    log_every: int = 10,
    device=None,
) -> dict:
    """Train ``steps`` steps (from the last checkpoint with ``resume``) →
    ``{"losses", "params", "seconds", "final_loss"}``, or ``{"losses",
    "preempted_at", "params"}`` when ``preempt_at`` stops it first."""
    dev = resolve_device(device)
    spec = reg.get_arch(arch)
    cfg = spec.smoke_config() if smoke else spec.config_for_shape("train_4k")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)

    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt_state = adamw_init(model.parameters())
    stream = TokenStream(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)
    start = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume and mgr and mgr.latest_step() is not None:
        tree, extra = mgr.restore(None, _train_tree(model, opt_state))
        _load_train_tree(model, opt_state, tree)
        stream.load_state_dict(extra["stream"])
        start = int(extra["host_step"])
        print(f"resumed from step {start}")

    step_fn = make_lm_train_step(cfg, opt_cfg, device=dev)

    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        model, opt_state, metrics = step_fn(model, opt_state, stream.next_batch())
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, _train_tree(model, opt_state),
                     extra={"stream": stream.state_dict(), "host_step": step + 1})
        if preempt_at is not None and step + 1 >= preempt_at:
            print(f"simulated preemption at step {step + 1}")
            return {"losses": losses, "preempted_at": step + 1, "params": model}
    dt = time.perf_counter() - t0
    return {"losses": losses, "seconds": dt, "params": model,
            "final_loss": losses[-1] if losses else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = train_lm(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, preempt_at=args.preempt_at, device=args.device,
    )
    if out.get("final_loss") is not None:
        print(f"final loss {out['final_loss']:.4f} in {out['seconds']:.1f}s")


if __name__ == "__main__":
    main()
