"""Two CPU measurements behind the model-zoo cells' checks and findings.

    PYTHONPATH=src python tools/torch_models_cpu_checks.py

Prints one JSON line each:

  ip_build        the DLRM × IPGM flow's index at 1,500 items (the smoke
                  DLRM tower of ``tools/torch_dlrm_retrieval.py``, seed 0,
                  metric ip, capacity 2,048, d_out 12, pool 32): average
                  out-degree and top-10 overlap with brute force of 32 user
                  queries, for the bulk-built graph and for one built by
                  inserting the items;
  decode_vs_prefix  the largest relative L2 error of a bf16 decode step's
                  logits against forward over the same prefix, per step, for
                  a 4-layer qwen3 and gemma2 at d_model 256, with the cache
                  as it is and with its length advanced by one before the
                  fourth step (a cache one position off) — the scale the
                  models phase's bf16 tolerance is set against;
  moe_prefill_bf16_vs_fp32  bf16 forward over a prompt (prefill's path and
                  token count) against fp32 forward, logits at every 8th
                  position, for phi3.5-moe (2 layers) and llama4-scout (4) at
                  d_model 256 with their 16 experts and capacity factor 1.25:
                  the median position's relative L2 error and the last
                  position's, with the reference at the same capacity factor
                  (what the models phase holds its MoE models to) and at
                  capacity N (no token dropped: the error a drop fault makes).

Runs on the CPU only; the numbers are the CPU's arithmetic, not a device
measurement. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dlrm_retrieval as flow  # noqa: E402

from repro_torch.configs import registry as reg  # noqa: E402
from repro_torch.core import IndexParams, IPGMIndex, SearchParams  # noqa: E402
from repro_torch.core.rebuild import bulk_knn_build  # noqa: E402
from repro_torch.models import dlrm as dlrm_mod  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import steps  # noqa: E402

CPU = torch.device("cpu")


def ip_build() -> dict:
    cfg = reg.get_arch("dlrm-rm2").smoke_config()
    model = dlrm_mod.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(0)
    items = flow.tower(model, rng.normal(size=(1500, cfg.n_dense)).astype(np.float32), CPU)
    users = flow.tower(model, rng.normal(size=(32, cfg.n_dense)).astype(np.float32), CPU)
    params = IndexParams(capacity=2048, dim=items.shape[1], d_out=12, metric="ip",
                         search=SearchParams(pool_size=32, max_steps=96, num_starts=2))
    _, bf = dlrm_mod.retrieval_scores(users, items, 10)
    out = {}
    for how in ("bulk", "insert"):
        if how == "bulk":
            state = bulk_knn_build(items, torch.ones(len(items), dtype=torch.bool),
                                   params, device=CPU)
            index = IPGMIndex(params, strategy="global", state=state, device=CPU)
        else:
            index = IPGMIndex(params, strategy="global", device=CPU)
            index.insert(items.numpy())
        ids, _ = index.query(users.numpy(), k=10)
        out[how] = {"avg_out_degree": index.stats()["avg_out_degree"],
                    "overlap_at_10": float(np.mean([len(set(ids[i]) & set(bf[i].tolist())) / 10
                                                    for i in range(len(ids))]))}
    return out


def decode_vs_prefix(arch: str, broken: bool) -> list[float]:
    cfg = dataclasses.replace(
        reg.get_arch(arch).smoke_config(), d_model=256, n_heads=4, n_kv_heads=2,
        d_head=64, d_ff=512, vocab=1024, compute_dtype=torch.bfloat16,
        block_q=32, block_kv=32, n_layers=4)
    model = L.cast_weights_(tfm.init_params(cfg, torch.Generator().manual_seed(0)),
                            torch.bfloat16)
    B, S, n = 2, 64, 8
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    logits, cache = steps.make_lm_prefill_step(cfg, S + n)(model, {"tokens": tokens})
    got, fed = [logits], []
    for i in range(n):
        fed.append(got[-1].argmax(-1, keepdim=True))
        if broken and i == 3:
            cache["len"] = cache["len"] + 1
        logits, cache = steps.make_lm_decode_step(cfg)(model, cache, {"tokens": fed[-1]})
        got.append(logits)
    h, _, _ = tfm.forward(model, torch.cat([tokens, *fed], 1), cfg)
    ref = tfm.logits_from_hidden(model, h[:, S - 1:], cfg)
    got = torch.stack(got, 1)
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).amax(0).tolist()


def moe_prefill_bf16_vs_fp32(arch: str, n_layers: int) -> dict:
    full = reg.get_arch(arch).config_for_shape("prefill_32k")
    m = full.moe
    cfg = dataclasses.replace(
        full, d_model=256, n_heads=4, n_kv_heads=2, d_head=64, d_ff=512, vocab=1024,
        window=64 if full.window else None, compute_dtype=torch.bfloat16,
        block_q=32, block_kv=32, n_layers=n_layers,
        moe=dataclasses.replace(m, d_model=256, d_ff=512))
    model = L.cast_weights_(tfm.init_params(cfg, torch.Generator().manual_seed(0)),
                            torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator().manual_seed(1))
    h, _, _ = tfm.forward(model, tokens, cfg)
    got = tfm.logits_from_hidden(model, h[:, 7::8], cfg).float()
    out = {}
    for name, cf in (("same capacity factor", m.capacity_factor),
                     ("no token dropped", m.n_experts / m.top_k)):
        ref_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                      moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        h, _, _ = tfm.forward(model, tokens, ref_cfg)
        ref = tfm.logits_from_hidden(model, h[:, 7::8], ref_cfg)
        rel = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
        out[name] = {"median": float(rel.median()), "last": float(rel[:, -1].max())}
    return out


def main() -> int:
    torch.manual_seed(0)
    print(json.dumps({"ip_build": ip_build()}), flush=True)
    print(json.dumps({"decode_vs_prefix": {
        f"{arch} {'cache one position off' if broken else 'cache as it is'}":
            decode_vs_prefix(arch, broken)
        for arch in ("qwen3-1.7b", "gemma2-27b") for broken in (False, True)}}), flush=True)
    print(json.dumps({"moe_prefill_bf16_vs_fp32": {
        arch: moe_prefill_bf16_vs_fp32(arch, n)
        for arch, n in (("phi3.5-moe-42b-a6.6b", 2), ("llama4-scout-17b-a16e", 4))}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
