"""Where the time of the port's model-zoo serving cells goes, on one card.

    python3 tools/torch_models_profile.py [--ops serving,gnn,train]

Builds the cells of ``chip_smoke.py``'s models phase that it profiles —
qwen3-1.7b at full depth with bf16 serving weights, and the full DLRM-RM2
(26 tables × 2^20 rows × 64, fp32) — and traces one run of each op with
``torch.profiler``: a prefill of B 4 × S 2,048, one decode step at B 4
against the prefilled cache, the DLRM serve step at B 512 and at 262,144,
and the retrieval step (1 query × 10^6 candidates, k 100). For each op it
prints the wall time of an untraced run (the median of
``launch.analysis.UNTRACED_RUNS``; ``traced`` lives there)
and of the traced one, the device's busy time in the trace and its share
of the untraced wall time (the profiler's own host cost would dilute a
share of the traced time), the kernel launches, and the kernels that take
the most device time; for the decode step also the device time by kind
(matmul, attention over the cache, elementwise and the rest). Last, the
``score_topk`` call of the retrieval step with its row range forced into
other split counts than the planner's (``kops.topk_splits`` replaced for
the sweep), each the median of CUDA-event times.

``--ops gnn`` traces the gnn phase's two large GraphSAGE ops: a train step
of graphsage-reddit-sampled on a batch already on the card, the same step
fed a fresh batch (the sampler's host time and the copy to the card
included), and the graphsage-products-full forward. The sampled ops draw
their batches from a graph of Reddit's 232,965 nodes at degree 32 (a
step's shapes are the batch's, 1,024 targets at fanout 15-10, whatever
the degree), so the profile skips the cell's 40 s CSR build.

``--ops train`` traces the train phase's two full-width steps: a
qwen3-1.7b train step (train_4k's config: bf16 compute, fp32 masters and
AdamW state) at S 4,096 and B ``TRAIN_BATCH`` (2, the largest B the
train phase finds to fit the card) on one repeated TokenStream batch, and a DLRM-RM2 train step at B 65,536 (dense table
gradients), each beside the device time of its AdamW update alone.

The card's name and power limit come first. Needs one CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from repro_torch.configs import dlrm_rm2  # noqa: E402
from repro_torch.configs import registry as reg  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.analysis import traced  # noqa: E402
from repro_torch.models import dlrm as dlrm_mod  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import steps  # noqa: E402

TRAIN_BATCH = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, runs: int = 20) -> float:
    """Median CUDA-event time of ``fn`` (after one warm-up call)."""
    fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def profile_gnn(dev) -> None:
    """The GraphSAGE sampled train step (batch on the card; fresh batch
    from the sampler) and the ogbn-products forward."""
    import chip_smoke
    from repro_torch.configs import graphsage_reddit
    from repro_torch.data.graph_sampler import NeighborSampler, random_graph
    from repro_torch.models.gnn import graphsage
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = graphsage_reddit.config_for_shape("minibatch_lg")
    csr = random_graph(232_965, 32, cfg.d_in, cfg.n_classes, seed=0)
    sampler = NeighborSampler(csr, cfg.sample_sizes, 1024, seed=0)
    model = graphsage.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = steps.make_gnn_train_step("graphsage", cfg, AdamWConfig(**chip_smoke.GNN_OPT), dev)
    state = [adamw_init(model.leaves())]
    batch = steps.batch_to(sampler.next_batch(), dev)

    def train(b):
        _, state[0], m = step(model, state[0], b)
        return m

    emit({"op": "graphsage-reddit-sampled train step, batch on the card",
          **traced(lambda: train(batch))})
    emit({"op": "graphsage-reddit-sampled train step, fresh batch (sampler + copy + step)",
          **traced(lambda: train(sampler.next_batch()))})
    del model, state, batch, csr, sampler
    torch.cuda.empty_cache()
    pcfg = graphsage_reddit.config_for_shape("ogb_products")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = chip_smoke.products_graph(torch, dev, gen, chip_smoke.PRODUCTS, pcfg.d_in)
    pmodel = graphsage.init_params(pcfg, gen, dev)
    fwd = steps.make_gnn_forward("graphsage", pcfg, dev)
    emit({"op": "graphsage-products-full forward, 2,449,029 nodes, 61,859,140 edges",
          **traced(lambda: fwd(pmodel, {"graph": g}))})


def profile_train(dev, batch: int) -> None:
    """One qwen3-1.7b train step at S 4,096 and B ``batch``, and one
    DLRM-RM2 train step at B 65,536, each with its AdamW update alone."""
    import chip_smoke
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

    opt = AdamWConfig(**chip_smoke.TRAIN_OPT)

    def traced_step(name, step, model, b):
        state = [adamw_init(model.parameters())]

        def one():
            _, state[0], m = step(model, state[0], b)
            return m
        emit({"op": name, **traced(one)})
        leaves = list(model.parameters())
        grads = [torch.ones_like(p) for p in leaves]
        emit({"op": f"{name}: its AdamW update alone",
              **traced(lambda: adamw_update(leaves, grads, state[0], opt))})

    cfg = reg.get_arch("qwen3-1.7b").config_for_shape("train_4k")
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    b = steps.batch_to(TokenStream(cfg.vocab, batch, chip_smoke.LM_TRAIN_SEQ).next_batch(), dev)
    traced_step(f"qwen3-1.7b train step B{batch} S{chip_smoke.LM_TRAIN_SEQ}",
                steps.make_lm_train_step(cfg, opt, device=dev), model, b)
    del model, b
    torch.cuda.empty_cache()
    dcfg = dlrm_rm2.config()
    g = torch.Generator(device=dev).manual_seed(0)
    dlrm = dlrm_mod.init_params(dcfg, g, dev)
    B = chip_smoke.DLRM_TRAIN_B
    shape = (B, dcfg.n_sparse, dcfg.nnz)
    db = {"dense": torch.randn((B, dcfg.n_dense), generator=g, device=dev),
          "sparse_ids": torch.randint(0, dcfg.n_rows, shape, generator=g, device=dev),
          "sparse_mask": torch.rand(shape, generator=g, device=dev) > 0.3,
          "labels": (torch.rand((B,), generator=g, device=dev) > 0.5).to(torch.int32)}
    traced_step(f"dlrm train step B{B}", steps.make_dlrm_train_step(dcfg, opt, dev), dlrm, db)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", default="serving,gnn",
                    help="comma-separated: serving (the models phase's ops), gnn, train")
    args = ap.parse_args(argv)
    ops = set(args.ops.split(","))
    if not torch.cuda.is_available():
        print("torch_models_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    if "gnn" in ops:
        profile_gnn(dev)
    if "serving" in ops:
        profile_serving(dev)
    if "train" in ops:
        profile_train(dev, TRAIN_BATCH)
    return 0


def profile_serving(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(0)

    # ---- qwen3-1.7b: prefill B 4 × S 2,048, then decode steps at B 4 ----
    cfg = reg.get_arch("qwen3-1.7b").config_for_shape("prefill_32k")
    model = L.cast_weights_(tfm.init_params(cfg, g, dev), torch.bfloat16)
    B, S = 4, 2048
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    prefill = steps.make_lm_prefill_step(cfg, S + 64)
    decode = steps.make_lm_decode_step(cfg)
    emit({"op": "qwen3-1.7b prefill B4 S2048", **traced(lambda: prefill(model, {"tokens": tokens}))})
    _, cache = prefill(model, {"tokens": tokens})
    nxt = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev)
    base = cache["len"].clone()

    def one_step():
        cache["len"] = base.clone()        # every traced step writes position S
        decode(model, cache, {"tokens": nxt})

    emit({"op": "qwen3-1.7b decode step B4 at 2,048", **traced(one_step)})
    del model, cache
    torch.cuda.empty_cache()

    # ---- DLRM-RM2 ----
    dcfg = dlrm_rm2.config()
    dlrm = dlrm_mod.init_params(dcfg, g, dev)
    serve = steps.make_dlrm_serve_step(dcfg)
    for Bd in (512, 262_144):
        shape = (Bd, dcfg.n_sparse, dcfg.nnz)
        batch = {"dense": torch.randn((Bd, dcfg.n_dense), generator=g, device=dev),
                 "sparse_ids": torch.randint(0, dcfg.n_rows, shape, generator=g, device=dev),
                 "sparse_mask": torch.rand(shape, generator=g, device=dev) > 0.3}
        emit({"op": f"dlrm serve B{Bd}", **traced(lambda: serve(dlrm, batch))})
        del batch
    items = dlrm_mod._mlp(dlrm.bot, torch.randn((1_000_000, dcfg.n_dense), generator=g,
                                                device=dev), final_act=True).contiguous()
    rb = {"dense": torch.randn((1, dcfg.n_dense), generator=g, device=dev), "candidates": items}
    retrieve = steps.make_dlrm_retrieval_step(dcfg)
    emit({"op": "dlrm retrieval 1 × 10^6 k100", **traced(lambda: retrieve(dlrm, rb))})

    # ---- score_topk at the retrieval shape by forced split count ----
    q = dlrm_mod._mlp(dlrm.bot, rb["dense"], final_act=True)
    csq = items.square().sum(1)
    k = 100
    planned = kops.topk_splits(1, items.shape[0], kops.num_sms(dev), k)
    plan, by_splits = kops.topk_splits, {}
    try:
        for n in sorted({1, 8, 32, 132, planned}):
            kops.topk_splits = lambda *a, n=n: n
            by_splits[n] = event_ms(lambda: kops.score_topk(items, csq, q, k, metric="ip"))
    finally:
        kops.topk_splits = plan
    emit({"op": "score_topk B1 M10^6 d64 k100 ip by split count", "planned_splits": planned,
          "ms_by_splits": by_splits})


if __name__ == "__main__":
    sys.exit(main())
