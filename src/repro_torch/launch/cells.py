"""Cell builder (``repro.launch.cells``): (arch × shape × mesh) → a step,
its arguments and its sharding.

The single glue point between the registry, the sharding rules and the
step functions. On ``meta`` (the default) every argument is a tensor with
a shape and a dtype and no data, so building a cell allocates nothing; the
planner traces the step over them. On the CPU or the card the arguments
are real: weights drawn from ``seed``, random inputs in range (token and
row ids, graph edges among the real nodes), and for the index a bulk build
of seeded synthetic rows. The step is the port's own (``train/steps.py``,
``distributed/ann.py``), called on the device its arguments are on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import registry as reg
from repro_torch.configs.gnn_common import GNN_ARCH, max_triplets
from repro_torch.configs.lm_common import lm_cache_specs
from repro_torch.configs.registry import TensorSpec
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import ShardMesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.train import steps as steps_mod
from repro_torch.train.optimizer import AdamWConfig, adamw_init

OPT = AdamWConfig()
# steps a run on a device takes (launch/dryrun.py: 1 warm, 3 timed, 1
# counted); a cell whose step consumes its inputs draws this many sets
RUNS = 5


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape: str
    kind: str
    fn: Callable            # the step: fn(*args)
    args: tuple             # tensors (and modules) on the cell's device
    meta: dict              # model_flops etc. for the roofline
    param_specs: object = None  # spec tree of args[0] (IO model)
    arg_specs: tuple = ()       # one spec tree per argument
    arg_names: tuple = ()       # what each argument is
    args_for: Callable | None = None  # run i → its args, where a step consumes its inputs

    def run_args(self, i: int) -> tuple:
        return self.args if self.args_for is None else self.args_for(i)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    # meta tensors draw nothing; a CPU generator stands in
    gen_dev = "cpu" if device.type == "meta" else device
    return torch.Generator(device=gen_dev).manual_seed(seed)


def materialize(tree, device: torch.device, fill=None):
    """The tensors of a :class:`TensorSpec` tree: empty on ``meta``, else
    ``fill(path, spec)``."""
    def go(t, path):
        if isinstance(t, TensorSpec):
            if device.type == "meta":
                return torch.empty(t.shape, dtype=t.dtype, device=device)
            return fill(path, t)
        if isinstance(t, dict):
            return {k: go(v, f"{path}.{k}" if path else k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v, f"{path}.{i}") for i, v in enumerate(t))
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: go(getattr(t, f.name), f"{path}.{f.name}" if path else f.name)
                for f in dataclasses.fields(t)})
        return t
    return go(tree, "")


def _randint(g, hi: int, spec: TensorSpec, device) -> torch.Tensor:
    return torch.randint(0, max(int(hi), 1), spec.shape, generator=g, device=device,
                         dtype=torch.int64).to(spec.dtype)


def _randn(g, spec: TensorSpec, device) -> torch.Tensor:
    return torch.randn(spec.shape, generator=g, device=device).to(spec.dtype)


def _first(n: int, spec: TensorSpec, device) -> torch.Tensor:
    """bool mask: the first ``n`` entries true."""
    return torch.arange(spec.shape[0], device=device) < n


# ---------------------------------------------------------------------------


def _bf16_serving(model) -> None:
    """Serving checkpoints store bf16 weights (§Perf hillclimb B)."""
    L.cast_weights_(model, torch.bfloat16)


def _lm_cell(spec: reg.ArchSpec, shape: str, mesh: ShardMesh, device, seed: int,
             layers: int | None) -> Cell:
    cfg = spec.config_for_shape(shape)
    cell = spec.shapes[shape]
    full = cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    g = _generator(device, seed)
    model = tfm.init_params(cfg, g, device)
    B, S = cell.sizes["batch"], cell.sizes["seq"]

    def tokens(path, t):
        if t.dtype == torch.bool:                        # the loss mask
            return torch.ones(t.shape, dtype=torch.bool, device=device)
        return _randint(g, cfg.vocab, t, device)

    batch_sds = spec.input_specs(cfg, shape)
    batch = materialize(batch_sds, device, tokens)
    b_spec = shr.lm_batch_specs(cell.kind, mesh, batch_sds)

    if cell.kind == "train":
        p_spec = shr.lm_param_specs(model)
        opt = adamw_init(list(model.parameters()))
        fn = steps_mod.make_lm_train_step(cfg, OPT, device=device)
        flops = 6 * full.n_active_params() * B * S
        return Cell(spec.arch_id, shape, cell.kind, fn, (model, opt, batch),
                    {"model_flops": flops, "n_params": full.n_params()}, p_spec,
                    (p_spec, shr.opt_specs(p_spec), b_spec),
                    ("params", "opt_state", "batch"))

    _bf16_serving(model)
    p_spec = shr.lm_param_specs_inference(model)
    csh = shr.lm_cache_specs_sharding(cell, mesh)
    if cell.kind == "prefill":
        fn = steps_mod.make_lm_prefill_step(cfg, pad_to=S)
        flops = 2 * full.n_active_params() * B * S
        return Cell(spec.arch_id, shape, cell.kind, fn, (model, batch),
                    {"model_flops": flops, "n_params": full.n_params()}, p_spec,
                    (p_spec, b_spec),
                    ("params", "batch"))

    # decode: one token per sequence against a cache of S - 1 positions
    def cache_fill(path, t):
        if path == "len":
            return torch.full(t.shape, S - 1, dtype=t.dtype, device=device)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    cache = materialize(lm_cache_specs(cfg, cell), device, cache_fill)
    c_spec = {"kv": [(csh["kv_spec"], csh["kv_spec"]) for _ in range(cfg.n_layers)],
              "len": csh["len_spec"]}
    fn = steps_mod.make_lm_decode_step(cfg)
    # decode flops: one token per sequence + attention against S-cache
    attn_read = full.n_layers * 2 * 2 * B * S * full.n_kv_heads * full.d_head
    flops = 2 * full.n_active_params() * B + attn_read
    return Cell(spec.arch_id, shape, cell.kind, fn, (model, cache, batch),
                {"model_flops": flops, "n_params": full.n_params()}, p_spec,
                (p_spec, c_spec, {"tokens": csh["tok_spec"]}),
                ("params", "cache", "batch"))


# ---------------------------------------------------------------------------


def _gnn_batch(batch_sds, sizes: dict, n_triplets: int, cfg, device, g):
    """Random inputs in range: edges among the real nodes, labels among the
    classes, the first n_nodes / n_edges / ``n_triplets`` valid; molecules
    in graphs of n_nodes / n_graphs nodes."""
    N, E = sizes["n_nodes"], sizes["n_edges"]
    per_graph = max(N // max(sizes.get("n_graphs", 1), 1), 1)
    n_classes = getattr(cfg, "n_classes", 2)

    def fill(path, t):
        name = path.rsplit(".", 1)[-1]
        if name in ("senders", "receivers"):
            return _randint(g, N, t, device)
        if name in ("edge_kj", "edge_ji"):
            return _randint(g, E, t, device)
        if name in ("labels", "block_labels"):
            return _randint(g, n_classes, t, device)
        if name == "graph_ids":
            return (torch.arange(t.shape[0], device=device) // per_graph).to(t.dtype)
        if t.dtype == torch.bool:
            if name in ("node_mask", "label_mask"):
                return _first(N, t, device)
            if name == "edge_mask":
                return _first(E, t, device)
            if path.startswith("triplets"):
                return _first(n_triplets, t, device)
            return torch.ones(t.shape, dtype=torch.bool, device=device)
        return _randn(g, t, device)

    return materialize(batch_sds, device, fill)


def _gnn_cell(spec: reg.ArchSpec, shape: str, mesh: ShardMesh, device, seed: int
              ) -> Cell:
    from repro_torch.models.gnn import dimenet, gat, gatedgcn, graphsage
    cfg = spec.config_for_shape(shape)
    cell = spec.shapes[shape]
    arch = GNN_ARCH[spec.arch_id]
    init = {"graphsage": graphsage.init_params, "gat": gat.init_params,
            "gatedgcn": gatedgcn.init_params, "dimenet": dimenet.init_params}[arch]
    g = _generator(device, seed)
    model = init(cfg, g, device)
    p_spec = shr.gnn_param_specs(model)
    batch_sds = spec.input_specs(cfg, shape)
    n_triplets = max_triplets(shape) if arch == "dimenet" else 0
    batch = _gnn_batch(batch_sds, cell.sizes, n_triplets, cfg, device, g)
    b_spec = shr.gnn_batch_specs(batch_sds, mesh)
    opt = adamw_init(list(model.leaves()))
    # AdamW's moments follow leaves(), JAX's order, not named_parameters()
    o_spec = shr.opt_specs(shr.gnn_param_specs(opt["m"]))
    fn = steps_mod.make_gnn_train_step(arch, cfg, OPT, device=device)
    n_param = sum(math.prod(p.shape) for p in model.leaves())
    flops = gnn_model_flops(arch, cfg, cell.sizes, shape)
    return Cell(spec.arch_id, shape, "train", fn, (model, opt, batch),
                {"model_flops": int(flops), "n_params": int(n_param)}, p_spec,
                (p_spec, o_spec, b_spec),
                ("params", "opt_state", "batch"))


def gnn_model_flops(arch: str, cfg, sizes: dict, shape: str) -> float:
    """Analytic fwd+bwd useful FLOPs per family (3× forward convention)."""
    N, E = sizes["n_nodes"], sizes["n_edges"]
    if arch == "graphsage":
        if shape == "minibatch_lg":
            B, (f1, f2) = sizes["batch_nodes"], sizes["fanout"]
            n1, n2 = B * f1, B * f1 * f2
            fwd = 2 * 2 * (n1 * cfg.d_in * cfg.d_hidden
                           + B * cfg.d_hidden * cfg.n_classes)
            fwd += (n2 * cfg.d_in + n1 * cfg.d_hidden)  # masked-mean adds
            return 3 * fwd
        d = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        fwd = sum(2 * 2 * N * d[i] * d[i + 1] for i in range(cfg.n_layers))
        fwd += cfg.n_layers * E * max(d[:-1])  # segment means
        return 3 * fwd
    if arch == "gat":
        H, dh = cfg.n_heads, cfg.d_hidden
        fwd = 2 * N * cfg.d_in * H * dh + 2 * N * H * dh * cfg.n_classes
        fwd += cfg.n_layers * E * H * (2 * dh + 6)  # scores + softmax + agg
        return 3 * fwd
    if arch == "gatedgcn":
        d = cfg.d_hidden
        per_layer = 2 * (3 * E + 2 * N) * d * d + 8 * E * d
        fwd = (2 * N * cfg.d_in * d + 2 * E * cfg.d_edge_in * d
               + cfg.n_layers * per_layer + 2 * N * d * cfg.n_classes)
        return 3 * fwd
    if arch == "dimenet":
        T = max_triplets(shape)
        d, nb = cfg.d_hidden, cfg.n_bilinear
        per_block = (
            2 * T * nb * d * d          # bilinear contraction (dominant)
            + 2 * T * cfg.n_spherical * cfg.n_radial * nb
            + 3 * 2 * E * d * d         # edge MLPs
        )
        fwd = cfg.n_blocks * per_block + 2 * E * (2 * d + cfg.n_radial) * d
        return 3 * fwd
    raise ValueError(arch)


# ---------------------------------------------------------------------------


def _dlrm_cell(spec: reg.ArchSpec, shape: str, mesh: ShardMesh, device, seed: int
               ) -> Cell:
    from repro_torch.models import dlrm as dlrm_mod
    cfg = spec.config_for_shape(shape)
    cell = spec.shapes[shape]
    g = _generator(device, seed)
    model = dlrm_mod.init_params(cfg, g, device)
    p_spec = shr.dlrm_param_specs(model)

    def fill(path, t):
        if path == "sparse_ids":
            return _randint(g, cfg.n_rows, t, device)
        if path == "labels":
            return _randint(g, 2, t, device)
        if t.dtype == torch.bool:
            return torch.ones(t.shape, dtype=torch.bool, device=device)
        return _randn(g, t, device)

    batch_sds = spec.input_specs(cfg, shape)
    batch = materialize(batch_sds, device, fill)
    b_spec = shr.dlrm_batch_specs(cell.kind, batch_sds, mesh)
    B = cell.sizes["batch"]
    mlp_flops = 2 * B * (
        sum(a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp, cfg.bot_mlp))
        + sum(a * b for a, b in zip(
            (cfg.n_interact + cfg.bot_mlp[-1],) + cfg.top_mlp, cfg.top_mlp))
    )

    if cell.kind == "train":
        opt = adamw_init(list(model.parameters()))
        fn = steps_mod.make_dlrm_train_step(cfg, OPT, device=device)
        return Cell(spec.arch_id, shape, cell.kind, fn, (model, opt, batch),
                    {"model_flops": 3 * mlp_flops}, p_spec,
                    (p_spec, shr.opt_specs(p_spec), b_spec),
                    ("params", "opt_state", "batch"))
    if cell.kind == "serve":
        fn = steps_mod.make_dlrm_serve_step(cfg)
        return Cell(spec.arch_id, shape, cell.kind, fn, (model, batch),
                    {"model_flops": mlp_flops}, p_spec, (p_spec, b_spec),
                    ("params", "batch"))
    # retrieval
    M = cell.sizes["n_candidates"]
    fn = steps_mod.make_dlrm_retrieval_step(cfg)
    flops = 2 * M * cfg.bot_mlp[-1] + mlp_flops
    return Cell(spec.arch_id, shape, cell.kind, fn, (model, batch),
                {"model_flops": flops}, p_spec, (p_spec, b_spec), ("params", "batch"))


# ---------------------------------------------------------------------------


def _ipgm_rows(dim: int, n: int, seed: int) -> np.ndarray:
    from repro_torch.data.synthetic import DATASET_SPECS, make_dataset
    name = next((k for k, (d, _) in DATASET_SPECS.items() if d == dim), "sift")
    return make_dataset(name, n, seed=seed, dim=dim)


def ipgm_state(dp, mesh: ShardMesh, device, seed: int = 0, room: int = 0):
    """The stacked state of the mesh's shards, each a bulk build (exact kNN,
    ``score_topk`` and SELECT-NEIGHBORS) of seeded synthetic rows into all
    of its slots but ``room``, rows kept in ``dp.vec_dtype``; → (state,
    rows per shard)."""
    from repro_torch.core.rebuild import bulk_knn_build
    from repro_torch.distributed import ann
    S, cap = ann.num_shards(dp, mesh), dp.index.capacity
    n = cap - room
    rows = _ipgm_rows(dp.index.dim, S * n, seed)
    valid = np.ones(n, bool)
    state = ann.stack_states([
        bulk_knn_build(rows[s * n:(s + 1) * n], valid, dp.index, device=device)
        for s in range(S)])
    if dp.vec_dtype == "bfloat16":
        state = ann.bf16_rows(state)
    return state, n


def _ipgm_cell(spec: reg.ArchSpec, shape: str, mesh: ShardMesh, device, seed: int
               ) -> Cell:
    from repro_torch.core import prng
    from repro_torch.core.graph import DATA_FIELDS
    from repro_torch.distributed import ann
    cfg = spec.config_for_shape(shape)
    cell = spec.shapes[shape]
    dp = ann.DistParams(
        index=cfg,
        pod_axis="pod" if "pod" in mesh.axis_names else None,
        vec_dtype="bfloat16",  # §Perf C: halves beam-expansion gather bytes
    )
    if device.type == "meta":
        state, n_fill = ann.init_sharded_state(dp, mesh, device=device), 0
    else:
        # every run of an insert cell takes a batch of free slots
        room = RUNS * cell.sizes["batch"] if cell.kind == "ipgm_insert" else 0
        state, n_fill = ipgm_state(dp, mesh, device, seed, room)
    # every field's leading (shard) dim over the shard axes
    state_spec = {f: shr.Spec(dp.axes, *([None] * (getattr(state, f).dim() - 1)))
                  for f in DATA_FIELDS}
    key = prng.prng_key(seed, device=device)
    rng = np.random.default_rng(seed + 1)

    def fill(path, t):
        if path == "route":
            return torch.as_tensor(rng.integers(0, 1 << 30, t.shape), device=device
                                   ).to(t.dtype)
        if path == "gids":           # placeholders: args_for draws alive ids
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        return torch.as_tensor(_ipgm_rows(cfg.dim, t.shape[0], seed + 1), device=device)

    inputs = materialize(spec.input_specs(cfg, shape), device, fill)
    # per-query hop expansion: pool·d_out candidate scorings of dim floats
    sp = cfg.search
    per_q = sp.max_steps * cfg.d_out * cfg.dim * 2
    args_for = None
    if cell.kind == "ipgm_query":
        fn = ann.make_query_step(dp, mesh)
        args, names = (state, inputs["queries"], key), ("state", "queries", "key")
        flops = cell.sizes["q_batch"] * per_q
    elif cell.kind == "ipgm_delete":
        fn = ann.make_delete_step(dp, mesh, "global")
        B = cell.sizes["batch"]
        args, names = (state, inputs["gids"], key), ("state", "gids", "key")
        flops = B * cfg.eff_d_in * per_q
        if device.type != "meta":
            # RUNS batches of distinct alive gids: s·stride + a filled slot
            S, stride = ann.shard_count(state), dp.gid_stride()
            alive = (np.arange(S)[:, None] * stride + np.arange(n_fill)[None]).ravel()
            pool = torch.as_tensor(rng.choice(alive, (RUNS, B), replace=False),
                                   dtype=torch.int32, device=device)
            args = (state, pool[0], key)

            def args_for(i):
                return (state, pool[i % RUNS], key)
    else:
        fn = ann.make_insert_step(dp, mesh)
        args = (state, inputs["vecs"], inputs["route"], key)
        names = ("state", "vecs", "route", "key")
        flops = cell.sizes["batch"] * per_q
    in_specs = {k: shr.replicated(len(v.shape)) for k, v in inputs.items()}
    return Cell(spec.arch_id, shape, cell.kind, fn, args, {"model_flops": int(flops)},
                state_spec, (state_spec, *in_specs.values(), shr.replicated(1)), names,
                args_for)


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape: str, mesh: ShardMesh, device="meta", *,
               seed: int = 0, layers: int | None = None) -> Cell:
    """The cell on ``device`` (``meta``: no data, nothing allocated).
    ``layers`` builds an LM cell with that many layers (the planner traces
    one and two layer periods); ``meta`` keeps the full config's counts."""
    spec = reg.get_arch(arch_id)
    cell = spec.shapes[shape]
    if cell.skip:
        raise ValueError(f"cell ({arch_id}, {shape}) skipped: {cell.skip}")
    device = torch.device(device)
    fam = spec.family
    if fam == "lm":
        return _lm_cell(spec, shape, mesh, device, seed, layers)
    if layers is not None:
        raise ValueError("layers applies to LM cells only")
    if fam == "gnn":
        return _gnn_cell(spec, shape, mesh, device, seed)
    if fam == "recsys":
        return _dlrm_cell(spec, shape, mesh, device, seed)
    if fam == "ipgm":
        return _ipgm_cell(spec, shape, mesh, device, seed)
    raise ValueError(fam)


def all_cells(include_skipped: bool = False) -> list[tuple[str, str, str | None]]:
    """[(arch, shape, skip_reason)] over the full assignment matrix."""
    out = []
    for arch_id, spec in reg.all_archs().items():
        for shape, cell in spec.shapes.items():
            out.append((arch_id, shape, cell.skip))
    return out
