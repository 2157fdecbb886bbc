"""The dry-run and launch tooling of ``repro_torch.launch`` (mesh, sharding,
collectives, analysis, cells, dryrun) against ``repro.launch``'s, on the
CPU.

The specs, byte counts and collective models must equal JAX's on its
production meshes (JAX's functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in carries the 256- and 512-device
shapes); the cost counter must give JAX's numbers on the closed forms of
``tests/test_analysis.py``; every registry cell must carry JAX's kind,
``model_flops`` and ``n_params`` and build on ``meta``; and the planner
must write a whole record for a smoke-size cell of each family.
"""
from __future__ import annotations

import ast
import dataclasses
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the intra-op thread count)
from repro.configs import registry as jreg
from repro.launch import analysis as jan
from repro.launch import cells as jcells
from repro.launch import collectives as jcoll
from repro.launch import sharding as jshr
from repro.models import dlrm as jdlrm
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.configs.lm_common import lm_input_specs
from repro_torch.core import search as tsearch
from repro_torch.kernels import ops as kops
from repro_torch.launch import analysis as tan
from repro_torch.launch import cells as tcells
from repro_torch.launch import collectives as tcoll
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshr
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import transformer as ttfm

LM_ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "qwen3-1.7b",
            "mistral-nemo-12b", "gemma2-27b"]
PROD = {"single": tmesh.make_production_mesh(),
        "multi": tmesh.make_production_mesh(multi_pod=True)}
META = torch.device("meta")


def _jmesh(mesh: tmesh.ShardMesh):
    """What JAX's functions read of a mesh, without its devices."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(mesh.shape))


def _m(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _norm(spec, ndim: int) -> tuple:
    """A JAX ``PartitionSpec`` or a port ``Spec`` padded to ``ndim`` with
    every part a tuple of axis names or None."""
    parts = [p if p is None or isinstance(p, tuple) else (p,) for p in tuple(spec)]
    return tuple(parts + [None] * (ndim - len(parts)))


def _jleaves(tree, specs):
    """{"/"-joined path: (shape, PartitionSpec)} of a JAX tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): (leaf.shape, sp)
            for (path, leaf), sp in zip(flat, leaves, strict=True)}


def _jax_lm(arch: str):
    cfg = jreg.get_arch(arch).config_for_shape("train_4k")
    return cfg, jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0), cfg))


def _port_lm(arch: str):
    cfg = treg.get_arch(arch).config_for_shape("train_4k")
    return cfg, ttfm.init_params(cfg, torch.Generator(), META)


def _lm_jax_path(name: str, period: int) -> str:
    """The port's ``layers.L.wq`` → JAX's ``positions/p{L % period}/wq``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return parts[0]
    return "/".join(["positions", f"p{int(parts[1]) % period}", *parts[2:]])


# ---------------------------------------------------------------------------
# analysis: the cost counter
# ---------------------------------------------------------------------------

def _both_costs(fn_j, fn_t, shapes, dtypes=None):
    dtypes = dtypes or [jnp.float32] * len(shapes)
    tdt = {jnp.float32: torch.float32, jnp.int32: torch.int32}
    jc = jan.cost_of(fn_j, *[jax.ShapeDtypeStruct(s, d) for s, d in zip(shapes, dtypes)],
                     io_bytes=False)
    tc = tan.cost_of(fn_t, *[_m(s, tdt[d]) for s, d in zip(shapes, dtypes)], io_bytes=False)
    return jc, tc


def test_cost_of_matmul_equals_jax():
    jc, tc = _both_costs(lambda a, b: a @ b, lambda a, b: a @ b, [(256, 512), (512, 128)])
    assert tc.flops == jc.flops == 2 * 256 * 512 * 128
    assert tc.hbm_bytes == jc.hbm_bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)
    assert tc.matmul_flops == {"float32": tc.flops}


def test_cost_of_loop_counts_every_trip_as_jax_scans():
    def jf(a):
        return jax.lax.scan(lambda c, _: (c @ a, None), a, None, length=7)[0]

    def tf(a):
        c = a
        for _ in range(7):
            c = c @ a
        return c

    jc, tc = _both_costs(jf, tf, [(128, 128)])
    assert tc.flops == jc.flops == 7 * 2 * 128 ** 3
    assert tc.hbm_bytes == jc.hbm_bytes


def test_cost_of_tanh_matmul_chain_equals_jax():
    jc, tc = _both_costs(lambda a, b: jnp.tanh(a @ b) @ b,
                         lambda a, b: torch.tanh(a @ b) @ b, [(384, 384), (384, 384)])
    assert (tc.flops, tc.hbm_bytes) == (jc.flops, jc.hbm_bytes)


def test_cost_of_gather_counts_bytes_not_flops():
    jc, tc = _both_costs(lambda t, i: t[i], lambda t, i: t[i], [(1000, 64), (32,)],
                         [jnp.float32, jnp.int32])
    assert tc.gather_bytes == jc.gather_bytes == 32 * 64 * 4
    assert tc.hbm_bytes == jc.hbm_bytes
    # JAX's indexing adds its negative-index wrap (64 element-wise FLOPs)
    assert tc.flops < 1e4 and jc.flops < 1e4


def test_cost_of_lm_train_step_close_to_6nd():
    """The smoke qwen3 train step (autograd and AdamW included) within
    0.9–4.0 of 6·N·D, as JAX's."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_lm_train_step
    cfg = treg.get_arch("qwen3-1.7b").smoke_config()
    B, S = 4, 64
    model = ttfm.init_params(cfg, torch.Generator(), META)
    batch = {"tokens": _m((B, S), torch.int32), "labels": _m((B, S), torch.int32),
             "mask": _m((B, S), torch.bool)}
    c = tan.cost_of(make_lm_train_step(cfg, AdamWConfig(), device=META), model,
                    adamw_init(list(model.parameters())), batch)
    assert 0.9 < c.flops / (6 * cfg.n_params() * B * S) < 4.0


@pytest.mark.parametrize("case", ["gather_f32", "gather_bf16", "gather_q8", "topk_l2",
                                  "topk_ip", "matrix", "matrix_self"])
def test_meta_kernel_call_charges_its_bound_work(case):
    """A wrapper on ``meta`` returns its outputs' shapes and dtypes and
    charges the kernel's work as PERF.md §6 reckons the bounds; it launches
    nothing and counts no launch."""
    B, C, N, d, M, k, R, n = 64, 32, 1000, 128, 4096, 10, 16, 24
    kops.reset_launches()
    if case.startswith("gather"):
        dt = {"gather_f32": torch.float32, "gather_bf16": torch.bfloat16,
              "gather_q8": torch.int8}[case]
        fn = kops.gather_scores_q8 if dt == torch.int8 else kops.gather_scores
        args = (_m((N, d), dt), _m((N,)), _m((B, C), torch.int32), _m((B, d)))
        flops = 2.0 * B * C * d
        nbytes = B * C * (d * _m((), dt).element_size() + 12) + B * d * 4
        shapes = [((B, C), torch.float32)]
    elif case.startswith("topk"):
        metric = case[-2:]
        fn = lambda x, xsq, q: kops.score_topk(x, xsq, q, k, metric=metric)  # noqa: E731
        args = (_m((M, d)), _m((M,)), _m((B, d)))
        flops = 2.0 * B * M * d
        nbytes = (M * d + B * d + (M if metric == "l2" else 0)) * 4 + B * k * 8
        shapes = [((B, k), torch.float32), ((B, k), torch.int32)]
    else:
        x = _m((R, n, d))
        args = (x, _m((R, n)), x if case == "matrix_self" else _m((R, B, d)))
        fn = kops.score_matrix
        Bq = n if case == "matrix_self" else B
        flops = 2.0 * R * Bq * n * d
        nbytes = (R * n * d + R * n + R * Bq * n) * 4 + (0 if case == "matrix_self"
                                                          else R * Bq * d * 4)
        shapes = [((R, Bq, n), torch.float32)]
    c = tan.cost_of(fn, *args, io_bytes=False)
    out = fn(*args)
    out = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in out] == shapes
    assert all(o.device.type == "meta" for o in out)
    assert c.flops == flops and c.matmul_flops == {"float32": flops}
    assert c.hbm_bytes == nbytes
    assert sum(c.kernel_calls.values()) == 1
    assert sum(kops.launches.values()) == 0


@pytest.mark.parametrize("arch, shape", [("qwen3-1.7b", "train_4k"),
                                         ("qwen3-1.7b", "prefill_32k"),
                                         ("dlrm-rm2", "serve_p99")])
def test_meta_trace_equals_the_cpu_run(monkeypatch, arch, shape):
    """The counter on ``meta`` (element-wise outputs made by the counter
    itself) gives the FLOPs, bytes and peak live bytes of the same step
    run on the CPU (smoke configs)."""
    if arch == "dlrm-rm2":
        spec = treg.get_arch(arch)
        monkeypatch.setitem(treg._REGISTRY, arch, dataclasses.replace(
            spec, config_for_shape=lambda s: spec.smoke_config()))
    else:
        _smoke_lm(monkeypatch, arch)
    meta = tcells.build_cell(arch, shape, tmesh.one_card())
    cpu = tcells.build_cell(arch, shape, tmesh.one_card(), device="cpu")
    tm, tc = tan.trace(meta.fn, *meta.args), tan.trace(cpu.fn, *cpu.args)
    assert tm.cost.asdict() == tc.cost.asdict()
    assert (tm.peak_bytes, tm.arg_bytes) == (tc.peak_bytes, tc.arg_bytes)


def test_roofline_prices_each_dtype_at_its_peak():
    c = tan.Cost(flops=3e12, hbm_bytes=3.35e12,
                 matmul_flops={"bfloat16": 989.4e12 / 10, "float32": 66.9e12 / 10})
    c.flops = sum(c.matmul_flops.values()) + 66.9e12
    r = tan.roofline(c, 450e9, n_devices=1)
    assert math.isclose(r["compute_s"], 0.1 + 0.1 + 1.0)
    assert math.isclose(r["memory_s"], 1.0) and r["collective_s"] == 0.0  # no link
    assert r["dominant"] == "compute"
    r4 = tan.roofline(c, 450e9, n_devices=4)
    assert math.isclose(r4["memory_s"], 0.25) and math.isclose(r4["collective_s"], 1.0)


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("rules", ["train", "inference"])
def test_lm_param_specs_equal_jax_leaf_for_leaf(arch, rules):
    jcfg, jparams = _jax_lm(arch)
    tcfg, model = _port_lm(arch)
    jrule = jshr.lm_param_specs if rules == "train" else jshr.lm_param_specs_inference
    trule = tshr.lm_param_specs if rules == "train" else tshr.lm_param_specs_inference
    jl = _jleaves(jparams, jrule(jparams))
    tspecs = trule(model)
    assert list(tspecs) == [n for n, _ in model.named_parameters()]
    seen = set()
    for name, p in model.named_parameters():
        path = _lm_jax_path(name, tcfg.period)
        key = next(k for k in (path, path + "/w", path + "/scale") if k in jl)
        shape, jspec = jl[key]
        stacked = key.startswith("positions/")
        want = _norm(jspec, len(shape))[1 if stacked else 0:]
        assert tuple(p.shape) == tuple(shape[1 if stacked else 0:]), name
        assert _norm(tspecs[name], p.dim()) == want, name
        assert len(tspecs[name]) == p.dim(), name
        seen.add(key)
    assert seen == set(jl)


def test_dlrm_and_gnn_param_specs_equal_jax():
    from repro.models.gnn import dimenet as jdim
    from repro.models.gnn import gat as jgat
    from repro.models.gnn import gatedgcn as jggcn
    from repro.models.gnn import graphsage as jsage
    jcfg = jreg.get_arch("dlrm-rm2").config_for_shape("train_batch")
    jparams = jax.eval_shape(lambda: jdlrm.init_params(jax.random.PRNGKey(0), jcfg))
    jl = _jleaves(jparams, jshr.dlrm_param_specs(jparams))
    model = tdlrm.init_params(treg.get_arch("dlrm-rm2").config_for_shape("train_batch"),
                              torch.Generator(), META)
    tspecs = tshr.dlrm_param_specs(model)
    for name, p in model.named_parameters():
        key = name if name == "tables" else name.replace(".", "/") + "/w"
        shape, jspec = jl.pop(key)
        assert tuple(p.shape) == tuple(shape)
        assert _norm(tspecs[name], p.dim()) == _norm(jspec, len(shape)), name
    assert not jl
    jinit = {"graphsage": jsage.init_params, "gat": jgat.init_params,
             "gatedgcn": jggcn.init_params, "dimenet": jdim.init_params}
    for arch_id, arch in {"graphsage-reddit": "graphsage", "gat-cora": "gat",
                          "gatedgcn": "gatedgcn", "dimenet": "dimenet"}.items():
        jc = jreg.get_arch(arch_id).config_for_shape("molecule")
        jp = jax.eval_shape(lambda: jinit[arch](jax.random.PRNGKey(0), jc))  # noqa: B023
        jspecs = jax.tree.leaves(jshr.gnn_param_specs(jp),
                                 is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
        cell = tcells.build_cell(arch_id, "molecule", tmesh.one_card())
        tspecs = tshr.flatten(cell.param_specs)
        assert len(tspecs) == len(jspecs) == len(list(cell.args[0].leaves()))
        assert all(all(x is None for x in s) for s in tspecs)
        assert all(tuple(s) == () for s in jspecs)


def test_opt_specs_shard_moments_as_their_parameter():
    _, model = _port_lm("qwen3-1.7b")
    p_spec = tshr.lm_param_specs(model)
    o = tshr.opt_specs(p_spec)
    jo = jshr.opt_specs("P")
    assert set(o) == set(jo) == {"m", "v", "step"}
    assert o["m"] == o["v"] == list(p_spec.values()) and o["step"] == tshr.Spec()


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_sharded_bytes_per_dev_equals_jax(mesh_kind):
    mesh = PROD[mesh_kind]
    for arch in LM_ARCHS:
        _, jparams = _jax_lm(arch)
        _, model = _port_lm(arch)
        for jrule, trule in ((jshr.lm_param_specs, tshr.lm_param_specs),
                             (jshr.lm_param_specs_inference, tshr.lm_param_specs_inference)):
            want = jshr.sharded_bytes_per_dev(jparams, jrule(jparams), _jmesh(mesh))
            got = tshr.sharded_bytes_per_dev(model, trule(model), mesh)
            assert math.isclose(got, want, rel_tol=1e-12), arch
    jcfg = jreg.get_arch("dlrm-rm2").config_for_shape("train_batch")
    jparams = jax.eval_shape(lambda: jdlrm.init_params(jax.random.PRNGKey(0), jcfg))
    model = tdlrm.init_params(treg.get_arch("dlrm-rm2").config_for_shape("train_batch"),
                              torch.Generator(), META)
    want = jshr.sharded_bytes_per_dev(jparams, jshr.dlrm_param_specs(jparams), _jmesh(mesh))
    got = tshr.sharded_bytes_per_dev(model, tshr.dlrm_param_specs(model), mesh)
    assert math.isclose(got, want, rel_tol=1e-12)


@pytest.mark.parametrize("layout", ["one", "four"])
def test_rules_divide_evenly_on_the_card_layouts(layout):
    """Every argument of every runnable cell divides by the axes its spec
    names on one card and on four."""
    mesh = tmesh.LAYOUTS[layout]()
    axes = mesh.axis_sizes
    for arch, shape, skip in tcells.all_cells():
        if skip:
            continue
        cell = tcells.build_cell(arch, shape, mesh)
        for a, s in zip(cell.args, cell.arg_specs):
            for t, sp in zip(tshr.flatten(a), tshr.flatten(s), strict=True):
                assert len(sp) == t.dim(), (arch, shape)
                for n, part in zip(t.shape, sp):
                    names = () if part is None else (part,) if isinstance(part, str) else part
                    k = math.prod(axes[x] for x in names)
                    assert n % k == 0, (arch, shape, tuple(t.shape), sp)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _jax_params_and_specs(spec, shape):
    """What JAX's roofline passes ``collectives_for``: the cell's params
    tree and its specs (serving cells: bf16 weights, inference rules)."""
    cfg, cell = spec.config_for_shape(shape), spec.shapes[shape]
    if spec.family == "lm":
        params = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0), cfg))
        if cell.kind in ("prefill", "decode"):
            params = jcells._bf16_serving(params)
            return params, jshr.lm_param_specs_inference(params)
        return params, jshr.lm_param_specs(params)
    if spec.family == "gnn":
        from repro.models.gnn import dimenet, gat, gatedgcn, graphsage
        init = {"graphsage-reddit": graphsage, "gat-cora": gat, "gatedgcn": gatedgcn,
                "dimenet": dimenet}[spec.arch_id].init_params
        return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg)), None
    return None, None


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_collectives_for_equals_jax_on_every_cell(mesh_kind):
    mesh = PROD[mesh_kind]
    n = 0
    for arch, shape, skip in tcells.all_cells():
        if skip:
            continue
        jspec, tspec = jreg.get_arch(arch), treg.get_arch(arch)
        jparams, jspecs = _jax_params_and_specs(jspec, shape)
        want = jcoll.collectives_for(jspec.family, jspec.config_for_shape(shape),
                                     jspec.shapes[shape], _jmesh(mesh), jparams, jspecs)
        cell = tcells.build_cell(arch, shape, mesh)
        got = tcoll.collectives_for(tspec.family, tspec.config_for_shape(shape),
                                    tspec.shapes[shape], mesh, cell.args[0], cell.param_specs)
        assert got == want, (arch, shape)
        n += 1
    assert n == 41


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def test_all_cells_equal_jax_with_their_skips():
    got, want = tcells.all_cells(), jcells.all_cells()
    assert sorted(got) == sorted(want)
    assert len(got) == 44 and sum(1 for *_, s in got if s) == 3


def test_every_cell_carries_jax_meta_and_allocates_nothing():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    n = 0
    for arch, shape, skip in tcells.all_cells():
        if skip:
            with pytest.raises(ValueError):
                tcells.build_cell(arch, shape, tmesh.one_card())
            continue
        want = jcells.build_cell(arch, shape, jmesh)
        got = tcells.build_cell(arch, shape, tmesh.one_card())
        assert (got.kind, got.meta) == (want.kind, want.meta), (arch, shape)
        tensors = tshr.flatten(got.args)
        assert tensors and all(t.device.type == "meta" for t in tensors), (arch, shape)
        assert len(got.args) == len(got.arg_specs) == len(got.arg_names)
        n += 1
    assert n == 41


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------

def _smoke_lm(monkeypatch, arch="qwen3-1.7b", B=2, S=32, periods=None):
    """The arch at its smoke config (``periods`` layer periods deep), each
    LM shape at batch ``B`` × ``S``."""
    spec = treg.get_arch(arch)
    shapes = {n: dataclasses.replace(c, sizes={"batch": B if c.sizes["batch"] > 1 else 1,
                                               "seq": S})
              for n, c in spec.shapes.items()}
    smoke = spec.smoke_config()
    if periods is not None:
        smoke = dataclasses.replace(smoke, n_layers=periods * smoke.period)
    monkeypatch.setitem(treg._REGISTRY, arch, dataclasses.replace(
        spec, config_for_shape=lambda shape: smoke, shapes=shapes,
        input_specs=lambda cfg, shape: lm_input_specs(cfg, shapes[shape])))
    return smoke


@pytest.mark.parametrize("arch, shape", [("qwen3-1.7b", "train_4k"),
                                         ("qwen3-1.7b", "prefill_32k"),
                                         ("qwen3-1.7b", "decode_32k"),
                                         ("gemma2-27b", "train_4k"),
                                         ("phi3.5-moe-42b-a6.6b", "prefill_32k")])
def test_layer_period_extrapolation_equals_the_full_trace(monkeypatch, arch, shape):
    """The planner traces two and three layer periods and extrapolates: at
    smoke size, to six periods, it must give the full trace's cost and
    peak live bytes."""
    cfg = _smoke_lm(monkeypatch, arch, periods=6)
    p = cfg.period
    cost, peak, _ = dryrun._lm_trace(arch, shape, tmesh.one_card())
    cell = tcells.build_cell(arch, shape, tmesh.one_card(), layers=6 * p)
    full = tan.trace(cell.fn, *cell.args)
    assert cost.asdict() == full.cost.asdict()
    assert peak == full.peak_bytes


RECORD_KEYS = {"status", "kind", "layout", "mesh", "devices", "meta", "bytes_per_device",
               "arg_bytes_one_card", "trace_peak_bytes", "planned_peak_bytes", "fits",
               "fit_limit_bytes", "traced", "trace_s", "cost", "collectives", "roofline_s"}
RUN_KEYS = {"device", "ms", "ms_median", "peak_allocated_bytes", "allocated_before_bytes",
            "launches", "planned_over_measured"}


def _check_record(rec, *, ipgm=False):
    assert set(rec) == RECORD_KEYS | {"run"}
    assert set(rec["run"]) == RUN_KEYS | ({"counted_s", "beam_trips", "beam_searches",
                                           "while_trip_bound"} if ipgm else set())
    assert rec["fits"] and rec["planned_peak_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["hbm_bytes"] > 0
    assert rec["roofline_s"]["dominant"] in ("compute", "memory", "collective")
    assert len(rec["run"]["ms"]) == dryrun.TIMED_STEPS
    assert all(np.isfinite(rec["run"]["ms"]))


@pytest.mark.parametrize("layout", ["one", "four"])
def test_run_cell_on_cpu_smoke_lm(monkeypatch, layout):
    _smoke_lm(monkeypatch)
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", layout, run=True, device="cpu")
    _check_record(rec)
    assert rec["devices"] == (1 if layout == "one" else 4)
    assert set(rec["bytes_per_device"]) == {"params", "opt_state", "batch"}


def test_run_cell_on_cpu_smoke_gnn_and_dlrm(monkeypatch):
    from repro_torch.configs.gnn_common import graph_specs
    spec = treg.get_arch("gat-cora")
    sizes = dict(n_nodes=300, n_edges=900, d_feat=12, n_classes=3, n_graphs=1)
    smoke = spec.smoke_config()
    monkeypatch.setitem(treg._REGISTRY, "gat-cora", dataclasses.replace(
        spec, config_for_shape=lambda shape: smoke,
        shapes={"full_graph_sm": dataclasses.replace(spec.shapes["full_graph_sm"],
                                                     sizes=sizes)},
        input_specs=lambda cfg, shape: {"graph": graph_specs(sizes)}))
    rec = dryrun.run_cell("gat-cora", "full_graph_sm", "one", run=True, device="cpu")
    _check_record(rec)
    dspec = treg.get_arch("dlrm-rm2")
    monkeypatch.setitem(treg._REGISTRY, "dlrm-rm2", dataclasses.replace(
        dspec, config_for_shape=lambda shape: dspec.smoke_config()))
    rec = dryrun.run_cell("dlrm-rm2", "serve_p99", "one", run=True, device="cpu")
    _check_record(rec)


@pytest.mark.parametrize("shape, layout", [("serve_d128", "one"), ("update_global", "four"),
                                           ("insert_stream", "one")])
def test_run_cell_on_cpu_smoke_ipgm(monkeypatch, shape, layout):
    """The index cells cost from their run: a bulk-built graph walked by
    real queries, inserts and GLOBAL deletes, with the beam loop's trips
    against JAX's max_steps bound. The trips are the loop's own: each
    search merges its seeds into its pools once and each trip its
    candidates once, counted here over the counted run alone."""
    from repro_torch.configs.registry import sds
    spec = treg.get_arch("ipgm-online")
    smoke = spec.smoke_config()
    sizes = {"q_batch": 16, "batch": 8, "cap_local": smoke.capacity, "dim": smoke.dim}
    shapes = {n: dataclasses.replace(c, sizes=sizes) for n, c in spec.shapes.items()}

    def inputs(cfg, s):
        kind = shapes[s].kind
        if kind == "ipgm_query":
            return {"queries": sds((16, cfg.dim), torch.float32)}
        if kind == "ipgm_delete":
            return {"gids": sds((8,), torch.int32)}
        return {"vecs": sds((8, cfg.dim), torch.float32), "route": sds((8,), torch.int32)}

    monkeypatch.setitem(treg._REGISTRY, "ipgm-online", dataclasses.replace(
        spec, config_for_shape=lambda s: smoke, shapes=shapes, input_specs=inputs))
    merges = {"on": False, "n": 0}
    merge, trace = tsearch._merge_pools, tan.trace

    def counted_merge(*a):
        merges["n"] += merges["on"]
        return merge(*a)

    def counted_trace(*a, **kw):
        merges["on"] = True
        try:
            return trace(*a, **kw)
        finally:
            merges["on"] = False

    monkeypatch.setattr(tsearch, "_merge_pools", counted_merge)
    monkeypatch.setattr(tan, "trace", counted_trace)
    rec = dryrun.run_cell("ipgm-online", shape, layout, run=True, device="cpu")
    _check_record(rec, ipgm=True)
    run = rec["run"]
    assert run["while_trip_bound"] == smoke.search.max_steps
    assert 0 < run["beam_trips"] <= run["beam_searches"] * smoke.search.max_steps
    assert run["beam_trips"] == merges["n"] - run["beam_searches"]
    assert rec["traced"] == "the counted run on cpu"
    assert rec["bytes_per_device"]["state"] > 0


def test_dryrun_list_prints_jax_keys_and_skips(capsys, tmp_path):
    assert dryrun.main(["--list", "--out", str(tmp_path / "m.json")]) == 0
    lines = capsys.readouterr().out.splitlines()
    want = {f"{a}|{s}|{m}" for a, s, _ in jcells.all_cells() for m in ("one", "four")}
    listed = {ln.split()[1].rstrip(":") for ln in lines if ln.startswith(("CELL", "SKIP"))}
    assert listed == want
    skips = {ln.split()[1].rstrip(":") for ln in lines if ln.startswith("SKIP")}
    assert skips == {f"{a}|{s}|{m}" for a, s, r in jcells.all_cells() if r
                     for m in ("one", "four")}


def test_launch_modules_import_no_jax():
    root = Path(tmesh.__file__).parent
    for name in ("mesh", "sharding", "collectives", "analysis", "cells", "dryrun"):
        tree = ast.parse((root / f"{name}.py").read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
                       for m in mods), name
