"""The GNN family of ``repro_torch`` (models, configs, the forward and train
steps) against ``repro``'s, on the CPU.

Every case seeds numpy, feeds the same padded graph to both packages and
carries JAX's parameters across with ``from_jax_params``. Tolerances, as
relative L2 error against JAX unless said otherwise: forwards 1e-5
(GraphSAGE, GAT) and 1e-4 (GatedGCN, DimeNet); every gradient 1e-4; the
loss and ``grad_norm`` 1e-5; parameters after a step within 1e-6
absolute; ``lr`` within 5e-7 relative.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the intra-op thread count)
from repro.configs import registry as jreg
from repro.data import graph_sampler as jsampler
from repro.models.gnn import common as jcommon
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import gat as jgat
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import graphsage as jsage
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.configs.gnn_common import GNN_ARCH, GNN_SIZES
from repro_torch.data import graph_sampler as tsampler
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn import dimenet as tdimenet
from repro_torch.models.gnn import gat as tgat
from repro_torch.models.gnn import gatedgcn as tgatedgcn
from repro_torch.models.gnn import graphsage as tsage
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

ARCHS = ["graphsage-reddit", "gat-cora", "gatedgcn", "dimenet"]
MODULES = {"graphsage": (jsage, tsage), "gat": (jgat, tgat),
           "gatedgcn": (jgatedgcn, tgatedgcn), "dimenet": (jdimenet, tdimenet)}
FWD_TOL = {"graphsage": 1e-5, "gat": 1e-5, "gatedgcn": 1e-4, "dimenet": 1e-4}
GRAD_TOL, LOSS_TOL, PARAM_ATOL = 1e-4, 1e-5, 1e-6
OPT = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
TOPT = topt.AdamWConfig(**dataclasses.asdict(OPT))

N_REAL, N_PAD, E_REAL, E_PAD = 40, 48, 120, 128
ISOLATED = 7            # no edge reaches it
ALL_MASKED = 9          # every edge that reaches it is masked


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def graph_arrays(cfg, seed: int) -> dict:
    """A padded two-graph batch without self-loops: 40 real nodes (8
    padded), 120 real edges (8 padded, 0 → 0 with mask False), node 7
    reached by no edge, node 9 only by masked edges, a partial label mask."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N_REAL, E_REAL)
    receivers = (senders + 1 + rng.integers(0, N_REAL - 1, E_REAL)) % N_REAL
    receivers = np.where(receivers == ISOLATED, (ISOLATED + 2) % N_REAL, receivers)
    edge_mask = np.ones(E_PAD, bool)
    edge_mask[:E_REAL] = receivers != ALL_MASKED
    pad = E_PAD - E_REAL
    return dict(
        x=np.concatenate([rng.normal(size=(N_REAL, cfg.d_in)),
                          np.zeros((N_PAD - N_REAL, cfg.d_in))]).astype(np.float32),
        senders=np.concatenate([senders, np.zeros(pad, np.int64)]).astype(np.int32),
        receivers=np.concatenate([receivers, np.zeros(pad, np.int64)]).astype(np.int32),
        node_mask=np.arange(N_PAD) < N_REAL,
        edge_mask=edge_mask,
        labels=rng.integers(0, getattr(cfg, "n_classes", 2), N_PAD).astype(np.int32),
        label_mask=rng.random(N_PAD) > 0.3,
        positions=np.concatenate([rng.normal(size=(N_REAL, 3)),
                                  np.zeros((N_PAD - N_REAL, 3))]).astype(np.float32),
        edge_attr=rng.normal(size=(E_PAD, 8)).astype(np.float32),
        graph_ids=(np.arange(N_PAD) >= N_REAL // 2).astype(np.int32),
        targets=rng.normal(size=2).astype(np.float32),
    )


def batches(arch: str, cfg, seed: int = 0):
    """The same batch for JAX and for the port."""
    a = graph_arrays(cfg, seed)
    jb = {"graph": jcommon.make_graph(a["x"], a["senders"], a["receivers"], n_graphs=2,
                                      **{k: a[k] for k in a if k not in
                                         ("x", "senders", "receivers")})}
    tb = {"graph": tcommon.make_graph(a["x"], a["senders"], a["receivers"], n_graphs=2,
                                      device="cpu",
                                      **{k: a[k] for k in a if k not in
                                         ("x", "senders", "receivers")})}
    if arch == "dimenet":
        # triplets over the real edges only; padded triplets point at edge 0
        trip = tdimenet.build_triplets(a["senders"][:E_REAL], a["receivers"][:E_REAL],
                                       E_REAL, 512)
        jb["triplets"] = {k: jnp.asarray(v) for k, v in trip.items()}
        tb["triplets"] = trip
    return jb, tb


def models(arch_id: str):
    arch = GNN_ARCH[arch_id]
    jmod, tmod = MODULES[arch]
    jcfg = jreg.get_arch(arch_id).smoke_config()
    tcfg = treg.get_arch(arch_id).smoke_config()
    jparams = jax.jit(jmod.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = tmod.from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jcfg, tcfg, jparams, model


def _assert_params_close(model, jparams):
    jl = jax.tree.leaves(jparams)
    tl = list(model.leaves())
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_matches_jax(arch_id):
    arch, jcfg, tcfg, jparams, model = models(arch_id)
    jb, tb = batches(arch, jcfg)
    want = np.asarray(jax.jit(jsteps.make_gnn_forward(arch, jcfg))(jparams, jb))
    got = tsteps.make_gnn_forward(arch, tcfg, device="cpu")(model, tb)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= FWD_TOL[arch], _rel(got, want)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_steps_match_jax(arch_id):
    """Every gradient at the start, then three AdamW steps: loss,
    grad_norm and lr of each, the parameters after the first and the
    third."""
    arch, jcfg, tcfg, jparams, model = models(arch_id)
    jb, tb = batches(arch, jcfg, seed=1)
    jgrads = jax.jit(jax.grad(lambda p, b: jsteps.gnn_loss(p, b, arch, jcfg)[0]))(jparams, jb)
    tbatch = tsteps.batch_to(tb, torch.device("cpu"))
    loss, _ = tsteps.gnn_loss(model, tbatch, arch, tcfg)
    tgrads = torch.autograd.grad(loss, list(model.leaves()))
    for j, t in zip(jax.tree.leaves(jgrads), tgrads):
        assert bool(torch.isfinite(t).all())
        assert _rel(t, j) <= GRAD_TOL, _rel(t, j)

    jstep = jax.jit(jsteps.make_gnn_train_step(arch, jcfg, OPT))
    tstep = tsteps.make_gnn_train_step(arch, tcfg, TOPT, device="cpu")
    jstate = jopt.adamw_init(jparams)
    tstate = topt.adamw_init(model.leaves())
    for i in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        model, tstate, tm = tstep(model, tstate, tb)
        assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= LOSS_TOL
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]), rtol=5e-7)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        if i in (0, 2):
            _assert_params_close(model, jparams)


def _sampled(seed: int):
    """One sampled block batch of the smoke GraphSAGE, from both samplers."""
    cfg = jreg.get_arch("graphsage-reddit").smoke_config()
    jg = jsampler.random_graph(200, 6, cfg.d_in, cfg.n_classes, seed=seed)
    batch = jsampler.NeighborSampler(jg, cfg.sample_sizes, batch=16, seed=seed).next_batch()
    return batch


def test_forward_sampled_and_its_train_step_match_jax():
    arch, jcfg, tcfg, jparams, model = models("graphsage-reddit")
    b = _sampled(0)
    jb = jax.tree.map(jnp.asarray, b)
    tb = tsteps.batch_to(b, torch.device("cpu"))
    want = jax.jit(jsage.forward_sampled, static_argnums=2)(jparams, jb["blocks"], jcfg)
    got = tsage.forward_sampled(model, tb["blocks"], tcfg)
    assert got.shape == (16, tcfg.n_classes)
    assert _rel(got, want) <= FWD_TOL["graphsage"]
    jstep = jax.jit(jsteps.make_gnn_train_step(arch, jcfg, OPT))
    tstep = tsteps.make_gnn_train_step(arch, tcfg, TOPT, device="cpu")
    jstate, tstate = jopt.adamw_init(jparams), topt.adamw_init(model.leaves())
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        model, tstate, tm = tstep(model, tstate, b)
        assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL
    _assert_params_close(model, jparams)


def test_segment_ops_match_jax_with_padding_and_empty_segments():
    """scatter_sum, segment_mean, segment_softmax ([E] and [E, H] scores)
    and the chunked neighbour_sum on a graph with padded edges, an isolated
    node and an all-masked segment: values and the gradients of a random
    functional equal JAX's, finite, with zeros for the empty segments."""
    a = graph_arrays(treg.get_arch("gatedgcn").smoke_config(), 2)
    rng = np.random.default_rng(3)
    dst, src, mask = a["receivers"], a["senders"], a["edge_mask"]
    msgs = rng.normal(size=(E_PAD, 5)).astype(np.float32)
    scores1 = rng.normal(size=(E_PAD,)).astype(np.float32)
    scores2 = rng.normal(size=(E_PAD, 3)).astype(np.float32)
    w_nodes = rng.normal(size=(N_PAD, 5)).astype(np.float32)
    w1, w2 = rng.normal(size=(E_PAD,)).astype(np.float32), rng.normal(size=(E_PAD, 3)).astype(np.float32)

    def jfun(m, s1, s2):
        mean = jcommon.segment_mean(m, dst, mask, N_PAD)
        tot = jcommon.scatter_sum(m, dst, N_PAD)
        p1 = jcommon.segment_softmax(s1, dst, mask, N_PAD)
        p2 = jcommon.segment_softmax(s2, dst, mask, N_PAD)
        return (jnp.sum(mean * w_nodes) + jnp.sum(tot * w_nodes) + jnp.sum(p1 * w1)
                + jnp.sum(p2 * w2)), (mean, tot, p1, p2)

    (jl, jouts), jgr = jax.jit(jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True))(
        msgs, scores1, scores2)
    tdst, tmask = torch.from_numpy(dst), torch.from_numpy(mask)
    tin = [torch.tensor(v, requires_grad=True) for v in (msgs, scores1, scores2)]
    mean = tcommon.segment_mean(tin[0], tdst, tmask, N_PAD)
    tot = tcommon.scatter_sum(tin[0], tdst, N_PAD)
    p1 = tcommon.segment_softmax(tin[1], tdst, tmask, N_PAD)
    p2 = tcommon.segment_softmax(tin[2], tdst, tmask, N_PAD)
    tl = ((mean * torch.from_numpy(w_nodes)).sum() + (tot * torch.from_numpy(w_nodes)).sum()
          + (p1 * torch.from_numpy(w1)).sum() + (p2 * torch.from_numpy(w2)).sum())
    tgr = torch.autograd.grad(tl, tin)
    for got, want in zip((mean, tot, p1, p2), jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(tgr, jgr):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the empty segments: nothing reaches node 7, only masked edges node 9
    mean, tot, p1 = mean.detach(), tot.detach(), p1.detach()
    for node in (ISOLATED, ALL_MASKED):
        assert float(mean[node].abs().sum()) == 0.0
    assert float(tot[ISOLATED].abs().sum()) == 0.0
    assert float(p1[~tmask].abs().sum()) == 0.0 and float(tgr[1][~tmask].abs().sum()) == 0.0
    # the masked edges of the all-masked segment: an empty max is -inf
    assert float(tcommon.segment_max(torch.where(tmask, tin[1].detach(), float("-inf")),
                                     tdst, N_PAD)[ALL_MASKED]) == float("-inf")
    # neighbour_sum in chunks of 7 edges adds what one index_add_ adds
    h = torch.from_numpy(rng.normal(size=(N_PAD, 5)).astype(np.float32))
    want = tcommon.scatter_sum(torch.where(tmask[:, None], h[torch.from_numpy(src).long()], 0.0),
                               tdst, N_PAD)
    got = tcommon.neighbour_sum(h, torch.from_numpy(src), tdst, tmask, N_PAD,
                                chunk_bytes=7 * 5 * 4)
    assert torch.equal(got, want)
    jwant = jcommon.scatter_sum(jnp.where(mask[:, None], h.numpy()[src], 0.0), dst, N_PAD)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-6, atol=1e-7)


def test_out_of_range_ids_read_and_write_as_in_jax():
    """Ids of -1, n and beyond either end: scatter_sum, segment_mean,
    segment_softmax and degree drop them as JAX's segment ops do; a
    gathered message (and neighbour_sum's) reads a negative id from the end
    and clamps the rest, as JAX's ``x[idx]`` does. Values and the
    gradients of a random functional against JAX's."""
    n, E = 6, 14
    rng = np.random.default_rng(5)
    dst = np.array([-1, 6, 0, 1, 2, 5, -7, 9, 3, 3, 4, -1, 6, 0], np.int32)
    src = np.array([6, -1, 0, 2, -2, 5, 8, -9, 1, 3, 4, 6, -1, 2], np.int32)
    mask = rng.random(E) > 0.2
    msgs = rng.normal(size=(E, 3)).astype(np.float32)
    scores = rng.normal(size=(E, 2)).astype(np.float32)
    h = rng.normal(size=(n, 3)).astype(np.float32)
    w_n, w_e = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(E, 2)).astype(np.float32)
    w_g = rng.normal(size=(E, 3)).astype(np.float32)

    def jfun(m, s, hh):
        outs = (jcommon.scatter_sum(m, dst, n), jcommon.segment_mean(m, dst, mask, n),
                jcommon.segment_softmax(s, dst, mask, n), jcommon.degree(dst, mask, n),
                hh[src], jcommon.scatter_sum(jnp.where(mask[:, None], hh[src], 0.0), dst, n))
        return (jnp.sum(outs[0] * w_n) + jnp.sum(outs[1] * w_n) + jnp.sum(outs[2] * w_e)
                + jnp.sum(outs[4] * w_g) + jnp.sum(outs[5] * w_n)), outs

    (_, jouts), jgr = jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True)(msgs, scores, h)
    tdst, tsrc, tmask = (torch.from_numpy(a) for a in (dst, src, mask))
    tin = [torch.tensor(v, requires_grad=True) for v in (msgs, scores, h)]
    touts = (tcommon.scatter_sum(tin[0], tdst, n), tcommon.segment_mean(tin[0], tdst, tmask, n),
             tcommon.segment_softmax(tin[1], tdst, tmask, n), tcommon.degree(tdst, tmask, n),
             tcommon.gather(tin[2], tsrc),
             tcommon.neighbour_sum(tin[2], tsrc, tdst, tmask, n, chunk_bytes=4 * 3 * 4))
    tl = ((touts[0] * torch.from_numpy(w_n)).sum() + (touts[1] * torch.from_numpy(w_n)).sum()
          + (touts[2] * torch.from_numpy(w_e)).sum() + (touts[4] * torch.from_numpy(w_g)).sum()
          + (touts[5] * torch.from_numpy(w_n)).sum())
    tgr = torch.autograd.grad(tl, tin)
    for got, want in zip(touts, jouts):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(tgr, jgr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # a dropped id really adds nothing: node 0 gets only edges 2 and 13
    keep = (dst >= 0) & (dst < n)
    assert float(touts[3][0]) == float((mask & (dst == 0)).sum()) and int(keep.sum()) < E
    assert float(tcommon.segment_max(tin[1].detach(), tdst, n)[5, 0]) == float(scores[5, 0])


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _spec_leaves(v)
    elif dataclasses.is_dataclass(tree) and not hasattr(tree, "dtype"):
        for f in dataclasses.fields(tree):
            yield from _spec_leaves(getattr(tree, f.name))
    else:
        yield tree


def test_registry_names_every_jax_arch_and_gnn_specs_match():
    dtypes = {np.dtype(jnp.float32): torch.float32, np.dtype(jnp.int32): torch.int32,
              np.dtype(jnp.bool_): torch.bool}
    assert set(treg.all_archs()) == set(jreg.all_archs())
    for arch_id in ARCHS:
        tspec, jspec = treg.get_arch(arch_id), jreg.get_arch(arch_id)
        assert tspec.family == jspec.family == "gnn"
        assert dataclasses.asdict(tspec.smoke_config()) == dataclasses.asdict(jspec.smoke_config())
        assert set(tspec.shapes) == set(jspec.shapes) == set(GNN_SIZES)
        for shape, cell in tspec.shapes.items():
            assert dataclasses.asdict(cell) == dataclasses.asdict(jspec.shapes[shape])
            tcfg, jcfg = tspec.config_for_shape(shape), jspec.config_for_shape(shape)
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            tin, jin = tspec.input_specs(tcfg, shape), jspec.input_specs(jcfg, shape)
            tl, jl = list(_spec_leaves(tin)), jax.tree.leaves(jin)
            assert len(tl) == len(jl) > 0
            for t, j in zip(tl, jl):
                assert (t.shape, t.dtype) == (tuple(j.shape), dtypes[np.dtype(j.dtype)])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get_arch("gat-cora").smoke_config()
    for build in (lambda: tsteps.make_gnn_forward("gat", cfg),
                  lambda: tsteps.make_gnn_train_step("gat", cfg, TOPT),
                  lambda: tgat.init_params(cfg, torch.Generator()),
                  lambda: tcommon.make_graph(np.zeros((2, 3)), np.zeros(1), np.zeros(1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # a model on another device than the step's is refused, not moved
    model = tgat.init_params(cfg, torch.Generator(), "cpu")
    step = tsteps.make_gnn_forward("gat", cfg, device="cpu")
    model = model.to("meta")
    with pytest.raises(ValueError, match="not on cpu"):
        step(model, {})
