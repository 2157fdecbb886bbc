"""DLRM-RM2 of ``repro_torch`` (model, configs, serving and retrieval steps,
the DLRM × IPGM tool) against ``repro``'s, on the CPU.

Every case seeds numpy, feeds the same inputs to both packages and carries
JAX's parameters across with ``from_jax_params``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the intra-op thread count)
from repro.configs import registry as jreg
from repro.models import dlrm as jdlrm
from repro.train import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.models import dlrm as tdlrm
from repro_torch.train import steps as tsteps

ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def dlrm():
    jcfg = jreg.get_arch("dlrm-rm2").smoke_config()
    tcfg = treg.get_arch("dlrm-rm2").smoke_config()
    jparams = jax.jit(jdlrm.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = tdlrm.from_jax_params(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, model


def _batch(cfg, B, rng, *, out_of_range=False):
    ids = rng.integers(0, cfg.n_rows, (B, cfg.n_sparse, cfg.nnz))
    mask = rng.random((B, cfg.n_sparse, cfg.nnz)) > 0.3
    if out_of_range:
        # padded ids under a false mask: past the end, negative, far negative
        pads = np.array([cfg.n_rows, cfg.n_rows + 7, -1, -3, -cfg.n_rows - 5])
        ids = np.where(mask, ids, rng.choice(pads, ids.shape))
    return {"dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
            "sparse_ids": ids.astype(np.int32), "sparse_mask": mask}


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


def test_embedding_bag_reads_jax_rows_for_padded_ids(dlrm):
    """Ids at or past ``n_rows`` and below zero, under a false mask and
    under a true one: JAX's gather clamps (and counts negatives from the
    end), so the port must read the same rows."""
    jcfg, tcfg, jparams, model = dlrm
    rng = np.random.default_rng(0)
    b = _batch(jcfg, 16, rng, out_of_range=True)
    want = jdlrm.embedding_bag(jparams["tables"], b["sparse_ids"], b["sparse_mask"])
    got = tdlrm.embedding_bag(model.tables, _t(b["sparse_ids"]), _t(b["sparse_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # with every mask true the padded ids' rows are what is averaged
    full = np.ones_like(b["sparse_mask"])
    want = jdlrm.embedding_bag(jparams["tables"], b["sparse_ids"], full)
    got = tdlrm.embedding_bag(model.tables, _t(b["sparse_ids"]), _t(full))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # the rows JAX reads: 7 of a 5-row table is row 4, -1 is row 4, -7 is row 0
    table = np.arange(5, dtype=np.float32)[None, :, None]
    ids = np.array([[[7, -1, -7, 2]]], np.int32)
    rows = np.asarray(jnp.asarray(table)[jnp.zeros((1, 1, 4), jnp.int32), ids])
    assert rows.ravel().tolist() == [4.0, 4.0, 0.0, 2.0]
    got = tdlrm.embedding_bag(_t(table), _t(ids[..., :1]), torch.ones((1, 1, 1), dtype=torch.bool))
    assert got.item() == 4.0


def test_forward_and_serve_step_match_jax(dlrm):
    jcfg, tcfg, jparams, model = dlrm
    rng = np.random.default_rng(1)
    b = _batch(jcfg, 64, rng, out_of_range=True)
    want = jax.jit(jdlrm.forward, static_argnums=2)(jparams, b, jcfg)
    np.testing.assert_allclose(model(_tbatch(b)).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    want = jax.jit(jsteps.make_dlrm_serve_step(jcfg))(jparams, b)
    got = tsteps.make_dlrm_serve_step(tcfg)(model, _tbatch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_interaction_order_is_jax_tril_order():
    """``torch.tril_indices(f, f, -1)`` lists the pairs in
    ``jnp.tril_indices(f, k=-1)``'s row-major order."""
    for f in (2, 5, 27):
        ti, tj = torch.tril_indices(f, f, -1)
        ji, jj = jnp.tril_indices(f, k=-1)
        assert ti.tolist() == np.asarray(ji).tolist()
        assert tj.tolist() == np.asarray(jj).tolist()


@pytest.mark.parametrize("k", [10, 100])
def test_retrieval_scores_match_jax_kernel(k):
    """Over 2,000 Gaussian candidates, against JAX's ``score_topk`` Pallas
    kernel in interpret mode: ids equal, scores within 1e-5 relative."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    cands = rng.normal(size=(2000, 64)).astype(np.float32)
    js, ji = jdlrm.retrieval_scores(jnp.asarray(q), jnp.asarray(cands), k)
    ts, ti = tdlrm.retrieval_scores(_t(q), _t(cands), k)
    assert ti.dtype == torch.int32 and ti.shape == (3, k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_retrieval_step_matches_jax(dlrm):
    """The k = 100 step: bottom MLP to a query embedding, then top-100 by
    inner product (JAX's step takes its plain path, the port's the CPU
    plain version)."""
    jcfg, tcfg, jparams, model = dlrm
    rng = np.random.default_rng(3)
    b = {"dense": rng.normal(size=(2, jcfg.n_dense)).astype(np.float32),
         "candidates": rng.normal(size=(1500, jcfg.bot_mlp[-1])).astype(np.float32)}
    js, ji = jax.jit(jsteps.make_dlrm_retrieval_step(jcfg))(jparams, b)
    ts, ti = tsteps.make_dlrm_retrieval_step(tcfg)(model, _tbatch(b))
    assert ti.shape == (2, 100)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def test_init_params_shapes_and_scales():
    cfg = treg.get_arch("dlrm-rm2").smoke_config()
    jp = jax.eval_shape(lambda k: jdlrm.init_params(k, jreg.get_arch("dlrm-rm2")
                                                    .smoke_config()), jax.random.PRNGKey(0))
    m = tdlrm.init_params(cfg, torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in m.parameters()] == [
        tuple(x.shape) for x in [jp["tables"], *[l["w"] for l in jp["bot"]],
                                 *[l["w"] for l in jp["top"]]]]
    assert abs(float(m.tables.std()) * cfg.embed_dim ** 0.5 - 1.0) < 0.05
    assert float(m.bot[0].abs().max()) <= 2.0 * cfg.n_dense ** -0.5


def test_config_and_specs_match_jax():
    jspec, tspec = jreg.get_arch("dlrm-rm2"), treg.get_arch("dlrm-rm2")
    assert tspec.config_for_shape("serve_bulk").__dict__ == \
        jspec.config_for_shape("serve_bulk").__dict__
    assert tspec.smoke_config().__dict__ == jspec.smoke_config().__dict__
    spec = tspec.input_specs(tspec.config_for_shape("retrieval_cand"), "retrieval_cand")
    assert spec["candidates"].shape == (1_000_000, 64)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_dlrm_retrieval", ROOT / "tools" / "torch_dlrm_retrieval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ip_bulk_build_of_tower_embeddings_matches_jax():
    """The flow's index: ``bulk_knn_build`` with metric ip over the smoke
    tower's ReLU'd item embeddings gives JAX's graph byte for byte (its few
    edges a node are the reference's, not the port's)."""
    from repro.core.params import IndexParams as JIndexParams
    from repro.core.params import SearchParams as JSearchParams
    from repro.core.rebuild import bulk_knn_build as jbulk
    from repro_torch.core import IndexParams, SearchParams
    from repro_torch.core.rebuild import bulk_knn_build

    tool = _tool()
    cfg = treg.get_arch("dlrm-rm2").smoke_config()
    model = tdlrm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    items = tool.tower(model, rng.normal(size=(600, cfg.n_dense)).astype(np.float32),
                       torch.device("cpu"))
    kw = dict(capacity=1024, dim=items.shape[1], d_out=12, metric="ip")
    ts = bulk_knn_build(items, torch.ones(600, dtype=torch.bool),
                        IndexParams(**kw, search=SearchParams(pool_size=32)), device="cpu")
    js = jbulk(jnp.asarray(items.numpy()), jnp.ones(600, bool),
               JIndexParams(**kw, search=JSearchParams(pool_size=32)))
    assert np.array_equal(np.asarray(js.adj), ts.adj.numpy())
    assert np.array_equal(np.asarray(js.radj), ts.radj.numpy())


def test_dlrm_retrieval_tool_on_cpu():
    """The DLRM × IPGM flow at a small size: item embeddings of the bottom
    tower in a metric-ip index, graph top-10 against brute force, then
    GLOBAL expiry and fresh inserts."""
    tool = _tool()
    out = tool.run(n_items=600, n_churn=100, n_queries=16, capacity=1024,
                   d_out=12, pool=32, max_steps=64, device="cpu", seed=0)
    assert 0.0 < out["overlap_at_10"] <= 1.0
    assert 0.0 <= out["recall_at_10_after_churn"] <= 1.0
    assert out["alive"] == 600
    assert out["graph_ids_alive"]


def test_dlrm_retrieval_tool_follows_the_example():
    """The tool's default flow is ``examples/dlrm_retrieval.py``'s: the items
    are inserted into a GLOBAL metric-ip index, the first ``n_churn`` ids the
    insert returned expire, and as many fresh items go in. JAX's
    ``IPGMIndex``, driven through the example's calls on the same tower
    embeddings, gives the same overlap, recall and out-degree."""
    from repro.core import IndexParams as JIndexParams
    from repro.core import IPGMIndex as JIndex
    from repro.core import SearchParams as JSearchParams

    tool = _tool()
    n, churn, nq, cpu = 400, 80, 16, torch.device("cpu")
    out = tool.run(n_items=n, n_churn=churn, n_queries=nq, capacity=512, d_out=12,
                   pool=32, max_steps=64, device="cpu", seed=0)
    assert out["build"] == "insert"
    cfg = treg.get_arch("dlrm-rm2").smoke_config()
    model = tdlrm.init_params(cfg, torch.Generator().manual_seed(0), cpu)
    rng = np.random.default_rng(0)
    items, users, fresh = (
        tool.tower(model, rng.normal(size=(m, cfg.n_dense)).astype(np.float32), cpu)
        for m in (n, nq, churn))
    index = JIndex(JIndexParams(capacity=512, dim=items.shape[1], d_out=12, metric="ip",
                                search=JSearchParams(pool_size=32, max_steps=64,
                                                     num_starts=2)),
                   strategy="global")
    ids = index.insert(items.numpy())
    graph_ids, _ = index.query(users.numpy(), k=10)
    _, bf = tdlrm.retrieval_scores(users, items, 10)
    overlap = np.mean([len(set(np.asarray(graph_ids)[i]) & set(bf[i].tolist())) / 10
                       for i in range(nq)])
    assert out["overlap_at_10"] == pytest.approx(overlap, abs=1e-9)
    index.delete(np.asarray(ids)[:churn])
    index.insert(fresh.numpy())
    assert out["recall_at_10_after_churn"] == pytest.approx(
        index.recall(users.numpy(), k=10), abs=1e-6)
    assert out["stats"]["avg_out_degree"] == pytest.approx(
        index.stats()["avg_out_degree"], abs=1e-6)


def test_dlrm_retrieval_tool_bulk_build_on_cpu():
    """``build="bulk"`` (the models phase's flow at 10^6 items) builds the
    index by exact kNN; the churn and its checks run as after inserts."""
    tool = _tool()
    out = tool.run(n_items=600, n_churn=100, n_queries=16, capacity=1024, d_out=12,
                   pool=32, max_steps=64, build="bulk", device="cpu", seed=0)
    assert out["build"] == "bulk"
    assert 0.0 < out["overlap_at_10"] <= 1.0
    assert out["inserted"] == 100 and out["alive"] == 600
    assert out["graph_ids_alive"]
    with pytest.raises(ValueError, match="build"):
        tool.run(n_items=8, build="knn", device="cpu")
