"""The sharded index (``repro_torch.distributed.ann``) against
``repro.distributed.ann``.

JAX's real ``make_{insert,query,delete,consolidate}_step`` and
``ShardedSession`` run in ONE subprocess with 8 forced host devices (a
process's device count is fixed at its first JAX init): mesh (4, 2), a
(2, 2, 2) pod mesh, capacity 64, d 16, integer-valued vectors, f32 and bf16.
The port runs the same inputs in-process on its stacked single-device
layout. Integer state, vectors and gids are byte-equal; scores meet the
gather tolerance of ``tests/test_kernels.py``. Then, on the port alone
with Gaussian data, every assertion of ``tests/test_distributed.py``; the
folded fan-out against the per-shard loop; ``topk_union`` against JAX's
on ties, ±0 and -inf.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.ann import topk_union as jtopk_union
from repro_torch.core import prng
from repro_torch.core.graph import DATA_FIELDS, NULL, tensor_to_numpy
from repro_torch.core.health import check_health
from repro_torch.core.params import IndexParams, MaintenanceParams, SearchParams
from repro_torch.distributed import ann
from repro_torch.distributed.ann import (
    DistParams,
    ShardedSession,
    ShardMesh,
    init_sharded_state,
    make_consolidate_step,
    make_delete_step,
    make_insert_step,
    make_query_step,
)
from repro_torch.distributed.compression import compressed_psum
from repro_torch.testing import faults
from torch_parity import int_vectors

ROOT = Path(__file__).resolve().parents[1]
DIM = 16

JAX_SCRIPT = r"""
import sys, warnings
warnings.filterwarnings("ignore", "Some donated buffers")
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.core.params import IndexParams, MaintenanceParams, SearchParams
from repro.distributed.ann import (DistParams, ShardedSession,
    init_sharded_state, make_consolidate_step, make_delete_step,
    make_insert_step, make_query_step)
from repro.distributed.compression import compressed_psum

out_dir = sys.argv[1]
inp = np.load(out_dir + "/inputs.npz")
X, Q, route = inp["X"], inp["Q"], inp["route"]
FIELDS = ("vectors", "sqnorms", "codes", "scales", "adj", "radj", "alive",
          "present", "size", "stamps", "clock", "touch", "tclock")
res = {}
K = jax.random.PRNGKey


def dump(tag, st):
    # a copy: the next step donates the state, and np.asarray may alias it
    for f in FIELDS:
        a = np.array(getattr(st, f), copy=True)
        res[tag + "/" + f] = a.view(np.uint16) if a.dtype.itemsize == 2 else a


def params(cap, **mkw):
    return IndexParams(capacity=cap, dim=16, d_out=8,
                       search=SearchParams(pool_size=16, max_steps=32,
                                           num_starts=2),
                       maintenance=MaintenanceParams(**mkw))


def pick(g, idx):
    d = g[idx].astype(np.int32)
    return np.concatenate([d, np.asarray([-1, 7 * 64 + 60], np.int32)])


mesh = jax.make_mesh((4, 2), ("data", "model"))
with compat.use_mesh(mesh):
    dp = DistParams(index=params(64, delete_chunk=16, consolidate_chunk=16))
    ins = make_insert_step(dp, mesh)
    qry = make_query_step(dp, mesh)
    st, g1 = ins(init_sharded_state(dp, mesh), jnp.asarray(X[:96]),
                 jnp.asarray(route[:96]), K(0))
    dump("ins1", st); res["ins1/gids"] = np.asarray(g1)
    i, s = qry(st, jnp.asarray(Q), K(1))
    res["q1/ids"], res["q1/scores"] = np.asarray(i), np.asarray(s)
    st, g2 = ins(st, jnp.asarray(X[96:192]), jnp.asarray(route[96:192]), K(2))
    dump("ins2", st); res["ins2/gids"] = np.asarray(g2)
    g = np.concatenate([np.asarray(g1), np.asarray(g2)])
    st = make_delete_step(dp, mesh, "global")(st, jnp.asarray(pick(g, np.arange(0, 84, 6))), K(3))
    dump("del_global", st)
    st = make_delete_step(dp, mesh, "local")(st, jnp.asarray(pick(g, np.arange(1, 85, 6))), K(4))
    dump("del_local", st)
    st = make_delete_step(dp, mesh, "mask")(st, jnp.asarray(pick(g, np.arange(2, 86, 6))), K(5))
    dump("del_mask", st)
    cons = make_consolidate_step(dp, mesh)
    st = cons(st, K(6))
    st = cons(st, K(7))
    dump("cons", st)
    i, s = qry(st, jnp.asarray(Q), K(8))
    res["q2/ids"], res["q2/scores"] = np.asarray(i), np.asarray(s)

    # lockstep growth and consolidation through the session
    dpg = DistParams(index=params(16, strategy="mask", insert_chunk=32,
                                  delete_chunk=32, consolidate_threshold=0.25,
                                  consolidate_chunk=16, max_capacity=128))
    sess = ShardedSession(dpg, mesh, strategy="mask", seed=3)
    h1 = np.asarray(sess.insert(X[:96], jnp.asarray(route[:96])))
    h2 = np.asarray(sess.insert(X[96:192], jnp.asarray(route[96:192])))
    sess.delete(jnp.asarray(pick(np.concatenate([h1, h2]), np.arange(0, 120, 2))))
    sess.flush()
    i, s = sess.query(jnp.asarray(Q))
    dump("grow", sess.state)
    res["grow/gids"] = np.concatenate([h1, h2])
    res["growq/ids"], res["growq/scores"] = np.asarray(i), np.asarray(s)
    res["grow/counters"] = np.asarray([sess.dp.index.capacity,
        sess.timers.n_grows, sess.timers.n_consolidations,
        sess.timers.n_consolidated, sess.timers.n_refused])

    # bf16 rows: one insert and one query step
    dpb = DistParams(index=params(64), vec_dtype="bfloat16")
    st, gb = make_insert_step(dpb, mesh)(init_sharded_state(dpb, mesh),
                                         jnp.asarray(X[:96]),
                                         jnp.asarray(route[:96]), K(0))
    dump("bf16", st); res["bf16/gids"] = np.asarray(gb)
    i, s = make_query_step(dpb, mesh)(st, jnp.asarray(Q), K(1))
    res["bf16q/ids"], res["bf16q/scores"] = np.asarray(i), np.asarray(s)


# the int8-compressed mean over 8 members
mesh1 = jax.make_mesh((8,), ("d",))
with compat.use_mesh(mesh1):
    G = {"w": jnp.asarray(inp["Gw"]), "b": jnp.asarray(inp["Gb"])}
    P = jax.sharding.PartitionSpec
    f = compat.shard_map(
        lambda t: compressed_psum(jax.tree.map(lambda x: x[0], t), K(11), "d"),
        mesh=mesh1, in_specs=(P("d"),), out_specs=P(), check_vma=False)
    c = jax.jit(f)(G)
    res["psum/w"], res["psum/b"] = np.asarray(c["w"]), np.asarray(c["b"])
mesh3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
with compat.use_mesh(mesh3):
    dp3 = DistParams(index=params(64), pod_axis="pod")
    st, g3 = make_insert_step(dp3, mesh3)(init_sharded_state(dp3, mesh3),
                                          jnp.asarray(X[:80]),
                                          jnp.asarray(route[:80]), K(0))
    dump("pod", st); res["pod/gids"] = np.asarray(g3)
    i, s = make_query_step(dp3, mesh3)(st, jnp.asarray(Q), K(1))
    res["podq/ids"], res["podq/scores"] = np.asarray(i), np.asarray(s)

np.savez(out_dir + "/jax.npz", **res)
print("RESULT ok")
"""


def _params(cap, **mkw):
    return IndexParams(capacity=cap, dim=DIM, d_out=8,
                       search=SearchParams(pool_size=16, max_steps=32,
                                           num_starts=2),
                       maintenance=MaintenanceParams(**mkw))


def _pick(g, idx):
    d = g[idx].astype(np.int32)
    return np.concatenate([d, np.asarray([-1, 7 * 64 + 60], np.int32)])


def _inputs():
    rng = np.random.default_rng(0)
    return {"X": int_vectors(rng, 192, DIM), "Q": int_vectors(rng, 16, DIM),
            "route": np.arange(192, dtype=np.int32),
            "Gw": rng.normal(size=(8, 32, 8)).astype(np.float32),
            "Gb": (rng.normal(size=(8, 16)) * 1e-3).astype(np.float32)}


def _run_port(inp) -> dict:
    """The JAX script's stream on the port, on the CPU."""
    X, Q, route = inp["X"], inp["Q"], inp["route"]
    res = {}
    K = prng.prng_key

    def dump(tag, st):
        # a copy: the steps update the state in place
        for f in DATA_FIELDS:
            a = tensor_to_numpy(getattr(st, f)).copy()
            res[tag + "/" + f] = a.view(np.uint16) if a.dtype.itemsize == 2 else a

    def query(tag, out):
        res[tag + "/ids"], res[tag + "/scores"] = (t.numpy() for t in out)

    mesh = ShardMesh((4, 2), ("data", "model"))
    dp = DistParams(index=_params(64, delete_chunk=16, consolidate_chunk=16))
    ins = make_insert_step(dp, mesh)
    qry = make_query_step(dp, mesh)
    st, g1 = ins(init_sharded_state(dp, mesh, device="cpu"), X[:96],
                 route[:96], K(0))
    dump("ins1", st)
    res["ins1/gids"] = g1.numpy()
    query("q1", qry(st, Q, K(1)))
    st, g2 = ins(st, X[96:192], route[96:192], K(2))
    dump("ins2", st)
    res["ins2/gids"] = g2.numpy()
    g = np.concatenate([g1.numpy(), g2.numpy()])
    st = make_delete_step(dp, mesh, "global")(st, _pick(g, np.arange(0, 84, 6)), K(3))
    dump("del_global", st)
    st = make_delete_step(dp, mesh, "local")(st, _pick(g, np.arange(1, 85, 6)), K(4))
    dump("del_local", st)
    st = make_delete_step(dp, mesh, "mask")(st, _pick(g, np.arange(2, 86, 6)), K(5))
    dump("del_mask", st)
    cons = make_consolidate_step(dp, mesh)
    st = cons(st, K(6))
    st = cons(st, K(7))
    dump("cons", st)
    query("q2", qry(st, Q, K(8)))

    dpg = DistParams(index=_params(16, strategy="mask", insert_chunk=32,
                                   delete_chunk=32, consolidate_threshold=0.25,
                                   consolidate_chunk=16, max_capacity=128))
    sess = ShardedSession(dpg, mesh, strategy="mask", seed=3, device="cpu")
    h1 = sess.insert(X[:96], route[:96]).numpy()
    h2 = sess.insert(X[96:192], route[96:192]).numpy()
    sess.delete(_pick(np.concatenate([h1, h2]), np.arange(0, 120, 2)))
    sess.flush()
    query("growq", sess.query(Q))
    dump("grow", sess.state)
    res["grow/gids"] = np.concatenate([h1, h2])
    res["grow/counters"] = np.asarray([
        sess.dp.index.capacity, sess.timers.n_grows,
        sess.timers.n_consolidations, sess.timers.n_consolidated,
        sess.timers.n_refused])

    dpb = DistParams(index=_params(64), vec_dtype="bfloat16")
    st, gb = make_insert_step(dpb, mesh)(
        init_sharded_state(dpb, mesh, device="cpu"), X[:96], route[:96], K(0))
    dump("bf16", st)
    res["bf16/gids"] = gb.numpy()
    query("bf16q", make_query_step(dpb, mesh)(st, Q, K(1)))

    c = compressed_psum({"w": torch.from_numpy(inp["Gw"]),
                         "b": torch.from_numpy(inp["Gb"])}, K(11))
    res["psum/w"], res["psum/b"] = c["w"].numpy(), c["b"].numpy()

    mesh3 = ShardMesh((2, 2, 2), ("pod", "data", "model"))
    dp3 = DistParams(index=_params(64), pod_axis="pod")
    st, g3 = make_insert_step(dp3, mesh3)(
        init_sharded_state(dp3, mesh3, device="cpu"), X[:80], route[:80], K(0))
    dump("pod", st)
    res["pod/gids"] = g3.numpy()
    query("podq", make_query_step(dp3, mesh3)(st, Q, K(1)))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    inp = _inputs()
    np.savez(out / "inputs.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out / "jax.npz") as z:
        jres = {k: z[k] for k in z.files}
    return jres, _run_port(inp)


STATE_TAGS = ["ins1", "ins2", "del_global", "del_local", "del_mask", "cons",
              "grow", "bf16", "pod"]
QUERY_TAGS = ["q1", "q2", "growq", "bf16q", "podq"]


@pytest.mark.parametrize("tag", STATE_TAGS)
def test_sharded_state_byte_equal(runs, tag):
    jres, tres = runs
    # every field: integer state, and the rows with their norms and codes
    # (exact on integer-valued vectors)
    diff = [f for f in DATA_FIELDS
            if not np.array_equal(jres[f"{tag}/{f}"], tres[f"{tag}/{f}"])]
    assert diff == [], f"{tag}: fields differ from JAX: {diff}"
    if f"{tag}/gids" in jres:
        np.testing.assert_array_equal(tres[f"{tag}/gids"], jres[f"{tag}/gids"])
    if tag == "bf16":
        assert tres["bf16/vectors"].dtype == np.uint16    # stored as bf16


@pytest.mark.parametrize("tag", QUERY_TAGS)
def test_sharded_query_matches_jax(runs, tag):
    jres, tres = runs
    np.testing.assert_array_equal(tres[f"{tag}/ids"], jres[f"{tag}/ids"])
    g, w = tres[f"{tag}/scores"], jres[f"{tag}/scores"]
    assert ((g == -np.inf) == (w == -np.inf)).all()
    m = np.isfinite(w)
    np.testing.assert_allclose(g[m], w[m], rtol=1e-4, atol=1e-3)


def test_session_counters_match_jax(runs):
    jres, tres = runs
    np.testing.assert_array_equal(tres["grow/counters"], jres["grow/counters"])
    cap, n_grows, n_cons, _, n_refused = tres["grow/counters"]
    assert cap > 16 and n_grows >= 1 and n_cons >= 1 and n_refused == 0


@pytest.mark.parametrize("leaf", ["w", "b"])
def test_compressed_psum_matches_jax(runs, leaf):
    """The int8 sum is exact and the noise bit-equal; the mean scale sums
    eight f32 scales, in member order here (XLA's all-reduce order may
    differ in the last bit)."""
    jres, tres = runs
    np.testing.assert_allclose(tres[f"psum/{leaf}"], jres[f"psum/{leaf}"],
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the port alone, Gaussian data: tests/test_distributed.py's assertions
# ---------------------------------------------------------------------------

MESH = ShardMesh((4, 2), ("data", "model"))


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(200, DIM)).astype(np.float32),
            rng.normal(size=(32, DIM)).astype(np.float32))


def _inserted(X, dp=None, mesh=MESH):
    dp = dp or DistParams(index=_params(64))
    st = init_sharded_state(dp, mesh, device="cpu")
    return make_insert_step(dp, mesh)(st, X, np.arange(len(X)), prng.prng_key(0))


def test_insert_query_delete_recall(gauss):
    X, Q = gauss
    st, gids = _inserted(X)
    g = gids.numpy()
    assert (g >= 0).sum() == 200 and len(set(g.tolist())) == 200
    assert ((g // 64) == np.arange(200) % 8).all()       # owner = route % S
    ids, _ = make_query_step(DistParams(index=_params(64)), MESH)(
        st, Q, prng.prng_key(1))
    allv = st.vectors.reshape(-1, DIM).numpy()
    alive = st.alive.reshape(-1).numpy()
    d2 = ((allv[None] - Q[:, None]) ** 2).sum(-1)
    d2[:, ~alive] = np.inf
    true10 = np.argsort(d2, 1)[:, :10]
    found = ids.numpy()[:, :10]
    recall = np.mean([len(set(found[i]) & set(true10[i])) / 10
                      for i in range(32)])
    assert recall > 0.9
    st = make_delete_step(DistParams(index=_params(64)), MESH, "global")(
        st, g[:50], prng.prng_key(2))
    assert int(st.alive.sum()) == 150
    for s in range(8):
        assert check_health(ann.shard_view(st, s)) == []


def test_sharded_consolidation_counts(gauss):
    X, _ = gauss
    dp = DistParams(index=_params(64, strategy="mask", delete_chunk=16,
                                  consolidate_threshold=0.25,
                                  consolidate_chunk=16))
    sess = ShardedSession(dp, MESH, strategy="mask", device="cpu")
    g = sess.insert(X, np.arange(200)).numpy()
    sess.delete(g[:40])
    sess.flush()                  # 40/200 = 0.2 < 0.25: no auto-trigger
    assert int(sess.state.masked.sum()) == 40
    assert sess.consolidate() == 40
    sess.flush()
    assert int(sess.state.masked.sum()) == 0
    assert int(sess.state.present.sum()) == 160
    sess.delete(g[40:100])        # 60 more: crosses 0.25 → auto-trigger
    sess.flush()
    assert int(sess.state.masked.sum()) == 0, "threshold crossing must drain"
    assert sess.timers.n_consolidations >= 2


def test_sharded_lockstep_growth(gauss):
    X, Q = gauss
    dp = DistParams(index=_params(16, strategy="pure", insert_chunk=32,
                                  delete_chunk=32, max_capacity=128))
    gs = ShardedSession(dp, MESH, strategy="pure", device="cpu")
    g1 = gs.insert(X[:100], np.arange(100)).numpy()
    g2 = gs.insert(X[100:200], np.arange(100, 200)).numpy()
    gs.flush()
    assert 16 < gs.dp.index.capacity <= 128, "shards must grow in lockstep"
    assert gs.state.vectors.shape[:2] == (8, gs.dp.index.capacity)
    assert gs.timers.n_grows <= 3
    assert gs.timers.n_refused == 0
    assert len(set(g1.tolist()) | set(g2.tolist())) == 200
    assert gs.n_alive() == 200
    gs.delete(g1[:20])            # pre-growth gids must still decode
    gs.flush()
    assert gs.n_alive() == 180
    qi, _ = gs.query(Q[:8])
    assert (qi.numpy()[:, 0] >= 0).all()


def test_sharded_crash_points(gauss):
    X, _ = gauss
    dp = DistParams(index=_params(16, strategy="mask", insert_chunk=32,
                                  delete_chunk=32, consolidate_threshold=0.25,
                                  consolidate_chunk=16, max_capacity=128))
    probe = faults.FaultPlan()
    with faults.inject(probe):
        fs = ShardedSession(dp, MESH, strategy="mask", device="cpu")
        fg1 = fs.insert(X[:100], np.arange(100)).numpy()
        fs.insert(X[100:200], np.arange(100, 200))
        fs.delete(fg1[:60])
        fs.consolidate()
        fs.flush()
    missing = [p for p in faults.SHARDED_CRASH_POINTS if probe.hits.get(p, 0) == 0]
    assert not missing, f"sharded stream never reached crash points: {missing}"
    with faults.inject(faults.crash_once("sharded-pre-dispatch", hit=1)):
        with pytest.raises(faults.SimulatedCrash):
            fs.insert(X[:10], np.arange(10))


def test_multipod_insert_and_query(gauss):
    X, Q = gauss
    mesh3 = ShardMesh((2, 2, 2), ("pod", "data", "model"))
    dp3 = DistParams(index=_params(64), pod_axis="pod")
    st, g = _inserted(X[:80], dp3, mesh3)
    assert (g.numpy() >= 0).sum() == 80
    assert st.vectors.shape[0] == 4                      # one replica
    ids, _ = make_query_step(dp3, mesh3)(st, Q[:8], prng.prng_key(1))
    assert (ids.numpy()[:, 0] >= 0).all()


# ---------------------------------------------------------------------------
# the folded fan-out, the merge and the stacked views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "bf16", "masked", "q8", "flat"])
def test_folded_fanout_equals_per_shard_loop(gauss, case):
    """One beam_search over S·B lanes of the flat view gives the per-shard
    calls' ids and scores bit for bit; so does the merged answer."""
    X, Q = gauss
    search = SearchParams(pool_size=16, max_steps=32, num_starts=2,
                          quantized=case == "q8", rerank_depth=8 if case == "q8" else 0)
    ip = IndexParams(capacity=64, dim=DIM, d_out=8, search=search)
    dp = DistParams(index=ip, vec_dtype="bfloat16" if case == "bf16" else "float32",
                    hierarchical_merge=case != "flat")
    st, g = _inserted(X, dp)
    if case == "masked":
        st = make_delete_step(dp, MESH, "mask")(st, g.numpy()[::3], prng.prng_key(5))
    key = prng.prng_key(9)
    f_ids, f_sc = ann.fanout_search(st, torch.from_numpy(Q), key, ip, fold=True)
    p_ids, p_sc = ann.fanout_search(st, torch.from_numpy(Q), key, ip, fold=False)
    assert torch.equal(f_ids, p_ids) and torch.equal(f_sc, p_sc)
    assert (f_ids != NULL).any()
    fa = make_query_step(dp, MESH)(st, Q, key)
    pa = make_query_step(dp, MESH, fold=False)(st, Q, key)
    assert all(torch.equal(a, b) for a, b in zip(fa, pa))


@pytest.mark.parametrize("case", ["ties", "signed_zero", "neg_inf"])
def test_topk_union_matches_lax(case):
    rng = np.random.default_rng(3)
    B, W, k = 5, 24, 8
    if case == "ties":
        s = rng.integers(-2, 3, size=(B, W)).astype(np.float32)
    elif case == "signed_zero":
        s = np.where(rng.random((B, W)) < 0.5, -0.0, 0.0).astype(np.float32)
        s[:, ::7] = 1.0
    else:
        s = rng.normal(size=(B, W)).astype(np.float32)
        s[rng.random((B, W)) < 0.7] = -np.inf
    ids = rng.permutation(B * W).reshape(B, W).astype(np.int32)
    ids[s == -np.inf] = NULL
    js, ji = jtopk_union(jnp.asarray(s), jnp.asarray(ids), k)
    ts, ti = ann.topk_union(torch.from_numpy(s), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_merge_is_two_stage_like_jax():
    """Hierarchical fan-in: a union within each 'model' group, then across
    'data' — against the two all_gather + top_k stages written out in JAX."""
    rng = np.random.default_rng(4)
    S, B, K = 8, 3, 6
    sc = rng.integers(-3, 3, size=(S, B, K)).astype(np.float32)
    gi = rng.permutation(S * B * K).reshape(S, B, K).astype(np.int32)
    dp = DistParams(index=_params(64))
    ts, ti = ann._merge(torch.from_numpy(sc), torch.from_numpy(gi), dp, MESH, K)

    def stage(s, i):                                  # [m, B, K] → [B, K]
        fs = jnp.transpose(s, (1, 0, 2)).reshape(B, -1)
        fi = jnp.transpose(i, (1, 0, 2)).reshape(B, -1)
        return jtopk_union(fs, fi, K)

    firsts = [stage(jnp.asarray(sc[d * 2:(d + 1) * 2]), jnp.asarray(gi[d * 2:(d + 1) * 2]))
              for d in range(4)]
    ws, wi = stage(jnp.stack([f[0] for f in firsts]), jnp.stack([f[1] for f in firsts]))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))


def test_views_write_into_the_stack_and_replaced_fields_are_copied_back():
    dp = DistParams(index=_params(16))
    st = init_sharded_state(dp, MESH, device="cpu")
    v = ann.shard_view(st, 3)
    v.size += 5                                   # in place: lands in the stack
    v.alive[2] = True
    out = dataclasses.replace(v, clock=torch.tensor(9, dtype=torch.int32))
    ann._write_back(st, 3, v, out)                # a replaced field
    assert st.size.tolist() == [0, 0, 0, 5, 0, 0, 0, 0]
    assert st.clock.tolist() == [0, 0, 0, 9, 0, 0, 0, 0]
    assert bool(st.alive[3, 2]) and int(st.alive.sum()) == 1


def test_init_sharded_state_matches_jax_layout():
    from repro.distributed.ann import DistParams as JDist
    from repro.distributed.ann import init_sharded_state as jinit

    class _Mesh:                                  # JAX reads mesh.shape only
        shape = {"data": 4, "model": 2}

    for vd in ("float32", "bfloat16"):
        jp = JDist(index=_jparams(), vec_dtype=vd)
        js = jinit(jp, _Mesh())
        ts = init_sharded_state(DistParams(index=_params(64), vec_dtype=vd),
                                MESH, device="cpu")
        for f in DATA_FIELDS:
            a, b = np.asarray(getattr(js, f)), tensor_to_numpy(getattr(ts, f))
            assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, f
            assert a.tobytes() == b.tobytes(), f


def _jparams():
    from repro.core.params import IndexParams as JIP
    from repro.core.params import SearchParams as JSP
    return JIP(capacity=64, dim=DIM, d_out=8,
               search=JSP(pool_size=16, max_steps=32, num_starts=2))


def test_sharded_checkpoint_crosses_packages(tmp_path):
    """A stacked state saved by either package's CheckpointManager restores
    in the other, f32 and bf16 (JAX's own bf16 leaves come back as 2-byte
    words, which the port reads as bf16)."""
    import ml_dtypes

    from repro.checkpoint.manager import CheckpointManager as JMgr
    from repro.core.graph import GraphState as JState
    from repro_torch.checkpoint.manager import CheckpointManager as TMgr
    from repro_torch.core.graph import graph_state_from_numpy

    rng = np.random.default_rng(5)
    X = int_vectors(rng, 96, DIM)
    for vd in ("float32", "bfloat16"):
        dp = DistParams(index=_params(64), vec_dtype=vd)
        st, _ = _inserted(X, dp)
        arrays = {f: tensor_to_numpy(getattr(st, f)) for f in DATA_FIELDS}
        if vd == "bfloat16":
            arrays["vectors"] = arrays["vectors"].view(ml_dtypes.bfloat16)
        meta = dict(capacity=64, dim=DIM, d_out=8, d_in=16, metric="l2")
        js = JState(**{f: jnp.asarray(a) for f, a in arrays.items()}, **meta)
        # JAX writes, the port reads
        JMgr(tmp_path / f"j-{vd}").save(0, {"graph": js})
        tree, _ = TMgr(tmp_path / f"j-{vd}").restore(None, {"graph": st})
        back = graph_state_from_numpy(tree["graph"], device="cpu", **meta)
        for f in DATA_FIELDS:
            assert torch.equal(getattr(back, f), getattr(st, f)), f
        # the port writes, JAX reads the same bytes
        TMgr(tmp_path / f"t-{vd}").save(0, {"graph": st})
        jt, _ = JMgr(tmp_path / f"t-{vd}").restore(None, {"graph": js})
        for f in DATA_FIELDS:
            a = np.asarray(getattr(jt["graph"], f))
            assert a.tobytes() == np.asarray(getattr(js, f)).tobytes(), f
