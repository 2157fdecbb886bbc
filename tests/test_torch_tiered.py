"""The port's two-tier index against the JAX package's (tests/test_tiered.py
and the tiered half of tests/test_recovery.py).

The same seeded streams drive both ``TieredSession``s: acked ids, query
external ids, mirrors, both tiers' arrays and every counter must match; the
merge-timing, upsert, mid-drain dedup, capped-merge and NaN checks run on
the port; the tiered crash matrix kills every merge phase and recovers
bit-exact; a tiered checkpoint crosses between the packages both ways.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.core import IndexParams, MaintenanceParams, SearchParams
from repro.core import TieredSession as JTiered
from repro.core.tiered import _union_topk as j_union_topk
from repro.testing import faults as jfaults
from repro_torch.core import TieredSession as TTiered
from repro_torch.core.graph import NULL
from repro_torch.core.merge import DRAIN, StreamingMerge
from repro_torch.core.rebuild import bulk_knn_build
from repro_torch.core.tiered import _top_columns, _union_topk
from repro_torch.testing import faults
from torch_parity import state_diff, torch_params

DIM = 8
CHUNK = 16
CAP = 96
FRESH = 32
RECALL_FLOOR = 0.75   # tests/test_tiered.py's floor
# query scores cross frameworks within the Pallas kernels' tolerance: the
# main tier's engine sums Gaussian dot products in another order than XLA
RTOL, ATOL = 1e-4, 1e-3


def _jparams(**maintenance_kw):
    mkw = dict(strategy="mask", insert_chunk=CHUNK, delete_chunk=CHUNK,
               max_capacity=4 * CAP)
    mkw.update(maintenance_kw)
    return IndexParams(
        capacity=CAP, dim=DIM, d_out=6,
        search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
        maintenance=MaintenanceParams(**mkw))


def _session(seed=0, **maintenance_kw):
    return TTiered(torch_params(_jparams(**maintenance_kw)),
                   fresh_capacity=FRESH, seed=seed, device="cpu")


class ExtOracle:
    """Ground truth keyed by external id: a dict of live vectors."""

    def __init__(self):
        self.vec: dict[int, np.ndarray] = {}

    def upsert(self, ids, vecs):
        for e, v in zip(np.asarray(ids).ravel(), np.asarray(vecs, np.float32)):
            if e != NULL:
                self.vec[int(e)] = v.copy()

    def delete(self, ids):
        for e in np.asarray(ids).ravel():
            self.vec.pop(int(e), None)

    def recall(self, found, queries, k):
        ids = np.fromiter(self.vec.keys(), np.int32)
        mat = np.stack([self.vec[int(e)] for e in ids])
        d2 = ((mat[None] - np.asarray(queries, np.float32)[:, None]) ** 2).sum(-1)
        true = ids[np.argsort(d2, axis=1)[:, :k]]
        hits = sum(len(set(f[f != NULL].tolist()) & set(t.tolist())) / len(t)
                   for f, t in zip(np.asarray(found)[:, :k], true))
        return hits / len(queries)


def _vecs(seed, n):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


def _drive(ts, oracle, seed, n_ops=30, explicit_merge_at=()):
    """tests/test_tiered.py's seeded stream; returns the transcript (acked
    ids, deleted ids, query ids and scores)."""
    rng = np.random.default_rng(seed)
    acks = []
    for t in range(n_ops):
        r = rng.random()
        if r < 0.45:
            v = _vecs(seed * 1000 + t, int(rng.integers(1, 12)))
            ids = ts.insert(v).result()
            if oracle is not None:
                oracle.upsert(ids, v)
            acks.append(("i", ids.tolist()))
        elif r < 0.65 and ts.n_alive > 4:
            live = np.fromiter(sorted(ts._loc), np.int64)
            pick = live[rng.integers(0, len(live),
                                     size=int(rng.integers(1, 4)))]
            ts.delete(pick).result()
            if oracle is not None:
                oracle.delete(pick)
            acks.append(("d", sorted(set(pick.tolist()))))
        else:
            ids, sc = ts.query(_vecs(seed * 7777 + t, 4), k=8).result()
            acks.append(("q", ids, sc))
        if t in explicit_merge_at:
            ts.merge()
        if t % 9 == 8:
            ts.flush()
    ts.flush()
    return acks


def _same_transcript(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]
        if x[0] == "q":
            np.testing.assert_array_equal(x[1], y[1])
            np.testing.assert_allclose(x[2], y[2], rtol=RTOL, atol=ATOL)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# the differential against the JAX TieredSession
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_matches_jax_tiered(seed):
    kw = dict(merge_fresh_threshold=0.6, merge_tombstone_threshold=0.3)
    js = JTiered(_jparams(**kw), fresh_capacity=FRESH, seed=seed)
    ts = _session(seed=seed, **kw)
    oracle = ExtOracle()
    want = _drive(js, None, seed=seed, n_ops=36)
    got = _drive(ts, oracle, seed=seed, n_ops=36)
    _same_transcript(got, want)
    assert ts._loc == js._loc and ts._both_set == js._both_set
    for a, b in ((ts._fm, js._fm), (ts._mm, js._mm)):
        for f in ("present", "masked", "ext"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(ts._fbias, js._fbias)
    assert state_diff(js._fresh.state, ts._fresh.state) == []
    assert state_diff(js._main.state, ts._main.state) == []
    assert (ts._op_counter, ts._merge_counter, ts._merges_done,
            ts._next_ext, ts._fresh._op_counter, ts._main._op_counter) == (
        js._op_counter, js._merge_counter, js._merges_done, js._next_ext,
        js._fresh._op_counter, js._main._op_counter)
    assert ts.timers.n_merges == js.timers.n_merges >= 1
    assert ts.timers.n_merged == js.timers.n_merged
    ts.check_mirrors()
    assert set(ts._loc) == set(oracle.vec)
    q = _vecs(seed + 31337, 16)
    ids, _ = ts.query(q, k=10).result()
    assert oracle.recall(ids, q, 10) >= RECALL_FLOOR
    gt_t = ts.ground_truth(q, 10)
    gt_j = js.ground_truth(q, 10)
    np.testing.assert_array_equal(gt_t[0], np.asarray(gt_j[0]))
    np.testing.assert_allclose(gt_t[1], np.asarray(gt_j[1]), rtol=RTOL,
                               atol=ATOL)
    assert ts.stats().keys() == js.stats().keys()


@pytest.mark.parametrize("seed", [0, 3])
def test_merge_timing_invariance(seed):
    """One logical stream under three merge policies: acked ids, the alive
    set and the per-tier key counters match; recall holds the floor."""
    configs = [
        dict(merge_fresh_threshold=0.5, merge_tombstone_threshold=0.25),
        dict(merge_fresh_threshold=0.9, merge_chunk=4),
        dict(merge_fresh_threshold=None, merge_tombstone_threshold=None),
    ]
    merge_at = [(), (), (7, 19)]
    transcripts, alive_sets, counters, recalls = [], [], [], []
    for kw, m_at in zip(configs, merge_at):
        ts = _session(seed=seed, **kw)
        oracle = ExtOracle()
        acks = _drive(ts, oracle, seed=seed, n_ops=30, explicit_merge_at=m_at)
        transcripts.append([a for a in acks if a[0] != "q"])
        alive_sets.append(set(ts._loc))
        counters.append((ts._op_counter, ts._fresh._op_counter,
                         ts._main._op_counter))
        q = _vecs(seed + 999, 12)
        ids, _ = ts.query(q, k=10).result()
        recalls.append(oracle.recall(ids, q, 10))
    assert transcripts[0] == transcripts[1] == transcripts[2]
    assert alive_sets[0] == alive_sets[1] == alive_sets[2]
    assert counters[0] == counters[1] == counters[2]
    assert min(recalls) >= RECALL_FLOOR, recalls


# ---------------------------------------------------------------------------
# external-id semantics
# ---------------------------------------------------------------------------

def test_delete_routes_and_ids_are_stable():
    ts = _session(seed=2, merge_fresh_threshold=None)
    ids = ts.insert(_vecs(3, 20)).result()
    assert ids.tolist() == list(range(20))
    ts.merge()                                  # all 20 main-resident
    ids2 = ts.insert(_vecs(4, 6)).result()      # fresh-resident
    ts.delete(np.concatenate([ids[:3], ids2[:2]])).result()
    st = ts.stats()
    assert st["n_main_masked"] == 3 and st["n_fresh"] == 4
    assert ts.n_alive == 21 and st["n_merges"] == 1 and st["merge_s"] > 0
    ts.check_mirrors()
    ts.merge()                                  # compaction reclaims them
    assert ts.stats()["n_main_masked"] == 0


def test_reinserted_id_never_surfaces_twice_nor_stale():
    ts = _session(seed=5, merge_fresh_threshold=None)
    v_old = _vecs(50, 12)
    ids = ts.insert(v_old).result()
    ts.merge()
    target = int(ids[0])
    ts.delete([target]).result()                # tombstone in main
    v_new = -v_old[0:1] * 3.0
    assert ts.insert(v_new, ids=[target]).result().tolist() == [target]
    q_ids, q_sc = ts.query(v_new, k=8).result()
    row = q_ids[0].tolist()
    assert row.count(target) == 1
    # scored against the NEW vector (l2 score of x = q is |q|^2)
    assert q_sc[0][row.index(target)] == pytest.approx(
        float(np.sum(v_new[0] ** 2)), rel=1e-4)
    ts.merge()
    q_ids, _ = ts.query(v_new, k=8).result()
    assert q_ids[0].tolist().count(target) == 1
    ts.check_mirrors()


def test_upsert_same_tier_and_within_batch():
    ts = _session(seed=6, merge_fresh_threshold=None)
    ids = ts.insert(_vecs(60, 4)).result()
    assert ts.insert(_vecs(61, 1), ids=[int(ids[1])]).result().tolist() == [
        int(ids[1])]
    assert ts.n_alive == 4
    v = _vecs(62, 3)
    assert ts.insert(v, ids=[100, 100, 101]).result().tolist() == [
        NULL, 100, 101]
    q_ids, q_sc = ts.query(v[1:2], k=8).result()
    row = q_ids[0].tolist()
    assert row.count(100) == 1
    assert q_sc[0][row.index(100)] == pytest.approx(
        float(np.sum(v[1] ** 2)), rel=1e-4)
    ts.check_mirrors()


def test_mid_drain_duplicate_is_deduped():
    ts = _session(seed=7, merge_fresh_threshold=None, merge_chunk=4)
    v = _vecs(70, 10)
    ts.insert(v).result()
    m = StreamingMerge(ts)
    while m.phase != DRAIN:
        m.step()
    m.step()                 # one drained chunk now lives in both tiers
    assert [e for e, loc in ts._loc.items() if loc[0] == "both"]
    q_ids, _ = ts.query(v, k=10).result()
    for row in q_ids:
        live = [x for x in row.tolist() if x != NULL]
        assert len(live) == len(set(live)), row
    m.run()
    ts.flush()
    ts.check_mirrors()


def test_capped_merge_leaves_suffix_fresh_and_refuses_exactly():
    ts = TTiered(torch_params(_jparams(merge_fresh_threshold=None,
                                       max_capacity=CAP)),
                 fresh_capacity=FRESH, seed=9, device="cpu")
    total = 0
    for i in range(6):
        ids = ts.insert(_vecs(900 + i, FRESH)).result()
        total += int(np.sum(ids != NULL))
        ts.merge()
    ts.flush()
    assert ts.n_alive == total <= CAP + FRESH
    assert ts.timers.n_refused == 6 * FRESH - total
    assert ts.stats()["main_capacity"] == CAP
    ts.check_mirrors()


def test_main_tier_grows_during_drain():
    ts = _session(seed=8, merge_fresh_threshold=None)
    for i in range(5):
        ts.insert(_vecs(800 + i, FRESH)).result()
        ts.merge()
    assert ts.n_alive == 5 * FRESH
    assert ts._main.state.capacity > CAP
    ts.check_mirrors()
    assert ts.recall(_vecs(888, 8), 10) >= RECALL_FLOOR


def test_nan_rows_rejected_and_acked_null():
    ts = _session(seed=10)
    v = _vecs(1000, 4)
    v[2, 0] = np.nan
    ids = ts.insert(v).result()
    assert ids[2] == NULL
    assert sorted(x for x in ids.tolist() if x != NULL) == [0, 1, 3]
    assert ts.timers.n_rejected == 1 and ts.n_alive == 3


def test_main_state_starts_from_a_built_index():
    p = torch_params(_jparams())
    x = _vecs(11, 40)
    valid = np.zeros(CAP, bool)
    valid[:40] = True
    base = np.zeros((CAP, DIM), np.float32)
    base[:40] = x
    ts = TTiered(p, fresh_capacity=FRESH, seed=1,
                 main_state=bulk_knn_build(base, valid, p, device="cpu"))
    assert ts.n_alive == 40 and ts._next_ext == 40
    ts.check_mirrors()
    assert ts.insert(_vecs(12, 3)).result().tolist() == [40, 41, 42]
    ts.delete([0, 41])
    assert ts.stats()["n_main_masked"] == 1
    ts.merge()
    ts.check_mirrors()
    assert ts.recall(x[5:15], 5) >= RECALL_FLOOR


def test_fan_in_ranks_like_a_stable_argsort():
    """The fan-in's order is ``np.argsort(-keys, kind="stable")``: ties to
    the lower column, NaN last, ±0 equal (Queue C: JAX's unstable default
    sort leaves the order of exact ties unspecified). Without ties both
    packages' unions pick the same ids."""
    rng = np.random.default_rng(0)
    keys = rng.integers(-3, 4, (64, 40)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.1] = -np.inf
    keys[rng.random(keys.shape) < 0.05] = np.nan
    keys[:, 3] = -0.0
    keys[:, 5] = 0.0
    gauss = rng.normal(size=(64, 40)).astype(np.float32)
    for k in (1, 7, 40):
        for x in (keys, gauss):     # ties at the k-th key, and none
            want = np.argsort(-x, axis=1, kind="stable")[:, :k]
            np.testing.assert_array_equal(_top_columns(x, k), want)
    ids = rng.permutation(64 * 40).reshape(64, 40).astype(np.int32) % 50
    ids[rng.random(ids.shape) < 0.1] = NULL
    sc = rng.normal(size=ids.shape).astype(np.float32)
    got_i, got_s = _union_topk(ids, sc, 10)
    want_i, want_s = j_union_topk(ids, sc, 10, device=True)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)


def test_union_device_route_is_the_sharded_fan_in():
    """The final pick goes through ``distributed.ann.topk_union`` (JAX's
    ``device=True``), on the given device or the CPU by default: JAX's
    device route's ids and scores, on ties, ±0, -inf and duplicate ext ids."""
    rng = np.random.default_rng(1)
    ids = rng.permutation(32 * 30).reshape(32, 30).astype(np.int32) % 40
    ids[rng.random(ids.shape) < 0.1] = NULL
    sc = rng.integers(-3, 4, ids.shape).astype(np.float32)
    sc[:, 2], sc[:, 4] = -0.0, 0.0
    sc[rng.random(sc.shape) < 0.1] = -np.inf
    for k in (1, 10, 30):
        want_i, want_s = j_union_topk(ids, sc, k, device=True)
        for device in (torch.device("cpu"), None):
            got_i, got_s = _union_topk(ids, sc, k, device=device)
            np.testing.assert_array_equal(got_i, want_i)
            assert got_s.tobytes() == np.asarray(want_s).tobytes()


# ---------------------------------------------------------------------------
# the tiered crash matrix (tests/test_recovery.py's tiered stream)
# ---------------------------------------------------------------------------

T_N_OPS = 48
T_SCHEDULE = "iidiqdiq"
T_FLUSH_EVERY = 7
T_SAVE_EVERY = 19
T_SEED = 3


def _t_jparams():
    mkw = dict(strategy="mask", insert_chunk=CHUNK, delete_chunk=CHUNK,
               consolidate_threshold=0.3, max_capacity=4 * CAP,
               growth_factor=2.0, refine_threshold=30, refine_chunk=8,
               merge_fresh_threshold=0.5, merge_tombstone_threshold=0.25,
               merge_chunk=8)
    return IndexParams(
        capacity=CAP, dim=DIM, d_out=6,
        search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
        maintenance=MaintenanceParams(**mkw))


def _t_session(directory, seed=T_SEED):
    return TTiered(torch_params(_t_jparams()), fresh_capacity=FRESH,
                   seed=seed, device="cpu", checkpoint_dir=directory)


def _t_recover(directory, seed=T_SEED, fresh_capacity=FRESH):
    return TTiered.recover(directory, torch_params(_t_jparams()),
                           fresh_capacity=fresh_capacity, seed=seed,
                           device="cpu")


def _tvec(t):
    return np.random.default_rng(1000 + t).normal(size=(5, DIM)).astype(
        np.float32)


def _t_n_ext(t):
    return 5 * sum(1 for s in range(t) if T_SCHEDULE[s % len(T_SCHEDULE)] == "i")


def _t_del(t):
    return np.random.default_rng(3000 + t).integers(
        0, max(_t_n_ext(t), 1), size=3).astype(np.int32)


def _t_events(ts, t):
    if (t + 1) % T_FLUSH_EVERY == 0:
        ts.flush()
    if (t + 1) % T_SAVE_EVERY == 0:
        ts.save(t + 1)


def _run_tiered_stream(ts, start=0):
    if start > 0:
        _t_events(ts, start - 1)
    for t in range(start, T_N_OPS):
        kind = T_SCHEDULE[t % len(T_SCHEDULE)]
        if kind == "i":
            ts.insert(_tvec(t))
        elif kind == "d":
            ts.delete(_t_del(t))
        else:
            ts.query(_tvec(t)[:2], k=8)
        _t_events(ts, t)
    ts.flush()
    return ts


_T_FIELDS = ("adj", "vectors", "codes", "scales", "alive", "present",
             "stamps")


def _tiered_summary(ts, probe=True):
    out = {"tiers": {}}
    for name, sess in (("fresh", ts._fresh), ("main", ts._main)):
        st = sess.state
        out["tiers"][name] = (
            {f: getattr(st, f).numpy() for f in _T_FIELDS},
            st.capacity, sess._op_counter)
    out["loc"] = dict(ts._loc)
    out["counters"] = (ts._op_counter, ts._merge_counter, ts._merges_done,
                       ts._next_ext)
    out["ext"] = (ts._fm.ext.copy(), ts._mm.ext.copy())
    if probe:
        ids, sc = ts.query(_vecs(5, 4), k=10).result()
        out["probe"] = (ids, sc)
    return out


def _assert_tiered_identical(a, b, label):
    assert a["counters"] == b["counters"], label
    assert a["loc"] == b["loc"], label
    for name in ("fresh", "main"):
        arrs_a, cap_a, opc_a = a["tiers"][name]
        arrs_b, cap_b, opc_b = b["tiers"][name]
        assert (cap_a, opc_a) == (cap_b, opc_b), f"{label}: {name}"
        for f, arr in arrs_a.items():
            np.testing.assert_array_equal(
                arr, arrs_b[f], err_msg=f"{label}: {name}.{f} diverged")
    for got, want in zip(a["ext"], b["ext"]):
        np.testing.assert_array_equal(got, want, err_msg=f"{label}: ext map")
    if "probe" in a and "probe" in b:
        np.testing.assert_array_equal(a["probe"][0], b["probe"][0])
        np.testing.assert_array_equal(a["probe"][1], b["probe"][1])


@pytest.fixture(scope="module")
def tiered_control(tmp_path_factory):
    plan = faults.FaultPlan()
    with faults.inject(plan):
        ts = _run_tiered_stream(_t_session(tmp_path_factory.mktemp("tctrl")))
    return _tiered_summary(ts), dict(plan.hits)


def test_tiered_stream_covers_every_merge_crash_point(tiered_control):
    _, hits = tiered_control
    missing = [p for p in faults.TIERED_CRASH_POINTS if not hits.get(p)]
    assert not missing, f"stream never reached crash points: {missing}"


@pytest.mark.parametrize(
    "point",
    list(faults.TIERED_CRASH_POINTS)
    + ["post-journal-append", "post-checkpoint-save"])
def test_tiered_kill_and_recover_bit_exact(point, tiered_control, tmp_path):
    ctrl_summary, hits = tiered_control
    hit = (hits[point] + 1) // 2
    plan = faults.crash_once(point, hit=hit)
    ts = _t_session(tmp_path)
    with faults.inject(plan):
        with pytest.raises(faults.SimulatedCrash):
            _run_tiered_stream(ts)
    assert plan.log, "the armed crash never fired"
    del ts
    rec = _t_recover(tmp_path)
    assert rec.recovery_info is not None and not rec.recovering
    _run_tiered_stream(rec, start=rec._op_counter)
    _assert_tiered_identical(_tiered_summary(rec), ctrl_summary,
                             f"tiered crash at {point}#{hit}")


def test_tiered_explicit_merge_is_journaled(tmp_path):
    ts = _t_session(tmp_path, seed=7)
    ids = ts.insert(_tvec(0)).result()
    ts.insert(_tvec(1))
    ts.merge()
    ts.delete(ids[:2])
    ts.merge()
    ts.insert(_tvec(2))
    ts.flush()
    want = _tiered_summary(ts, probe=False)
    del ts
    rec = _t_recover(tmp_path, seed=7)
    assert rec.recovery_info["step"] is None
    assert rec.recovery_info["n_replayed"] >= 6
    _assert_tiered_identical(_tiered_summary(rec, probe=False), want,
                             "explicit merge replay")


def test_tiered_fingerprint_guard(tmp_path):
    ts = _t_session(tmp_path, seed=0)
    ts.insert(_tvec(0))
    ts.flush()
    del ts
    with pytest.raises(ValueError, match="fingerprint"):
        _t_recover(tmp_path, seed=0, fresh_capacity=2 * FRESH)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tiered_checkpoint_crosses_packages(writer, tiered_control, tmp_path):
    """One package runs the tiered stream with checkpoints and is killed
    mid-drain; each package recovers a copy of the directory and finishes
    the stream: both tiers' arrays, the location table and the counters end
    equal, and the probe's ids too."""
    _, hits = tiered_control
    point = "merge-drain-step"
    hit = (hits[point] + 1) // 2
    src = tmp_path / "crashed"
    if writer == "jax":
        ts = JTiered(_t_jparams(), fresh_capacity=FRESH, seed=T_SEED,
                     checkpoint_dir=src)
        with jfaults.inject(jfaults.crash_once(point, hit=hit)):
            with pytest.raises(jfaults.SimulatedCrash):
                _run_tiered_stream(ts)
    else:
        ts = _t_session(src)
        with faults.inject(faults.crash_once(point, hit=hit)):
            with pytest.raises(faults.SimulatedCrash):
                _run_tiered_stream(ts)
    del ts
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "torch")
    jrec = JTiered.recover(tmp_path / "jax", _t_jparams(),
                           fresh_capacity=FRESH, seed=T_SEED)
    trec = _t_recover(tmp_path / "torch")
    assert trec.recovery_info["step"] == jrec.recovery_info["step"] is not None
    _run_tiered_stream(jrec, start=jrec._op_counter)
    _run_tiered_stream(trec, start=trec._op_counter)
    assert trec._loc == jrec._loc
    assert (trec._op_counter, trec._merge_counter, trec._merges_done,
            trec._next_ext) == (jrec._op_counter, jrec._merge_counter,
                                jrec._merges_done, jrec._next_ext)
    for t, j in ((trec._fresh, jrec._fresh), (trec._main, jrec._main)):
        assert t._op_counter == j._op_counter
        assert state_diff(j.state, t.state) == []
    for a, b in ((trec._fm, jrec._fm), (trec._mm, jrec._mm)):
        np.testing.assert_array_equal(a.ext, b.ext)
    q = _vecs(5, 4)
    ti, ts_ = trec.query(q, k=10).result()
    ji, js_ = jrec.query(q, k=10).result()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts_, js_, rtol=RTOL, atol=ATOL)
