"""The port's durability against the JAX package's (tests/test_recovery.py).

One deterministic mixed stream (inserts, deletes, queries, flushes and
saves, with auto-consolidation, auto-growth and auto-refine armed) runs
uninterrupted on the port to give the control state and the hit count of
every crash point; the control equals the JAX control. Then every
session-tier crash point is killed at its middle hit, recovered with
``Session.recover`` and resumed, and must end bit-identical to the control.
Checkpoints and journals written by either package recover in the other and
end in byte-equal states.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro.core import IndexParams, MaintenanceParams, SearchParams
from repro.core import Session as JSession
from repro.core import ops as jops
from repro.core.session import params_fingerprint as jfingerprint
from repro.testing import faults as jfaults
from repro_torch.checkpoint import journal as tjournal
from repro_torch.core import Session as TSession
from repro_torch.core import delete as tdelete
from repro_torch.core.maintenance import IPGMIndex
from repro_torch.core import maint as tmaint
from repro_torch.core import ops as ops_mod
from repro_torch.core.graph import NULL
from repro_torch.core.session import params_fingerprint
from repro_torch.testing import faults
from torch_parity import state_diff, torch_params

CAP = 96
DIM = 8
CHUNK = 16
N_OPS = 60
FLUSH_EVERY = 7
SAVE_EVERY = 20
SCHEDULE = "iidiq"


def _jparams(**maintenance_kw):
    # every session-tier maintenance op is armed so that the stream reaches
    # every registered crash point (tests/test_recovery.py's settings)
    mkw = dict(strategy="mask", insert_chunk=CHUNK, delete_chunk=CHUNK,
               consolidate_threshold=0.3, max_capacity=4 * CAP,
               growth_factor=2.0, refine_threshold=30, refine_chunk=8)
    mkw.update(maintenance_kw)
    return IndexParams(
        capacity=CAP, dim=DIM, d_out=6,
        search=SearchParams(pool_size=16, max_steps=48, num_starts=2),
        maintenance=MaintenanceParams(**mkw))


def _params(**maintenance_kw):
    return torch_params(_jparams(**maintenance_kw))


def _session(directory=None, seed=3, **kw):
    return TSession(_params(**kw), seed=seed, device="cpu",
                    checkpoint_dir=directory)


def _recover(directory, seed=3, **kw):
    return TSession.recover(directory, _params(**kw), seed=seed, device="cpu")


def _vec(t):
    return np.random.default_rng(1000 + t).normal(size=(5, DIM)).astype(
        np.float32)


def _del_ids(t):
    return np.random.default_rng(2000 + t).integers(
        0, CAP, size=3).astype(np.int32)


def _probe_q(seed=5):
    return np.random.default_rng(seed).normal(size=(4, DIM)).astype(
        np.float32)


def _events(sess, t):
    if (t + 1) % FLUSH_EVERY == 0:
        sess.flush()
    if (t + 1) % SAVE_EVERY == 0:
        sess.save(t + 1)


def _run_stream(sess, start=0):
    """Ops ``start..N_OPS-1`` (either package's Session); a resumed run
    first re-runs the events of op ``start-1``, which the kill may have
    cut (both are idempotent against the recovered state)."""
    if start > 0:
        _events(sess, start - 1)
    for t in range(start, N_OPS):
        kind = SCHEDULE[t % len(SCHEDULE)]
        if kind == "i":
            sess.insert(_vec(t))
        elif kind == "d":
            sess.delete(_del_ids(t))
        else:
            sess.query(_vec(t)[:2])
        _events(sess, t)
    sess.flush()
    return sess


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _state_summary(sess, probe=True):
    """Bit-exactness snapshot; ``probe=False`` where want and got straddle
    a recovery (a probe query is journaled and advances the key chain)."""
    st = sess.state
    out = {
        "arrays": {f: _np(getattr(st, f)) for f in
                   ("adj", "vectors", "codes", "scales", "alive", "present",
                    "masked")},
        "capacity": st.capacity,
        "op_counter": sess._op_counter,
        "consolidate_counter": sess._consolidate_counter,
        "refine_counter": sess._refine_counter,
        "refine_wear": sess._refine_wear,
    }
    if probe:
        ids, scores = sess.query(_probe_q(), k=10).result()
        out["probe"] = (np.asarray(ids), np.asarray(scores))
    return out


def _assert_bit_identical(a, b, label):
    for key in ("capacity", "op_counter", "consolidate_counter",
                "refine_counter", "refine_wear"):
        assert a[key] == b[key], f"{label}: {key}"
    for f, arr in a["arrays"].items():
        np.testing.assert_array_equal(
            arr, b["arrays"][f], err_msg=f"{label}: state.{f} diverged")
    if a.get("probe") is not None and b.get("probe") is not None:
        np.testing.assert_array_equal(a["probe"][0], b["probe"][0],
                                      err_msg=f"{label}: probe ids")
        np.testing.assert_array_equal(a["probe"][1], b["probe"][1],
                                      err_msg=f"{label}: probe scores")


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """The port's uninterrupted run: (summary, crash-point hit counts)."""
    d = tmp_path_factory.mktemp("ctrl")
    plan = faults.FaultPlan()      # crashes nothing, counts everything
    with faults.inject(plan):
        sess = _run_stream(_session(d))
    return _state_summary(sess), dict(plan.hits)


@pytest.fixture(scope="module")
def jax_control(tmp_path_factory):
    d = tmp_path_factory.mktemp("jctrl")
    plan = jfaults.FaultPlan()
    with jfaults.inject(plan):
        sess = _run_stream(JSession(_jparams(), seed=3, checkpoint_dir=d))
    return _state_summary(sess), dict(plan.hits)


def test_crash_point_registry_equals_jax():
    for name in ("SESSION_CRASH_POINTS", "SHARDED_CRASH_POINTS",
                 "TIERED_CRASH_POINTS", "CRASH_POINTS"):
        assert getattr(faults, name) == getattr(jfaults, name), name
    from repro.core import maint as jmaint
    for name in ("CONSOLIDATE", "GROW", "REFINE", "MERGE"):
        t, j = getattr(tmaint, name), getattr(jmaint, name)
        assert (t.extra_key, t.state_attrs, t.crash_points,
                t.sharded_crash_points) == (
            j.extra_key, j.state_attrs, j.crash_points,
            j.sharded_crash_points), name
    assert ops_mod.JR_NAMES == jops.JR_NAMES
    for seed in (0, 123, 124):
        assert faults.random_plan(seed).crashes == jfaults.random_plan(
            seed).crashes
    with pytest.raises(ValueError):
        faults.crash_point("not-a-registered-point")
    with pytest.raises(ValueError):
        faults.crash_once("also-not-registered")
    with faults.inject(faults.FaultPlan()):
        with pytest.raises(RuntimeError):
            with faults.inject(faults.FaultPlan()):
                pass


def test_control_equals_jax_control(control, jax_control):
    """Same stream, same seeds: the port's final state, counters, probe ids
    and the hit count of every crash point equal JAX's; the probe scores
    agree within the Pallas kernels' tolerance (rtol 1e-4, atol 1e-3 —
    torch and XLA sum the Gaussian dot products in other orders)."""
    got, hits = control
    want, jhits = jax_control
    _assert_bit_identical({**got, "probe": None}, {**want, "probe": None},
                          "port control vs JAX control")
    np.testing.assert_array_equal(got["probe"][0], want["probe"][0])
    np.testing.assert_allclose(got["probe"][1], want["probe"][1],
                               rtol=1e-4, atol=1e-3)
    assert hits == jhits


def test_stream_covers_every_session_crash_point(control):
    _, hits = control
    missing = [p for p in faults.SESSION_CRASH_POINTS if not hits.get(p)]
    assert not missing, f"stream never reached crash points: {missing}"


@pytest.mark.parametrize("point", faults.SESSION_CRASH_POINTS)
def test_kill_and_recover_bit_exact(point, control, tmp_path):
    ctrl_summary, hits = control
    hit = (hits[point] + 1) // 2
    plan = faults.crash_once(point, hit=hit)
    sess = _session(tmp_path)
    with faults.inject(plan):
        with pytest.raises(faults.SimulatedCrash):
            _run_stream(sess)
    assert plan.log, "the armed crash never fired"
    del sess  # device state dies with the process; the disk is what is left
    rec = _recover(tmp_path)
    assert rec.recovery_info is not None and not rec.recovering
    start = rec._op_counter
    assert 0 <= start <= N_OPS
    _run_stream(rec, start=start)
    _assert_bit_identical(_state_summary(rec), ctrl_summary,
                          f"crash at {point}#{hit}")


def test_double_crash_recover(control, tmp_path):
    """A second kill before the next checkpoint recovers from the same disk
    state: replayed records stay in the journal until a save."""
    ctrl_summary, hits = control
    plan = faults.crash_once("post-journal-append",
                             hit=(hits["post-journal-append"] + 1) // 2)
    sess = _session(tmp_path)
    with faults.inject(plan):
        with pytest.raises(faults.SimulatedCrash):
            _run_stream(sess)
    rec1 = _recover(tmp_path)
    with faults.inject(faults.crash_once("post-journal-append", hit=4)):
        with pytest.raises(faults.SimulatedCrash):
            _run_stream(rec1, start=rec1._op_counter)
    del rec1
    rec2 = _recover(tmp_path)
    _run_stream(rec2, start=rec2._op_counter)
    _assert_bit_identical(_state_summary(rec2), ctrl_summary, "double crash")


# ---------------------------------------------------------------------------
# harness and degradation details
# ---------------------------------------------------------------------------

def test_explicit_consolidate_and_grow_are_journaled(tmp_path):
    sess = _session(tmp_path, seed=1, consolidate_threshold=None)
    ids = sess.insert(_vec(0)).result()
    sess.delete(ids[:3])
    sess.consolidate()
    sess.grow(2 * CAP)
    sess.insert(_vec(1))
    sess.flush()
    want = _state_summary(sess, probe=False)
    del sess
    rec = _recover(tmp_path, seed=1, consolidate_threshold=None)
    info = rec.recovery_info
    assert info["step"] is None and info["n_replayed"] >= 5
    _assert_bit_identical(_state_summary(rec, probe=False), want,
                          "explicit maintenance")


def test_explicit_refine_is_journaled(tmp_path):
    kw = dict(consolidate_threshold=None, refine_threshold=None)
    sess = _session(tmp_path, seed=1, **kw)
    sess.insert(_vec(0))
    sess.insert(_vec(1))
    sess.delete(sess.insert(_vec(2)).result()[:3])
    assert sess.refine(n=10, chunk=4) == 10
    sess.insert(_vec(3))
    sess.flush()
    want = _state_summary(sess, probe=False)
    assert want["refine_counter"] == 3  # ceil(10/4) key draws
    del sess
    rec = _recover(tmp_path, seed=1, **kw)
    assert rec.recovery_info["step"] is None
    _assert_bit_identical(_state_summary(rec, probe=False), want,
                          "explicit refine replay")


def test_literal_code_journal_replays_through_registry(tmp_path):
    """A journal of literal record codes (JR_META=16, JR_FLUSH=17,
    JR_CONSOLIDATE=18, JR_GROW=19), as the JAX test writes it, replays
    bit-exactly through the registry."""
    kw = dict(consolidate_threshold=None, refine_threshold=None)
    p = _params(**kw)
    sess = TSession(p, seed=9, device="cpu")
    sess.insert(_vec(30))
    sess.delete(np.asarray([0, 2, 4], np.int32))
    sess.flush()
    sess.consolidate()
    sess.grow(2 * CAP)
    sess.insert(_vec(31))
    sess.flush()
    want = _state_summary(sess, probe=False)
    j = tjournal.OpJournal(tmp_path / "journal.bin", fsync="always")
    j.append(16, seq=0, cseq=0,
             aux={"fingerprint": params_fingerprint(p, "mask")})
    j.append(ops_mod.OP_INSERT, seq=0, cseq=0, payload=_vec(30),
             aux={"chunk": None})
    j.append(ops_mod.OP_DELETE, seq=1, cseq=0,
             ids=np.asarray([0, 2, 4], np.int32), aux={"chunk": None})
    j.append(17, seq=2, cseq=0)
    j.append(18, seq=2, cseq=0, aux={"strategy": None, "chunk": None})
    j.append(19, seq=2, cseq=1, aux={"new_capacity": 2 * CAP})
    j.append(ops_mod.OP_INSERT, seq=2, cseq=1, payload=_vec(31),
             aux={"chunk": None})
    j.append(17, seq=3, cseq=1)
    j.close()
    rec = _recover(tmp_path, seed=9, **kw)
    assert rec.recovery_info["step"] is None
    assert rec.recovery_info["n_replayed"] == 7
    _assert_bit_identical(_state_summary(rec, probe=False), want,
                          "literal-code journal")


def test_recover_without_checkpoint_replays_from_empty(tmp_path):
    sess = _session(tmp_path, seed=2)
    sess.insert(_vec(3))
    sess.query(_vec(4)[:2])
    sess.flush()
    want = _state_summary(sess, probe=False)
    del sess
    rec = _recover(tmp_path, seed=2)
    assert rec.recovery_info["step"] is None
    _assert_bit_identical(_state_summary(rec, probe=False), want,
                          "no-checkpoint recover")


def test_recover_falls_back_past_corrupt_checkpoint(tmp_path):
    sess = _session(tmp_path, seed=4)
    sess.insert(_vec(10))
    sess.save(1)
    sess.insert(_vec(11))
    sess.save(2)
    sess.insert(_vec(12))
    sess.flush()
    del sess
    shard = tmp_path / "step_000000000002" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:100])
    rec = _recover(tmp_path, seed=4)
    assert rec.recovery_info["step"] == 1
    # the ops between save(1) and save(2) went with the corrupt step; the
    # journaled suffix after save(2) is a dead timeline, counted, not applied
    assert rec._op_counter == 1
    assert rec.recovery_info["n_unreplayable"] == 2
    rec.insert(_vec(13))
    rec.flush()
    del rec
    rec2 = _recover(tmp_path, seed=4)
    assert rec2.recovery_info["n_unreplayable"] == 0
    assert rec2._op_counter == 2


def test_fingerprint_and_capacity_guards(tmp_path):
    sess = _session(tmp_path, seed=0)
    sess.insert(_vec(0))
    sess.flush()
    del sess
    with pytest.raises(ValueError, match="fingerprint"):
        _recover(tmp_path, seed=0, consolidate_threshold=0.5)
    sess = _session(tmp_path, seed=0)
    sess.insert(_vec(0))
    sess.save(1)
    with pytest.raises(ValueError, match="fingerprint"):
        TSession(_params(consolidate_threshold=0.5), seed=0, device="cpu",
                 checkpoint_dir=tmp_path).restore()
    big = dataclasses.replace(_params(), capacity=2 * CAP)
    with pytest.raises(ValueError, match="capacity"):
        TSession(big, seed=0, device="cpu", checkpoint_dir=tmp_path).restore()


def test_transient_flush_failures_retry_with_backoff():
    sess = TSession(_params(), seed=0, device="cpu", flush_retries=3,
                    flush_backoff_s=1e-4)
    sess.insert(_vec(0))
    with faults.inject(faults.transient("flush", count=2)):
        sess.flush()
    assert sess.timers.n_retries == 2
    sess.insert(_vec(1))
    with faults.inject(faults.transient("flush", count=10)):
        with pytest.raises(faults.TransientDispatchError):
            sess.flush()


def test_rejection_replays_identically(tmp_path):
    sess = _session(tmp_path, seed=6)
    v = _vec(21)
    v[0, 0] = np.nan
    ids = sess.insert(v).result()
    assert ids[0] == NULL and sess.timers.n_rejected == 1
    sess.insert(_vec(22))
    sess.flush()
    want = _state_summary(sess, probe=False)
    del sess
    rec = _recover(tmp_path, seed=6)
    assert rec.timers.n_rejected == 1
    _assert_bit_identical(_state_summary(rec, probe=False), want,
                          "rejection replay")


def test_only_reference_strategies_stay_unported(tmp_path):
    """A port session given a checkpoint directory journals, saves and
    restores. Every strategy is ported: each reference strategy's
    fingerprint equals JAX's (so either package reads the other's
    checkpoints), and a ``local_reference`` session recovers bit-exactly,
    replaying its deletes through the sequential applier."""
    sess = _session(tmp_path)
    recs, _, _ = tjournal.scan_file(tmp_path / "journal.bin")
    assert [r.code for r in recs] == [ops_mod.JR_META]
    sess.insert(_vec(0))
    assert sess.save(1).name == "step_000000000001"
    assert sess.restore() == 1
    for strategy in tdelete.REFERENCE_STRATEGIES:
        assert params_fingerprint(_params(), strategy) == (
            jfingerprint(_jparams(), strategy))
    p = _params(strategy="local_reference")
    ref = TSession(p, seed=3, device="cpu", checkpoint_dir=tmp_path / "ref")
    for t in range(8):
        ref.insert(_vec(t))
    ref.save(1)
    for t in range(8, 12):
        ref.insert(_vec(t))
        ref.delete(_del_ids(t))
    ref.flush()
    want = _state_summary(ref, probe=False)
    del ref
    rec = TSession.recover(tmp_path / "ref", p, seed=3, device="cpu")
    assert rec.strategy == "local_reference"
    assert rec.recovery_info["n_replayed"] > 0
    _assert_bit_identical(_state_summary(rec, probe=False), want,
                          "local_reference replay")
    index = IPGMIndex(_params(), device="cpu", checkpoint_dir=tmp_path / "ix")
    index.insert(_vec(1))
    recs, _, _ = tjournal.scan_file(tmp_path / "ix" / "journal.bin")
    assert [r.code for r in recs] == [ops_mod.JR_META, ops_mod.OP_INSERT,
                                      ops_mod.JR_FLUSH]


# ---------------------------------------------------------------------------
# checkpoints and journals across packages
# ---------------------------------------------------------------------------

def _final(sess):
    """Every GraphState array and the counters, after the stream ends."""
    sess.flush()
    return sess.state, (sess.state.capacity, sess._op_counter,
                        sess._consolidate_counter, sess._refine_counter,
                        sess._refine_wear)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("point", ["post-journal-append", "refine-step",
                                   "mid-checkpoint-save"])
def test_crashed_directory_recovers_in_both_packages(writer, point, control,
                                                     tmp_path):
    """One package writes a checkpoint and a journal and is killed at
    ``point``; each package recovers a copy of the directory and runs the
    stream to its end: the two final states are byte-equal."""
    _, hits = control
    hit = (hits[point] + 1) // 2
    src = tmp_path / "crashed"
    if writer == "jax":
        sess = JSession(_jparams(), seed=3, checkpoint_dir=src)
        with jfaults.inject(jfaults.crash_once(point, hit=hit)):
            with pytest.raises(jfaults.SimulatedCrash):
                _run_stream(sess)
    else:
        sess = _session(src)
        with faults.inject(faults.crash_once(point, hit=hit)):
            with pytest.raises(faults.SimulatedCrash):
                _run_stream(sess)
    del sess
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "torch")
    jrec = JSession.recover(tmp_path / "jax", _jparams(), seed=3)
    trec = _recover(tmp_path / "torch")
    assert trec.recovery_info["step"] == jrec.recovery_info["step"]
    for key in ("n_replayed", "n_skipped", "n_unreplayable", "dropped_bytes"):
        assert trec.recovery_info[key] == jrec.recovery_info[key], key
    assert trec._op_counter == jrec._op_counter
    jstate, jcounters = _final(_run_stream(jrec, start=jrec._op_counter))
    tstate, tcounters = _final(_run_stream(trec, start=trec._op_counter))
    assert tcounters == jcounters
    assert state_diff(jstate, tstate) == []
