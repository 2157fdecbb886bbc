"""The port's serving front end (``repro_torch.serving``,
``repro_torch.launch.serve``) on the CPU: the thirteen behaviours of
tests/test_serving.py held against the port, one ``BatchedServer`` step
equal to JAX's over the same carried-over state, ``quorum_merge`` equal to
JAX's on ties, and ``serve_online`` in its plain, tiered and
checkpoint-then-recover modes against JAX's ``serve_online``."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from helpers import small_params
from repro.core import IPGMIndex as JIndex
from repro.launch.serve import serve_online as jserve_online
from repro.serving.batcher import BatchedServer as JServer
from repro.serving.batcher import ServeConfig as JServeConfig
from repro.serving.batcher import quorum_merge as jquorum_merge
from repro_torch.core.consolidate import (
    consolidate,
    consolidate_reference,
    masked_fraction,
    maybe_consolidate,
)
from repro_torch.core.graph import NULL
from repro_torch.core.health import check_health
from repro_torch.core.maintenance import IPGMIndex
from repro_torch.launch.serve import serve_online
from repro_torch.serving import (
    BatchedServer,
    ServeConfig,
    ServerNotReadyError,
    ServerOverloadError,
    quorum_merge,
)
from torch_parity import int_vectors, torch_params, torch_state

ROOT = Path(__file__).resolve().parents[1]


def build_index(X, strategy="global", capacity=None) -> IPGMIndex:
    """tests/helpers.py's ``build_index`` on the port, on the CPU."""
    cap = capacity if capacity is not None else X.shape[0] + 64
    p = torch_params(small_params(capacity=cap, dim=X.shape[1]))
    idx = IPGMIndex(p, strategy=strategy, seed=0, device="cpu")
    idx.insert(X)
    return idx


# ---------------------------------------------------------------------------
# the thirteen behaviours of tests/test_serving.py
# ---------------------------------------------------------------------------

def test_batched_server_roundtrip():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 8)).astype(np.float32)
    idx = build_index(X, capacity=256)
    srv = BatchedServer(idx, ServeConfig(max_batch=16, k=5))
    rids = [srv.submit(X[i] + 0.01) for i in range(5)]
    out = srv.step()
    assert set(out) == set(rids)
    for i, rid in enumerate(rids):
        ids, scores = out[rid]
        assert ids.shape == (5,) and isinstance(ids, np.ndarray)
        assert i in ids.tolist(), "query ≈ a stored vector must find it"
    assert srv.stats["requests"] == 5 and srv.stats["batches"] == 1


class _FakeTime:
    """Deterministic clock that only advances when sleep() is called."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []
        self.on_sleep = None

    def clock(self):
        return self.now

    def sleep(self, dt):
        assert dt > 0, "sleep(<=0) would busy-spin"
        self.sleeps.append(dt)
        self.now += dt
        if self.on_sleep is not None:
            self.on_sleep(self.now)


def _server(cfg, ft):
    rng = np.random.default_rng(9)
    X = rng.normal(size=(60, 8)).astype(np.float32)
    idx = build_index(X, capacity=96)
    return BatchedServer(idx, cfg, clock=ft.clock, sleep=ft.sleep)


def test_drain_waits_for_late_arrivals():
    ft = _FakeTime()
    srv = _server(ServeConfig(max_batch=4, max_wait_s=0.005, k=3), ft)
    srv.submit(np.zeros(8, np.float32))

    def late_arrival(now):
        if now >= 0.002 and srv.stats.get("_arrived") is None:
            srv.stats["_arrived"] = True
            srv.submit(np.ones(8, np.float32))

    ft.on_sleep = late_arrival
    batch = srv._drain()
    assert len(batch) == 2, "mid-window arrival must join the batch"
    assert ft.now <= 0.005 + srv._POLL_S, "deadline overshot"


def test_drain_deadline_bounded_and_not_spinning():
    ft = _FakeTime()
    srv = _server(ServeConfig(max_batch=4, max_wait_s=0.005, k=3), ft)
    srv.submit(np.zeros(8, np.float32))
    batch = srv._drain()
    assert len(batch) == 1
    assert abs(ft.now - 0.005) < 1e-9
    assert 0 < len(ft.sleeps) <= int(0.005 / srv._POLL_S) + 2
    assert all(dt > 0 for dt in ft.sleeps)


def test_drain_idle_and_full_batch_skip_the_wait():
    ft = _FakeTime()
    srv = _server(ServeConfig(max_batch=2, max_wait_s=0.005, k=3), ft)
    assert srv._drain() == [] and not ft.sleeps, "idle queue must not block"
    srv.submit(np.zeros(8, np.float32))
    srv.submit(np.ones(8, np.float32))
    srv.submit(np.zeros(8, np.float32))
    assert len(srv._drain()) == 2 and not ft.sleeps, "full batch is immediate"
    assert len(srv._queue) == 1


def test_quorum_merge_degrades_gracefully():
    rng = np.random.default_rng(1)
    P, B, k = 8, 4, 10
    scores = rng.normal(size=(P, B, k)).astype(np.float32)
    scores.sort(axis=-1)
    scores = scores[..., ::-1]
    ids = rng.integers(0, 10_000, size=(P, B, k)).astype(np.int32)
    full_i, full_s = quorum_merge(ids, scores, np.ones(P, bool), k)
    arrived = np.ones(P, bool)
    arrived[[2, 5]] = False
    part_i, part_s = quorum_merge(ids, scores, arrived, k)
    assert (part_s <= full_s + 1e-6).all(), "partial merge can't beat full"
    alive_ids = set(ids[arrived].reshape(-1).tolist())
    got = part_i[part_i != NULL]
    assert set(got.tolist()) <= alive_ids
    overlap = np.mean([
        len(set(full_i[b]) & set(part_i[b])) / k for b in range(B)])
    assert overlap >= 0.6


def test_consolidate_removes_tombstones():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(150, 8)).astype(np.float32)
    idx = build_index(X, strategy="mask", capacity=256)
    idx.delete(np.arange(40))
    assert masked_fraction(idx.state) > 0.25
    assert consolidate(idx, strategy="global") == 40
    assert masked_fraction(idx.state) == 0.0
    st = idx.stats()
    assert st["n_alive"] == 110 and st["n_masked"] == 0
    assert check_health(idx.state) == []
    Q = rng.normal(size=(32, 8)).astype(np.float32)
    assert idx.recall(Q, k=5) > 0.6


def test_maybe_consolidate_threshold():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(100, 8)).astype(np.float32)
    idx = build_index(X, strategy="mask", capacity=160)
    idx.delete(np.arange(10))           # 10% masked < 20% threshold
    assert maybe_consolidate(idx, threshold=0.2) == 0
    idx.delete(np.arange(10, 25))       # now 25% masked
    assert maybe_consolidate(idx, threshold=0.2) == 25


def _masked_index(seed=8, n=120, n_del=35):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    idx = build_index(X, strategy="mask", capacity=192)
    idx.delete(rng.choice(n, size=n_del, replace=False))
    return idx, rng


def test_consolidate_reference_parity_pins_jitted_pass():
    """The revive-then-delete oracle and the chunked compaction pass agree
    on the alive and present sets, both healthy, with equivalent recall."""
    idx_ref, rng = _masked_index()
    idx_jit, _ = _masked_index()
    assert consolidate_reference(idx_ref, strategy="global") == 35
    assert consolidate(idx_jit, strategy="global") == 35
    for idx in (idx_ref, idx_jit):
        assert masked_fraction(idx.state) == 0.0
        assert check_health(idx.state) == []
    assert np.array_equal(idx_ref.state.alive.numpy(),
                          idx_jit.state.alive.numpy())
    assert np.array_equal(idx_ref.state.present.numpy(),
                          idx_jit.state.present.numpy())
    Q = rng.normal(size=(48, 8)).astype(np.float32)
    r_ref, r_jit = idx_ref.recall(Q, k=10), idx_jit.recall(Q, k=10)
    assert abs(r_ref - r_jit) < 0.1, (r_ref, r_jit)
    assert min(r_ref, r_jit) > 0.6


def test_consolidate_reference_is_exception_safe():
    idx, _ = _masked_index()
    alive_before = idx.state.alive.numpy().copy()
    present_before = idx.state.present.numpy().copy()
    real_delete = idx.session.delete

    def boom(*a, **k):
        raise RuntimeError("injected repair failure")

    idx.session.delete = boom
    with pytest.raises(RuntimeError, match="injected"):
        consolidate_reference(idx, strategy="global")
    idx.session.delete = real_delete
    assert idx.strategy == "mask", "strategy must roll back"
    assert np.array_equal(idx.state.alive.numpy(), alive_before)
    assert np.array_equal(idx.state.present.numpy(), present_before)
    assert check_health(idx.state) == []
    assert consolidate(idx, strategy="global") == 35
    assert masked_fraction(idx.state) == 0.0


def test_bounded_queue_sheds_overload():
    ft = _FakeTime()
    srv = _server(ServeConfig(max_batch=4, k=3, max_queue=3), ft)
    for _ in range(3):
        srv.submit(np.zeros(8, np.float32))
    with pytest.raises(ServerOverloadError):
        srv.submit(np.zeros(8, np.float32))
    assert srv.stats["shed_overload"] == 1
    assert len(srv._queue) == 3, "the shed request must not occupy a slot"
    assert len(srv.step()) == 3
    srv.submit(np.zeros(8, np.float32))
    assert srv.stats["shed_overload"] == 1


def test_per_request_deadline_expires_stale_entries():
    ft = _FakeTime()
    srv = _server(
        ServeConfig(max_batch=4, max_wait_s=0.0, k=3, deadline_s=0.01), ft)
    stale = srv.submit(np.zeros(8, np.float32))
    ft.now += 0.02
    fresh = srv.submit(np.ones(8, np.float32))
    out = srv.step()
    assert fresh in out and stale not in out
    assert srv.failed[stale] == "deadline"
    assert srv.stats["shed_deadline"] == 1
    assert out[fresh][0].shape == (3,)


def test_readiness_gate_rejects_until_recovered():
    ft = _FakeTime()
    srv = _server(ServeConfig(max_batch=4, k=3), ft)
    assert srv.ready
    srv.set_ready(False)
    with pytest.raises(ServerNotReadyError):
        srv.submit(np.zeros(8, np.float32))
    srv.set_ready(True)
    srv.submit(np.zeros(8, np.float32))
    assert len(srv.step()) == 1


def test_readiness_tracks_session_recovery_flag():
    ft = _FakeTime()
    srv = _server(ServeConfig(max_batch=4, k=3), ft)
    srv.session.recovering = True
    assert not srv.ready
    with pytest.raises(ServerNotReadyError):
        srv.submit(np.zeros(8, np.float32))
    srv.session.recovering = False
    assert srv.ready


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_server_step_equals_jax_over_carried_state():
    """A JAX-built index carried to the port: the same requests give the
    same ids and scores (integer rows), a partial batch padded to
    ``max_batch`` in both."""
    rng = np.random.default_rng(4)
    p = small_params(capacity=160)
    jidx = JIndex(p, strategy="global", seed=2)
    jidx.insert(int_vectors(rng, 120, 8))
    tidx = IPGMIndex(torch_params(p), strategy="global", seed=2,
                     state=torch_state(jidx.state))
    tidx.session._op_counter = jidx.session._op_counter
    jsrv = JServer(jidx, JServeConfig(max_batch=16, k=6, max_wait_s=0.0))
    tsrv = BatchedServer(tidx, ServeConfig(max_batch=16, k=6, max_wait_s=0.0))
    for n in (11, 16):
        Q = int_vectors(rng, n, 8)
        for srv in (jsrv, tsrv):
            for q in Q:
                srv.submit(q)
        want, got = jsrv.step(), tsrv.step()
        assert want.keys() == got.keys()
        for rid in want:
            assert np.array_equal(got[rid][0], np.asarray(want[rid][0]))
            assert np.array_equal(got[rid][1], np.asarray(want[rid][1]))
    assert tsrv.stats == jsrv.stats


@pytest.mark.parametrize("seed", [0, 1])
def test_quorum_merge_equals_jax_on_ties(seed):
    rng = np.random.default_rng(seed)
    P, B, k = 5, 6, 7
    scores = rng.integers(-3, 3, size=(P, B, k)).astype(np.float32)
    scores[0, 0, :3] = -np.inf
    ids = rng.integers(0, 50, size=(P, B, k)).astype(np.int32)
    arrived = rng.random(P) < 0.7
    arrived[0] = True
    for kk in (1, k, P * k + 2):
        gi, gs = quorum_merge(ids, scores, arrived, min(kk, P * k))
        wi, ws = jquorum_merge(ids, scores, arrived, min(kk, P * k))
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)


SERVE_KW = dict(n_base=300, n_steps=2, batch_size=30, n_queries=64)


def _comparable(rec):
    """A record without its timings; recall@10 is compared apart (the two
    frameworks sum the per-query fractions in another order)."""
    return {k: v for k, v in rec.items()
            if not k.endswith("_s") and k not in ("qps", "update_ops_per_s",
                                                  "recall@10")}


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _comparable(g) == _comparable(w)
        assert abs(g["recall@10"] - w["recall@10"]) <= 1e-6


@pytest.mark.parametrize("tiered", [False, True])
def test_serve_online_equals_jax(tiered):
    got = serve_online(**SERVE_KW, tiered=tiered, device="cpu")
    want = jserve_online(**SERVE_KW, tiered=tiered)
    _assert_records_equal(got, want)
    assert got[-1]["n_alive"] == 300


def test_serve_online_checkpoint_then_recover_equals_jax(tmp_path, capsys):
    """A checkpointed run, then ``--recover`` from its directory: the
    recovered step and every record equal JAX's."""
    records, steps = [], []
    for name, fn, extra in (("torch", serve_online, {"device": "cpu"}),
                            ("jax", jserve_online, {})):
        d = str(tmp_path / name)
        fn(**SERVE_KW, checkpoint_dir=d, checkpoint_every=1, **extra)
        capsys.readouterr()
        records.append(fn(**SERVE_KW, checkpoint_dir=d, recover=True,
                          **extra))
        steps.append(re.search(r"recovered from .*: step=(\d+)",
                               capsys.readouterr().out).group(1))
    assert steps == ["1", "1"]
    _assert_records_equal(*records)


def test_serve_cli_runs_on_cpu_and_imports_no_jax(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu`` runs, and neither
    it nor ``repro_torch.serving`` loads jax or a ``repro`` module."""
    code = (
        "import sys, runpy\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "sys.argv = ['serve', '--device', 'cpu', '--scale', '120',\n"
        "            '--steps', '1']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "step 0: recall@10=" in out.stdout
