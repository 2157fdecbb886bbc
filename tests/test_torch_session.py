"""The port's ``Session`` against the JAX ``Session`` on one mixed stream,
the vectorised health check, and the import boundary of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import IndexParams, MaintenanceParams, SearchParams
from repro.core import Session as JSession
from repro.core.session import params_fingerprint as jfingerprint
from repro.data.synthetic import make_dataset as jmake_dataset
from repro_torch.core import Session as TSession
from repro_torch.core.health import check_health
from repro_torch.core.session import params_fingerprint as tfingerprint
from repro_torch.data.synthetic import make_dataset as tmake_dataset
from torch_parity import int_vectors, state_diff, torch_params, torch_state

ROOT = Path(__file__).resolve().parents[1]


def _params(strategy):
    return IndexParams(
        capacity=192, dim=8, d_out=5,
        search=SearchParams(pool_size=12, max_steps=36, num_starts=2),
        maintenance=MaintenanceParams(strategy=strategy, insert_chunk=24,
                                      delete_chunk=24))


def _drive(sess, rng):
    """A mixed stream: ragged chunks, a NaN row, duplicate and invalid
    delete ids, flushes between rounds. Returns every result."""
    out = {}
    first = int_vectors(rng, 100, 8)
    out["ins0"] = sess.insert(first).result()
    out["q0"] = sess.query(int_vectors(rng, 30, 8), k=6).result()
    more = int_vectors(rng, 20, 8)
    more[4, 2] = np.nan                                  # rejected at dispatch
    out["ins1"] = sess.insert(more, chunk=7).result()
    alive = np.concatenate([out["ins0"], out["ins1"][out["ins1"] >= 0]])
    dels = rng.choice(alive, 25, replace=False).astype(np.int32)
    sess.delete(np.concatenate([dels, [dels[0], -1]]).astype(np.int32))
    sess.flush()
    out["q1"] = sess.query(int_vectors(rng, 17, 8)).result()
    out["ins2"] = sess.insert(int_vectors(rng, 40, 8)).result()
    sess.delete(rng.choice(out["ins2"], 10, replace=False).astype(np.int32))
    sess.flush()
    Q = int_vectors(rng, 12, 8)
    out["recall"] = sess.recall(Q, 5)
    out["gt"] = tuple(np.asarray(a) if not torch.is_tensor(a) else a.numpy()
                      for a in sess.ground_truth(Q, 5))
    out["rejected"] = sess.timers.n_rejected
    return out


def test_mixed_stream_matches_jax_session():
    """Acked ids, query ids and scores, ground truth and final state are
    byte-equal; recall is equal up to the float32 rounding of its mean
    (the two frameworks sum the per-query fractions in another order)."""
    p = _params("global")
    js = JSession(p, seed=3)
    ts = TSession(torch_params(p), seed=3, device="cpu")
    want = _drive(js, np.random.default_rng(9))
    got = _drive(ts, np.random.default_rng(9))
    assert want.keys() == got.keys()
    for name in want:
        w, g = want[name], got[name]
        if isinstance(w, tuple):
            for a, b in zip(w, g):
                assert np.array_equal(np.asarray(a), np.asarray(b)), name
        elif name == "recall":
            assert abs(w - g) <= 1e-6
        else:
            assert np.array_equal(np.asarray(w), np.asarray(g)), name
    js.flush()
    assert state_diff(js.state, ts.state) == []
    assert check_health(ts.state) == []


def test_health_check_flags_corruption():
    p = _params("global")
    ts = TSession(torch_params(p), seed=0, device="cpu")
    ts.insert(int_vectors(np.random.default_rng(0), 60, 8)).result()
    st = ts.state
    assert check_health(st) == []
    u = int(torch.nonzero(st.adj[:, 0] >= 0)[0])
    v = int(st.adj[u, 0])
    st.radj[v][st.radj[v] == u] = -1                     # break I1
    st.codes[u, 0] += 1                                  # break I5
    st.size += 1
    errs = check_health(st)
    assert any("I1" in e for e in errs) and any("I5" in e for e in errs)
    assert any("size" in e for e in errs)


def test_params_fingerprint_and_dataset_match():
    for strategy in ("global", "mask"):
        p = _params(strategy)
        assert tfingerprint(torch_params(p), strategy) == jfingerprint(p, strategy)
    for name in ("sift", "glove200"):
        assert np.array_equal(tmake_dataset(name, 300, seed=4),
                              jmake_dataset(name, 300, seed=4))


def test_session_device_and_unported_features(monkeypatch, tmp_path):
    """A ``local_reference`` session runs: the sequential oracle strategy
    takes the mixed stream to JAX's results and state. A checkpoint
    directory arms the journal; a journal needs a directory."""
    p = torch_params(_params("global"))
    TSession(p, checkpoint_dir=tmp_path, device="cpu").save(0)
    assert (tmp_path / "journal.bin").exists()
    assert (tmp_path / "step_000000000000" / "manifest.json").exists()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TSession(p, journal=True, device="cpu")
    jp = _params("local_reference")
    js = JSession(jp, seed=4)
    ts = TSession(torch_params(jp), seed=4, device="cpu")
    want = _drive(js, np.random.default_rng(5))
    got = _drive(ts, np.random.default_rng(5))
    for name in ("ins0", "q0", "ins1", "q1", "ins2"):
        w, g = want[name], got[name]
        pairs = zip(w, g) if isinstance(w, tuple) else [(w, g)]
        assert all(np.array_equal(a, b) for a, b in pairs), name
    js.flush()
    assert state_diff(js.state, ts.state) == []
    assert check_health(ts.state) == []
    for strategy in ("local", "rwalk"):
        assert TSession(p, strategy=strategy, device="cpu").consolidate() == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSession(p)                                      # default is cuda


def test_carried_state_continues_like_jax():
    """A JAX-built state handed to the port's session continues the stream
    exactly as the JAX session does from the same state."""
    p = _params("global")
    rng = np.random.default_rng(1)
    js = JSession(p, seed=5)
    js.insert(int_vectors(rng, 80, 8))
    js.flush()
    ts = TSession(torch_params(p), seed=5, state=torch_state(js.state))
    ts._op_counter = js._op_counter
    Q = int_vectors(rng, 10, 8)
    V = int_vectors(rng, 10, 8)
    wq = js.query(Q, k=5).result()
    gq = ts.query(Q, k=5).result()
    assert all(np.array_equal(a, b) for a, b in zip(wq, gq))
    assert np.array_equal(js.insert(V).result(), ts.insert(V).result())
    js.flush()
    assert state_diff(js.state, ts.state) == []


def test_import_boundary():
    """Every module of repro_torch imports without jax or any repro module,
    and chip_smoke.py imports neither."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n.startswith('jaxlib') or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
