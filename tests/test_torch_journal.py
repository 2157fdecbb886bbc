"""The port's write-ahead journal and checkpoint manager against the JAX
package's: the same unit checks, byte-identical records both ways, and
checkpoint manifests whose keys, leaf count and dtypes equal JAX's."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import journal as jjournal
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import IndexParams, MaintenanceParams, SearchParams
from repro.core import Session as JSession
from repro.core import TieredSession as JTiered
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.checkpoint import journal as tjournal
from repro_torch.core import Session as TSession
from repro_torch.core import TieredSession as TTiered
from repro_torch.core import ops as ops_mod
from torch_parity import torch_params


# ---------------------------------------------------------------------------
# journal unit tests (the port's counterparts of tests/test_recovery.py)
# ---------------------------------------------------------------------------

def test_journal_roundtrip(tmp_path):
    path = tmp_path / "j.bin"
    j = tjournal.OpJournal(path, fsync="always")
    pay = np.arange(12, dtype=np.float32).reshape(3, 4)
    ids = np.asarray([7, 9], np.int32)
    j.append(ops_mod.OP_INSERT, seq=0, payload=pay, aux={"chunk": 8})
    j.append(ops_mod.OP_DELETE, seq=1, cseq=2, ids=ids, aux={"chunk": 4})
    j.append(ops_mod.JR_FLUSH, seq=2)
    j.close()
    recs, valid, dropped = tjournal.scan_file(path)
    assert dropped == 0 and valid == path.stat().st_size
    assert [r.code for r in recs] == [
        ops_mod.OP_INSERT, ops_mod.OP_DELETE, ops_mod.JR_FLUSH]
    assert [r.name for r in recs] == ["insert", "delete", "flush"]
    np.testing.assert_array_equal(recs[0].payload, pay)
    assert recs[0].aux == {"chunk": 8} and recs[0].seq == 0
    np.testing.assert_array_equal(recs[1].ids, ids)
    assert recs[1].cseq == 2
    assert recs[2].payload is None and recs[2].ids is None


def test_journal_torn_tail_dropped(tmp_path):
    path = tmp_path / "j.bin"
    j = tjournal.OpJournal(path, fsync="never")
    for s in range(5):
        j.append(ops_mod.OP_QUERY, seq=s, aux={"n": 3})
    j.sync()
    whole = path.stat().st_size
    j.close()
    with open(path, "r+b") as f:          # a kill during the last append
        f.truncate(whole - 5)
    recs, valid, dropped = tjournal.scan_file(path)
    assert [r.seq for r in recs] == [0, 1, 2, 3]
    assert dropped > 0
    j2 = tjournal.OpJournal(path)
    recs2, dropped2 = j2.repair()
    assert dropped2 == dropped and len(recs2) == 4
    assert path.stat().st_size == valid
    j2.append(ops_mod.OP_QUERY, seq=4, aux={"n": 1})
    j2.sync()
    recs3, _, d3 = tjournal.scan_file(path)
    assert d3 == 0 and [r.seq for r in recs3] == [0, 1, 2, 3, 4]


def test_journal_corrupt_record_ends_prefix(tmp_path):
    path = tmp_path / "j.bin"
    j = tjournal.OpJournal(path, fsync="never")
    offsets = [0]
    for s in range(4):
        j.append(ops_mod.OP_QUERY, seq=s, aux={"n": 1})
        j.sync()
        offsets.append(path.stat().st_size)
    j.close()
    data = bytearray(path.read_bytes())
    data[offsets[2] + 14] ^= 0xFF         # rot inside record 2's body
    path.write_bytes(bytes(data))
    recs, valid, dropped = tjournal.scan_file(path)
    assert [r.seq for r in recs] == [0, 1]
    assert valid == offsets[2] and dropped == len(data) - offsets[2]


def test_journal_truncate_and_policies(tmp_path):
    with pytest.raises(ValueError):
        tjournal.OpJournal(tmp_path / "x.bin", fsync="sometimes")
    j = tjournal.OpJournal(tmp_path / "j.bin", fsync="flush")
    j.append(ops_mod.OP_QUERY, seq=0, aux={"n": 1})
    j.truncate()
    assert (tmp_path / "j.bin").stat().st_size == 0
    j.reset(meta={"fingerprint": "fp"})
    recs, _, _ = tjournal.scan_file(tmp_path / "j.bin")
    assert [r.code for r in recs] == [ops_mod.JR_META]
    assert recs[0].aux == {"fingerprint": "fp"}


def test_scan_missing_file_is_empty(tmp_path):
    recs, valid, dropped = tjournal.scan_file(tmp_path / "nope.bin")
    assert recs == [] and valid == 0 and dropped == 0


# ---------------------------------------------------------------------------
# the journal across packages
# ---------------------------------------------------------------------------

RECORDS = [
    dict(code=ops_mod.JR_META, seq=0, cseq=0, aux={"fingerprint": "{\"a\": 1}"}),
    dict(code=ops_mod.OP_INSERT, seq=3, cseq=1, aux={"chunk": None},
         payload=np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)),
    dict(code=ops_mod.OP_INSERT, seq=4, cseq=0, aux={},
         payload=np.full((2, 3), np.nan, np.float32),
         ids=np.asarray([10, 11], np.int32)),
    dict(code=ops_mod.OP_DELETE, seq=5, cseq=2, aux={"chunk": 16},
         ids=np.asarray([-1, 0, 2**31 - 1], np.int32)),
    dict(code=ops_mod.OP_QUERY, seq=6, cseq=0, aux={"n": 7}),
    dict(code=ops_mod.JR_CONSOLIDATE, seq=7, cseq=3,
         aux={"strategy": "local", "chunk": None}),
    dict(code=ops_mod.JR_GROW, seq=7, cseq=4, aux={"new_capacity": 192}),
    dict(code=ops_mod.JR_REFINE, seq=8, cseq=1, aux={"n": 10, "chunk": 4}),
    dict(code=ops_mod.JR_MERGE, seq=9, cseq=2),
    dict(code=ops_mod.JR_FLUSH, seq=9, cseq=0),
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_record_bytes_equal_jax(i):
    r = RECORDS[i]
    args = (r["code"], r["seq"], r["cseq"], r.get("payload"), r.get("ids"),
            r.get("aux"))
    assert tjournal._encode(*args) == jjournal._encode(*args)


def _write(mod, path, fsync):
    j = mod.OpJournal(path, fsync=fsync)
    for r in RECORDS:
        j.append(r["code"], seq=r["seq"], cseq=r["cseq"],
                 payload=r.get("payload"), ids=r.get("ids"), aux=r.get("aux"))
    j.sync()
    j.close()


def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.code, x.seq, x.cseq, x.aux, x.name) == (
            y.code, y.seq, y.cseq, y.aux, y.name)
        for f in ("payload", "ids"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_file_scans_equal_in_both_packages(tmp_path, writer):
    path = tmp_path / "journal.bin"
    _write(jjournal if writer == "jax" else tjournal, path,
           "always" if writer == "jax" else "flush")
    got_t, valid_t, drop_t = tjournal.scan_file(path)
    got_j, valid_j, drop_j = jjournal.scan_file(path)
    assert (valid_t, drop_t) == (valid_j, drop_j) == (path.stat().st_size, 0)
    _same_records(got_t, got_j)
    other = tmp_path / "other.bin"
    _write(tjournal if writer == "jax" else jjournal, other, "never")
    assert other.read_bytes() == path.read_bytes()


# ---------------------------------------------------------------------------
# checkpoint manager (the port's counterparts of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(8, 4)).astype(np.float32),
            "nested": {"b": np.arange(5, dtype=np.int32),
                       "c": np.float32(3.5)}}


def _zeros_like(t):
    return {"a": np.zeros_like(t["a"]),
            "nested": {"b": np.zeros_like(t["nested"]["b"]),
                       "c": np.float32(0)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(7, t, extra={"stream": {"step": 7}})
    assert set(mgr.timings) == {"to_host_s", "savez_s", "save_crc_s",
                                "publish_s"}
    got, extra = mgr.restore(None, _zeros_like(t))
    assert set(mgr.timings) == {"restore_crc_s", "read_s"}
    np.testing.assert_array_equal(got["a"], t["a"])
    np.testing.assert_array_equal(got["nested"]["b"], t["nested"]["b"])
    assert got["nested"]["c"] == t["nested"]["c"]
    assert got["nested"]["b"].dtype == np.int32
    assert extra["stream"]["step"] == 7
    # the JAX manager reads the port's checkpoint into its own tree
    jgot, jextra = JManager(tmp_path).restore(
        None, {"a": jnp.zeros((8, 4)), "nested": {"b": jnp.zeros(5, jnp.int32),
                                                  "c": jnp.float32(0)}})
    np.testing.assert_array_equal(np.asarray(jgot["a"]), t["a"])
    assert jextra == extra


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_torn_write_recovery(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    bad = tmp_path / "step_000000000002"   # a step dir without a manifest
    bad.mkdir()
    (tmp_path / "LATEST").write_text(bad.name)
    assert mgr.latest_step() == 1
    got, _ = mgr.restore(None, _zeros_like(t))
    np.testing.assert_array_equal(got["a"], t["a"])


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(None, {"different": np.zeros(3)})


def test_keep_last_alias(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5, keep_last=2)
    for s in (1, 2, 3):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [2, 3]


def test_corrupt_manifest_raises_typed(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t, extra={"s": 1})
    mgr.save(2, t, extra={"s": 2})
    (tmp_path / "step_000000000002" / "manifest.json").write_text("{garbled")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        mgr.restore(2, _zeros_like(t))
    _, extra = mgr.restore(None, _zeros_like(t))
    assert extra["s"] == 1


def test_truncated_shard_crc_detected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t, extra={"s": 1})
    mgr.save(2, t, extra={"s": 2})
    shard = tmp_path / "step_000000000002" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:60])
    with pytest.raises(CheckpointCorruptError, match="crc|unreadable"):
        mgr.restore(2, _zeros_like(t))
    got, extra = mgr.restore(None, _zeros_like(t))
    assert extra["s"] == 1
    np.testing.assert_array_equal(got["a"], t["a"])


def test_flipped_shard_byte_crc_detected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(3, t)
    shard = tmp_path / "step_000000000003" / "shard_0.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(3, _zeros_like(t))


def test_all_steps_corrupt_aggregates(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    (tmp_path / "step_000000000001" / "shard_0.npz").unlink()
    with pytest.raises(CheckpointCorruptError, match="every checkpoint"):
        mgr.restore(None, _zeros_like(t))


# ---------------------------------------------------------------------------
# session and tiered checkpoints: the same keys, leaves and dtypes as JAX's
# ---------------------------------------------------------------------------

def _params():
    return IndexParams(
        capacity=64, dim=8, d_out=5,
        search=SearchParams(pool_size=12, max_steps=36, num_starts=2),
        maintenance=MaintenanceParams(strategy="mask", insert_chunk=16,
                                      delete_chunk=16, max_capacity=256))


def _manifest_and_leaves(step_dir):
    manifest = json.loads((step_dir / "manifest.json").read_text())
    with np.load(step_dir / "shard_0.npz") as data:
        leaves = [(data[f"leaf_{i}"].dtype.str, data[f"leaf_{i}"].shape)
                  for i in range(manifest["n_leaves"])]
    return manifest, leaves


@pytest.mark.parametrize("kind", ["session", "tiered"])
def test_checkpoint_layout_equals_jax(tmp_path, kind):
    p = _params()
    x = np.random.default_rng(2).integers(-4, 5, (20, 8)).astype(np.float32)
    if kind == "session":
        js = JSession(p, seed=1, checkpoint_dir=tmp_path / "jax")
        ts = TSession(torch_params(p), seed=1, device="cpu",
                      checkpoint_dir=tmp_path / "torch")
    else:
        js = JTiered(p, fresh_capacity=32, seed=1,
                     checkpoint_dir=tmp_path / "jax")
        ts = TTiered(torch_params(p), fresh_capacity=32, seed=1, device="cpu",
                     checkpoint_dir=tmp_path / "torch")
    for s in (js, ts):
        s.insert(x)
        s.save(1)
    jm, jl = _manifest_and_leaves(tmp_path / "jax" / "step_000000000001")
    tm, tl = _manifest_and_leaves(tmp_path / "torch" / "step_000000000001")
    assert tm["keys"] == jm["keys"] and tm["n_leaves"] == jm["n_leaves"]
    assert tl == jl
    assert set(tm["extra"]) == set(jm["extra"])
    for k in ("fingerprint", "op_counter", "capacity", "consolidate_counter",
              "refine_counter", "refine_wear", "fresh_capacity",
              "main_capacity", "fresh_op_counter", "main_op_counter",
              "merge_counter", "merges_done", "next_ext"):
        assert tm["extra"].get(k) == jm["extra"].get(k), k
    want = (["base_key"] + [f"graph/.{f}" for f in (
        "vectors", "sqnorms", "codes", "scales", "adj", "radj", "alive",
        "present", "size", "stamps", "clock", "touch", "tclock")]
        if kind == "session" else None)
    if want is not None:
        assert tm["keys"] == want
    else:
        assert tm["keys"][:2] == ["base_key", "fresh_ext"]
        assert tm["keys"][15] == "main_ext" and len(tm["keys"]) == 29
    assert dict(zip(tm["keys"], tl))["base_key"] == ("<u4", (2,))
