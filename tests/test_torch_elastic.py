"""Elastic re-sharding (``repro_torch.distributed.elastic``): the three tests
of ``tests/test_elastic.py`` on the port, and ``gather_alive`` / ``reshard``
byte-equal to JAX's on the same stacked state (no mesh needed), also after
the state crossed packages through a checkpoint."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexParams as JIndexParams
from repro.core import MaintenanceParams as JMaintenanceParams
from repro.core import SearchParams as JSearchParams
from repro.core.graph import GraphState as JState
from repro.distributed import elastic as jelastic
from repro_torch.core import search as search_mod
from repro_torch.core.graph import DATA_FIELDS, NULL, graph_state_from_numpy
from repro_torch.core.maintenance import IPGMIndex
from repro_torch.core.params import IndexParams, MaintenanceParams, SearchParams
from repro_torch.distributed.ann import shard_view, stack_states
from repro_torch.distributed.elastic import gather_alive, reshard
from torch_parity import int_vectors, torch_params


def _params(cap, dim=8, *, pool=16, steps=48, **mkw):
    return IndexParams(capacity=cap, dim=dim, d_out=6,
                       search=SearchParams(pool_size=pool, max_steps=steps,
                                           num_starts=2),
                       maintenance=MaintenanceParams(**mkw))


def _stacked_index(n_shards, cap, dim, n_vecs, rng, X=None):
    """A stacked sharded state built by hashing vectors to shards."""
    params = _params(cap, dim)
    X = rng.normal(size=(n_vecs, dim)).astype(np.float32) if X is None else X
    shards = []
    for s in range(n_shards):
        idx = IPGMIndex(params, strategy="pure", seed=s, device="cpu")
        idx.insert(X[np.arange(len(X)) % n_shards == s])
        shards.append(idx.session.state)
    return stack_states(shards), params, X


def test_reshard_preserves_vectors_and_recall():
    rng = np.random.default_rng(0)
    stacked, params, X = _stacked_index(4, 64, 8, 120, rng)
    vecs_before, _ = gather_alive(stacked)
    assert vecs_before.shape[0] == 120

    new_stacked, remap = reshard(stacked, params, _params(64), 3)
    assert new_stacked.vectors.shape[0] == 3

    vecs_after, _ = gather_alive(new_stacked)
    assert vecs_after.shape[0] == 120
    a = np.sort(vecs_before.round(5).view([("", vecs_before.dtype)] * 8), 0)
    b = np.sort(vecs_after.round(5).view([("", vecs_after.dtype)] * 8), 0)
    np.testing.assert_array_equal(a, b)

    shard0 = shard_view(new_stacked, 0)
    q = torch.from_numpy(vecs_after[:1])
    res = search_mod.search_one(shard0, q[0], torch.tensor([0, 1], dtype=torch.int32),
                                params.search)
    assert int(res.ids[0]) != NULL


def test_reshard_growth_armed_stride():
    """Both sides of the remap live in the armed session's gid space
    (stride = max_capacity)."""
    rng = np.random.default_rng(2)
    stacked, _, _ = _stacked_index(2, 64, 8, 60, rng)
    armed = _params(64, max_capacity=256)
    _, held_gids = gather_alive(stacked, stride=256)
    assert ((held_gids // 256) < 2).all() and ((held_gids % 256) < 64).all()
    assert held_gids.max() >= 256, "shard 1 gids must be stride-encoded"

    new_stacked, remap = reshard(stacked, armed, armed, 2)
    new_gids = remap[held_gids]
    assert (new_gids >= 0).all(), "every held gid must translate"
    _, readback = gather_alive(new_stacked, stride=256)
    assert set(new_gids.tolist()) == set(readback.tolist())


def test_reshard_capacity_guard():
    rng = np.random.default_rng(1)
    stacked, params, _ = _stacked_index(4, 64, 8, 120, rng)
    tiny = _params(16, pool=8, steps=16)
    with pytest.raises(ValueError, match="capacity"):
        reshard(stacked, params, tiny, 2)


# ---------------------------------------------------------------------------
# against JAX, on the same stacked state
# ---------------------------------------------------------------------------

def _jax_state(ts):
    return JState(**{f: jnp.asarray(getattr(ts, f).numpy()) for f in DATA_FIELDS},
                  capacity=ts.capacity, dim=ts.dim, d_out=ts.d_out,
                  d_in=ts.d_in, metric=ts.metric)


@pytest.fixture(scope="module")
def int_stacked():
    """4 shards over integer-valued rows, with some deletes (so alive has
    holes) — exact in every summation order, with ties."""
    rng = np.random.default_rng(3)
    X = int_vectors(rng, 120, 8)
    stacked, params, _ = _stacked_index(4, 64, 8, 120, rng, X=X)
    for s in range(4):
        stacked.alive[s, ::5] = False
        stacked.size[s] = stacked.alive[s].sum()
    return stacked, params


@pytest.mark.parametrize("stride", [None, 256])
def test_gather_alive_equals_jax(int_stacked, stride):
    stacked, _ = int_stacked
    tv, tg = gather_alive(stacked, stride=stride)
    jv, jg = jelastic.gather_alive(_jax_state(stacked), stride=stride)
    assert tv.tobytes() == np.asarray(jv).tobytes()
    np.testing.assert_array_equal(tg, np.asarray(jg))


@pytest.mark.parametrize("n_new,route,armed", [(3, "hash", False),
                                               (2, "hash", True),
                                               (5, "round_robin", False)])
def test_reshard_byte_equal_to_jax(int_stacked, n_new, route, armed):
    stacked, _ = int_stacked
    mk = dict(max_capacity=128) if armed else {}
    old = _params(64, **mk)
    new = _params(64, **mk)
    jold = JIndexParams(capacity=64, dim=8, d_out=6,
                        search=JSearchParams(pool_size=16, max_steps=48,
                                             num_starts=2),
                        maintenance=JMaintenanceParams(**mk))
    assert torch_params(jold) == old
    ts, tremap = reshard(stacked, old, new, n_new, route=route)
    js, jremap = jelastic.reshard(_jax_state(stacked), jold, jold, n_new,
                                  route=route)
    np.testing.assert_array_equal(tremap, np.asarray(jremap))
    diff = [f for f in DATA_FIELDS
            if np.asarray(getattr(js, f)).tobytes()
            != getattr(ts, f).numpy().tobytes()]
    assert diff == []


def test_reshard_after_a_checkpoint_from_jax(int_stacked, tmp_path):
    """A stacked state JAX's manager saved, restored by the port's manager
    and re-sharded, gives JAX's remap and state."""
    from repro.checkpoint.manager import CheckpointManager as JMgr
    from repro_torch.checkpoint.manager import CheckpointManager as TMgr

    stacked, params = int_stacked
    js = _jax_state(stacked)
    JMgr(tmp_path).save(3, {"graph": js})
    tree, _ = TMgr(tmp_path).restore(None, {"graph": stacked})
    back = graph_state_from_numpy(tree["graph"], capacity=64, dim=8, d_out=6,
                                  d_in=12, metric="l2", device="cpu")
    ts, tremap = reshard(back, params, params, 2)
    jp = JIndexParams(capacity=64, dim=8, d_out=6,
                      search=JSearchParams(pool_size=16, max_steps=48,
                                           num_starts=2))
    jt, jremap = jelastic.reshard(js, jp, jp, 2)
    np.testing.assert_array_equal(tremap, np.asarray(jremap))
    assert all(np.asarray(getattr(jt, f)).tobytes() == getattr(ts, f).numpy().tobytes()
               for f in DATA_FIELDS)
