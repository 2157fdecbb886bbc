"""The sharded index's rank path (``launch.mesh.CardGroup``,
``run_on_ranks``) against the stacked layout, on gloo ranks on the CPU.

One spawn of 2 ranks runs ``testing/ranks.py::rank_checks``: a MASK
session that grows in lockstep and consolidates, a session restarted from
its gathered state, every sharded crash point, and one member a rank of an
int8-compressed mean. The same streams run stacked in this process.
``reshard(shards=...)``, the block layout's arguments and a failing rank
need no group or one short spawn. Integer-valued vectors: every product
is exact, so the layouts must agree byte for byte.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.graph import DATA_FIELDS
from repro_torch.distributed import elastic
from repro_torch.distributed.ann import (
    DistParams,
    ShardedSession,
    init_sharded_state,
    make_insert_step,
    shard_block,
)
from repro_torch.distributed.compression import compressed_psum
from repro_torch.launch.mesh import CardGroup, RankFailure, run_on_ranks
from repro_torch.testing import faults, ranks
from torch_parity import int_vectors

DIM = 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return (int_vectors(rng, 200, DIM), int_vectors(rng, 16, DIM),
            {"w": rng.normal(size=(2, 32, 8)).astype(np.float32),
             "b": (rng.normal(size=(2, 16)) * 1e-3).astype(np.float32)})


@pytest.fixture(scope="module")
def checks(data):
    X, Q, members = data
    per_rank = run_on_ranks(ranks.rank_checks, 2, device="cpu",
                            timeout_s=120, args=(X, Q, members))
    stacked = {"session": ranks.session_checks(None, X, Q),
               "crash": ranks.crash_checks(None, X)}
    return per_rank, stacked


def test_lockstep_growth_and_consolidation_equal_the_stack(checks):
    per_rank, stacked = checks
    want = stacked["session"]
    cap, n_grows, n_cons, n_consolidated, n_refused, _, n_alive, n_masked = (
        want["counters"])
    assert cap > 16 and n_grows >= 1 and n_cons >= 2 and n_refused == 0
    assert n_consolidated > 0 and n_masked == 0 and n_alive == 200 - 80
    for got in per_rank:
        s = got["session"]
        np.testing.assert_array_equal(s["counters"], want["counters"])
        np.testing.assert_array_equal(s["gids"], want["gids"])
        np.testing.assert_array_equal(s["ids"], want["ids"])
        assert s["scores"].tobytes() == want["scores"].tobytes()
        for f in DATA_FIELDS:
            assert s["state"][f].tobytes() == want["state"][f].tobytes(), f


def test_gather_state_round_trips_through_a_session(checks):
    """``ShardedSession(state=<global stack>, group=...)`` keeps the rank's
    block, and gathering it again gives the stack back."""
    per_rank, stacked = checks
    for got in per_rank:
        s = got["session"]
        assert s["roundtrip_block"]
        for f in DATA_FIELDS:
            assert s["roundtrip_state"][f].tobytes() == s["state"][f].tobytes(), f
    assert stacked["session"]["roundtrip_block"]


def test_crash_points_fire_at_the_same_hit_on_every_rank(checks):
    per_rank, stacked = checks
    want = stacked["crash"]
    assert set(want) == set(faults.SHARDED_CRASH_POINTS)
    for point, rec in want.items():
        assert rec["ops"][-1] == "crash", f"{point} never fired"
        for got in per_rank:
            assert got["crash"][point] == rec, point


def test_compressed_psum_over_ranks_equals_the_stacked_form(data, checks):
    _, _, members = data
    per_rank, _ = checks
    want = compressed_psum({k: torch.from_numpy(v) for k, v in members.items()},
                           prng.prng_key(11))
    for got in per_rank:
        for k, v in want.items():
            assert got["psum"][k].tobytes() == v.numpy().tobytes(), k


@pytest.mark.parametrize("block", [range(0, 2), range(2, 4), range(3, 4)])
def test_reshard_of_some_shards_equals_those_of_the_full_reshard(data, block):
    X, _, _ = data
    dp = DistParams(index=ranks.small_params(64, DIM))
    st, _ = make_insert_step(dp, ranks.MESH)(
        init_sharded_state(dp, ranks.MESH, device="cpu"), X, np.arange(200),
        prng.prng_key(0))
    new = ranks.small_params(128, DIM)
    full, remap = elastic.reshard(st, dp.index, new, 4)
    part, remap_part = elastic.reshard(st, dp.index, new, 4, shards=block)
    np.testing.assert_array_equal(remap_part, remap)
    assert part.vectors.shape[0] == len(block)
    for f in DATA_FIELDS:
        assert torch.equal(getattr(part, f),
                           getattr(full, f)[block.start:block.stop]), f


def test_a_world_that_does_not_divide_the_shards_raises():
    dp = DistParams(index=ranks.small_params(16, DIM))
    lone = CardGroup(rank=0, world=3, device=torch.device("cpu"), pg=None)
    with pytest.raises(ValueError, match="do not divide"):
        shard_block(dp, ranks.MESH, lone)
    with pytest.raises(ValueError, match="do not divide"):
        ShardedSession(dp, ranks.MESH, group=lone)
    half = CardGroup(rank=1, world=2, device=torch.device("cpu"), pg=None)
    assert shard_block(dp, ranks.MESH, half) == range(4, 8)
    three = init_sharded_state(dp, ranks.MESH, device="cpu")
    three = dataclasses.replace(three, **{f: getattr(three, f)[:3]
                                          for f in DATA_FIELDS})
    with pytest.raises(ValueError, match="does not match the mesh"):
        ShardedSession(dp, ranks.MESH, group=half, state=three)


def test_a_rank_that_raises_fails_the_parent_within_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 raised"):
        run_on_ranks(ranks.raise_on_rank, 2, device="cpu", timeout_s=60,
                     args=(1,))
    assert time.monotonic() - t0 < 60
