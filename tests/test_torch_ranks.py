"""The sharded index's rank path (``launch.mesh.CardGroup``,
``run_on_ranks``) against the stacked layout, on gloo ranks on the CPU.

One spawn of 4 ranks runs ``testing/ranks.py::pod_checks`` on a (2, 4, 2)
pod mesh, each pod a replica on 2 ranks: the session and crash points
below, one member a pod of an int8-compressed mean over the pod-peer
group, a checkpoint saved by rank 0, and replicas made to disagree. Then
one spawn of 2 ranks runs ``rank_checks``: a MASK session that grows in
lockstep and consolidates, a session restarted from its gathered state,
every sharded crash point, one member a rank of an int8-compressed mean,
and the pod checkpoint restored onto 2 ranks. The same streams run
stacked in this process (the pod mesh as the pod loop on one replica).
``reshard(shards=...)``, the block layout's arguments, a one-rank group
and a failing rank need no group, one in this process or one short
spawn. Integer-valued vectors: every product is exact, so the layouts
must agree byte for byte.
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
    ShardMesh,
    init_sharded_state,
    make_insert_step,
    pod_of,
    shard_block,
)
from repro_torch.distributed.compression import compressed_psum
from repro_torch.launch.mesh import CardGroup, RankFailure, one_rank, run_on_ranks
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
def pods(data, tmp_path_factory):
    """``pod_checks`` on 4 ranks (2 pods × 2), and the pod loop stacked
    here; the 4-rank run's checkpoint directory."""
    X, Q, members = data
    ckpt = tmp_path_factory.mktemp("pods4")
    per_rank = run_on_ranks(ranks.pod_checks, 4, device="cpu",
                            timeout_s=150, args=(X, Q, members, str(ckpt)))
    stacked = {"session": ranks.session_checks(None, X, Q, mesh=ranks.POD_MESH),
               "crash": ranks.crash_checks(None, X, mesh=ranks.POD_MESH),
               "resume": ranks.resume_source(
                   None, X, Q, str(tmp_path_factory.mktemp("stacked")))}
    return per_rank, stacked, ckpt


@pytest.fixture(scope="module")
def checks(data, pods):
    X, Q, members = data
    per_rank = run_on_ranks(ranks.rank_checks, 2, device="cpu",
                            timeout_s=120, args=(X, Q, members, str(pods[2])))
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


# ---------------------------------------------------------------------------
# pods on their own ranks: (2, 4, 2), 2 pods × 2 ranks, 4 shards a rank
# ---------------------------------------------------------------------------

def _same_session(got: dict, want: dict) -> None:
    np.testing.assert_array_equal(got["counters"], want["counters"])
    np.testing.assert_array_equal(got["gids"], want["gids"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert got["scores"].tobytes() == want["scores"].tobytes()
    for f in DATA_FIELDS:
        assert got["state"][f].tobytes() == want["state"][f].tobytes(), f


def test_pod_replicas_equal_each_other_and_the_pod_loop(pods):
    """After MASK deletes, consolidation and a grow, each pod's gathered
    replica equals the other's and the one-process pod loop's, byte for
    byte, with the same gids, counters and answers."""
    per_rank, stacked, _ = pods
    want = stacked["session"]
    cap, n_grows, n_cons, n_consolidated, n_refused, _, n_alive, n_masked = (
        want["counters"])
    assert cap > 16 and n_grows >= 1 and n_cons >= 2 and n_refused == 0
    assert n_consolidated > 0 and n_masked == 0 and n_alive == 200 - 80
    assert [got["pod"] for got in per_rank] == [0, 0, 1, 1]
    for got in per_rank:
        _same_session(got["session"], want)
    _same_session(per_rank[2]["session"], per_rank[0]["session"])
    for got in per_rank:
        assert got["session"]["roundtrip_block"]
        for f in DATA_FIELDS:
            assert (got["session"]["roundtrip_state"][f].tobytes()
                    == want["state"][f].tobytes()), f


def test_pod_crash_points_fire_at_the_same_hit_on_every_rank_of_both_pods(pods):
    per_rank, stacked, _ = pods
    want = stacked["crash"]
    assert set(want) == set(faults.SHARDED_CRASH_POINTS)
    for point, rec in want.items():
        assert rec["ops"][-1] == "crash", f"{point} never fired"
        for got in per_rank:
            assert got["crash"][point] == rec, point


def test_disagreeing_replicas_raise_on_every_rank(pods):
    per_rank, _, _ = pods
    for r, got in enumerate(per_rank):
        msg = got["disagree"]
        assert "pod 0" in msg and "pod 1" in msg, f"rank {r}: {msg!r}"


def test_compressed_psum_over_the_pod_peer_group_equals_the_stacked_form(
        data, pods):
    """JAX's cross-pod sync: one member a pod, over each pod-peer group."""
    _, _, members = data
    per_rank, _, _ = pods
    want = compressed_psum({k: torch.from_numpy(v) for k, v in members.items()},
                           prng.prng_key(11))
    for got in per_rank:
        for k, v in want.items():
            assert got["psum"][k].tobytes() == v.numpy().tobytes(), k


def test_a_pod_checkpoint_restores_from_four_ranks_onto_two(pods, checks):
    """Rank 0 of the 4-rank pod session saves its replica's gathered state
    and key counters; restored on 2 ranks (2 pods × 1), the next query op,
    insert op and state equal the uninterrupted run's and the pod loop's."""
    per_rank4, stacked, _ = pods
    per_rank2, _ = checks
    want = per_rank4[0]["resume"]
    for got in [r["resume"] for r in per_rank4 + per_rank2] + [stacked["resume"]]:
        np.testing.assert_array_equal(got["ids"], want["ids"])
        assert got["scores"].tobytes() == want["scores"].tobytes()
        np.testing.assert_array_equal(got["gids"], want["gids"])
        for f in DATA_FIELDS:
            assert got["state"][f].tobytes() == want["state"][f].tobytes(), f
    assert (want["gids"] >= 0).all()


def test_a_world_that_the_pods_do_not_split_raises():
    mesh = ShardMesh((2, 3, 2), ("pod", "data", "model"))   # 6 shards
    dp = DistParams(index=ranks.small_params(16, DIM), pod_axis="pod")
    three = CardGroup(rank=0, world=3, device=torch.device("cpu"), pg=None)
    # 3 ranks divide the 6 shards, but not the 2 pods
    assert shard_block(dataclasses.replace(dp, pod_axis=None), mesh,
                       three) == range(0, 2)
    with pytest.raises(ValueError, match="do not split over 2 pods"):
        shard_block(dp, mesh, three)
    with pytest.raises(ValueError, match="do not split over 2 pods"):
        ShardedSession(dp, mesh, group=three)
    four = CardGroup(rank=3, world=4, device=torch.device("cpu"), pg=None)
    assert pod_of(dp, ranks.POD_MESH, four) == 1
    assert shard_block(dp, ranks.POD_MESH, four) == range(4, 8)
    with pytest.raises(ValueError, match="2 ranks a pod do not divide 3"):
        shard_block(dp, ShardMesh((2, 3, 1), ("pod", "data", "model")), four)


def test_a_one_rank_group_on_a_pod_mesh_runs_the_pod_loop(data):
    """W = 1: no subgroup, one replica running the batch pod by pod, with
    its collectives over the one-rank group; equal to no group at all."""
    X, Q, _ = data
    dp = ranks.growing_dist_params(DIM, ranks.POD_MESH)
    out = []
    with one_rank("cpu", timeout_s=60) as g:
        for group in (g, None):
            sess = ShardedSession(dp, ranks.POD_MESH, strategy="mask", seed=3,
                                  device="cpu", group=group)
            gids = sess.insert(X[:100], np.arange(100))
            out.append((gids, *sess.query(Q), sess.gather_state()))
            if group is not None:
                assert sess.replica is g and sess.peers is None
                assert sess.state.vectors.shape[0] == 8
        assert g.n_collectives > 0
    (g1, i1, s1, st1), (g0, i0, s0, st0) = out
    assert torch.equal(g1, g0) and torch.equal(i1, i0) and torch.equal(s1, s0)
    for f in DATA_FIELDS:
        assert torch.equal(getattr(st1, f), getattr(st0, f)), f


def test_a_rank_that_raises_fails_the_parent_within_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 raised"):
        run_on_ranks(ranks.raise_on_rank, 2, device="cpu", timeout_s=60,
                     args=(1,))
    assert time.monotonic() - t0 < 60
