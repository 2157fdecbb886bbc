"""The program's spans and counters (``repro_torch.tracing``) on the CPU.

With no sink a span constructs nothing and the gathers count nothing;
with a recording sink the session's ops give the same bits, and the
spans they open pair up well nested inside each op. The gathers'
valid-lane count on the plain route is the count of ids in [0, N), which
the kernels count on the card (``chip_smoke.py``'s kernels phase holds
them to it there).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import IndexParams, MaintenanceParams, SearchParams, Session
from repro_torch.core.graph import DATA_FIELDS
from repro_torch.core.quantize import quantize_rows
from repro_torch.core.rebuild import bulk_knn_build
from repro_torch.distributed.ann import ShardedSession
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import one_rank
from repro_torch.testing import ranks
from torch_parity import int_vectors

DIM = 16
OP_SPANS = {
    "query": {"search.entry_draw", "search.beam"},
    "insert": {"search.entry_draw", "search.beam", "graph.select", "graph.apply"},
    "delete": {"search.entry_draw", "search.beam", "graph.select", "graph.apply"},
}


class Recorder:
    """A sink that keeps every call, the ops' own marks included."""

    def __init__(self):
        self.calls: list[str] = []

    def __call__(self, name: str) -> None:
        self.calls.append(name)


def pair_spans(calls: list[str]) -> list[tuple[str, tuple]]:
    """(name, names open around it) of each span, from a sink's calls; a
    call that is neither the innermost open span's exit nor an entry
    (every name may be entered) shows up as a span left open."""
    open_, spans = [], []
    for name in calls:
        if open_ and open_[-1] == name:
            open_.pop()
            spans.append((name, tuple(open_)))
        else:
            open_.append(name)
    assert open_ == [], f"spans left open: {open_}"
    return spans


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    X = int_vectors(rng, 400, DIM)
    params = IndexParams(
        capacity=512, dim=DIM, d_out=6, d_in=12,
        search=SearchParams(pool_size=12, max_steps=24, num_starts=2),
        maintenance=MaintenanceParams(strategy="global", insert_chunk=16,
                                      delete_chunk=16))
    state = bulk_knn_build(X[:300], np.ones(300, bool), params, k_nn=12, device="cpu")
    return params, state, X, rng.choice(300, 40, replace=False)


def drive(built, sink=None):
    """A query, an insert and a GLOBAL delete on a session of its own over
    a copy of the built state, each inside an op mark when ``sink`` is
    given; the answers and the final state."""
    params, state, X, dels = built
    sess = Session(params, state=dataclasses.replace(
        state, **{f: getattr(state, f).clone() for f in DATA_FIELDS}), seed=7, device="cpu")

    def op(name, fn):
        if sink is not None:
            sink(f"op.{name}")
        out = fn()
        if sink is not None:
            sink(f"op.{name}")
        return out

    out = {}
    out["q"] = op("query", lambda: sess.query(X[300:340], k=5).result())
    out["ins"] = op("insert", lambda: sess.insert(X[340:380]).result())

    def delete():
        sess.delete(dels.astype(np.int32))
        sess.flush()
    op("delete", delete)
    out["q2"] = op("query", lambda: sess.query(X[380:400], k=5).result())
    return out, sess.state


def test_with_no_sink_a_span_makes_nothing_and_no_lane_is_counted(built, monkeypatch):
    made = []

    class Spy(tracing._Span):
        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    monkeypatch.setattr(tracing, "_Span", Spy)
    tracing.set_sink(None)
    kops.reset_launches()
    before = tracing.counters()
    drive(built)
    assert made == []
    assert tracing.span("search.beam") is tracing.span("graph.apply")
    after = tracing.counters()
    assert after["valid_lanes"] == before["valid_lanes"] == {n: 0 for n in kops.GATHERS}
    assert after["loop_counts"]["searches"] > before["loop_counts"]["searches"]


def test_a_recording_sink_changes_no_bit_and_nests_every_span_in_its_op(built):
    want, want_state = drive(built)
    rec = Recorder()
    tracing.set_sink(rec)
    try:
        got, got_state = drive(built, sink=rec)
    finally:
        tracing.set_sink(None)
    for name in want:
        for a, b in zip(want[name] if isinstance(want[name], tuple) else (want[name],),
                        got[name] if isinstance(got[name], tuple) else (got[name],)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    for f in DATA_FIELDS:
        assert torch.equal(getattr(want_state, f), getattr(got_state, f)), f
    spans = pair_spans(rec.calls)
    for kind, names in OP_SPANS.items():
        inside = {n for n, around in spans if around[:1] == (f"op.{kind}",)}
        assert names <= inside, (kind, inside)
    # every program span lies in an op; the flush's repair under the delete
    assert all(around and around[0].startswith("op.")
               for n, around in spans if not n.startswith("op."))


def test_the_sink_arms_the_valid_lane_count_and_counters_difference():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-3, 55, (6, 7)).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    tsq = (x * x).sum(1)
    kops.reset_launches()
    kops.gather_scores(x, tsq, ids, q)
    assert tracing.counters()["valid_lanes"]["gather_scores"] == 0
    tracing.set_sink(lambda name: None)
    try:
        a = tracing.counters()
        kops.gather_scores(x, tsq, ids, q)
        kops.gather_scores(x, tsq, ids, q)
        b = tracing.counters()
    finally:
        tracing.set_sink(None)
    want = int(((ids >= 0) & (ids < 50)).sum())
    assert 0 < want < ids.numel()
    assert b["valid_lanes"]["gather_scores"] - a["valid_lanes"]["gather_scores"] == 2 * want
    kops.gather_scores(x, tsq, ids, q)
    assert tracing.counters()["valid_lanes"] == b["valid_lanes"]
    assert set(b) == {"loop_counts", "launches", "launches_by_shape", "valid_lanes"}
    assert set(b["launches_by_shape"]) == set(kops.launches)


@pytest.mark.parametrize("rows", ["f32", "bf16", "q8"])
def test_the_plain_route_counts_ids_inside_the_table(rows):
    rng = np.random.default_rng(len(rows))
    N = 37
    x = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-5, N + 5, (9, 11)).astype(np.int32))
    ids[0, :4] = torch.tensor([-1, 0, N - 1, N], dtype=torch.int32)
    name = {"f32": "gather_scores", "bf16": "gather_scores_bf16",
            "q8": "gather_scores_q8"}[rows]
    kops.reset_launches()
    kops.arm_valid_lanes(True)
    try:
        if rows == "q8":
            codes, scales = quantize_rows(x)
            kops.gather_scores_q8(codes, scales, ids, q)
        else:
            table = x if rows == "f32" else x.bfloat16()
            kops.gather_scores(table, (x * x).sum(1), ids, q)
    finally:
        kops.arm_valid_lanes(False)
    counted = kops.read_valid_lanes()
    assert counted[name] == int(((ids >= 0) & (ids < N)).sum())
    assert all(v == 0 for k, v in counted.items() if k != name)
    assert all(v == 0 for v in kops.launches.values())      # the CPU never launches


def test_sharded_spans_and_collectives_nest_in_a_one_rank_group():
    """A pod-mesh session over a one-rank gloo group: the flat view, the
    merge and every collective open their spans (the collectives inside
    the group's synchronised timing), and the answers keep their bits."""
    rng = np.random.default_rng(3)
    X, Q = int_vectors(rng, 100, DIM), int_vectors(rng, 12, DIM)
    dp = ranks.growing_dist_params(DIM, ranks.POD_MESH)
    out = []
    with one_rank("cpu", timeout_s=60) as g:
        for rec in (None, Recorder()):
            tracing.set_sink(rec)
            try:
                sess = ShardedSession(dp, ranks.POD_MESH, strategy="mask", seed=3,
                                      device="cpu", group=g)
                gids = sess.insert(X, np.arange(100))
                n0 = g.n_collectives
                if rec is not None:
                    rec("op.query")
                ids, scores = sess.query(Q)
                if rec is not None:
                    rec("op.query")
            finally:
                tracing.set_sink(None)
            out.append((gids, ids, scores, g.n_collectives - n0))
    (g0, i0, s0, c0), (g1, i1, s1, c1) = out
    assert torch.equal(g0, g1) and torch.equal(i0, i1) and torch.equal(s0, s1)
    spans = pair_spans(rec.calls)
    in_query = [n for n, around in spans if around[:1] == ("op.query",)]
    assert {"sharded.merge", "search.beam", "search.entry_draw"} <= set(in_query)
    assert in_query.count("collective.all_gather") + in_query.count(
        "collective.all_reduce") == c1 == c0 > 0
