"""The benchmark's inputs: one seed gives the same bytes twice, and the
clustered stream deletes whole spans of the cluster order, oldest first."""
import numpy as np
import torch

from ann_bench.data.streams import Plan, kmeans_labels
from ann_bench.data.surrogate import Law, generator

RANDOM = {"pattern": "random", "k": 10, "recall_lanes": 3,
          "round": [{"op": "query", "n": 8, "repeat": 2}, {"op": "insert", "n": 5},
                    {"op": "delete", "n": 5}]}
CLUSTERED = {"pattern": "clustered", "clusters": 4, "kmeans_iters": 8, "max_rounds": 30,
             "k": 10, "recall_lanes": 3,
             "round": [{"op": "delete", "n": 6}, {"op": "insert", "n": 6},
                       {"op": "query", "n": 4}]}
SEED = 2**31 + 12345      # past 32 signed bits, as the benchmark's seeds are


def stream_bytes(traffic, seed, rounds=6):
    plan = Plan(traffic, Law(16, 4, 0.05, seed, "cpu"), 200, seed)
    ops = plan.warmup() + [op for _ in range(rounds) for op in plan.next_round()]
    out = [plan.base().numpy().tobytes()]
    for op in ops:
        if op.kind == "query":
            out += [plan.queries(op).numpy().tobytes(), op.sample.tobytes()]
        elif op.kind == "insert":
            out += [plan.insert_rows(op).numpy().tobytes(), op.rows.tobytes()]
        else:
            out.append(op.rows.tobytes())
    return out


def test_one_seed_gives_the_same_bytes_twice():
    for traffic in (RANDOM, CLUSTERED):
        a, b = stream_bytes(traffic, SEED), stream_bytes(traffic, SEED)
        assert a == b
        assert stream_bytes(traffic, SEED + 1)[0] != a[0]


def test_law_has_the_stated_rank_and_noise():
    x = Law(64, 5, 0.05, 3, "cpu").draw(4000, "t")
    sv = torch.linalg.svdvals(x - x.mean(0))
    # five directions carry the variance; the rest is the noise floor
    assert sv[4] > 20 * sv[5]
    # each coordinate's variance is a sum of rank squared draws of the
    # basis: 1 + noise² on average, within a few tenths at rank 5
    assert abs(float(x.var(0).mean()) - (1 + 0.05**2)) < 0.3


def test_random_deletes_only_alive_rows_once():
    plan = Plan(RANDOM, Law(16, 4, 0.05, 1, "cpu"), 50, 1)
    alive = set(range(50))
    for op in plan.warmup() + [op for _ in range(20) for op in plan.next_round()]:
        if op.kind == "insert":
            alive |= set(op.rows.tolist())
        elif op.kind == "delete":
            assert set(op.rows.tolist()) <= alive and len(set(op.rows.tolist())) == op.n
            alive -= set(op.rows.tolist())


def test_clustered_stream_deletes_whole_spans_in_order():
    plan = Plan(CLUSTERED, Law(16, 4, 0.05, 5, "cpu"), 120, 5)
    ops = plan.warmup() + [op for _ in range(30) for op in plan.next_round()]
    deleted = np.concatenate([op.rows for op in ops if op.kind == "delete"])
    assert np.array_equal(deleted, np.arange(deleted.size))      # oldest first, no gaps
    inserted = np.concatenate([op.rows for op in ops if op.kind == "insert"])
    assert np.array_equal(inserted, 120 + np.arange(inserted.size))
    # the base and the inserts lie in cluster order: the labels of the
    # laid-out corpus never go back
    corpus = torch.cat([plan.base()] + [plan.insert_rows(op) for op in ops
                                        if op.kind == "insert"])
    law = Law(16, 4, 0.05, 5, "cpu")
    raw = law.draw(120 + 6 * 31, "corpus")
    labels = kmeans_labels(raw, 4, 8, generator("cpu", 5, "kmeans"))
    laid = labels[torch.argsort(labels, stable=True)][:corpus.shape[0]]
    assert bool((laid[1:] >= laid[:-1]).all())
    assert torch.equal(corpus, raw[torch.argsort(labels, stable=True)][:corpus.shape[0]])
