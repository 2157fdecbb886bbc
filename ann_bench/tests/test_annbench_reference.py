"""The reference against a NumPy brute force, and the judge against runs
whose faults are known."""
import numpy as np
import torch

from ann_bench.reference import judge
from ann_bench.reference.exact import Rows, recall, round_tf32, topk_alive


def brute(x, q, alive, k, groups=None, exclude=None):
    s = 2.0 * q @ x.T - (x * x).sum(1)[None, :]
    s = np.where(alive, s, -np.inf)
    if groups is not None:
        s = np.where(groups[0][None, :] == groups[1][:, None], s, -np.inf)
    if exclude is not None:
        s[np.arange(len(q)), exclude] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    rows = np.where(np.take_along_axis(s, order, 1) > -np.inf, order, -1)
    return rows


def test_topk_alive_matches_numpy_brute_force():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(700, 24)).astype(np.float32)
    q = rng.normal(size=(40, 24)).astype(np.float32)
    t_in = np.where(np.arange(700) < 500, -1, rng.integers(0, 50, 700))
    t_out = np.where(rng.random(700) < 0.3, rng.integers(0, 60, 700), judge.NEVER)
    t_q = rng.integers(0, 60, 40)
    rows = Rows([torch.from_numpy(x[:500]), torch.from_numpy(x[500:])])
    alive = (t_in[None, :] < t_q[:, None]) & (t_out[None, :] > t_q[:, None])
    _, got = topk_alive(rows, t_in, t_out, torch.from_numpy(q), t_q, 10, "cpu")
    assert np.array_equal(got.numpy(), brute(x.astype(np.float64), q.astype(np.float64),
                                             alive, 10))
    grp = rng.integers(0, 4, 700)
    qg = rng.integers(0, 4, 40)
    ex = rng.integers(0, 700, 40)
    _, got = topk_alive(rows, t_in, t_out, torch.from_numpy(q), t_q, 7, "cpu",
                        groups=(grp, qg), exclude=ex)
    assert np.array_equal(got.numpy(), brute(x.astype(np.float64), q.astype(np.float64),
                                             alive, 7, (grp, qg), ex))


def test_recall_and_tf32_rounding():
    assert np.allclose(recall(np.array([[1, 2, 3], [4, 5, -1]]),
                              np.array([[3, 2, 9], [4, -1, -1]])), [2 / 3, 1.0])
    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10, 3.14159265])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert abs(float(r[2]) - 3.14159265) < 2**-10 * 4


def events_of(answers, n_base=10):
    """Query ops over a base of ``n_base`` rows at ids 0..n-1, then an
    insert of row n_base at id 20 and a delete of row 0 (id 0)."""
    ev = [{"kind": "insert", "t": 0, "n": 1, "rows": np.array([n_base]),
           "x": np.zeros((1, 4), np.float32), "ids": np.array([20])},
          {"kind": "delete", "t": 1, "n": 1, "rows": np.array([0]), "ids": np.array([0])}]
    for i, a in enumerate(answers):
        ev.append({"kind": "query", "t": 2 + i, "n": len(a), "ids": np.array(a),
                   "sample": np.zeros(0, np.int64), "q": None, "s": None})
    return ev


def test_replay_counts_each_kind_of_bad_answer_and_lost_write():
    good = [[1, 2, 20], [3, 4, 5]]
    rep = judge.replay(events_of([good]), np.arange(10), 32, 11, 3)
    assert (rep.bad_answers, rep.lost_writes) == (0, 0)
    for bad, n in (([[0, 2, 20], [3, 4, 5]], 1),      # a deleted row
                   ([[1, 1, 20], [3, 4, 5]], 1),      # a row twice
                   ([[1, 2, -1], [3, 4, 5]], 1),      # short
                   ([[1, 2, 20]], 1),                 # a lane missing
                   ([[1, 2, 31], [3, 4, 40]], 2)):    # an empty and an unknown id
        ev = events_of([bad])
        ev[-1]["n"] = 2
        assert judge.replay(ev, np.arange(10), 32, 11, 3).bad_answers == n
    ev = events_of([good])
    ev[0]["ids"] = np.array([5])                      # an insert on an occupied id
    assert judge.replay(ev, np.arange(10), 32, 11, 3).lost_writes == 1


def test_state_and_graph_faults():
    rows = Rows([torch.arange(12, dtype=torch.float32).reshape(6, 2)])
    expected = np.array([0, 1, -1, 3, -1, -1])
    alive = torch.tensor([True, True, False, True, False, False])
    vec = rows.take(np.array([0, 1, 0, 3, 0, 0]))
    assert judge.state_faults(alive, vec, expected, rows, row_dtype="float32") == 0
    vec[3, 1] += 1
    assert judge.state_faults(alive, vec, expected, rows, row_dtype="float32") == 1
    alive2 = alive.clone()
    alive2[2] = True
    assert judge.state_faults(alive2, rows.take(np.array([0, 1, 0, 3, 0, 0])), expected,
                              rows, row_dtype="float32") == 1
    adj = torch.tensor([[1, 3], [0, -1], [-1, -1], [0, -1], [-1, -1], [-1, -1]])
    radj = torch.tensor([[1, 3], [0, -1], [-1, -1], [0, -1], [-1, -1], [-1, -1]])
    present = alive.clone()
    assert judge.graph_faults(alive, present, adj, radj, 3) == 0
    assert judge.graph_faults(alive, present, adj, radj, 2) == 1           # size
    bad = adj.clone()
    bad[1, 1] = 2                                                         # to a free slot
    assert judge.graph_faults(alive, present, bad, radj, 3) >= 1
    bad = adj.clone()
    bad[3, 0] = 1                                                         # radj no longer its transpose
    assert judge.graph_faults(alive, present, bad, radj, 3) >= 1
