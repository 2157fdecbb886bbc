"""``correct`` can fail: a tiny run with the program broken underneath (each
fault a one-card cell can have) and the control (the reference in the
precision below the configuration's) both come out not correct, while the
sound tiny run comes out correct."""
import pytest

from ann_bench import harness
from ann_bench.control import simulate
from ann_bench.tests import faults, tiny

SEED = 2**31 + 77


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def run(root, cell_name):
    path, bench = root
    cell = harness.load_cell(cell_name, bench, path)
    before = harness.forbidden_modules()      # what the test process already holds
    line, _, loaded = harness.run_cell(cell, bench, SEED, 0.0, False, device="cpu",
                                       root=path)
    assert set(loaded) <= set(before)
    return line


@pytest.mark.parametrize("cell", ["tiny-sift1m-search", "tiny-sift1m-churn"])
def test_sound_run_is_correct(root, cell):
    line = run(root, cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) >= {"items_per_s", "recall_at_10", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["tiny-sift1m-search", "tiny-sift1m-churn"])
def test_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    import repro_torch.core.delete as delete
    import repro_torch.core.search as search
    import repro_torch.kernels.ref as ref

    for mod, name in ((delete, "delete_batch"), (search, "beam_search"),
                      (ref, "gather_scores")):
        monkeypatch.setattr(mod, name, getattr(mod, name))   # restored after
    faults.plant(fault)
    assert not run(root, cell)["correct"]


@pytest.mark.parametrize("cell,precision", [
    ("tiny-sift1m-search", None), ("tiny-sift1m-churn", None),
    ("tiny-sift1m-pods-4", None), ("tiny-sift1m-pods-4", "tf32")],
    ids=["tiny-sift1m-search", "tiny-sift1m-churn", "tiny-sift1m-pods-4",
         "tiny-sift1m-pods-4-tf32"])
def test_control_is_not_correct(root, cell, precision):
    """The configuration's control; on the bf16-row cell also TF32 products,
    the tensor-core step a faster gather would take."""
    path, bench = root
    c = harness.load_cell(cell, bench, path)
    nums = simulate(c, SEED, 3, "cpu", precision=precision)
    ok, checks = harness.judge_checks(nums, {k: v for k, v in c.config["limits"].items()
                                             if k in nums})
    assert not ok and checks["score_gap"]["value"] > checks["score_gap"]["max"], checks
