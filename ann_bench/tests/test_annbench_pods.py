"""The four-card cell's deployment on four gloo ranks at a tiny size: the sound
run is correct, and every fault the cell can have (a planted fault in
every rank, the exchange between cards among them) is not."""
import pytest

from ann_bench import harness
from ann_bench.deployments import sharded
from ann_bench.tests import faults, tiny

SEED = 2**31 + 91
CELL = "tiny-sift1m-pods-4"


def run(tmp_path, fault=None, monkeypatch=None):
    path, bench = tiny.make_root(tmp_path)
    cell = harness.load_cell(CELL, bench, path)
    if fault is not None:
        cell.config["fault"] = fault
        monkeypatch.setattr(sharded, "rank_main", faults.faulty_rank_main)
    before = harness.forbidden_modules()      # what the test process already holds
    line, _, loaded = harness.run_cell(cell, bench, SEED, 0.0, False, device="cpu",
                                       root=path)
    assert set(loaded) <= set(before)
    return line


def test_sound_run_is_correct(tmp_path):
    line = run(tmp_path)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_is_not_correct(tmp_path, fault, monkeypatch):
    assert not run(tmp_path, fault, monkeypatch)["correct"]
