"""The comparison that decides ``correct`` fails where it must: the harness
run on the CPU's dry-run sizes (its look for a chip skipped) with the
timed path broken underneath, and the controls, the reference at fp8 in
the program's place."""
import json
from pathlib import Path

import pytest

from portbench import run as bench
from portbench.tests.fault_readings import plant

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SERVE = [c for c in CELLS if not c.endswith(".train")]
TRAIN = [c for c in CELLS if c.endswith(".train")]


def _result(cell, seed=3, control=None):
    args = ["--workload", cell, "--seed", str(seed), "--seconds", "2",
            "--cpu"] + (["--control", control] if control else [])
    return bench.run(bench.parse_args(args))[0]


@pytest.mark.parametrize("fault", ["token", "next_codebook"])
@pytest.mark.parametrize("cell", SERVE)
def test_a_broken_serving_path_is_not_correct(cell, fault, monkeypatch):
    """A token altered where it is produced, and frozen pages installed
    with another page's codebooks."""
    plant(fault, monkeypatch.setattr)
    res = _result(cell)
    assert res["correct"] is False
    assert res["checks"]["max_gap"]["value"] \
        > res["checks"]["max_gap"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    plant(fault, monkeypatch.setattr)
    res = _result(cell)
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(cell):
    """The reference at fp8 judged by the same test as a run: some number
    of the cell reads above its limit."""
    res = _result(cell, control="fp8")
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over and "failed" not in over, res["checks"]
