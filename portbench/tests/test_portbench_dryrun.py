"""A CPU dry run of every cell on the configurations' reduced sizes: the
last line parses to the contract, the import check holds, and the run
refuses without a card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.yardstick.imports import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(*args, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _applies(m, cell):
    return "workloads" not in m or cell in m["workloads"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_dry_run_prints_the_contracts_line(cell, trace):
    p = _run("--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds",
             "2", "--trace", str(trace), "--cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert p.stderr.strip().splitlines()[-1].startswith("[portbench] check")
    if trace == 0:
        want = {m["name"] for m in BENCH["end_to_end"] if _applies(m, cell)}
        assert set(res["metrics"]) == want
    else:
        names = {m["name"] for m in BENCH["per_layer"] if _applies(m, cell)}
        assert set(res["metrics"]) <= names
    for name, m in res["metrics"].items():
        assert isinstance(m["value"], float) and m["value"] >= 0, name
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name


def test_a_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the refusal shows only on a machine with no card")
    p = _run("--workload", CELLS[0], "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and not p.stdout.strip()


def test_forbidden_names_are_compared_whole():
    assert forbidden_loaded(["repro_torch", "repro_torch.serving",
                             "jaxtyping", "reprolib", "flaxen"]) == []
    assert forbidden_loaded(["repro.core", "jax.numpy", "jaxlib",
                             "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                "repro"]


def test_no_file_of_the_benchmark_imports_jax_or_reads_the_jax_tree():
    for path in (ROOT / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert forbidden_loaded(mods) == [], (path, mods)
        if "tests" not in path.parts:
            assert "benchmarks" not in path.read_text(), path


@pytest.mark.parametrize("cell", CELLS)
def test_the_card_limits_name_what_the_dry_run_checks(cell):
    limits = json.loads((ROOT / "portbench" / "checks" / f"{cell}.json")
                        .read_text())
    dry = limits.pop("cpu_dry_run")
    assert set(limits) == set(dry)
    assert all(isinstance(v, float) and v > 0 for v in limits.values())
