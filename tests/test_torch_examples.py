"""The port's five examples (``examples/torch_*.py``) run through their
``main(["--device", "cpu", ...])`` at a small size, in a child process
that cannot import jax or the reference package, and their readings held
against the reference's on the same inputs.

Tolerances and why:
- quickstart, the deterministic methods: the same n_values and the l2
  loss within 1e-5 relative (3.4e-7 read, l0). l1 (no refit): its loss
  within 1e-4 relative (5.8e-5 read) and its n_values the support's,
  which is the reference's l1_ls count: the reference reconstructs l1 by
  an f32 cumsum that rounds equal prefixes apart (269 values from 267
  jumps), the port by a sequential host cumsum that keeps them equal.
  The seeded methods (kmeans_ls, kmeans, mog, dtc; the port draws other
  seeds): the loss within x1.5 of the reference's (``LOSS_RATIO`` of
  tests/test_torch_kv_host.py).
- serve_quantized on weights carried over from the reference: the
  compression equal to 1e-12 (the same byte counts), the dense and the
  quantized greedy tokens equal to the reference's pipeline's on the same
  prompts, hence the same agreement.
- trace_serving: the trace reconciled with the counters (exact counts).
- train_lm (2 layers, d 64, vocab 512): the loss falls over 12 steps;
  after the crash at step 9 the steps replayed from step 8's checkpoint
  read the first pass's losses bitwise.
- train_quantized_mlp: QAT accuracy at or above the PTQ accuracy at 4, 8
  and 16 values.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import quantize as jax_quantize
from repro.quant.ptq import compression_ratio as jax_compression_ratio
from repro.quant.ptq import dequantize_tree as jax_dequantize_tree
from repro.quant.ptq import quantize_tree as jax_quantize_tree
from repro_torch import models

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
NAMES = ("quickstart", "serve_quantized", "trace_serving", "train_lm",
         "train_quantized_mlp")
SEEDED = ("kmeans_ls", "kmeans", "mog", "dtc")
DET_RTOL = 1e-5
L1_RTOL = 1e-4
LOSS_RATIO = 1.5


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(EXAMPLES, f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BLOCKED = """
import importlib.util, json, os, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
torch.set_num_threads(1)
out_path, examples, tmp = sys.argv[1:4]

def load(name):
    spec = importlib.util.spec_from_file_location(
        "torch_" + name, os.path.join(examples, "torch_" + name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

cpu = ["--device", "cpu"]
out = {
    "quickstart": load("quickstart").main(cpu),
    "serve_quantized": load("serve_quantized").main(cpu),
    "trace_serving": load("trace_serving").main(
        cpu + ["--out", os.path.join(tmp, "trace")]),
    "train_lm": load("train_lm").main(
        cpu + ["--layers", "2", "--d-model", "64", "--vocab", "512",
               "--steps", "12", "--ckpt-every", "4", "--fail-at", "9",
               "--ckpt-dir", os.path.join(tmp, "ckpt")]),
    "train_quantized_mlp": load("train_quantized_mlp").main(cpu),
}
out["serve_quantized"] = {k: v for k, v in out["serve_quantized"].items()
                          if not k.endswith("_tokens")}
# every module of the port, and chip_smoke.py
import pkgutil, importlib, repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
sys.path.insert(0, os.path.dirname(examples))
import chip_smoke
out["foreign"] = sorted(
    m for m in sys.modules if sys.modules[m] is not None
    and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
json.dump(out, open(out_path, "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    """Every example's ``main`` on the CPU in one child process where
    importing jax or the reference package fails, started with the
    module's first test (it runs beside the in-process ones)."""
    d = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED, str(d / "out.json"), EXAMPLES,
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def runs(child):
    proc, d = child
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    out = json.loads((d / "out.json").read_text())
    out["log"] = stdout
    return out


def test_serve_quantized_on_the_references_weights():
    """The example on the reference's reduced qwen3 weights: the
    reference's PTQ and greedy decode (its example's pipeline) on the
    same prompts give the same compression and tokens."""
    ex = load("serve_quantized")
    jcfg = jax_reduced_config("qwen3_0_6b")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ex.get_reduced_config("qwen3_0_6b")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        got = ex.main(["--device", "cpu"], params=params)
    qtree, report = jax_quantize_tree(jparams, ex.PTQ_SPEC)
    assert got["compression"] == pytest.approx(
        jax_compression_ratio(report), rel=1e-12)
    tokens = jax.numpy.asarray(ex.prompts_for(cfg), jax.numpy.int32)

    def generate(p):
        cache = jmodels.init_cache(jcfg, ex.B, ex.PROMPT_LEN + ex.GEN)
        logits, cache = jmodels.prefill(p, jcfg, {"tokens": tokens}, cache)
        tok = jax.numpy.argmax(logits[:, -1:], -1).astype(jax.numpy.int32)
        out = [tok]
        for i in range(ex.GEN - 1):
            logits, cache = jmodels.decode_step(p, jcfg, tok, cache,
                                                ex.PROMPT_LEN + i)
            tok = jax.numpy.argmax(logits[:, -1:], -1).astype(
                jax.numpy.int32)
            out.append(tok)
        return np.asarray(jax.numpy.concatenate(out, axis=1))

    dense, quant = generate(jparams), generate(jax_dequantize_tree(qtree))
    assert np.array_equal(got["dense_tokens"], dense)
    assert np.array_equal(got["quant_tokens"], quant)
    assert got["agreement"] == float((dense == quant).mean())
    assert got["n_params"] == jmodels.param_count(jparams)
    assert got["completed"] == ex.B and got["host_page_solves"] == 0
    assert 0 < got["migrate_bytes"] < got["migrate_fp_equiv_bytes"]
    assert got["migrated_pages"] == ex.B     # one full page a prompt


def test_examples_run_without_jax_on_the_cpu(runs):
    """The five examples ran, and every module of the port and
    ``chip_smoke.py`` imported, with jax and the reference blocked: none
    of them imports either."""
    assert runs["foreign"] == []
    for name in NAMES:
        assert runs[name]["device"] == "cpu", name
        assert runs[name]["card"] == "the CPU", name


def test_examples_refuse_a_missing_gpu():
    """``--device cuda`` (the default) raises without a GPU; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    for name in NAMES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with contextlib.redirect_stdout(io.StringIO()):
                load(name).main([])


def test_quickstart_matches_the_references_quantize(runs):
    w = np.random.default_rng(0).normal(0, 1, 2000).round(2)
    got = runs["quickstart"]["methods"]
    ref = {spec: jax_quantize(w, spec)[1] for spec in got}
    for spec, row in got.items():
        method, r = spec.split("@")[0].split(":")[0], ref[spec]
        rel = abs(row["l2_loss"] / r["l2_loss"] - 1)
        if method in SEEDED:
            assert row["n_values"] <= 16, spec
            assert row["l2_loss"] <= LOSS_RATIO * r["l2_loss"], spec
        elif method == "l1":
            assert row["n_values"] == ref["l1_ls:lam=0.05"]["n_values"]
            assert rel <= L1_RTOL, (spec, rel)
        else:
            assert row["n_values"] == r["n_values"], spec
            assert rel <= DET_RTOL, (spec, rel)
    k = runs["quickstart"]["kmeans_ls16"]
    assert k["dense_bytes"] == 8000 and k["ratio"] == 8000 / k[
        "compressed_bytes"]


def test_serve_quantized_prices_at_the_h100s_rate(runs):
    r = runs["serve_quantized"]
    est = r["estimate"]
    dense = r["n_params"] * 2
    assert est["t_dense_s"] == pytest.approx(dense / 3.35e12, rel=1e-12)
    assert est["t_quant_s"] == pytest.approx(
        dense / r["compression"] / 3.35e12, rel=1e-12)


def test_trace_serving_reconciles(runs):
    r = runs["trace_serving"]
    assert r["reconciled"] and r["completed"] == 4
    assert r["decode_steps"] > 0 and r["freeze_dispatches"] > 0
    assert r["spec_steps"] > 0 and r["gen_tokens"] == 4 * 12
    assert {"decode/w0", "prefill/w0", "router",
            "transfer"} <= set(r["tracks"])
    assert "-> reconciled" in runs["log"]


def test_train_lm_learns_and_recovers(runs):
    r = runs["train_lm"]
    assert r["mesh"] == [1, 1] and r["restarts"] == 1
    assert r["n_params"] > 0
    losses, steps = r["losses"], r["steps_run"]
    assert losses[-1] < losses[0]
    first, replayed = {}, 0
    for st, loss in zip(steps, losses):
        if st in first:
            assert first[st] == loss, st
            replayed += 1
        first.setdefault(st, loss)
    assert replayed == 1 and sorted(first) == list(range(12))


def test_train_quantized_mlp_qat_recovers_ptq(runs):
    r = runs["train_quantized_mlp"]
    assert r["acc_test"] > 0.85
    assert sorted(r["by_values"]) == ["16", "4", "8"]
    for k, v in r["by_values"].items():
        assert v["n_values"] == int(k)
        assert v["qat"] >= v["ptq"], k
