"""The static engine (``repro_torch.launch.static_steps``, ``--engine
static``) held to the reference's ``repro.launch.static_steps`` on carried
weights (reduced qwen3, and gemma2, whose local layers read a window of
the ring cache), and to the continuous engine on an fp pool; the
launcher's flags for the static and disaggregated engines.

Tolerances: greedy tokens equal; logits within atol 1e-4 of the
reference's step logits (the LM bar of ``tests/test_torch_model.py``);
static vs continuous inside the port, equal greedy tokens and logits
within 1e-4 of their range (the two differ only in the row counts of
their matmuls: a batch of B prompts against one prompt a prefill).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.launch.static_steps import (static_decode_step as
                                       jax_static_decode_step)
from repro.launch.static_steps import static_prefill as jax_static_prefill
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.launch import serve
from repro_torch.launch.static_steps import static_generate
from repro_torch.quant import dequantize_tree, quantize_tree
from repro_torch.serving import ContinuousBatchingEngine

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

B, P, G = 3, 12, 6


@pytest.fixture(scope="module", params=["qwen3_0_6b", "gemma2_27b"])
def reduced(request):
    jcfg = jax_reduced_config(request.param)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config(request.param)
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, P)) \
        .astype(np.int32)


def test_static_tokens_and_logits_match_the_reference(reduced):
    jcfg, jparams, cfg, params = reduced
    toks = _tokens(cfg)
    tok, cache = jax_static_prefill(jparams, jcfg, jnp.asarray(toks), None,
                                    G)
    ref_toks = [np.asarray(tok)]
    # the reference's steps return tokens only: its logits come from the
    # same cache and positions through the model facade
    ref_logits = [np.asarray(jmodels.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks)},
        jmodels.init_cache(jcfg, B, P + G, enc_len=P))[0][:, -1])]
    for i in range(G - 1):
        logits, _ = jmodels.decode_step(jparams, jcfg, tok, cache,
                                        jnp.int32(P + i))
        ref_logits.append(np.asarray(logits[:, -1]))
        tok, cache = jax_static_decode_step(jparams, jcfg, tok, cache,
                                            jnp.int32(P + i))
        ref_toks.append(np.asarray(tok))
    ref_toks = np.concatenate(ref_toks, axis=1)
    out, logits = static_generate(params, cfg, torch.from_numpy(toks), G)
    assert out.dtype == torch.int32 and out.shape == (B, G)
    np.testing.assert_array_equal(out.numpy(), ref_toks)
    np.testing.assert_allclose(logits.numpy(), np.stack(ref_logits, 1),
                               atol=1e-4, rtol=0)


def test_static_equals_continuous_engine_on_an_fp_pool(reduced):
    _, _, cfg, params = reduced
    toks = _tokens(cfg, 1)
    out, logits = static_generate(params, cfg, torch.from_numpy(toks), G)
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=B,
                                   block_size=8, max_seq_len=32,
                                   record_logits=True)
    got = eng.generate(toks.tolist(), max_new_tokens=G)
    assert [got[i] for i in range(B)] == out.tolist()
    scale = float(logits.abs().max())
    for i in range(B):
        d = np.abs(eng.request_logits[i] - logits[i].numpy()).max()
        assert d <= 1e-4 * scale, (i, d, scale)


def test_launcher_static_serves_dequantized_codes(capsys):
    """``--engine static --quantize`` on the CPU: the PTQ'd weights
    dequantized, the batch generated, finite logits; the tokens are the
    static steps' on the same dense weights."""
    args = serve.parse_args(["--engine", "static", "--reduced", "--device",
                             "cpu", "--quantize", "kmeans_ls@16",
                             "--batch", "2"])
    assert (args.prompt_len, args.gen) == (16, 16)
    r = serve.run(args)
    assert r["tokens"].shape == (2, 16)
    assert bool(torch.isfinite(r["logits"]).all())
    assert "[serve] static on cpu" in capsys.readouterr().out
    cfg = r["cfg"]
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dense = dequantize_tree(quantize_tree(
        params, "kmeans_ls@16", skip_patterns=serve.PTQ_SKIP)[0])
    out, _ = static_generate(dense, cfg, serve.static_prompts(cfg, args,
                                                              "cpu"), 16)
    assert torch.equal(out, r["tokens"])


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "disagg", "--prefill-chunk", "7"], "prefill-chunk"),
    (["--engine", "disagg", "--prefix-cache"], "prefix-cache"),
    (["--engine", "static", "--prefill-chunk", "7"], "prefill-chunk"),
    (["--speculate", "2", "--temperature", "0.5"], "greedy"),
    (["--engine", "static", "--shared-prefix-len", "4"], "shared-prefix"),
    (["--freeze-page-budget", "0"], "freeze-page-budget"),
    (["--engine", "disagg", "--decode-workers", "0"], "decode-workers"),
    (["--engine", "disagg", "--staging-depth", "0"], "staging-depth"),
])
def test_launcher_refuses_what_the_engine_does_not_compose(argv, msg,
                                                           capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert msg in capsys.readouterr().err


def test_launcher_migrate_takes_fp_only():
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "disagg", "--migrate", "frozen"])
    args = serve.parse_args(["--engine", "disagg", "--migrate", "fp"])
    assert (args.prompt_len, args.gen, args.migrate) == (64, 32, "fp")


def test_launcher_disagg_serves_and_checks_on_the_cpu(capsys):
    """``--engine disagg`` with two decode workers on the CPU: every
    request completes, the handoffs and bytes are reported per worker,
    and the serving check passes on the disagg composition."""
    args = serve.parse_args(
        ["--engine", "disagg", "--reduced", "--device", "cpu",
         "--prefill-workers", "1", "--decode-workers", "2", "--kv-quant",
         "kmeans_ls@16", "--num-requests", "4", "--prompt-len", "24",
         "--gen", "8", "--max-seq-len", "64", "--request-rate", "50"])
    s = serve.run(args)
    out = capsys.readouterr().out
    assert s["completed"] == 4 and s["migrated_seqs"] == 4
    assert s["prefills_done"] == 4
    assert s["migrate_bytes"] == s["migrate_fp_equiv_bytes"] > 0
    assert sum(w["migrated_seqs"] for w in s["per_worker"]["decode"]) == 4
    assert "decode worker 1:" in out and "MB crossed" in out
    assert "serving check (kmeans_ls@16)" in out and "-> OK" in out
