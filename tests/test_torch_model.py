"""LM forward, prefill and decode: the port against ``repro.models`` on the
reference's own parameters (converted by ``params_from_reference``), on
the reduced qwen3 config (4 layers, d_model 64, Hkv 2, Dh 32, f32), with
dense weights and with the reference's kmeans_ls@16 PTQ'd weights.

Tolerance: atol 1e-4 / rtol 1e-4 on f32 logits of magnitude ~10. Both
packages run the same f32 math; matmuls and reductions sum in different
orders, which moves logits by ~1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.quant.ptq import quantize_tree as jax_quantize_tree
from repro.serving.kv_cache import init_paged_cache as jax_init_paged_cache
from repro.serving.kv_cache import with_tables as jax_with_tables
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.core import QuantizedTensor
from repro_torch.launch.serve import PTQ_SKIP
from repro_torch.quant import fallback_count
from repro_torch.serving.kv_cache import init_paged_cache, with_tables

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

ATOL = RTOL = 1e-4


# the reduced configs of every arch the port serves: qwen3 (qk-norm, tied
# head), glm4 (Dh 8, G = 4, untied head), yi (Dh 8, 3 layers, untied) and
# gemma2 (Dh 16, local window 8 + global, softcaps, post-block norms,
# GeGLU, scaled tied embedding)
ARCHS = ["qwen3_0_6b", "glm4_9b", "yi_34b", "gemma2_27b"]


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    jcfg = jax_reduced_config(request.param)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config(request.param)
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
           "d_ff", "vocab", "qk_norm", "rope_theta", "tie_embeddings",
           "attn_softcap", "final_softcap", "post_block_norm", "act",
           "embed_scale", "param_dtype", "compute_dtype")


def _layers(cfg):
    specs = list(cfg.head_layers) + list(cfg.group) * cfg.n_groups
    return [(s.mixer, s.ffn, s.window) for s in specs]


def test_config_matches_reference(reduced):
    jcfg, _, cfg, _ = reduced
    for f in _FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert _layers(cfg) == _layers(jcfg)
    # the full config too: its widths are what the card serves
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    arch = cfg.name.split("-")[0]
    arch = {"qwen3": "qwen3_0_6b", "glm4": "glm4_9b", "yi": "yi_34b",
            "gemma2": "gemma2_27b"}[arch]
    a, b = jax_config(arch), get_config(arch)
    for f in _FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert _layers(a) == _layers(b)


def test_lm_forward_logits_match_reference(reduced):
    jcfg, jparams, cfg, params = reduced
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 11))
    ref = jmodels.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                          train=False)
    got = models.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_prefill_then_decode_over_paged_cache_matches_reference(reduced):
    """Prefill two prompts into a paged pool, then three decode steps at
    per-sequence lengths, through the gather read path of both packages
    (the same block tables on both sides)."""
    jcfg, jparams, cfg, params = reduced
    rng = np.random.default_rng(1)
    bs, nb, mb = 8, 9, 4
    P = 16                                    # two full pages per prompt
    prompts = rng.integers(0, cfg.vocab, (2, P))
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jtree = jax_init_paged_cache(jcfg, num_blocks=nb, block_size=bs, batch=2,
                                 max_blocks=mb)
    pool = init_paged_cache(cfg, num_blocks=nb, block_size=bs, device="cpu")
    lens = np.zeros((2,), np.int32)
    jlog, jtree = jmodels.prefill(jparams, jcfg,
                                  {"tokens": jnp.asarray(prompts)},
                                  jax_with_tables(jtree, table, lens))
    plog, _ = models.prefill(params, cfg,
                             {"tokens": torch.from_numpy(prompts)},
                             with_tables(pool, table, lens))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=RTOL)
    lens = np.asarray([P, P - 3], np.int32)   # ragged: row 1 rewrites
    toks = rng.integers(0, cfg.vocab, (2, 1))
    for _ in range(3):
        jlog, jtree = jmodels.decode_step(
            jparams, jcfg, jnp.asarray(toks),
            jax_with_tables(jtree, table, lens), jnp.asarray(lens))
        views = with_tables(pool, table, lens)
        plog, _ = models.decode_step(params, cfg, torch.from_numpy(toks),
                                     views, views[0].seq_lens)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=RTOL)

        toks = np.asarray(jlog[:, -1]).argmax(-1)[:, None]
        lens = lens + 1


def test_prefill_then_decode_over_dense_ring_cache_matches_reference(
        reduced):
    """The dense ring-buffer adapter (a scalar cache index) against the
    reference's."""
    jcfg, jparams, cfg, params = reduced
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab, (2, 9))
    jcache = jmodels.init_cache(jcfg, 2, 16)
    cache = models.init_cache(cfg, 2, 16, "cpu")
    jlog, jcache = jmodels.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(prompts)}, jcache)
    plog, cache = models.prefill(params, cfg,
                                 {"tokens": torch.from_numpy(prompts)}, cache)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=RTOL)
    toks = np.asarray(jlog[:, -1]).argmax(-1)[:, None]
    for i in range(2):
        jlog, jcache = jmodels.decode_step(jparams, jcfg, jnp.asarray(toks),
                                           jcache, 9 + i)
        plog, cache = models.decode_step(params, cfg, torch.from_numpy(toks),
                                         cache, 9 + i)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=RTOL)
        toks = np.asarray(jlog[:, -1]).argmax(-1)[:, None]


def test_lm_forward_on_quantized_weights_matches_reference(reduced):
    """The reference's PTQ'd tree (kmeans_ls@16 on all seven projections of
    every layer) carried across: the port serves the same codes through
    qmatmul and gives the reference's logits (which run its quant_matmul
    kernel in interpret mode)."""
    jcfg, jparams, cfg, _ = reduced
    jq, _ = jax_quantize_tree(jparams, "kmeans_ls@16",
                              skip_patterns=PTQ_SKIP)
    params = models.params_from_reference(jax.tree.map(np.asarray, jq), cfg,
                                          "cpu")
    G = len(cfg.group)
    wq = params["layers"][2]["mixer"]["wq"]
    assert isinstance(wq, QuantizedTensor) and not wq.stacked
    np.testing.assert_array_equal(
        wq.indices.numpy(), np.asarray(jq["groups"][f"l{2 % G}"]["mixer"]
                                       ["wq"].indices[2 // G]))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 11))
    ref = jmodels.forward(jq, jcfg, {"tokens": jnp.asarray(toks)},
                          train=False)
    n0 = fallback_count()
    got = models.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert fallback_count() == n0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_param_count_matches_reference(reduced):
    """``models.param_count`` on weights carried over from the reference:
    the reference's count (its stacked groups hold the same elements as
    the port's layer list)."""
    jcfg, jparams, cfg, params = reduced
    assert models.param_count(params) == jmodels.param_count(jparams)


LN_TOL = 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """``models.norms.layer_norm``: f32 statistics, the (1 + scale)
    convention, x's dtype out; within 1e-6 of the reference's (f32 read
    4.8e-7 on values of magnitude ~3; bf16 reads 0: both round one f32
    result)."""
    import ml_dtypes

    from repro.models.norms import layer_norm as jax_layer_norm
    from repro_torch.models.norms import layer_norm

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 7, 96)) * 3 + 0.7).astype(np.float32)
    scale = (rng.normal(size=96) * 0.1).astype(np.float32)
    bias = (rng.normal(size=96) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x, scale, bias = (a.astype(ml_dtypes.bfloat16)
                          for a in (x, scale, bias))
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias))).astype(np.float32)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            getattr(torch, dtype))

    got = layer_norm(t(x), t(scale), t(bias))
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(got.float().numpy() - ref).max() <= LN_TOL
