"""The per-page host freeze of the count methods without a batched device
solver (dp, l0, tv_iter, mog, dtc) as ``--kv-quant``: the port's
``serving.kv_cache.quantize_page`` against the reference's on the same
page rows, the engine's route and counter, and a reduced ``dp@16`` serve
in both packages.

Tolerances: dp codes and codebooks equal (both run the same float64 host
arithmetic); tv_iter codes equal and codebooks within one f32 ulp (its
refit sums in float64 here, in f32 in the reference); l0 equal values kept
and loss within 1e-12 relative;
mog and dtc draw their seeds from a ``torch.Generator`` (the reference
from jax's), so they are held by loss: within x1.5 of the reference's and
never below dp's. The engines' request logits within 1e-3 (the serving
parity bar of tests/test_torch_serving.py), greedy tokens equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.kv_cache import quantize_page as jax_quantize_page
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.core import QuantSpec, device_methods
from repro_torch.serving import (ContinuousBatchingEngine, dispatch_freeze,
                                 init_paged_cache, quantize_page,
                                 resolve_kv_spec)

torch.set_num_threads(1)

HOST_METHODS = ["dp", "l0", "tv_iter", "mog", "dtc"]
LOSS_RATIO = 1.5


def _pages(seed, n=4, shape=(8, 2, 8)):
    """Page rows like the reduced engine's (block 8, Hkv 2, Dh 8): k/v
    values rounded to 3 decimals, so values repeat (weighted problems)."""
    rng = np.random.default_rng(seed)
    return [np.round(rng.normal(size=shape), 3).astype(np.float32)
            for _ in range(n)]


def _loss(page, codes, cb):
    return float(np.sum((page.astype(np.float64)
                         - np.asarray(cb, np.float64)[codes]) ** 2))


def test_every_count_method_resolves_and_only_device_ones_batch():
    for m in HOST_METHODS:
        spec = resolve_kv_spec(f"{m}@16")
        assert spec == QuantSpec(m, num_values=16)
        assert not spec.device_capable
    assert resolve_kv_spec("tv") == QuantSpec("tv_iter", num_values=16)
    assert set(device_methods()) == {"kmeans_ls", "kmeans", "iter_l1"}
    with pytest.raises(ValueError, match="count budget"):
        resolve_kv_spec("l1_ls:lam=0.05")


@pytest.mark.parametrize("method", HOST_METHODS)
def test_quantize_page_against_the_reference(method):
    spec = f"{method}@16"
    for page in _pages(0):
        c, cb = quantize_page(torch.from_numpy(page), spec)
        jc, jcb = jax_quantize_page(page, spec)
        c, cb = c.numpy(), cb.numpy()
        assert c.dtype == np.uint8 and c.shape == page.shape
        assert cb.shape == jcb.shape == (16,)
        loss, jloss = _loss(page, c, cb), _loss(page, jc, jcb)
        dp_c, dp_cb = jax_quantize_page(page, "dp@16")
        dp_loss = _loss(page, dp_c, dp_cb)
        if method == "dp":
            np.testing.assert_array_equal(cb, jcb)
            np.testing.assert_array_equal(c, jc)
        elif method == "tv_iter":
            # the same support; the refit of its values is float64 prefix
            # sums in the port, an f32 one in the reference: one f32 ulp
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_max_ulp(cb, jcb, maxulp=1)
        elif method == "l0":
            assert len(np.unique(cb[c])) == len(np.unique(jcb[jc]))
            assert abs(loss - jloss) <= 1e-12 * jloss
        else:
            assert loss <= LOSS_RATIO * jloss
            assert jloss <= LOSS_RATIO * loss
        assert loss >= dp_loss * (1 - 1e-12)


@pytest.mark.parametrize("method", HOST_METHODS)
def test_host_freeze_solves_each_row_and_pads_the_codebook(method):
    """dispatch_freeze routes a host method to the per-page freeze: one
    solve per (page, layer, k/v) row, complete on return, its codes the
    rows' quantize_page codes (packed), its codebooks padded to 16."""
    cfg = get_reduced_config("yi_34b")
    pool = init_paged_cache(cfg, num_blocks=5, block_size=4, quantized=True,
                            num_values=16, device="cpu")
    gen = torch.Generator().manual_seed(1)
    pool.k_fp.copy_(torch.randn(pool.k_fp.shape, generator=gen).round(
        decimals=1))
    pool.v_fp.copy_(torch.randn(pool.v_fp.shape, generator=gen))
    pending = dispatch_freeze(pool, [3, 1], f"{method}@16")
    assert pending.is_ready() and pending.event is None
    assert pending.host_solves == 2 * cfg.n_layers * 2
    assert pending.cb.shape == (2, cfg.n_layers, 2, 16)
    assert pending.codes.shape == (2, cfg.n_layers, 2, 4, 2, 4)
    if method in ("dp", "tv_iter", "l0"):       # deterministic solvers
        from repro_torch.kernels import pack4
        c, cb = quantize_page(pool.v_fp[1, 3], f"{method}@16")
        assert torch.equal(pending.codes[1, 1, 1], pack4(c))
        assert torch.equal(pending.cb[1, 1, 1], cb)
    # a codebook with fewer values than the budget repeats its last value
    k = pool.k_fp[0, 1]
    c, cb = quantize_page(k, f"{method}@64")
    n = len(torch.unique(k))
    if n < 64:
        assert torch.all(cb[n - 1:] == cb[n - 1])


# ------------------------------------------------------------- engines


PROMPTS_SEED, GEN = 5, 6


def _prompts(vocab):
    rng = np.random.default_rng(PROMPTS_SEED)
    return [rng.integers(0, vocab, n).tolist() for n in (19, 12, 24)]


@pytest.mark.parametrize("attn_impl", ["fused", "gather"])
def test_dp_pages_serve_as_the_reference_engine(attn_impl):
    """--kv-quant dp@16 in both packages on the reduced yi config: the
    host freeze's row solves are counted alike, greedy tokens are equal
    and request logits agree within 1e-3."""
    jcfg = jax_reduced_config("yi_34b")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("yi_34b")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    kw = dict(max_slots=2, block_size=8, max_seq_len=40, kv_quant="dp@16",
              record_logits=True, freeze_async=False, prefill_chunk=7)
    jeng = JaxEngine(jparams, jcfg, attn_impl="gather", **kw)
    ref = jeng.generate(_prompts(cfg.vocab), max_new_tokens=GEN)
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   attn_impl=attn_impl, **kw)
    out = eng.generate(_prompts(cfg.vocab), max_new_tokens=GEN)
    assert out == ref
    assert eng.counters["host_page_solves"] > 0
    assert eng.counters["host_page_solves"] == \
        jeng.counters["host_page_solves"]
    assert eng.counters["freeze_installs"] == eng.counters[
        "freeze_dispatches"] > 0
    for i in range(3):
        np.testing.assert_allclose(eng.request_logits[i],
                                   jeng.request_logits[i], atol=1e-3, rtol=0)


def test_device_methods_make_no_host_solve():
    cfg = get_reduced_config("glm4_9b")
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=2,
                                   block_size=8, max_seq_len=40,
                                   kv_quant="kmeans_ls@16")
    eng.generate(_prompts(cfg.vocab), max_new_tokens=GEN)
    assert eng.counters["freeze_installs"] > 0
    assert eng.counters["host_page_solves"] == 0


def test_launcher_serves_dp_pages_and_passes_its_checks(capsys):
    """The launcher with --kv-quant dp@16 on the reduced config: the trace
    is served through the host freeze, whose solves the summary prints,
    and the serving check (quantized vs fp) and both chunked replays
    pass."""
    from repro_torch.launch import serve

    s = serve.main(["--reduced", "--device", "cpu", "--kv-quant", "dp@16",
                    "--prefill-chunk", "7", "--num-requests", "3",
                    "--request-rate", "8"])
    out = capsys.readouterr().out
    assert s["completed"] == 3 and s["host_page_solves"] > 0
    assert f"{s['host_page_solves']} host page solves" in out
    assert "serving check (dp@16)" in out
    assert out.count("-> OK") == 3, out
