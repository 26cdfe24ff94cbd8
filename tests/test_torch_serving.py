"""Serving: the port's allocator, scheduler, spec resolution and
continuous-batching engine, held against the JAX package's engine on the
reduced qwen3, glm4, yi and gemma2 configs (f32; gemma2's window of 8
binds on the 12-24-token prompts) with kmeans_ls@16 KV pages and chunked
prefill, with dense weights and with the reference's kmeans_ls@16 PTQ'd
weights.

Tolerances: request logits within atol 1e-3 of the reference engine's
(the reference's own fused-vs-gather engine bar, tests/test_serving.py);
chunked vs whole-prompt prefill inside the port within atol 1e-4 on the
CPU, where the two read the same pages but run matmuls of different row
counts (bitwise equality is checked on the card, through the kernel, by
chip_smoke.py).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.quant.ptq import quantize_tree as jax_quantize_tree
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.core import QuantSpec
from repro_torch.kernels import quant_matmul
from repro_torch.launch.serve import PTQ_SKIP
from repro_torch.quant import fallback_count
from repro_torch.serving import (BlockAllocator, ContinuousBatchingEngine,
                                 ContinuousBatchingScheduler, DoubleFree,
                                 PoolExhausted, Request, poisson_trace,
                                 resolve_kv_spec)

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

pytestmark = pytest.mark.serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ------------------------------------------------------------- allocator


def test_allocator_refcounts_and_double_free():
    a = BlockAllocator(6)
    got = a.alloc(3)
    assert got == [1, 2, 3] and a.num_free == 2
    a.retain([2])
    assert a.refcount(2) == 2
    assert a.free([1, 2]) == [1]             # 2 still held by a second table
    assert a.free([2]) == [2] and a.refcount(2) == 0
    with pytest.raises(DoubleFree) as ei:
        a.free([2])
    assert ei.value.block == 2
    with pytest.raises(DoubleFree):
        a.free([0])                          # the null page is never live
    with pytest.raises(ValueError):
        a.retain([4])                        # not live
    with pytest.raises(PoolExhausted) as ei:
        a.alloc(9)
    assert (ei.value.requested, ei.value.free) == (9, a.num_free)
    # the free list and the live pages partition the allocatable pool
    assert a.num_free + len(a._used) == 5


def test_scheduler_admission_is_worst_case_fcfs():
    s = ContinuousBatchingScheduler(max_slots=2, block_size=8, max_queue=3)
    reqs = [Request(id=i, prompt=(1,) * 10, max_new_tokens=6)
            for i in range(4)]
    assert [s.submit(r) for r in reqs] == [True, True, True, False]
    assert s.rejected == [3]
    admitted = s.schedule(free_blocks=5)     # 2 blocks each: two fit
    assert [st.req.id for st in admitted] == [0, 1]
    assert s.schedule(free_blocks=5) == []   # no free slot
    s.release(admitted[0])
    assert [st.req.id for st in s.schedule(free_blocks=1)] == []
    assert [st.req.id for st in s.schedule(free_blocks=2)] == [2]


def test_poisson_trace_matches_reference():
    kw = dict(vocab=499, prompt_len=12, max_new_tokens=5, seed=3)
    ours, ref = poisson_trace(6, 4.0, **kw), jax_poisson_trace(6, 4.0, **kw)
    for a, b in zip(ours, ref):
        assert (a.id, a.prompt, a.max_new_tokens, a.arrival_time, a.seed) \
            == (b.id, b.prompt, b.max_new_tokens, b.arrival_time, b.seed)


def test_kv_spec_resolution_and_unfreezable_specs(reduced):
    _, _, cfg, params = reduced
    assert resolve_kv_spec("kmeans_ls@16") == QuantSpec("kmeans_ls", 16)
    assert resolve_kv_spec(None, method="kmeans_ls", num_values=8) \
        == QuantSpec("kmeans_ls", num_values=8)
    for good in ("iter_l1@16", "kmeans@16"):
        assert resolve_kv_spec(good) == QuantSpec.parse(good)
    for bad in ("tv:lam=0.05", "l1_ls@16", "l1_ls:lam=0.05"):
        with pytest.raises(ValueError, match="kmeans_ls"):
            ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=1,
                                     block_size=8, max_seq_len=16,
                                     kv_quant=bad)


def test_entry_points_default_to_the_card(reduced):
    """Without a GPU, the default device raises instead of falling back."""
    _, _, cfg, params = reduced
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(params, cfg)
    eng = ContinuousBatchingEngine(params, cfg, device="cpu")
    assert eng.attn_impl == "gather"          # auto: gather on the CPU


@pytest.mark.parametrize("head_dim,num_values,refused", [
    (8, 16, None), (16, 16, None), (24, 16, None),
    (128, 16, None), (128, None, None), (32, 16, None),
    (128, 300, "codebook width 300"), (257, 16, "head_dim 257"),
    (257, None, "head_dim 257"), (9, 16, "head_dim 9 on a packed pool"),
    (9, None, None), (9, 200, None), (256, 256, None), (1, None, None),
    (128, 17, None)])
def test_fused_cuda_engine_raises_on_pools_the_kernel_refuses(
        head_dim, num_values, refused):
    """On CUDA ``auto`` is the fused kernel on every pool, and both
    ``auto`` and ``fused`` raise, naming the shape, on a pool the kernel
    refuses (head_dim past 256, an odd head_dim on a packed pool, a
    codebook wider than 16 packed or 256 unpacked) instead of reading it
    another way; every head_dim 1-256 takes the kernel otherwise, among
    them the reference's reduced yi/glm4 (Dh 8), gemma2/granite (16) and
    deepseek (24) shapes. ``gather`` is asked for, never chosen. No card
    is needed: the resolution reads shapes only."""
    from repro_torch.serving.engine import _resolve_attn_impl

    cuda = torch.device("cuda")
    kw = dict(head_dim=head_dim, block_size=16, num_values=num_values)
    for impl in ("auto", "fused"):
        if refused:
            with pytest.raises(ValueError, match=f"refuses this pool: "
                                                 f"{refused}"):
                _resolve_attn_impl(impl, cuda, **kw)
        else:
            assert _resolve_attn_impl(impl, cuda, **kw) == "fused"
    assert _resolve_attn_impl("gather", cuda, **kw) == "gather"
    # the CPU runs the kernel's plain version, which takes any pool
    assert _resolve_attn_impl("fused", torch.device("cpu"), **kw) == "fused"
    assert _resolve_attn_impl("auto", torch.device("cpu"), **kw) == "gather"


def test_kernel_takes_every_reference_config_and_kernel_test_shape():
    """shape_refusal takes the head_dim of every reference config, full
    and reduced, at blocks of 8, 16, 32 and 64 keys, on fp, packed (16
    values) and unpacked (256) pools, and the reference kernel tests' own
    shapes (tests/test_kernels.py:147,170: Dh 16, block 8); it refuses a
    head_dim past 256, an odd one on a packed pool and a block past 128."""
    from repro.configs import get_config as jax_config
    from repro.configs import list_archs
    from repro_torch.kernels.paged_attention import shape_refusal

    dims = set()
    for arch in list_archs():
        dims |= {jax_config(arch).head_dim,
                 jax_reduced_config(arch).head_dim}
    assert {8, 16, 24, 128} <= dims
    for Dh in sorted(dims):
        for bs in (8, 16, 32, 64):
            for nv, packed in ((None, True), (16, True), (256, False)):
                assert shape_refusal(Dh, bs, nv, packed=packed) is None, (
                    Dh, bs, nv)
    assert shape_refusal(16, 8) is None
    assert shape_refusal(16, 8, 16, packed=True) is None
    assert shape_refusal(16, 8, 16, packed=False) is None
    assert "head_dim 257" in shape_refusal(257, 16)
    assert "packed" in shape_refusal(25, 16, 16, packed=True)
    assert shape_refusal(25, 16, 16, packed=False) is None
    assert "block size 129" in shape_refusal(128, 129)


def test_fused_cuda_engine_raises_on_an_odd_block_size():
    """Blocks of 1-128 keys take the kernel, powers of two or not (24 and
    48 were refused before the kernel cut its splits in keys); a block
    past 128 is refused, naming it."""
    from repro_torch.serving.engine import _resolve_attn_impl

    for impl, bs, nv in (("auto", 24, 16), ("fused", 48, None),
                         ("auto", 1, 16), ("fused", 128, 200),
                         ("auto", 100, None)):
        assert _resolve_attn_impl(impl, torch.device("cuda"), head_dim=128,
                                  block_size=bs, num_values=nv) == "fused"
    for impl, bs, nv in (("auto", 129, 16), ("fused", 256, None)):
        with pytest.raises(ValueError, match=f"block size {bs}"):
            _resolve_attn_impl(impl, torch.device("cuda"), head_dim=128,
                               block_size=bs, num_values=nv)


@pytest.mark.parametrize("arch", ["glm4_9b", "yi_34b", "gemma2_27b"])
@pytest.mark.parametrize("block_size", [1, 5, 7, 12, 13])
@pytest.mark.parametrize("num_values", [None, 16, 5, 200])
def test_every_layer_of_a_pool_is_a_kernel_operand(arch, block_size,
                                                   num_values):
    """Each layer's view of the stacked pools is what the kernel wrapper
    demands of an operand (contiguous, 16-byte aligned) at every block
    size, also where one layer's pages are not a whole number of 16-byte
    pieces (reduced glm4/yi: Dh 8, 2 KV heads, 4-byte packed code rows;
    the engine's default page count is odd), in f32 and bf16, and the
    layers' pages do not overlap."""
    from repro_torch.serving.kv_cache import init_paged_cache

    cfg = get_reduced_config(arch)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        pool = init_paged_cache(
            c, num_blocks=2 * 6 + 1, block_size=block_size,
            quantized=num_values is not None, num_values=num_values or 16,
            device="cpu")
        views = [pool.layer(i, None, None) for i in range(pool.n_layers)]
        names = ["k_fp", "v_fp"] + (["k_codes", "v_codes", "k_cb", "v_cb"]
                                    if pool.quantized else [])
        for name in names:
            ends = []
            for v in views:
                t = getattr(v, name)
                assert t.shape[0] == 13 and t.is_contiguous(), name
                assert t.data_ptr() % 16 == 0, (name, t.data_ptr() % 16)
                ends.append((t.data_ptr(),
                             t.data_ptr() + t.numel() * t.element_size()))
            assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])), name


def test_paged_layer_converter_feeds_both_packages_one_pool(reduced):
    """A reference paged layer with pages frozen by the reference's own
    solver, converted into the port: the port's fused decode (write +
    attention over frozen and hot pages) matches the reference's within
    2e-5 / 1e-4, and the pool the port wrote equals the reference's."""
    import dataclasses

    import jax.numpy as jnp

    from repro.serving.kv_cache import freeze_blocks as jax_freeze_blocks
    from repro.serving.kv_cache import init_paged_layer as jax_paged_layer
    from repro_torch.serving import paged_layer_from_reference

    jcfg = reduced[0]
    rng = np.random.default_rng(6)
    leaf = jax_paged_layer(jcfg, num_blocks=8, block_size=8, batch=2,
                           max_blocks=3, quantized=True, num_values=16,
                           dtype=jnp.float32, fused=True)
    leaf = dataclasses.replace(
        leaf,
        k_fp=jnp.asarray(rng.normal(size=leaf.k_fp.shape), jnp.float32),
        v_fp=jnp.asarray(rng.normal(size=leaf.v_fp.shape), jnp.float32),
        block_table=jnp.asarray([[3, 1, 2], [5, 4, 0]], np.int32),
        seq_lens=jnp.asarray([17, 9], np.int32))
    leaf = jax_freeze_blocks(leaf, [3, 1, 5])      # pages 2 and 4 stay hot
    port = paged_layer_from_reference(
        {f: np.asarray(getattr(leaf, f)) for f in leaf._LEAVES},
        block_size=8, quantized=True, packed=True, device="cpu")
    port.fused = True
    H, Hkv, Dh = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    q, k, v = (rng.normal(size=(2, 1, h, Dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    jnew, jout = leaf.fused_decode(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v))
    _, out = port.fused_decode(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_array_equal(port.k_fp.numpy(), np.asarray(jnew.k_fp))
    np.testing.assert_array_equal(port.v_codes.numpy(),
                                  np.asarray(jnew.v_codes))


# ------------------------------------------------------------- engine


PROMPT_LENS = (19, 12, 24)
GEN = 6


def _prompts(cfg):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]


def _engine_kw():
    return dict(max_slots=2, block_size=8, max_seq_len=40,
                kv_quant="kmeans_ls@16", record_logits=True,
                freeze_async=False)


@pytest.fixture(scope="module")
def jax_run(reduced):
    """One live reference run: gather reads, chunked prefill (C = 7)."""
    jcfg, jparams, cfg, _ = reduced
    eng = JaxEngine(jparams, jcfg, attn_impl="gather", prefill_chunk=7,
                    **_engine_kw())
    out = eng.generate(_prompts(cfg), max_new_tokens=GEN)
    assert eng.counters["freeze_installs"] > 0
    return out, eng.request_logits


@pytest.mark.parametrize("attn_impl", ["fused", "gather"])
def test_engine_matches_reference_engine(reduced, jax_run, attn_impl):
    """Same greedy tokens and request logits within 1e-3 as the reference
    engine, with pages frozen to kmeans_ls@16 mid-run."""
    _, _, cfg, params = reduced
    ref_out, ref_logits = jax_run
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   attn_impl=attn_impl, prefill_chunk=7,
                                   **_engine_kw())
    out = eng.generate(_prompts(cfg), max_new_tokens=GEN)
    assert out == ref_out
    assert eng.counters["freeze_installs"] > 0
    for i in range(len(PROMPT_LENS)):
        np.testing.assert_allclose(eng.request_logits[i], ref_logits[i],
                                   atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def quantized(reduced):
    """The reference's PTQ'd tree (kmeans_ls@16, the launcher's skip list:
    all seven projections of every layer), the port's conversion of it,
    and one live reference engine run on it."""
    jcfg, jparams, cfg, _ = reduced
    jq, _ = jax_quantize_tree(jparams, "kmeans_ls@16",
                              skip_patterns=PTQ_SKIP)
    params = models.params_from_reference(jax.tree.map(np.asarray, jq), cfg,
                                          "cpu")
    eng = JaxEngine(jq, jcfg, attn_impl="gather", prefill_chunk=7,
                    **_engine_kw())
    out = eng.generate(_prompts(cfg), max_new_tokens=GEN)
    return params, out, eng.request_logits


@pytest.mark.parametrize("attn_impl", ["fused", "gather"])
def test_engine_on_quantized_weights_matches_reference_engine(
        reduced, quantized, attn_impl):
    """Both packages serve the same codes: same greedy tokens, request
    logits within 1e-3, no dense fallback."""
    _, _, cfg, _ = reduced
    params, ref_out, ref_logits = quantized
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   attn_impl=attn_impl, prefill_chunk=7,
                                   **_engine_kw())
    n0 = fallback_count()
    out = eng.generate(_prompts(cfg), max_new_tokens=GEN)
    assert out == ref_out and fallback_count() == n0
    for i in range(len(PROMPT_LENS)):
        np.testing.assert_allclose(eng.request_logits[i], ref_logits[i],
                                   atol=1e-3, rtol=0)


def test_chunked_prefill_matches_whole_prompt(reduced):
    """Inside the port: prompts prefilled in chunks of 5 through the fused
    path == whole-prompt prefill (same tokens, logits within 1e-4)."""
    _, _, cfg, params = reduced
    runs = []
    for chunk in (None, 5):
        eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                       attn_impl="fused", prefill_chunk=chunk,
                                       **_engine_kw())
        runs.append((eng.generate(_prompts(cfg), max_new_tokens=GEN), eng))
    (whole, e0), (chunked, e1) = runs
    assert whole == chunked
    assert e1.prefill.counters["prefill_chunks"] > len(PROMPT_LENS)
    for i in range(len(PROMPT_LENS)):
        np.testing.assert_allclose(e1.request_logits[i],
                                   e0.request_logits[i], atol=1e-4, rtol=0)


def test_port_runs_without_jax():
    """Import the whole port (every config module too) with jax blocked,
    PTQ the reduced model and serve one request from its codes: the port
    needs no JAX."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        import repro_torch.launch.serve, repro_torch.quant
        import repro_torch.serving
        from repro_torch import models
        from repro_torch.configs import ARCHS, get_config, get_reduced_config
        from repro_torch.launch.serve import PTQ_SKIP
        from repro_torch.quant import quantize_tree
        from repro_torch.serving import ContinuousBatchingEngine
        for arch in ARCHS:             # every config module of the port
            get_config(arch), get_reduced_config(arch)
        assert not any(m == "repro" or m.startswith(("repro.", "jax"))
                       for m in sys.modules if sys.modules[m] is not None)
        cfg = get_reduced_config("qwen3_0_6b")
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        params, report = quantize_tree(params, "kmeans_ls@16",
                                       skip_patterns=PTQ_SKIP)
        assert len(report) == 7 * cfg.n_layers
        eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                       max_slots=1, block_size=8,
                                       max_seq_len=32, kv_quant="kmeans_ls@16",
                                       attn_impl="fused", prefill_chunk=5)
        out = eng.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9]], max_new_tokens=2)
        assert len(out[0]) == 2, out
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_launcher_serves_and_passes_both_replay_checks(capsys):
    """The port's launcher on the reduced config (the CI serve gate's
    configuration without --quantize): it serves a trace, and both replay
    checks run and pass: quantized vs fp within the reference's abs 2.5 /
    8% of the range; chunked vs single-shot in f32, on an fp pool and on
    the kmeans_ls@16 pool, with equal greedy tokens and logits within
    1e-4 / 1% of the range."""
    from repro_torch.launch import serve

    s = serve.main(["--reduced", "--device", "cpu", "--kv-quant",
                    "kmeans_ls@16", "--prefill-chunk", "7",
                    "--num-requests", "3", "--request-rate", "8"])
    out = capsys.readouterr().out
    assert s["completed"] == 3 and s["freeze_installs"] > 0
    assert "serving check (kmeans_ls@16)" in out
    assert out.count("chunked-prefill check") == 2
    assert out.count("greedy tokens equal") == 2
    assert out.count("-> OK") == 3, out


def test_launcher_serves_quantized_weights_and_passes_replays(capsys):
    """The CI serve gate's configuration on the CPU: --quantize
    kmeans_ls@16 PTQs all seven projections of every layer, the trace is
    served from their codes with no dense fallback, and the replays (which
    serve the same codes, in f32 for the chunked one) pass."""
    from repro_torch.launch import serve

    q0 = quant_matmul.launches
    s = serve.main(["--reduced", "--device", "cpu", "--quantize",
                    "kmeans_ls@16", "--kv-quant", "kmeans_ls@16",
                    "--prefill-chunk", "7", "--num-requests", "3",
                    "--request-rate", "8"])
    out = capsys.readouterr().out
    assert s["completed"] == 3 and s["qmatmul_dequant_fallback"] == 0
    assert s["ptq"]["tensors"] == 28 and s["ptq"]["compression"] > 7
    # the CPU takes the plain version: no kernel launches
    assert s["quant_matmul_launches"] == 0 and quant_matmul.launches == q0
    assert "PTQ kmeans_ls@16: 28 tensors" in out
    assert "qmatmul_dequant_fallback=0" in out
    assert out.count("greedy tokens equal") == 2
    assert out.count("-> OK") == 3, out
