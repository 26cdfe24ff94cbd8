"""The MoE, MLA, M-RoPE and encoder-decoder families: the port against
``repro.models`` on the reference's own parameters (converted by
``params_from_reference``) and seeded numpy inputs, on the reduced
granite-moe-3b-a800m (attention + MoE, tied head), deepseek-v2-lite-16b
(MLA; a dense head layer, then MLA + MoE with 2 shared experts),
qwen2-vl-72b (embeddings in, M-RoPE over 3 position streams) and
whisper-tiny (encoder-decoder with cross-attention) configs, f32; and
the port's launcher against the reference launcher's outcome on each
family.

Tolerance: atol/rtol 1e-4 on f32 logits (both packages run the same f32
math in other summation orders); prefill + decode at the reference's own
2e-3 (``tests/test_models_smoke.py``), with the MoE capacity factor
raised to 8.0 there so that nothing drops (capacity is per call, so a
prefill of S - 1 tokens routes otherwise than a forward of S at the
default 1.25); engine request logits at the engine bar 1e-3; the int8
ring cache's codes bitwise and its scales at 1e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced_config
from repro.models import attention as jattn
from repro.models.cache import Int8RingCache as JaxInt8RingCache
from repro.models.rope import apply_mrope as jax_apply_mrope
from repro.quant.ptq import DEFAULT_SKIP
from repro.quant.ptq import _names as _jax_names
from repro.quant.ptq import should_quantize as jax_should_quantize
from repro.quant.ptq import quantize_tree as jax_quantize_tree
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro_torch import models
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import serve
from repro_torch.launch.serve import PTQ_SKIP
from repro_torch.models import attention, transformer
from repro_torch.models.cache import Int8RingCache
from repro_torch.models.convert import _tree
from repro_torch.models.rope import apply_mrope
from repro_torch.quant import quantize_tree
from repro_torch.serving import ContinuousBatchingEngine

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
STEP_TOL = 2e-3
FAMILIES = ["granite_moe_3b_a800m", "deepseek_v2_lite_16b", "qwen2_vl_72b",
            "whisper_tiny"]
B, S = 2, 11
# the reference's entry points jitted (one compile a shape instead of an
# eager dispatch an op); the cache index of a decode step stays traced
_jinit = jax.jit(jmodels.init_params, static_argnums=0)
_jforward = jax.jit(jmodels.forward, static_argnums=1,
                    static_argnames=("train", "return_hidden"))
_jprefill = jax.jit(jmodels.prefill, static_argnums=1)
_jdecode = jax.jit(jmodels.decode_step, static_argnums=1)


@pytest.fixture(scope="module", params=FAMILIES)
def reduced(request):
    jcfg = jax_reduced_config(request.param)
    jparams = _jinit(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config(request.param)
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed=0, S=S):
    """Seeded inputs of each family, as numpy: tokens; embeds with
    3-stream positions (qwen2-vl); encoder embeds + decoder tokens."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"enc_embeds": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.input_kind == "embeds":
        pos = rng.integers(0, 3 * S, (3, B, S)).astype(np.int32)
        return {"embeds": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "positions": pos}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S))}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
           "head_dim", "d_ff", "vocab", "rope_theta", "qk_norm",
           "attn_softcap", "final_softcap", "mrope_sections",
           "post_block_norm", "attn_q_chunk", "kv_cache_dtype",
           "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim",
           "n_experts", "n_shared_experts", "top_k", "expert_ff",
           "capacity_factor", "router_dtype", "n_enc_layers",
           "enc_bidirectional", "input_kind", "tie_embeddings",
           "embed_scale", "act", "param_dtype", "compute_dtype")


def _layers(cfg):
    specs = list(cfg.head_layers) + list(cfg.group) * cfg.n_groups
    return [(s.mixer, s.ffn, s.window, s.cross_attn) for s in specs]


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_config_matches_reference(arch, size):
    """Field for field (every field the port carries) and layer for
    layer, reduced and full; the archs are in the port's ARCHS."""
    assert arch in PORT_ARCHS
    if size == "reduced":
        a, b = jax_reduced_config(arch), get_reduced_config(arch)
    else:
        a, b = jax_config(arch), get_config(arch)
    for f in _FIELDS:
        want = getattr(a, f)
        got = getattr(b, f)
        if f == "mrope_sections" and want is not None:
            want, got = tuple(want), tuple(got)
        assert got == want, f
    assert _layers(b) == _layers(a)


def test_encdec_config_needs_encoder_layers():
    cfg = get_reduced_config("whisper_tiny")
    with pytest.raises(ValueError, match="n_enc_layers"):
        dataclasses.replace(cfg, n_enc_layers=0).validate()


def test_forward_logits_match_reference(reduced):
    jcfg, jparams, cfg, params = reduced
    batch = _batch(cfg)
    ref = np.asarray(_jforward(jparams, jcfg, _j(batch), train=False))
    got = models.forward(params, cfg, _t(batch))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b",
                                  "granite_moe_3b_a800m", "whisper_tiny"])
def test_prefill_then_decode_matches_reference(arch):
    """Prefill S - 1 tokens into the ring cache, then two decode steps,
    against the reference's (2e-3), and the first step against the
    port's own forward over S tokens (the reference test's check)."""
    jcfg = jax_reduced_config(arch)
    jparams = _jinit(jcfg, jax.random.PRNGKey(2))
    cfg = get_reduced_config(arch)
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    if cfg.n_experts:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)  # no drops
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    batch = _batch(cfg, seed=1)
    toks = batch["tokens"]
    pre = dict(batch, tokens=toks[:, :S - 1])
    full = models.forward(params, cfg, _t(batch))
    jcache = jmodels.init_cache(jcfg, B, S + 1, enc_len=S)
    cache = models.init_cache(cfg, B, S + 1, "cpu", enc_len=S)
    jlog, jcache = _jprefill(jparams, jcfg, _j(pre), jcache)
    plog, cache = models.prefill(params, cfg, _t(pre), cache)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                               atol=STEP_TOL, rtol=STEP_TOL)
    step = toks[:, S - 1:S]
    for i in range(2):
        jlog, jcache = _jdecode(jparams, jcfg, jnp.asarray(step),
                                           jcache, S - 1 + i)
        plog, cache = models.decode_step(params, cfg, torch.from_numpy(step),
                                         cache, S - 1 + i)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=STEP_TOL, rtol=STEP_TOL)
        if i == 0:
            np.testing.assert_allclose(plog[:, 0].numpy(),
                                       full[:, -1].numpy(), atol=STEP_TOL,
                                       rtol=STEP_TOL)
        step = np.asarray(jlog[:, -1]).argmax(-1)[:, None]


@pytest.mark.parametrize("sections,D", [((2, 3, 3), 16), ((16, 24, 24), 128),
                                        ((1, 1, 2), 8)])
def test_apply_mrope_matches_reference(sections, D):
    """Three distinct position streams over their frequency bands."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
    pos = rng.integers(0, 1000, (3, 2, 5)).astype(np.int32)
    ref = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                    (1,) * 3)


@pytest.mark.parametrize("zero_head", [False, True])
def test_int8_ring_update_matches_reference(zero_head):
    """Two writes (4 tokens at 0, 3 at 4): codes bitwise, scales 1e-7, the
    dequantized buffers at f32 precision; an all-zero head takes the 1e-8
    scale floor."""
    rng = np.random.default_rng(4)
    Bc, L, Hkv, Dh = 2, 9, 2, 16
    shapes = {"k": (Bc, L, Hkv, Dh), "v": (Bc, L, Hkv, Dh),
              "k_s": (Bc, L, Hkv, 1), "v_s": (Bc, L, Hkv, 1)}
    jc = {n: jnp.zeros(s, jnp.int8 if len(n) == 1 else jnp.float32)
          for n, s in shapes.items()}
    pc = {n: torch.zeros(s, dtype=torch.int8 if len(n) == 1
                         else torch.float32) for n, s in shapes.items()}
    for idx, n in ((0, 4), (4, 3)):
        k = (3 * rng.standard_normal((Bc, n, Hkv, Dh))).astype(np.float32)
        v = rng.standard_normal((Bc, n, Hkv, Dh)).astype(np.float32)
        if zero_head:
            k[:, :, 1] = 0.0
        jc, jk, jv, _, jvalid = JaxInt8RingCache(jc).update(
            jnp.asarray(k), jnp.asarray(v), idx)
        pc, pk, pv, _, pvalid = Int8RingCache(pc).update(
            torch.from_numpy(k), torch.from_numpy(v), idx)
        assert pvalid == int(jvalid) == idx + n
        for name in ("k", "v"):
            np.testing.assert_array_equal(pc[name].numpy(),
                                          np.asarray(jc[name]))
            np.testing.assert_allclose(pc[name + "_s"].numpy(),
                                       np.asarray(jc[name + "_s"]),
                                       atol=1e-7, rtol=0)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6,
                                   rtol=1e-6)
    if zero_head:
        assert float(pc["k_s"][:, :7, 1].max()) == pytest.approx(1e-8)


@pytest.mark.parametrize("with_cache", [False, True])
def test_mla_attention_matches_reference(with_cache):
    """Layer 0's MLA of the reduced deepseek: q/k 24 wide, v 16. With a
    cache: 6 tokens written at 3 of a 12-slot latent ring."""
    jcfg = jax_reduced_config("deepseek_v2_lite_16b")
    cfg = get_reduced_config("deepseek_v2_lite_16b")
    spec = jcfg.head_layers[0]
    jp = jattn.init_mla(jcfg, spec, jax.random.PRNGKey(5), jnp.float32)
    p = _tree(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    off = 3 if with_cache else 0
    pos = np.broadcast_to(np.arange(off, off + 6)[None], (2, 6)).astype(
        np.int32)
    jcache = cache = None
    if with_cache:
        lat = {"ckv": rng.standard_normal((2, 12, cfg.kv_lora_rank)),
               "krope": rng.standard_normal((2, 12, cfg.qk_rope_dim))}
        jcache = {k: jnp.asarray(v, jnp.float32) for k, v in lat.items()}
        cache = {k: torch.from_numpy(v.astype(np.float32))
                 for k, v in lat.items()}
    ref, jnew = jattn.mla_attention(jp, jcfg, spec, jnp.asarray(x),
                                    jnp.asarray(pos), cache=jcache,
                                    cache_index=off)
    got, new = attention.mla_attention(p, cfg, spec, torch.from_numpy(x),
                                       torch.from_numpy(np.array(pos)),
                                       cache=cache, cache_index=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    if with_cache:
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                       atol=1e-6, rtol=1e-6)
    else:
        assert new is None and jnew is None


def test_qwen2vl_prefill_then_decode_on_the_int8_ring_matches_reference():
    """The reduced qwen2-vl with the full config's int8 ring cache:
    prefill on embeds with 3-stream positions, then two decode steps on
    tokens (M-RoPE positions from the cache index), against the
    reference; the cache's codes bitwise."""
    jcfg = dataclasses.replace(jax_reduced_config("qwen2_vl_72b"),
                               kv_cache_dtype="int8")
    cfg = dataclasses.replace(get_reduced_config("qwen2_vl_72b"),
                              kv_cache_dtype="int8")
    jparams = _jinit(jcfg, jax.random.PRNGKey(6))
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    batch = _batch(cfg, seed=6)
    batch["positions"] = np.broadcast_to(np.arange(S)[None, None],
                                         (3, B, S)).astype(np.int32)
    jcache = jmodels.init_cache(jcfg, B, S + 2)
    cache = models.init_cache(cfg, B, S + 2, "cpu")
    assert cache[0]["k"].dtype == torch.int8 and "k_s" in cache[0]
    jlog, jcache = _jprefill(jparams, jcfg, _j(batch), jcache)
    plog, cache = models.prefill(params, cfg, _t(batch), cache)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=RTOL)
    step = np.asarray(jlog[:, -1]).argmax(-1)[:, None]
    for i in range(2):
        jlog, jcache = _jdecode(jparams, jcfg, jnp.asarray(step),
                                           jcache, S + i)
        plog, cache = models.decode_step(params, cfg, torch.from_numpy(step),
                                         cache, S + i)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=RTOL)
        step = np.asarray(jlog[:, -1]).argmax(-1)[:, None]
    for g in range(cfg.n_layers):
        np.testing.assert_array_equal(
            cache[g]["k"].numpy(), np.asarray(jcache["groups"]["l0"]["k"][g]))


def test_mixers_of_the_next_slice_are_refused():
    """mamba, rwkv6 and cmix, the state-space slice's, now build (their
    parameters in the mixer dict: cmix adds only ln2); an unknown mixer
    or ffn is refused by name."""
    from repro_torch.configs import LayerSpec

    cfg = get_reduced_config("granite_moe_3b_a800m")
    for spec, key in ((LayerSpec(mixer="mamba"), "A_log"),
                      (LayerSpec(mixer="rwkv6", ffn="cmix"), "c_k")):
        p = transformer.init_layer(cfg, spec, torch.Generator(),
                                   torch.float32, "cpu")
        assert key in p["mixer"]
    for spec, word in ((LayerSpec(mixer="hyena"), "mixer 'hyena'"),
                       (LayerSpec(ffn="glu9"), "ffn 'glu9'")):
        with pytest.raises(ValueError, match=word):
            transformer.init_layer(cfg, spec, torch.Generator(),
                                   torch.float32, "cpu")


# ------------------------------------------------ granite on the engine


def test_granite_continuous_engine_matches_reference_engine():
    """fp pages, gather reads, whole-prompt prefills: the same greedy
    tokens and request logits within 1e-3 as the reference's engine."""
    jcfg = jax_reduced_config("granite_moe_3b_a800m")
    jparams = _jinit(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("granite_moe_3b_a800m")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (19, 12, 24)]
    kw = dict(max_slots=2, block_size=8, max_seq_len=40, record_logits=True,
              freeze_async=False)
    jeng = JaxEngine(jparams, jcfg, attn_impl="gather", **kw)
    ref = jeng.generate(prompts, max_new_tokens=6)
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   attn_impl="gather", **kw)
    out = eng.generate(prompts, max_new_tokens=6)
    assert out == ref
    for i in range(len(prompts)):
        np.testing.assert_allclose(eng.request_logits[i],
                                   jeng.request_logits[i], atol=1e-3,
                                   rtol=0)


# ------------------------------------------------------------- PTQ


def _port_name(name: str, cfg) -> list[str]:
    """A reference leaf path -> the port's leaf paths it becomes: a
    stacked ``groups/l<i>/...`` leaf one per group, ``head_<i>/...`` one."""
    parts = name.split("/")
    if parts[0] == "groups":
        i, G = int(parts[1][1:]), len(cfg.group)
        nh = len(cfg.head_layers)
        return ["/".join(["layers", str(nh + g * G + i)] + parts[2:])
                for g in range(cfg.n_groups)]
    if parts[0].startswith("head_"):
        return ["/".join(["layers", parts[0][5:]] + parts[1:])]
    return [name]


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("skip", ["default", "launcher"])
def test_quantize_tree_chooses_the_reference_leaves_and_slices(arch, skip):
    """The same leaves quantized, each port leaf the reference's per-group
    slice (an expert stack one (E, D, F) tensor a layer): names, dense
    shapes and value budgets; the router stays dense under both lists."""
    patterns = DEFAULT_SKIP if skip == "default" else PTQ_SKIP
    jcfg, cfg = jax_reduced_config(arch), get_reduced_config(arch)
    jparams = _jinit(jcfg, jax.random.PRNGKey(0))
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    spec = "kmeans@4"                 # the quickest solve of both packages
    jq, jrep = jax_quantize_tree(jparams, spec, skip_patterns=patterns)
    q, rep = quantize_tree(params, spec, skip_patterns=patterns)
    want = sorted(n for name in jrep for n in _port_name(name, cfg))
    assert sorted(rep) == want
    assert not any("router" in n for n in rep)
    carried = models.params_from_reference(jax.tree.map(np.asarray, jq),
                                           cfg, "cpu")
    for name in rep:
        a, b = carried, q
        for part in name.split("/"):
            a = a[int(part)] if isinstance(a, list) else a[part]
            b = b[int(part)] if isinstance(b, list) else b[part]
        assert not a.stacked and not b.stacked, name
        assert tuple(a.shape) == tuple(b.shape), name
        assert a.num_values <= 4 and b.num_values <= 4, name
    if skip == "launcher":
        assert any(n.endswith("ffn/w_gate") and len(
            _leaf(q, n).shape) == 3 for n in rep)


# leaves the launcher's PTQ_SKIP quantizes that the reference's default
# list (its static launcher's) leaves dense, per layer: "mix(?!er)" lets
# the mixer subtree through; embed and lm_head go the other way
_SSM_PTQ_ADDED = {
    "rwkv6_3b": {"rwkv6": ("w_r", "w_k", "w_v", "w_g", "w_lora_a",
                           "w_lora_b", "w_o", "c_k", "c_v", "c_r")},
    "jamba_1_5_large_398b": {"mamba": ("w_in", "conv_w", "w_bcdt", "w_dt",
                                       "w_out"),
                             "attn": ("wq", "wk", "wv", "wo")},
}


@pytest.mark.parametrize("arch,n_ref", [("rwkv6_3b", 2),
                                        ("jamba_1_5_large_398b", 14)])
def test_ssm_ptq_leaf_choice_matches_the_reference(arch, n_ref):
    """Under the reference's skip list (its static launcher's) both
    packages quantize the same leaves: embed and lm_head, and jamba's
    dense and expert FFN stacks (2 and 14 tensors). Under the port's
    PTQ_SKIP the difference from the default list is exactly the mixers'
    projections named in _SSM_PTQ_ADDED (A_log, dt_bias, D_skip, w0, u,
    mix, cmix and the norms stay dense). The reference under PTQ_SKIP
    picks the same leaves and rwkv6's ``u`` too: stacked over groups it
    is (G, D), 2-D, where the port's per-layer ``u`` is (D,)."""
    jcfg, cfg = jax_reduced_config(arch), get_reduced_config(arch)
    jparams = _jinit(jcfg, jax.random.PRNGKey(0))
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    chosen = {}
    for name, patterns in (("default", DEFAULT_SKIP), ("launcher",
                                                      PTQ_SKIP)):
        # the reference's choice is its quantize_tree's own test, without
        # its solves (eager jax on every stacked slice: ~1 min here)
        jrep = ["/".join(_jax_names(path)) for path, leaf in
                jax.tree_util.tree_flatten_with_path(jparams)[0]
                if jax_should_quantize(path, leaf, patterns)]
        _, rep = quantize_tree(params, "kmeans@4", skip_patterns=patterns)
        chosen[name] = (len(jrep), {n for k in jrep
                                    for n in _port_name(k, cfg)}, set(rep))
    n, ref, port = chosen["default"]
    assert n == n_ref and port == ref
    _, ref, port = chosen["launcher"]
    assert ref - port == {f"layers/{i}/mixer/u"
                          for i, sp in enumerate(cfg.layer_specs())
                          if sp.mixer == "rwkv6"}
    assert port <= ref
    added = chosen["launcher"][2] - chosen["default"][2]
    want = {f"layers/{i}/mixer/{leaf}"
            for i, sp in enumerate(cfg.layer_specs())
            for leaf in _SSM_PTQ_ADDED[arch].get(sp.mixer, ())}
    assert added == want
    assert chosen["default"][2] - chosen["launcher"][2] == {"embed",
                                                            "lm_head"}


def test_layers_cuts_inside_a_group():
    """--layers 5 on jamba (8-layer groups) keeps the first five layer
    specs, every layer kind of the model; a whole-group cut keeps the
    pattern; the reduced config serves at 3 of its 4 layers."""
    full = get_config("jamba_1_5_large_398b")
    cut = serve.cut_depth(full, 5)
    assert cut.n_layers == 5 and cut.layer_specs() == full.layer_specs()[:5]
    assert {(sp.mixer, sp.ffn) for sp in cut.layer_specs()} == {
        ("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")}
    assert serve.cut_depth(full, 16).group == full.group
    assert serve.cut_depth(full, 16).layer_specs() == full.layer_specs()[:16]
    r = serve.main(_RUN + ["--arch", "jamba_1_5_large_398b", "--engine",
                           "static", "--layers", "3"])
    assert r["cfg"].layer_specs() == get_reduced_config(
        "jamba_1_5_large_398b").layer_specs()[:3]
    assert len(r["params"]["layers"]) == 3
    assert bool(torch.isfinite(r["logits"]).all())


def _leaf(tree, name):
    for part in name.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


# ------------------------------------------------------- the launcher
# Each row of the reference launcher's outcome on the CPU (--reduced
# --num-requests 2): it serves; it fails a replay check (the port's check
# prints its failing verdict and exits 1); or it fails with an exception,
# where the port refuses with a SystemExit naming the reason.

_RUN = ["--reduced", "--device", "cpu", "--num-requests", "2", "--gen", "8"]
_ROWS = [
    ("granite_moe_3b_a800m", "continuous", [], "serves"),
    ("granite_moe_3b_a800m", "continuous",
     ["--kv-quant", "kmeans_ls@16", "--prefill-chunk", "7"], "EXCEEDED"),
    ("granite_moe_3b_a800m", "continuous", ["--prefill-chunk", "7"],
     "MISMATCH"),
    # the reference reads its speculative engine in the serving check
    # (rel 33.165%, EXCEEDED); the port in its speculative check
    ("granite_moe_3b_a800m", "continuous",
     ["--speculate", "2", "--draft-config", "self"], "MISMATCH"),
    ("granite_moe_3b_a800m", "continuous", ["--quantize", "kmeans_ls@16"],
     "refused: --quantize"),
    ("granite_moe_3b_a800m", "disagg", [], "serves"),
    ("granite_moe_3b_a800m", "static", ["--quantize", "kmeans_ls@16"],
     "serves"),
    ("deepseek_v2_lite_16b", "static", ["--quantize", "kmeans_ls@16"],
     "serves"),
    ("deepseek_v2_lite_16b", "continuous", [], "refused: deepseek"),
    ("whisper_tiny", "static", [], "serves"),
    ("whisper_tiny", "continuous", [], "refused: whisper"),
    ("qwen2_vl_72b", "static", [], "refused: qwen2vl"),
    ("qwen2_vl_72b", "continuous", [], "refused: qwen2vl"),
    # the state-space family: the static engine only (the reference's
    # paged engines assert "paged serving supports attention mixers only")
    ("rwkv6_3b", "static", [], "serves"),
    ("rwkv6_3b", "static", ["--quantize", "kmeans_ls@16"], "serves"),
    ("rwkv6_3b", "continuous", [], "refused: rwkv6"),
    ("rwkv6_3b", "disagg", [], "refused: rwkv6"),
    ("jamba_1_5_large_398b", "static", [], "serves"),
    ("jamba_1_5_large_398b", "static", ["--quantize", "kmeans_ls@16"],
     "serves"),
    ("jamba_1_5_large_398b", "continuous", [], "refused: jamba"),
    ("jamba_1_5_large_398b", "disagg", [], "refused: jamba"),
]


@pytest.mark.parametrize("arch,engine,flags,outcome", _ROWS,
                         ids=[f"{a}-{e}-{'_'.join(f) or 'plain'}"
                              for a, e, f, _ in _ROWS])
def test_launcher_gives_the_reference_outcome(arch, engine, flags, outcome,
                                              capsys):
    argv = _RUN + ["--arch", arch, "--engine", engine] + flags
    if outcome == "serves":
        r = serve.main(argv)
        if engine == "static":
            assert bool(torch.isfinite(r["logits"]).all())
        else:
            assert r["completed"] == 2
        return
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    if outcome.startswith("refused"):
        assert str(e.value.code).startswith(f"[serve] {outcome}")
    else:
        assert e.value.code == 1
        assert f"-> {outcome}" in capsys.readouterr().out
