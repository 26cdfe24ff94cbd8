"""The state-space family (``models/ssm.py``: Mamba and RWKV-6) against
``repro.models.ssm`` on the reference's own parameters (converted by
``params_from_reference``) and seeded numpy inputs, on the reduced
rwkv6-3b (RWKV-6 time mix + channel mix) and jamba-1.5-large (Mamba and
attention, dense and MoE FFNs) configs, f32.

Tolerances: the scans and mixers at atol/rtol 1e-5 (f32 values of order 1;
the port's doubling scan and the reference's associative scan combine in
other orders, and the WKV matmuls sum in other orders: the readings here
are 1e-7 to 1.5e-6); f32 logits at 1e-4, the CPU model tests' bar;
prefill + decode against the port's own forward at the reference's 2e-3
(``tests/test_models_smoke.py``), with jamba's MoE capacity factor raised
to 8.0 so that nothing drops (capacity is per call).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

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
from repro.models import ssm as jssm
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.launch.static_steps import static_generate
from repro_torch.models import ssm
from repro_torch.models.convert import _tree

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOD = dict(atol=1e-5, rtol=1e-5)
LOGIT = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = 2e-3
SSM_ARCHS = ["rwkv6_3b", "jamba_1_5_large_398b"]
B, S = 2, 21          # S crosses two chunks of 8 and pads the third

_jinit = jax.jit(jmodels.init_params, static_argnums=0)
_jforward = jax.jit(jmodels.forward, static_argnums=1,
                    static_argnames=("train", "return_hidden"))


def _np(t):
    return np.asarray(t)


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(arch):
    return jax_reduced_config(arch), get_reduced_config(arch)


def _x(D, seed=0, S=S):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


# ------------------------------------------------------------ Mamba


@pytest.mark.parametrize("c", [8, 13])
def test_mamba_scan_chunk_matches_reference(c):
    """The doubling scan against ``lax.associative_scan``, at a power of
    two and not (13 positions: the last doubling covers a part)."""
    rng = np.random.default_rng(c)
    a = rng.uniform(0.2, 1.0, (B, c, 6, 4)).astype(np.float32)
    b = rng.standard_normal((B, c, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((B, 6, 4)).astype(np.float32)
    jh, jlast = jssm._mamba_scan_chunk(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(h0))
    h, last = ssm._mamba_scan_chunk(_pt(a), _pt(b), _pt(h0))
    np.testing.assert_allclose(h.numpy(), _np(jh), **MOD)
    np.testing.assert_allclose(last.numpy(), _np(jlast), **MOD)
    seq = h0
    for t in range(c):                    # and the recurrence itself
        seq = a[:, t] * seq + b[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), seq, **MOD)


def _mamba_params(seed=0):
    jcfg, cfg = _cfgs("jamba_1_5_large_398b")
    jp = jssm.init_mamba(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, cfg, jp, _tree(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_matches_reference_across_padded_chunks(with_cache):
    """S = 21 with scan_chunk 8: two whole chunks and one padded by 3.
    With a cache the output, the state h and the conv tail (the last
    d_conv - 1 inputs) match; the cache starts from a nonzero state."""
    jcfg, cfg, jp, p = _mamba_params()
    assert cfg.scan_chunk == 8 and S % 8
    x = _x(cfg.d_model)
    jc = c = None
    if with_cache:
        rng = np.random.default_rng(3)
        h = rng.standard_normal((B, cfg.d_inner, cfg.ssm_d_state)).astype(
            np.float32)
        conv = rng.standard_normal(
            (B, cfg.ssm_d_conv - 1, cfg.d_inner)).astype(np.float32)
        jc = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        c = {"h": _pt(h), "conv": _pt(conv)}
    jy, jnew = jssm.mamba(jp, jcfg, jnp.asarray(x), cache=jc)
    y, new = ssm.mamba(p, cfg, _pt(x), cache=c)
    np.testing.assert_allclose(y.numpy(), _np(jy), **MOD)
    if with_cache:
        for k in ("h", "conv"):
            np.testing.assert_allclose(new[k].numpy(), _np(jnew[k]), **MOD)
    else:
        assert new is None and jnew is None


def test_mamba_padding_leaves_the_state_unchanged():
    """A prompt of 21 (padded to 24) and the same prompt's 21 positions
    inside a prompt of 24 that the scan does not pad: h after position 21
    agrees, so the pads neither decay nor feed the state."""
    _, cfg, _, p = _mamba_params()
    x = _x(cfg.d_model, seed=4, S=24)
    c0 = ssm.init_mamba_cache(cfg, B, torch.float32, "cpu")
    _, short = ssm.mamba(p, cfg, _pt(x[:, :S]), cache=c0)
    c1 = ssm.init_mamba_cache(cfg, B, torch.float32, "cpu")
    _, mid = ssm.mamba(p, cfg, _pt(x[:, :16]), cache=c1)
    _, mid = ssm.mamba(p, dataclasses.replace(cfg, scan_chunk=5),
                       _pt(x[:, 16:S]), cache=mid)
    np.testing.assert_allclose(short["h"].numpy(), mid["h"].numpy(), **MOD)


def test_mamba_decode_steps_match_reference():
    """Prefill 13 positions into a cache, then 5 single-position decode
    steps (the O(1) update), each against the reference's."""
    jcfg, cfg, jp, p = _mamba_params(seed=1)
    x = _x(cfg.d_model, seed=1, S=18)
    jc = jssm.init_mamba_cache(jcfg, B, jnp.float32)
    c = ssm.init_mamba_cache(cfg, B, torch.float32, "cpu")
    for t0, t1 in [(0, 13)] + [(t, t + 1) for t in range(13, 18)]:
        jy, jc = jssm.mamba(jp, jcfg, jnp.asarray(x[:, t0:t1]), cache=jc)
        y, c = ssm.mamba(p, cfg, _pt(x[:, t0:t1]), cache=c)
        np.testing.assert_allclose(y.numpy(), _np(jy), **MOD)
        np.testing.assert_allclose(c["h"].numpy(), _np(jc["h"]), **MOD)
        np.testing.assert_allclose(c["conv"].numpy(), _np(jc["conv"]), **MOD)


# ------------------------------------------------------------ RWKV-6


def _wkv_inputs(seed, *, c=8, H=3, hd=4, decay=(0.5, 0.99)):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, c, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(*decay, (B, c, H, hd)).astype(np.float32)
    u = (0.1 * rng.standard_normal((1, H, hd, 1))).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def test_wkv6_matmul_form_equals_the_sequential_scan():
    """The port's chunked matmul WKV against its own step-by-step scan
    (the reference's oracle relation), outputs and state."""
    args = [_pt(a) for a in _wkv_inputs(0)]
    y, s = ssm._wkv6_chunk_matmul(*args)
    y_seq, s_seq = ssm._wkv6_chunk(*args)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), **MOD)
    np.testing.assert_allclose(s.numpy(), s_seq.numpy(), **MOD)


@pytest.mark.parametrize("form", ["matmul", "sequential"])
def test_wkv6_forms_match_reference(form):
    a = _wkv_inputs(1)
    jfn, fn = ((jssm._wkv6_chunk_matmul, ssm._wkv6_chunk_matmul)
               if form == "matmul" else (jssm._wkv6_chunk, ssm._wkv6_chunk))
    jy, js = jfn(*(jnp.asarray(t) for t in a))
    y, s = fn(*(_pt(t) for t in a))
    np.testing.assert_allclose(y.numpy(), _np(jy), **MOD)
    np.testing.assert_allclose(s.numpy(), _np(js), **MOD)


def test_wkv6_chunk_decay_clamp_binds_as_in_the_reference():
    """A strong decay (w in (0.01, 0.05): a chunk's total decay ~e^-30)
    makes the e^-15 floor on W_c bind. The port keeps it: its state
    matches the reference's and not the unclamped recurrence, which a
    large S_0 (1e4) sets apart by ~3e-3."""
    r, k, v, w, u, s0 = _wkv_inputs(2, decay=(0.01, 0.05))
    s0 = s0 * 1e4
    assert float(np.log(w).sum(axis=1).max()) < -15.0
    a = (r, k, v, w, u, s0)
    jy, js = jssm._wkv6_chunk_matmul(*(jnp.asarray(t) for t in a))
    y, s = ssm._wkv6_chunk_matmul(*(_pt(t) for t in a))
    np.testing.assert_allclose(y.numpy(), _np(jy), **MOD)
    np.testing.assert_allclose(s.numpy(), _np(js), **MOD)
    _, s_seq = ssm._wkv6_chunk(*(_pt(t) for t in a))
    assert float((s - s_seq).abs().max()) > 1e-3


def _rwkv_params(seed=0):
    jcfg, cfg = _cfgs("rwkv6_3b")
    jp = jssm.init_rwkv6(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, cfg, jp, _tree(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("S_", [1, S])
def test_rwkv6_time_mix_matches_reference(S_):
    """S = 1 (the sequential decode path) and S = 21 (three chunks of 8
    through the matmul form, the last padded), from a nonzero shift and
    wkv state: the output and both carried states."""
    jcfg, cfg, jp, p = _rwkv_params()
    rng = np.random.default_rng(5)
    x = _x(cfg.d_model, seed=5, S=S_)
    shift = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    hd = cfg.rwkv_head_dim
    s0 = rng.standard_normal((B, cfg.d_model // hd, hd, hd)).astype(
        np.float32)
    jy, jshift, js = jssm.rwkv6_time_mix(
        jp, jcfg, jnp.asarray(x), shift_state=jnp.asarray(shift),
        wkv_state=jnp.asarray(s0))
    y, new_shift, s = ssm.rwkv6_time_mix(p, cfg, _pt(x),
                                         shift_state=_pt(shift),
                                         wkv_state=_pt(s0))
    np.testing.assert_allclose(y.numpy(), _np(jy), **MOD)
    np.testing.assert_array_equal(new_shift.numpy(), _np(jshift))
    np.testing.assert_allclose(s.numpy(), _np(js), **MOD)


def test_rwkv6_channel_mix_matches_reference():
    jcfg, cfg, jp, p = _rwkv_params(seed=1)
    x = _x(cfg.d_model, seed=6)
    shift = np.random.default_rng(6).standard_normal(
        (B, cfg.d_model)).astype(np.float32)
    jy, jshift = jssm.rwkv6_channel_mix(jp, jcfg, jnp.asarray(x),
                                        shift_state=jnp.asarray(shift))
    y, new_shift = ssm.rwkv6_channel_mix(p, cfg, _pt(x),
                                         shift_state=_pt(shift))
    np.testing.assert_allclose(y.numpy(), _np(jy), **MOD)
    np.testing.assert_array_equal(new_shift.numpy(), _np(jshift))


# ------------------------------------------------------- whole models


@pytest.fixture(scope="module", params=SSM_ARCHS)
def reduced(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = _jinit(jcfg, jax.random.PRNGKey(0))
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed=0, S=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def test_forward_logits_match_reference(reduced):
    jcfg, jparams, cfg, params = reduced
    toks = _tokens(cfg)
    want = _jforward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                     train=False)
    got = models.forward(params, cfg, {"tokens": _pt(toks)})
    np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The reference's invariant (``tests/test_models_smoke.py``), port
    against port: a prefill of S - 4 positions (padded inside its last
    chunk), then 4 decode steps, each step's logits == the forward's at
    its position."""
    cfg = get_reduced_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)   # no drops
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    toks = _pt(_tokens(cfg, seed=2))
    full = models.forward(params, cfg, {"tokens": toks})
    cache = models.init_cache(cfg, B, S, "cpu")
    P = S - 4
    pre, cache = models.prefill(params, cfg, {"tokens": toks[:, :P]}, cache)
    np.testing.assert_allclose(pre.numpy(), full[:, :P].numpy(),
                               atol=STEP_TOL, rtol=STEP_TOL)
    for i in range(P, S):
        step, cache = models.decode_step(params, cfg, toks[:, i:i + 1],
                                         cache, i)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(),
                                   atol=STEP_TOL, rtol=STEP_TOL)


def test_static_tokens_and_logits_match_the_reference(reduced):
    """``static_generate``: greedy tokens equal and the logits of each
    token's row within 1e-4 of the reference's static steps."""
    jcfg, jparams, cfg, params = reduced
    P, G = 12, 6
    toks = _tokens(cfg, seed=3, S=P)
    tok, cache = jax_static_prefill(jparams, jcfg, jnp.asarray(toks), None,
                                    G)
    ref_toks = [_np(tok)]
    ref_logits = [_np(jmodels.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks)},
        jmodels.init_cache(jcfg, B, P + G))[0][:, -1])]
    for i in range(G - 1):
        logits, _ = jmodels.decode_step(jparams, jcfg, tok, cache,
                                        jnp.int32(P + i))
        ref_logits.append(_np(logits[:, -1]))
        tok, cache = jax_static_decode_step(jparams, jcfg, tok, cache,
                                            jnp.int32(P + i))
        ref_toks.append(_np(tok))
    out, logits = static_generate(params, cfg, _pt(toks), G)
    np.testing.assert_array_equal(out.numpy(),
                                  np.concatenate(ref_toks, axis=1))
    np.testing.assert_allclose(logits.numpy(), np.stack(ref_logits, 1),
                               **LOGIT)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _np_dtype(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bf16_params_and_caches_carry_the_reference_dtypes(arch):
    """A bf16 config: every converted leaf, every leaf the port's own
    init makes, and every cache leaf (fresh and after a prefill) in the
    reference's dtype (A_log, D_skip, w0, u and the states h, s f32)."""
    jcfg, cfg = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jparams = _jinit(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(np.asarray, jparams)
    conv = models.params_from_reference(jp, cfg, "cpu")
    own = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    G, nh = len(cfg.group), len(cfg.head_layers)
    want = {}
    for path, leaf in _leaves(jp):
        if path[0] == "groups":
            for g in range(cfg.n_groups):
                want[("layers", nh + g * G + int(path[1][1:]))
                     + path[2:]] = leaf.dtype.name
        else:
            want[path] = leaf.dtype.name
    for tree in (conv, own):
        got = {p: _np_dtype(t) for p, t in _leaves(tree)}
        assert got == want
    assert {want[p] for p in want if p[-1] in ("A_log", "D_skip", "w0",
                                               "u")} == {"float32"}
    jcache = jmodels.init_cache(jcfg, B, S)
    cache = models.init_cache(cfg, B, S, "cpu")
    toks = _tokens(cfg)
    _, jcache2 = jmodels.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                 jcache)
    _, cache2 = models.prefill(conv, cfg, {"tokens": _pt(toks)}, cache)
    for jc, c in ((jcache, cache), (jcache2, cache2)):
        want = {}
        for path, leaf in _leaves(jax.tree.map(np.asarray, jc)):
            for g in range(cfg.n_groups):
                want[(nh + g * G + int(path[1][1:]),) + path[2:]] = \
                    leaf.dtype.name
        got = {p: _np_dtype(t) for p, t in _leaves(c)}
        assert got == want
    assert all(_np_dtype(t) == "float32" for p, t in _leaves(cache2)
               if p[-1] in ("h", "s"))


def test_ssm_modules_run_without_jax():
    """With jax blocked: import the port's SSM modules and configs, and
    serve both reduced configs on the static engine."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)
        import repro_torch.models.ssm
        from repro_torch.launch import serve
        for arch in ("rwkv6_3b", "jamba_1_5_large_398b"):
            r = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--engine", "static", "--gen", "4"])
            assert tuple(r["tokens"].shape) == (4, 4)
        assert not any(m == "repro" or m.startswith(("repro.", "jax"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-2000:]
