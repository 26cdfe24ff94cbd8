"""The port's PTQ path against the JAX package on seeded numpy inputs: the
sorted-unique problem, the LS refit, Lloyd's iterations, kmeans_ls,
value-shared tensors, qmatmul's three branches and quantize_tree.

Tolerances and why:
- unique/counts/inverse and ``make_problem``: bitwise (the same float64
  arithmetic, cast to f32 once).
- ``refit_support``: 1e-6 of the values' scale. The port sums segments in
  float64 prefix sums, the reference in f32 segment sums.
- ``_lloyd`` from the same initial centers: centers within 1e-6 of the
  scale, assignments equal.
- kmeans_ls as a whole: the seeding draws from another generator than
  jax.random, so codebooks differ; the port's loss is held within 1% of
  the reference's and at or above the optimal 16-value loss (``dp@16``,
  the reference's exact 1-D DP), less 1e-4 of it for bf16 inputs, whose
  reconstruction is rounded to bf16 after the solve.
- qmatmul's plain path vs the reference kernel in interpret mode: the
  reference's own bars, 1e-4 in f32 and 3e-2 in bf16.
"""
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.tree_util import tree_map_with_path

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import quantize as jax_quantize
from repro.core.kmeans import _lloyd as jax_lloyd
from repro.core.problem import make_problem as jax_make_problem
from repro.core.problem import unique_with_counts as jax_unique
from repro.core.refit import refit_support as jax_refit
from repro.core.types import from_dense as jax_from_dense
from repro.core.types import stack_quantized as jax_stack
from repro.kernels import quant_matmul as jax_qmm
from repro.kernels import quant_matmul_stacked as jax_qmm_stacked
from repro.quant.ptq import should_quantize as jax_should_quantize
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.core import (QuantizedTensor, from_dense, make_problem,
                              quantize, refit_support, stack_quantized,
                              unique_with_counts)
from repro_torch.core.kmeans import _lloyd
from repro_torch.launch.serve import PTQ_SKIP
from repro_torch.quant import (DEFAULT_SKIP, compression_ratio,
                               dequantize_tree, fallback_count, qmatmul,
                               quantize_tree)
from repro_torch.quant.serve import _broadcast_stacked

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)


def _sample(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "laplace":
        return rng.laplace(size=n).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    if kind == "bf16":
        return w.astype(ml_dtypes.bfloat16)
    if kind == "repeats":       # few distinct values, many repeats
        return np.round(w * 4).astype(np.float32) / 4
    return w


def _port_in(w):
    """numpy (f32 or ml_dtypes bf16) -> the same values as a torch tensor."""
    if w.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(w))


# ------------------------------------------------------------ problem


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["normal", "bf16", "repeats"])
def test_unique_and_make_problem_are_bitwise_the_reference(kind, weighted):
    w = _sample(kind, 3000, 0).reshape(60, 50)
    rv, rc, ri = jax_unique(w)
    vals, counts, inv = unique_with_counts(_port_in(w))
    np.testing.assert_array_equal(vals.numpy(), rv)
    np.testing.assert_array_equal(counts.numpy(), rc)
    np.testing.assert_array_equal(inv.numpy(), ri.reshape(-1))
    ref = jax_make_problem(rv, rc, weighted=weighted)
    got = make_problem(vals, counts, weighted=weighted)
    for f in ("w_hat", "d", "counts", "z", "n_suffix"):
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert got.m == ref.m


@pytest.mark.parametrize("first_on", [True, False])
def test_refit_support_matches_reference(first_on):
    w = _sample("repeats", 4000, 1)
    rv, rc, _ = jax_unique(w)
    rng = np.random.default_rng(2)
    support = rng.random(rv.shape[0]) < 0.3
    support[0] = first_on
    ref_w, ref_a = jax_refit(jax_make_problem(rv, rc, weighted=True),
                             jnp.asarray(support))
    got_w, got_a = refit_support(make_problem(rv, rc, weighted=True),
                                 torch.from_numpy(support))
    scale = np.abs(rv).max()
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), rtol=0,
                               atol=1e-6 * scale)
    if not first_on:          # rows before the first support are 0
        assert float(got_w[0]) == 0.0
    # alpha = jump / d: compare the jumps it encodes, d * alpha
    d = np.asarray(jax_make_problem(rv, rc, weighted=True).d)
    np.testing.assert_allclose(got_a.numpy() * d, np.asarray(ref_a) * d,
                               rtol=0, atol=2e-6 * scale)


def test_lloyd_from_the_same_centers_matches_reference():
    w = _sample("normal", 5000, 3)
    rv, rc, _ = jax_unique(np.round(w * 64) / 64)
    prob = jax_make_problem(rv, rc, weighted=True)
    rng = np.random.default_rng(4)
    c0 = np.sort(rng.choice(np.asarray(prob.w_hat), 16, replace=False))
    rc_, ri_, rin_, rit_ = jax_lloyd(prob.w_hat, prob.counts, jnp.asarray(c0),
                                     300, 1e-7)
    pprob = make_problem(rv, rc, weighted=True)
    c, idx, inertia, iters = _lloyd(pprob.w_hat, pprob.counts,
                                    torch.from_numpy(c0), 300, 1e-7)
    scale = np.abs(rv).max()
    np.testing.assert_allclose(c.numpy(), np.asarray(rc_), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri_))
    np.testing.assert_allclose(float(inertia), float(rin_), rtol=1e-5)
    assert abs(int(iters) - int(rit_)) <= 1


@pytest.mark.parametrize("kind", ["normal", "laplace", "bf16"])
def test_kmeans_ls_loss_matches_reference(kind):
    w = _sample(kind, 4096, 5).reshape(64, 64)
    spec = "kmeans_ls@16:weighted=true"
    _, ref = jax_quantize(w, spec)
    _, opt = jax_quantize(w, "dp@16:weighted=true")
    qt, info = quantize(_port_in(w), spec)
    assert qt.num_values == 16 and qt.indices.dtype == torch.uint8
    assert qt.dtype == (torch.bfloat16 if kind == "bf16" else torch.float32)
    for k in ("m_unique", "n_values", "l2_loss", "lloyd_iters", "time_s"):
        assert k in info, k
    assert info["m_unique"] == ref["m_unique"]
    assert info["l2_loss"] <= 1.01 * ref["l2_loss"]
    slack = 1e-4 if kind == "bf16" else 0.0
    assert info["l2_loss"] >= opt["l2_loss"] * (1 - slack)


# ------------------------------------------------------------ types


def test_from_dense_stack_and_to_dense_match_reference():
    rng = np.random.default_rng(6)
    qts, jqts = [], []
    for L in (16, 9, None):
        w = rng.normal(size=(24, 20)).astype(np.float32)
        vals, _, inv = jax_unique(w)
        # about L distinct values; None keeps all 480 (int32 codes)
        recon = vals if L is None else np.round(vals * L / 8) / (L / 8)
        jq = jax_from_dense(w, recon, inv)
        q = from_dense(torch.from_numpy(w), torch.from_numpy(recon),
                       torch.from_numpy(inv.reshape(-1)))
        np.testing.assert_array_equal(q.codebook.numpy(),
                                      np.asarray(jq.codebook))
        np.testing.assert_array_equal(q.indices.numpy(),
                                      np.asarray(jq.indices))
        assert q.indices.dtype == (torch.uint8 if q.num_values <= 256
                                   else torch.int32)
        np.testing.assert_array_equal(q.to_dense().numpy(),
                                      np.asarray(jq.to_dense()))
        assert q.nbytes() == jq.nbytes() and q.shape == jq.shape
        qts.append(q)
        jqts.append(jq)
    st, jst = stack_quantized(qts), jax_stack(jqts)
    assert st.stacked and st.indices.dtype == torch.int32
    np.testing.assert_array_equal(st.codebook.numpy(),
                                  np.asarray(jst.codebook))
    np.testing.assert_array_equal(st.indices.numpy(), np.asarray(jst.indices))
    np.testing.assert_array_equal(st.to_dense().numpy(),
                                  np.asarray(jst.to_dense()))
    assert st.nbytes() == jst.nbytes()
    # .float()/.to() change the dense dtype only, never the codes
    b = st.to(torch.bfloat16).float()
    assert b.codebook is st.codebook and b.indices is st.indices
    assert b.dtype == torch.float32


# ------------------------------------------------------------ qmatmul

_QMM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _qmm_inputs(M, K, N, L=16, dtype="float32", G=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    x = rng.normal(size=lead + (M, K)).astype(np.float32)
    idx = rng.integers(0, L, lead + (K, N))
    cb = rng.normal(size=lead + (L,)).astype(np.float32)
    idx = idx.astype(np.uint8 if L <= 256 else np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return (jx, jnp.asarray(idx), jnp.asarray(cb)), (
        tx, torch.from_numpy(idx), torch.from_numpy(cb))


def _qt(idx, cb, K, N, stacked=False):
    n = idx.shape[0] if stacked else None
    flat = idx.reshape(n, -1) if stacked else idx.reshape(-1)
    return QuantizedTensor(cb, flat, (K, N), torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(8, 32, 16), (16, 128, 128),
                                   (128, 256, 64), (5, 33, 17)])
def test_qmatmul_plain_path_matches_reference_kernel(M, K, N, dtype):
    (jx, jidx, jcb), (x, idx, cb) = _qmm_inputs(M, K, N, dtype=dtype)
    ref = jax_qmm(jx, jidx, jcb, interpret=True)
    got = qmatmul(x, _qt(idx, cb, K, N))
    assert got.dtype == x.dtype and got.shape == (M, N)
    tol = _QMM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)
    # leading batch axes reshape through, as x @ w
    got3 = qmatmul(x.reshape(1, M, K), _qt(idx, cb, K, N))
    assert torch.equal(got3[0], got)


@pytest.mark.parametrize("L", [16, 1000])
def test_qmatmul_bf16_rounds_the_gathered_weight_before_the_product(L):
    """x = diag(v) in bf16: each output is one product v[m] * W[m, n],
    exact in f32, so y must equal v * bf16(codebook[idx]) rounded to bf16
    bit for bit, in the port and in the reference's kernel. Without the
    weight's rounding (the f32 codebook value in the product) most entries
    differ in the last bit."""
    K = N = 64
    rng = np.random.default_rng(5)
    v = rng.normal(size=K).astype(np.float32)
    x = torch.diag(torch.from_numpy(v)).to(torch.bfloat16)
    idx = rng.integers(0, L, (K, N)).astype(np.uint8 if L <= 256
                                             else np.int32)
    cb = rng.normal(size=L).astype(np.float32)
    w = torch.from_numpy(cb)[torch.from_numpy(idx).long()]
    want = (x.float().diagonal()[:, None]
            * w.to(torch.bfloat16).float()).to(torch.bfloat16)
    unrounded = (x.float().diagonal()[:, None] * w).to(torch.bfloat16)
    assert not torch.equal(want, unrounded)
    got = qmatmul(x, _qt(torch.from_numpy(idx), torch.from_numpy(cb), K, N))
    assert torch.equal(got, want)
    ref = jax_qmm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                  jnp.asarray(idx), jnp.asarray(cb), interpret=True)
    assert torch.equal(torch.from_numpy(np.asarray(ref, np.float32)),
                       want.float())


def test_qmatmul_int32_codes_large_codebook_matches_reference():
    (jx, jidx, jcb), (x, idx, cb) = _qmm_inputs(16, 64, 32, L=1000, seed=1)
    assert idx.dtype == torch.int32
    ref = jax_qmm(jx, jidx, jcb, interpret=True)
    np.testing.assert_allclose(qmatmul(x, _qt(idx, cb, 64, 32)).numpy(),
                               np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul_stacked_branch_matches_reference_kernel(dtype):
    G, M, K, N = 3, 5, 17, 9
    (jx, jidx, jcb), (x, idx, cb) = _qmm_inputs(M, K, N, G=G, dtype=dtype,
                                                 seed=2)
    ref = jax_qmm_stacked(jx, jidx, jcb, interpret=True)
    n0 = fallback_count()
    got = qmatmul(x, _qt(idx, cb, K, N, stacked=True))
    assert fallback_count() == n0 and got.shape == (G, M, N)
    tol = _QMM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_fallback_counter_counts_a_stacked_weight_without_group_axis():
    G, M, K, N = 3, 4, 8, 6
    _, (x, idx, cb) = _qmm_inputs(M, K, N, G=G, seed=3)
    w = _qt(idx, cb, K, N, stacked=True)
    n0 = fallback_count()
    out = qmatmul(x[0], w)          # (M, K): no group axis to tile against
    assert fallback_count() == n0 + 1
    torch.testing.assert_close(out, x[0] @ w.to_dense())
    dense = torch.randn(K, N)
    torch.testing.assert_close(qmatmul(x[0], dense), x[0] @ dense)
    assert fallback_count() == n0 + 1     # dense weights never count


@pytest.mark.parametrize("lead", [(), (1,), (2, 1)])
def test_stacked_weight_without_group_axis_broadcasts_x_over_the_groups(
        lead):
    """On the card a stacked weight without x's group axis goes to the
    stacked kernel with x copied to every group; here the same reshaping
    runs through the kernel's plain version: x @ W under matmul's
    broadcasting, with no fallback counted."""
    G, M, K, N = 3, 4, 8, 6
    _, (x, idx, cb) = _qmm_inputs(M, K, N, G=G, seed=4)
    w = _qt(idx, cb, K, N, stacked=True)
    xs = x[:math.prod(lead)].reshape(*lead, M, K)
    n0 = fallback_count()
    got = _broadcast_stacked(xs, idx, cb)
    assert fallback_count() == n0
    want = xs @ w.to_dense()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    vec = _broadcast_stacked(x[0, 0], idx, cb)       # 1-D x, as x @ W
    torch.testing.assert_close(vec, x[0, 0] @ w.to_dense(), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------ quantize_tree


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_reduced_config("qwen3_0_6b")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("qwen3_0_6b")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _ref_leaves(jparams, jcfg, skip):
    """The port's names of the leaves the reference's PTQ selects: each
    stacked ``groups/l<i>/...`` leaf is one leaf per layer."""
    names = []

    def visit(path, leaf):
        if jax_should_quantize(path, leaf, skip):
            keys = [getattr(k, "key", str(k)) for k in path]
            if keys[0] != "groups":
                names.append("/".join(keys))
                return leaf
            i = int(keys[1][1:])
            for g in range(jcfg.n_groups):
                layer = g * len(jcfg.group) + i
                names.append("/".join(["layers", str(layer)] + keys[2:]))
        return leaf

    tree_map_with_path(visit, jparams)
    return sorted(names)


# the skip list of the reference's launcher (repro/launch/serve.py), as
# written there
REFERENCE_LAUNCHER_SKIP = ("ln", "norm", "router", "A_log", "mix", "dt_bias",
                           "D_skip", "w0", "embed", "lm_head")


@pytest.mark.parametrize("skip", ["default", "launcher",
                                  "reference_launcher"])
def test_quantize_tree_skips_and_reports_the_reference_leaves(reduced, skip):
    jcfg, jparams, cfg, params = reduced
    patterns = {"default": DEFAULT_SKIP, "launcher": PTQ_SKIP,
                "reference_launcher": REFERENCE_LAUNCHER_SKIP}[skip]
    qtree, report = quantize_tree(params, "kmeans_ls@16",
                                  skip_patterns=patterns)
    assert sorted(report) == _ref_leaves(jparams, jcfg, patterns)
    # the reference's own lists skip the attention projections ("mix"
    # matches "mixer"): its default quantizes the embedding, its launcher's
    # list keeps it dense, and so serves 3 projections a layer from codes;
    # the port's launcher list keeps all seven projections of a layer
    # quantized and the embedding dense
    n = {"default": 3 * cfg.n_layers + 1, "launcher": 7 * cfg.n_layers,
         "reference_launcher": 3 * cfg.n_layers}[skip]
    assert len(report) == n
    for name, row in report.items():
        assert row["n_values"] == 16 and row["spec"] == "kmeans_ls@16"
        assert row["bytes"] < row["dense_bytes"]
    assert compression_ratio(report) > 7
    layer = qtree["layers"][1]
    assert isinstance(layer["ffn"]["w_up"], QuantizedTensor)
    assert isinstance(layer["ln1"], torch.Tensor)
    if skip != "default":
        assert torch.equal(qtree["embed"], params["embed"])
    dense = dequantize_tree(qtree)
    w, q = params["layers"][1]["ffn"]["w_up"], dense["layers"][1]["ffn"][
        "w_up"]
    assert q.shape == w.shape and len(torch.unique(q)) == 16
    assert float(((w - q) ** 2).sum()) == pytest.approx(
        report["layers/1/ffn/w_up"]["l2_loss"], rel=1e-6)


@pytest.mark.parametrize("cache_bytes", [0, 3_000_000])
def test_estimate_decode_bytes_prices_at_the_h100s_rate(cache_bytes):
    """``quant.estimate_decode_bytes``: the reference's numbers at the
    reference's v5e rate (819e9 B/s) when asked for it, and at the
    default (the H100's 3.35e12 B/s, ``device.HBM_BYTES_PER_S``) the
    times scaled by 819e9 / 3.35e12, the speedup unchanged."""
    from repro.analysis.roofline import HBM_BW
    from repro.quant import estimate_decode_bytes as jax_estimate
    from repro_torch.device import HBM_BYTES_PER_S
    from repro_torch.quant import estimate_decode_bytes

    assert HBM_BW == 819e9 and HBM_BYTES_PER_S == 3.35e12
    args = (596_049_920 * 2, 7.9, cache_bytes)
    ref = jax_estimate(*args)
    at_v5e = estimate_decode_bytes(*args, hbm_bytes_per_s=819e9)
    assert at_v5e == ref
    ours = estimate_decode_bytes(*args)
    assert set(ours) == set(ref) == {"t_dense_s", "t_quant_s", "speedup"}
    for k in ("t_dense_s", "t_quant_s"):
        assert ours[k] == pytest.approx(ref[k] * 819e9 / 3.35e12,
                                        rel=1e-12)
    assert ours["speedup"] == pytest.approx(ref["speedup"], rel=1e-12)
