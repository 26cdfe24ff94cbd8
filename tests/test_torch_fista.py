"""The port's l1 path against the JAX package on seeded numpy inputs: the
FISTA kernel's plain version, the batched solve around it, coordinate
descent, Algorithm 2, lam specs, FISTA page freezing (iter_l1), the kmeans
page solver, batched PTQ, and the engine with iter_l1@16 KV pages.

Tolerances and why:
- FISTA iterates (``fista_quant`` on the CPU = ``ref_fista``) against the
  reference kernel (interpret mode) and its ``ref_fista``: atol 2e-4 /
  rtol 1e-3, the reference's kernel bar (tests/test_kernels.py:67); the
  scans add in different orders. On preconditioned 4096-column rows after
  1000 steps that bar does not hold between any two f32 orders; there
  the two plain versions' eq.-6 objectives agree within 1e-3 and their
  distances from a float64 run within 3x of each other.
- ``solve_fista_batch``: the same bar; its padding tail exactly 0 and a
  row alone within 1e-4 of the row in the batch (test_kernels.py:88).
  ``power_iter_lipschitz``: 1e-9 relative (both float64).
- FISTA's objective within 1% of CD's (test_kernels.py:70).
- ``cd_solve``: the port sweeps in float64, the reference in f32: alpha
  within 1e-3 of the data's scale and the objective within 1e-5
  relative; against the float64 dense oracle within 1e-6.
- ``iterative_l1``: the same number of values, iterations and support,
  reconstruction within 1e-5 of the scale.
- FISTA page freezing: the reference test's bounds (budget, sorted, beats
  a crude 2-level quantizer, within 5x of kmeans_ls), and each row's MSE
  within 1e-4 relative of the reference function's on the same rows.
- batched PTQ: the same problems (values within 1e-12 of their scale:
  the port sums buckets by float64 prefix-sum differences; counts and
  inverse equal), FISTA's eq.-6 objective within 1e-3 of the
  reference's on them, one shared codebook per projection. After 1000
  steps FISTA has not converged on these weighted problems and its
  support depends on summation order, so the number of values and the
  reconstruction loss are held within 25%.
- the engine on iter_l1@16 pages: the reference test's bounds against
  the fp engine (abs 2.5, 8% of the range; test_serving.py:626), and
  with synchronous freezing (so both install each freeze at the same
  step) the reference engine's tokens and logits within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.core import QuantSpec as JaxSpec
from repro.core import cd_solve as jax_cd_solve
from repro.core import make_problem as jax_make_problem
from repro.core import objective as jax_objective
from repro.core import quantize as jax_quantize
from repro.core.cd import max_stable_lam2 as jax_max_stable_lam2
from repro.core.iterative import iterative_l1 as jax_iterative_l1
from repro.core.problem import unique_with_counts as jax_unique
from repro.kernels import fista_quant as jax_fista_quant
from repro.kernels import power_iter_lipschitz as jax_power_iter
from repro.kernels import quantize_pages_device as jax_pages_kmeans
from repro.kernels import quantize_pages_fista as jax_pages_fista
from repro.kernels import ref_fista as jax_ref_fista
from repro.kernels import solve_fista_batch as jax_solve_fista_batch
from repro.kernels.page_quant import \
    quantize_pages_kmeans_raw_spec as jax_pages_kmeans_raw
from repro.quant.ptq import quantize_tree as jax_quantize_tree
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.core import (QuantSpec, cd_solve, cd_solve_dense_reference,
                              iterative_l1, make_problem, max_stable_lam2,
                              objective, quantize, registry)
from repro_torch.kernels import (fista_quant, power_iter_lipschitz,
                                 quantize_pages_device, quantize_pages_fista,
                                 solve_fista_batch)
from repro_torch.launch.serve import PTQ_SKIP
from repro_torch.quant import quantize_tree
from repro_torch.quant.ptq import tree_problems
from repro_torch.serving import ContinuousBatchingEngine

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

T = torch.from_numpy


def _fista_rows(B, M, seed=2):
    """The reference kernel test's inputs: sorted normal rows, unit
    weights, lambda 0.05, the power-iteration step size."""
    rng = np.random.default_rng(seed)
    w = np.sort(rng.normal(size=(B, M)), axis=1).astype(np.float32)
    d = np.diff(w, axis=1, prepend=0.0).astype(np.float32)
    n = np.ones((B, M), np.float32)
    lam = np.full((B, M), 0.05, np.float32)
    eta = (1.0 / (jax_power_iter(d, n) * 1.01)).astype(np.float32)
    return w, d, n, lam, eta


# ------------------------------------------------------------ FISTA


@pytest.mark.parametrize("B,M,Tb", [(1, 128, 128), (3, 256, 128),
                                    (2, 100, 128), (4, 64, 64)])
def test_fista_plain_version_matches_reference_kernel(B, M, Tb):
    w, d, n, lam, eta = _fista_rows(B, M)
    pad = (-M) % Tb
    nb = (M + pad) // Tb
    blk = lambda a: np.pad(a, ((0, 0), (0, pad))).reshape(B, nb, Tb)
    ref_kernel = np.asarray(jax_fista_quant(
        *(jnp.asarray(blk(a)) for a in (w, d, n, lam)),
        jnp.asarray(eta.reshape(B, 1, 1)), n_iters=50, block_t=Tb,
        interpret=True)).reshape(B, -1)[:, :M]
    ref_plain = np.asarray(jax_ref_fista(
        *(jnp.asarray(a) for a in (w, d, n, lam, eta)), n_iters=50))
    n0 = fista_quant.launches
    ours = fista_quant(*(T(blk(a)) for a in (w, d, n, lam)),
                       T(eta.reshape(B, 1, 1)), n_iters=50)
    assert fista_quant.launches == n0      # the CPU runs the plain version
    ours = ours.numpy().reshape(B, -1)[:, :M]
    for ref in (ref_kernel, ref_plain):
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)


def test_f32_fista_after_1000_steps_on_preconditioned_rows_is_held_by_f64():
    """Why the card holds the kernel on batched PTQ's preconditioned rows
    by the objective and the float64 distance, not the elementwise bar:
    there two f32 plain versions (the reference's and the port's) already
    differ beyond 2e-4 / 1e-3 after 1000 steps, while each stays within
    3x of the other's distance from a float64 run and their eq.-6
    objectives agree within 1e-3."""
    from repro_torch.kernels.ops import fista_batch_problem
    from repro_torch.kernels.ref import ref_fista

    rng = np.random.default_rng(2)
    w = T(np.sort(rng.normal(size=(2, 4096)), axis=1).astype(np.float32))
    d = torch.diff(w, dim=1, prepend=torch.zeros(2, 1))
    p = fista_batch_problem(w, d, torch.ones_like(w), 0.05)
    args = [p[k].reshape(2, -1) for k in ("w", "d", "n", "lam")]
    eta = p["eta"].reshape(2)
    ours = ref_fista(*args, eta, n_iters=1000).double()
    ref = T(np.asarray(jax_ref_fista(*(jnp.asarray(a.numpy())
                                       for a in args + [eta]),
                                     n_iters=1000))).double()
    exact = ref_fista(*[a.double() for a in args], eta.double(),
                      n_iters=1000)
    assert not np.allclose(ours.numpy(), ref.numpy(), atol=2e-4, rtol=1e-3)
    e_ours, e_ref = ((a - exact).abs().max() for a in (ours, ref))
    assert e_ours <= 3.0 * e_ref and e_ref <= 3.0 * e_ours

    def f(a):
        r = args[0].double() - torch.cumsum(a * args[1].double(), 1)
        return 0.5 * (args[2].double() * r * r).sum(1) + (
            args[3].double() * a.abs()).sum(1)
    assert torch.allclose(f(ours), f(ref), rtol=1e-3, atol=0)


def test_power_iteration_matches_reference():
    _, d, n, _, _ = _fista_rows(3, 200, seed=5)
    n = n * np.random.default_rng(6).integers(1, 50, n.shape)
    np.testing.assert_allclose(power_iter_lipschitz(T(d), T(n)).numpy(),
                               jax_power_iter(d, n), rtol=1e-9)


def _padded_rows(seed=4, lengths=(60, 90)):
    rng = np.random.default_rng(seed)
    m2 = max(lengths)
    W = np.zeros((len(lengths), m2), np.float32)
    D, N = np.zeros_like(W), np.zeros_like(W)
    for i, m in enumerate(lengths):
        v = np.sort(rng.normal(size=m)).astype(np.float32)
        W[i, :m] = v
        D[i, :m] = np.diff(v, prepend=0.0)
        N[i, :m] = 1.0
    return W, D, N


def test_solve_fista_batch_matches_reference_and_masks_padding():
    W, D, N = _padded_rows()
    ref = jax_solve_fista_batch(W, D, N, 0.05, n_iters=200, interpret=True)
    ours = solve_fista_batch(T(W), T(D), T(N), 0.05, n_iters=200).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)
    # the short row alone equals the short row in the batch; its padded
    # tail stays 0
    m1 = 60
    alone = solve_fista_batch(T(W[:1, :m1]), T(D[:1, :m1]), T(N[:1, :m1]),
                              0.05, n_iters=200).numpy()
    np.testing.assert_allclose(ours[0, :m1], alone[0], atol=1e-4)
    assert np.all(ours[0, m1:] == 0)


def test_fista_reaches_the_cd_objective():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, 500).round(2)
    prob = make_problem(*np.unique(w, return_counts=True))
    m = prob.m
    alpha = solve_fista_batch(prob.w_hat[None], prob.d[None],
                              torch.ones(1, m), 0.05, n_iters=2000)
    a_cd, _ = cd_solve(prob, 0.05, max_sweeps=500, tol=1e-9)
    f_fista = float(objective(prob, alpha[0], 0.05))
    f_cd = float(objective(prob, a_cd, 0.05))
    assert f_fista <= f_cd * 1.01 + 1e-4


# ------------------------------------------------------------ CD, alg. 2


def _problem(seed, n=300, weighted=True):
    w = np.random.default_rng(seed).laplace(size=n).round(2)
    vals, counts, _ = jax_unique(w)
    return (jax_make_problem(vals, counts, weighted=weighted),
            make_problem(vals, counts, weighted=weighted))


@pytest.mark.parametrize("lam2_frac,penalize_first", [(0.0, True),
                                                      (0.0, False),
                                                      (0.25, True)])
def test_cd_solve_matches_reference_and_dense_oracle(lam2_frac,
                                                     penalize_first):
    jprob, prob = _problem(0)
    assert max_stable_lam2(prob) == pytest.approx(
        jax_max_stable_lam2(jprob), rel=1e-7)
    lam1, lam2 = 0.5, lam2_frac * max_stable_lam2(prob)
    kw = dict(penalize_first=penalize_first)
    ours, sweeps = cd_solve(prob, lam1, lam2, **kw)
    ref, _ = jax_cd_solve(jprob, jnp.float32(lam1), jnp.float32(lam2), **kw)
    scale = float(prob.w_hat.abs().max())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=1e-3 * scale, rtol=0)
    f_ours = float(objective(prob, ours.double(), lam1, lam2,
                             penalize_first=penalize_first))
    f_ref = float(jax_objective(jprob, ref, lam1, lam2,
                                penalize_first=penalize_first))
    assert f_ours == pytest.approx(f_ref, rel=1e-5)
    dense, _ = cd_solve_dense_reference(prob, lam1, lam2, **kw)
    np.testing.assert_allclose(ours.numpy(), dense, atol=1e-6 * scale,
                               rtol=0)
    assert 0 < sweeps <= 200


def test_cd_sweep_equals_one_sweep_of_the_dense_oracle():
    from repro_torch.core.cd import cd_sweep

    _, prob = _problem(1, n=120)
    lam = torch.full((prob.m,), 0.3)
    one, _ = cd_sweep(torch.ones(prob.m), prob, lam, 0.0)
    dense, _ = cd_solve_dense_reference(prob, 0.3, max_sweeps=1)
    np.testing.assert_allclose(one.numpy(), dense, atol=1e-6, rtol=0)


@pytest.mark.parametrize("l", [4, 12])
def test_iterative_l1_matches_reference(l):
    jprob, prob = _problem(2, n=200)
    w_ref, a_ref, nnz_ref, it_ref = jax_iterative_l1(jprob, l)
    w, a, nnz, it = iterative_l1(prob, l)
    assert (nnz, it) == (nnz_ref, it_ref) and nnz <= l
    np.testing.assert_array_equal(a.numpy() != 0, np.asarray(a_ref) != 0)
    scale = float(prob.w_hat.abs().max())
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref),
                               atol=1e-5 * scale, rtol=0)


# ------------------------------------------------------------ specs


@pytest.mark.parametrize("text", [
    "l1_ls:lam=0.02", "l1:lam=0.5,weighted=true",
    "l1_ls:lam=0.02,clip=-1.0..1.0", "iter_l1@16", "iter_l1@8:weighted=true",
    "kmeans@16", "kmeans_ls@16:seed=3"])
def test_spec_strings_round_trip_as_in_reference(text):
    ours = QuantSpec.parse(text)
    assert str(ours) == str(JaxSpec.parse(text)) == text
    assert QuantSpec.parse(str(ours)) == ours
    assert ours.param_kind == JaxSpec.parse(text).param_kind


@pytest.mark.parametrize("text,match", [
    ("l1_ls", "requires lam"), ("l1_ls@16:lam=0.1", "not valid for lam"),
    ("iter_l1@16:lam=0.1", "not valid for count"),
    ("l1_ls:lam=0.1,lam2=0.01", "lam2"), ("l1_ls:lam=-1.0", ">= 0"),
    ("iter_l1", "requires num_values")])
def test_spec_rejections_match_reference(text, match):
    with pytest.raises(ValueError):
        JaxSpec.parse(text)
    with pytest.raises(ValueError, match=match):
        QuantSpec.parse(text)


def test_registry_kinds_match_reference():
    """The port's registry is the reference's, name for name, with the
    same capabilities."""
    from repro.core import registry as jax_registry

    assert registry.methods() == jax_registry.methods()
    for name in registry.methods():
        ours, ref = registry.get(name), jax_registry.get(name)
        assert (ours.param_kind, ours.tree_batched, ours.accepts_lam2,
                ours.device_batch is not None) == (
            ref.param_kind, ref.tree_batched, ref.accepts_lam2,
            ref.device_batch is not None), name
        if ours.device_batch is None and not ours.tree_batched:
            # host-only methods; the others name the port's kernels
            assert ours.description == ref.description, name
    assert registry.lam_methods() == jax_registry.lam_methods()
    assert registry.count_methods() == jax_registry.count_methods()
    assert set(registry.device_methods()) == set(
        jax_registry.device_methods()) == {"iter_l1", "kmeans", "kmeans_ls"}


@pytest.mark.parametrize("spec", ["l1:lam=0.5", "l1_ls:lam=0.5,weighted=true",
                                  "iter_l1@8"])
def test_quantize_lam_and_iter_specs_match_reference(spec):
    w = np.random.default_rng(7).laplace(size=(12, 25)).round(2).astype(
        np.float32)
    jqt, jinfo = jax_quantize(w, spec)
    qt, info = quantize(T(w), spec)
    assert info["n_values"] == jinfo["n_values"]
    assert info["l2_loss"] == pytest.approx(jinfo["l2_loss"], rel=1e-4)
    assert "alpha" in info and info["alpha"].shape == (info["m_unique"],)
    np.testing.assert_allclose(qt.to_dense().numpy(),
                               np.asarray(jqt.to_dense()), atol=1e-4)


# ------------------------------------------------------------ page solvers


def _page_rows():
    """The reference test's rows (test_kernels.py:202): clusterable rows
    and gaussian rows."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(2, 6)) * 4
    clustered = (centers[:, rng.integers(0, 6, 320)]
                 + rng.normal(size=(2, 320)) * 0.05)
    gauss = rng.normal(size=(2, 320))
    return np.concatenate([clustered, gauss]).astype(np.float32)


def _row_mse(rows, codes, cb):
    recon = np.take_along_axis(np.asarray(cb), np.asarray(codes).astype(
        np.int64), axis=1)
    return ((recon - rows) ** 2).mean(axis=1)


def test_quantize_pages_fista_bounds_and_reference_mse():
    rows = _page_rows()
    L = 16
    codes, cb = quantize_pages_fista(T(rows), num_values=L)
    codes, cb = codes.numpy(), cb.numpy()
    assert codes.shape == rows.shape and cb.shape == (4, L)
    assert codes.dtype == np.uint8 and codes.max() < L
    assert np.all(np.diff(cb, axis=1) >= -1e-5), "codebooks must be sorted"
    err = _row_mse(rows, codes, cb)
    crude = np.sign(rows) * np.abs(rows).mean(axis=1, keepdims=True)
    assert np.all(err < 0.5 * ((crude - rows) ** 2).mean(axis=1))
    kerr = _row_mse(rows, *quantize_pages_device(T(rows), num_values=L))
    assert err.mean() < 5.0 * kerr.mean() + 1e-6
    ref = _row_mse(rows, *jax_pages_fista(jnp.asarray(rows), num_values=L))
    np.testing.assert_allclose(err, ref, rtol=1e-4)


def test_quantize_pages_fista_rows_do_not_depend_on_the_batch():
    rows = T(_page_rows())
    codes, cb = quantize_pages_fista(rows, num_values=16)
    for i in range(rows.shape[0]):
        c1, cb1 = quantize_pages_fista(rows[i:i + 1], num_values=16)
        assert torch.equal(c1[0], codes[i]) and torch.equal(cb1[0], cb[i])


def test_iter_l1_and_kmeans_specs_freeze_pages_as_the_reference():
    rows = _page_rows()
    for text in ("iter_l1@16", "kmeans@16"):
        spec = QuantSpec.parse(text)
        assert spec.device_capable
        codes, cb = spec.device_solve(T(rows))
        assert codes.dtype == torch.uint8 and cb.shape == (4, 16)
        if text == "kmeans@16":      # the DP's centers, no refit
            rc, rcb = jax_pages_kmeans_raw(jnp.asarray(rows),
                                           JaxSpec.parse(text))
            np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
            np.testing.assert_allclose(cb.numpy(), np.asarray(rcb),
                                       atol=1e-6, rtol=0)
            refit = jax_pages_kmeans(jnp.asarray(rows), num_values=16)[1]
            assert not np.allclose(cb.numpy(), np.asarray(refit))


# ------------------------------------------------------------ batched PTQ


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_reduced_config("qwen3_0_6b")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("qwen3_0_6b")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _reference_problem(leaf, max_unique=4096):
    """The reference's per-leaf problem (quant/ptq.py:117-140)."""
    vals, counts, inv = jax_unique(np.asarray(leaf))
    if len(vals) > max_unique:
        edges = np.quantile(vals, np.linspace(0, 1, max_unique + 1)[1:-1])
        bucket = np.searchsorted(edges, vals)
        bvals, bcnt = np.zeros(max_unique), np.zeros(max_unique)
        np.add.at(bcnt, bucket, counts)
        np.add.at(bvals, bucket, counts * vals)
        nz = bcnt > 0
        vals, counts = bvals[nz] / bcnt[nz], bcnt[nz]
        inv = (np.cumsum(nz) - 1)[bucket[inv]]
    return vals, counts, inv


def test_quantize_tree_batched_matches_reference(reduced):
    jcfg, jparams, cfg, params = reduced
    text = "l1_ls:lam=0.05,weighted=true"
    jq, jreport = jax_quantize_tree(jparams, text, batched=True,
                                    skip_patterns=PTQ_SKIP)
    q, report = quantize_tree(params, text, batched=True,
                              skip_patterns=PTQ_SKIP)
    # the same problems: each projection's layers as one vector
    probs, W, D, N = tree_problems(params, QuantSpec.parse(text),
                                   skip_patterns=PTQ_SKIP)
    assert len(probs) == len(jreport) == 7
    jleaves = jparams["groups"]["l0"]
    for key, members, vals, counts, inv in probs:
        sub, proj = key.split("/")[-2:]
        assert [m[0] for m in members] == [
            f"layers/{i}/{sub}/{proj}" for i in range(cfg.n_layers)]
        rv, rc, ri = _reference_problem(jleaves[sub][proj])
        np.testing.assert_allclose(vals.numpy(), rv, rtol=0,
                                   atol=1e-12 * np.abs(rv).max())
        np.testing.assert_array_equal(counts.numpy(), rc)
        np.testing.assert_array_equal(inv.numpy(), ri)
    # FISTA on them reaches the reference's objective
    lam = 0.05
    ours = solve_fista_batch(W, D, N, lam, n_iters=1000)
    ref = jax_solve_fista_batch(W.numpy(), D.numpy(), N.numpy(), lam,
                                n_iters=1000, interpret=True)
    for i, (_, _, vals, counts, _) in enumerate(probs):
        m = vals.numel()
        prob = make_problem(vals, counts, weighted=True)
        f = [float(objective(prob, torch.as_tensor(a[i, :m]).double(), lam))
             for a in (ours, ref)]
        assert f[0] == pytest.approx(f[1], rel=1e-3)
    # outputs: per-layer leaves sharing their projection's codebook
    for key, jrow in jreport.items():
        sub, proj = key.split("/")[-2:]
        jdense = np.asarray(jq["groups"]["l0"][sub][proj].to_dense()).astype(
            np.float64)
        loss = ref_loss = 0.0
        for i in range(cfg.n_layers):
            qt = q["layers"][i][sub][proj]
            row = report[f"layers/{i}/{sub}/{proj}"]
            assert row["group"] == f"layers/*/{sub}/{proj}"
            assert torch.equal(qt.codebook,
                               q["layers"][0][sub][proj].codebook)
            assert row["n_values"] == pytest.approx(jrow["n_values"],
                                                    rel=0.25)
            w = params["layers"][i][sub][proj].double().numpy()
            loss += ((qt.to_dense().double().numpy() - w) ** 2).sum()
            ref_loss += ((jdense[i] - w) ** 2).sum()
        assert loss == pytest.approx(ref_loss, rel=0.25)


def test_quantize_tree_batched_rejects_specs_it_cannot_batch(reduced):
    params = reduced[3]
    for text in ("l1:lam=0.05", "iter_l1@16", "kmeans_ls@16"):
        with pytest.raises(ValueError, match="tree-batched"):
            quantize_tree(params, text, batched=True)


def test_quantize_tree_per_leaf_takes_lam_specs():
    w = np.random.default_rng(8).laplace(size=(16, 20)).round(2).astype(
        np.float32)
    q, report = quantize_tree({"layers": [{"w": T(w)}]}, "l1_ls:lam=0.5",
                              skip_patterns=())
    _, jinfo = jax_quantize(w, "l1_ls:lam=0.5")
    assert report["layers/0/w"]["n_values"] == jinfo["n_values"]


# ------------------------------------------------------------ engine


def test_engine_with_iter_l1_pages_matches_fp_and_reference(reduced):
    """The reference test's geometry (test_serving.py:626): the iter_l1@16
    engine against the fp engine, and against the reference engine on the
    same run."""
    jcfg, jparams, cfg, params = reduced
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, 32).tolist() for _ in range(2)]
    kw = dict(max_slots=2, block_size=16, max_seq_len=64,
              record_logits=True)
    runs = {}
    for kvq in (None, "iter_l1@16"):
        eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                       kv_quant=kvq, **kw)
        runs[kvq] = (eng.generate(prompts, max_new_tokens=8), eng)
    (_, fp), (out, q) = runs[None], runs["iter_l1@16"]
    assert q.freeze_async and q.kv_spec.device_capable
    assert q.counters["freeze_dispatches"] > 0
    for i in range(len(prompts)):
        d = np.abs(fp.request_logits[i] - q.request_logits[i])
        scale = np.abs(fp.request_logits[i]).max()
        assert d.max() <= 2.5 and d.max() / scale <= 0.08
    kw["freeze_async"] = False
    sync = ContinuousBatchingEngine(params, cfg, device="cpu",
                                    kv_quant="iter_l1@16", **kw)
    jeng = JaxEngine(jparams, jcfg, kv_quant="iter_l1@16", **kw)
    assert sync.generate(prompts, max_new_tokens=8) == jeng.generate(
        prompts, max_new_tokens=8)
    for i in range(len(prompts)):
        np.testing.assert_allclose(sync.request_logits[i],
                                   jeng.request_logits[i], atol=1e-3,
                                   rtol=0)
