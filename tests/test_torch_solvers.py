"""The port's other solvers against the JAX package on seeded numpy inputs:
the optimal 1-D DP (dp), the exact TV solver (tv, tv_iter), l0 (eq. 16),
l1l2 (eq. 13), the mog and dtc baselines, the whole registry end to end,
and the options of kernel 4's wrappers (``solve_fista_batch``'s
penalize_first, precondition and use_kernel; ``quantize_pages_fista``'s
n_iters, bisect_steps and lloyd_rounds).

Tolerances and why:
- dp: bitwise (the same float64 operations in the same order).
- tv1d_weighted, tv_solve_problem: 1e-12 of the data's scale (the same
  float64 operations; both read 0 here). tv_iterative: the same number
  of values and bisection steps, the reconstruction within 1e-6 of the
  range (refit in float64 prefix sums against the reference's f32
  segment sums: 7.3e-8 of the range read).
- l0_solve at a fixed gamma: the same support, alpha within rtol 1e-3
  (the port sweeps in float64, the reference in f32: 1.2e-4 relative
  read, on alphas of magnitude 1-23). l0_quantize: the same count, the
  reference's unreachable count included.
- l1l2: the same number of values and lam2 (max_stable_lam2 is the same
  f32 value), the reconstruction within 1e-5 of the range (CD's bar in
  tests/test_torch_fista.py).
- mog from the reference's k-means centers: the same EM in f32 (torch's
  and XLA's exp/logsumexp), the reconstruction within 1e-5 of the range
  (3.1e-7 read) and the same number of values. dtc from the reference's
  clusters: within 1e-6 of the range (float64 prefix sums against f32
  segment sums: 4.2e-8 read). From the port's own seeding (a
  torch.Generator draws other seeds): the loss within 10% of the
  reference's (seeds 0-2 of mog, dtc and kmeans read 3.8% at most) and
  never below dp's.
- solve_fista_batch with precondition=False and use_kernel=False
  against the reference's ``solve_fista_batch(..., interpret=True)``:
  atol 2e-4 / rtol 1e-3, the reference kernel's bar
  (tests/test_kernels.py:67). With penalize_first=False that bar does
  not hold between the reference's own kernel and plain version (8.0e-4
  read), so there: the objective within 1e-3 of the reference's and the
  distance from a float64 run within 3x the reference kernel's.
- quantize_pages_fista with its options: each row's MSE within 1e-4
  relative of the reference's on the same rows, the bar of
  tests/test_torch_fista.py's page test.
- The paper's dense oracles (eq. 9 by lstsq on the materialized V*; eqs.
  18-20's E and V-hat*): the port's fast ``refit_support`` and
  ``kmeans_ls_quantize`` on a float64 problem within 1e-9 of the port's
  oracles (the closed form and lstsq differ by rounding only: ~5e-13
  read); the port's oracles within 1e-12 of the reference's on the same
  f32 problem (the same float64 numpy).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
from repro.core import registry as jax_registry
from repro.core.iterative import tv_iterative as jax_tv_iterative
from repro.core.kmeans_ls import (
    kmeans_ls_dense_reference as jax_kmeans_ls_oracle)
from repro.core.l0 import l0_quantize as jax_l0_quantize
from repro.core.l0 import l0_solve as jax_l0_solve
from repro.core.refit import (
    refit_support_dense_reference as jax_refit_oracle)
from repro.kernels import quantize_pages_fista as jax_pages_fista
from repro.kernels import solve_fista_batch as jax_solve_fista_batch
from repro_torch import core
from repro_torch.core import (ALL_METHODS, COUNT_METHODS, LAM_METHODS,
                              QuantSpec, cd_solve, kmeans_ls_dense_reference,
                              kmeans_ls_quantize, l0_quantize, l0_solve,
                              make_problem, objective, optimal_kmeans_1d,
                              quantize, refit_support,
                              refit_support_dense_reference, registry,
                              support_of, tv1d_weighted, tv_iterative,
                              tv_solve_problem)
from repro_torch.kernels import quantize_pages_fista, solve_fista_batch

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

T = torch.from_numpy


def _data(seed=0, n=300, round_to=2):
    """The reference core tests' data: rounded normals, so values repeat."""
    return np.random.default_rng(seed).normal(0, 1, n).round(round_to)


def _problems(seed, n=300, weighted=False):
    vals, counts, _ = jcore.unique_with_counts(_data(seed, n))
    return (jcore.make_problem(vals, counts, weighted=weighted),
            make_problem(vals, counts, weighted=weighted))


def _scale(a):
    a = np.asarray(a, np.float64)
    return max(float(a.max() - a.min()), 1e-12)


# ------------------------------------------------------------ dp


def _check_dp(vals, counts, k):
    ref = jcore.optimal_kmeans_1d(vals, counts, k)
    ours = optimal_kmeans_1d(T(vals), T(counts), k)
    for r, o in zip(ref[:3], ours[:3]):
        assert np.array_equal(np.asarray(r), o.numpy()), (len(vals), k)
        assert o.dtype == torch.from_numpy(np.asarray(r)).dtype
    assert ours[3] == ref[3]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("weighted", [False, True])
def test_dp_is_bitwise_the_reference(seed, weighted):
    """Random sizes and budgets; equally spaced values (tied costs); a
    single value; k = m."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 300))
    cases = [np.unique(rng.normal(size=m).round(2)),
             np.arange(m, dtype=np.float64),            # ties everywhere
             np.array([0.5]),
             np.unique(rng.laplace(size=40))]
    for vals in cases:
        counts = (rng.integers(1, 6, size=len(vals)).astype(np.float64)
                  if weighted else np.ones(len(vals)))
        for k in {1, len(vals), int(rng.integers(1, len(vals) + 1)), 16}:
            _check_dp(vals, counts, k)


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(st.lists(st.integers(-40, 40), min_size=1, max_size=120),
       st.integers(1, 130), st.booleans())
def test_dp_is_bitwise_the_reference_property(ints, k, weighted):
    vals = np.unique(np.asarray(ints, np.float64) / 8)
    counts = (np.arange(len(vals)) % 3 + 1.0 if weighted
              else np.ones(len(vals)))
    _check_dp(vals, counts, k)


# ------------------------------------------------------------ tv


@pytest.mark.parametrize("seed", range(3))
def test_tv1d_weighted_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 3, 57, 300):
        y = rng.normal(size=n)
        w = rng.uniform(0.5, 3.0, size=n)
        lam = rng.uniform(0.0, 0.6, size=max(n - 1, 0))
        ref = jcore.tv1d_weighted(y, w, lam)
        ours = tv1d_weighted(y, w, lam).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12 * _scale(y))


@pytest.mark.parametrize("weighted", [False, True])
def test_tv_solve_problem_and_tv_iterative_match_reference(weighted):
    jprob, prob = _problems(5, weighted=weighted)
    for lam in (0.01, 0.05, 0.2):
        np.testing.assert_allclose(tv_solve_problem(prob, lam).numpy(),
                                   jcore.tv_solve_problem(jprob, lam),
                                   rtol=0, atol=1e-12)
    for l in (3, 8, 20):
        w_ref, _, nnz_ref, it_ref = jax_tv_iterative(jprob, l)
        w, _, nnz, it = tv_iterative(prob, l)
        assert (nnz, it) == (nnz_ref, it_ref) and nnz <= l
        np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0,
                                   atol=1e-6 * _scale(w_ref))


def test_tv_exact_beats_or_matches_cd():
    """The reference's check (tests/test_core_quant.py:69): TV solves eq.
    6 without the first coordinate's penalty globally, so its objective
    is at most CD's on the same objective."""
    _, prob = _problems(5, n=400)
    d = prob.d.double()
    for lam in (0.01, 0.05, 0.2):
        a_cd, _ = cd_solve(prob, lam, penalize_first=False, max_sweeps=300,
                           tol=1e-9)
        u = tv_solve_problem(prob, lam)
        a_tv = torch.diff(u, prepend=u.new_zeros(1)) / torch.where(
            d == 0, torch.ones_like(d), d)
        f = lambda a: float(objective(prob, a.float(), lam,
                                      penalize_first=False))
        assert f(a_tv) <= f(a_cd) + 1e-4 * abs(f(a_cd))


def _image():
    """benchmarks/common.py:synthetic_image: a 28 x 28 image in [0, 1]
    whose smallest value is 0."""
    from benchmarks.common import synthetic_image

    return synthetic_image()


def test_tv_leaves_a_zero_first_value_free():
    """Where the smallest value is 0, d_1 = 0 and eq. 6 pins the first
    reconstructed value to 0, while tv leaves it free: tv's objective,
    evaluated as eq. 6, lies above CD's, in both packages alike, so the
    check above holds only on data without a 0."""
    img = _image()
    lam = 0.02
    vals, counts, _ = jcore.unique_with_counts(img)
    assert vals[0] == 0.0
    jprob, prob = jcore.make_problem(vals, counts), make_problem(vals, counts)
    a_cd, _ = cd_solve(prob, lam, penalize_first=False, max_sweeps=300,
                       tol=1e-9)
    u = tv_solve_problem(prob, lam)
    d = prob.d.double()
    a_tv = torch.diff(u, prepend=u.new_zeros(1)) / torch.where(
        d == 0, torch.ones_like(d), d)
    f = lambda a: float(objective(prob, a.double(), lam,
                                  penalize_first=False))
    assert float(u[0]) > 0 and f(a_tv) > 1.05 * f(a_cd)
    ja_cd, _ = jcore.cd_solve(jprob, lam, penalize_first=False,
                              max_sweeps=300, tol=1e-9)
    ju = jcore.tv_solve_problem(jprob, lam)
    np.testing.assert_allclose(u.numpy(), ju, rtol=0, atol=1e-12)
    jd = np.asarray(jprob.d)
    ja_tv = np.diff(ju, prepend=0.0) / np.where(jd == 0, 1.0, jd)
    jf = lambda a: float(jcore.objective(jprob, jnp.asarray(a, jnp.float32),
                                         lam, penalize_first=False))
    assert jf(ja_tv) > 1.05 * jf(ja_cd)


# ------------------------------------------------------------ l0


@pytest.mark.parametrize("gamma", [0.01, 0.1, 1.0])
def test_l0_solve_at_a_fixed_gamma_matches_reference(gamma):
    jprob, prob = _problems(6)
    ref = np.asarray(jax_l0_solve(jprob, jnp.float32(gamma)))
    ours = l0_solve(prob, float(np.float32(gamma))).numpy()
    np.testing.assert_array_equal(ours != 0, ref != 0)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=0)


def test_l0_quantize_matches_reference_counts():
    """The same count at every budget, including one l0 cannot reach
    (the paper's "non-universal"): 33 gives 32 here, in both."""
    jprob, prob = _problems(7, n=400)
    unreachable = 0
    for l in (4, 9, 16, 33):
        _, nnz_ref = jax_l0_quantize(jprob, l)
        alpha, nnz = l0_quantize(prob, l)
        assert nnz == nnz_ref <= l, (l, nnz, nnz_ref)
        assert alpha.dtype == torch.float32
        unreachable += nnz < l
    assert unreachable >= 1


# ------------------------------------------------------------ l1l2


@pytest.mark.parametrize("lam2", [None, 1e-9, 10.0])
def test_l1l2_matches_reference(lam2):
    """lam2 defaulted (0.25 x max_stable_lam2), given, and clamped (0.49
    x); the same lam2 reported."""
    w = _data(4).astype(np.float32)
    text = "l1l2:lam=0.05" + ("" if lam2 is None else f",lam2={lam2!r}")
    qt_ref, ref = jcore.quantize(w, text)
    qt, info = quantize(T(w), text)
    assert info["n_values"] == ref["n_values"]
    assert info["lam2"] == ref["lam2"]
    np.testing.assert_allclose(qt.to_dense().numpy(),
                               np.asarray(qt_ref.to_dense()), rtol=0,
                               atol=1e-5 * _scale(w))


def test_l1l2_sparser_at_equal_lam1():
    """The reference's check (tests/test_core_quant.py:61): negative l2
    gives no more values than l1 at equal lam1."""
    w = T(_data(4, n=400))
    _, i1 = quantize(w, "l1:lam=0.05")
    _, i2 = quantize(w, "l1l2:lam=0.05")
    assert i2["n_values"] <= i1["n_values"]


# ------------------------------------------------------------ mog, dtc


def _reference_kmeans(monkeypatch, module):
    """Patch ``module``'s kmeans_1d with the reference's (same inputs as
    numpy, outputs as tensors): both packages then start from the same
    centers."""
    def kmeans_1d(vals, counts, k, **kw):
        out = jcore.kmeans_1d(jnp.asarray(vals.numpy()),
                              jnp.asarray(counts.numpy()), k, **kw)
        return tuple(torch.from_numpy(np.array(a)) for a in out)
    monkeypatch.setattr(module, "kmeans_1d", kmeans_1d)


@pytest.mark.parametrize("method", ["mog", "dtc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_mog_and_dtc_from_the_reference_centers(monkeypatch, method,
                                                weighted):
    import repro_torch.core.dtc as dtc
    import repro_torch.core.mog as mog

    _reference_kmeans(monkeypatch, mog if method == "mog" else dtc)
    w = _data(8).astype(np.float32)
    text = f"{method}@8" + (":weighted=true" if weighted else "")
    qt_ref, ref = jcore.quantize(w, text)
    qt, info = quantize(T(w), text)
    tol = 1e-5 if method == "mog" else 1e-6
    assert info["n_values"] == ref["n_values"]
    np.testing.assert_allclose(qt.to_dense().numpy(),
                               np.asarray(qt_ref.to_dense()), rtol=0,
                               atol=tol * _scale(w))


@pytest.mark.parametrize("method", ["mog", "dtc", "kmeans"])
@pytest.mark.parametrize("seed", range(3))
def test_seeded_methods_loss_near_reference_and_above_dp(method, seed):
    w = _data(9 + seed).astype(np.float32)
    text = f"{method}@6:seed={seed}" if seed else f"{method}@6"
    _, ref = jcore.quantize(w, text)
    _, info = quantize(T(w), text)
    _, dp = quantize(T(w), "dp@6")
    assert info["l2_loss_unique"] <= 1.10 * ref["l2_loss_unique"]
    assert info["l2_loss_unique"] >= dp["l2_loss_unique"] * (1 - 1e-12)


# ------------------------------------------------------------ the registry


def test_capability_tuples_derive_from_registry():
    """tests/test_spec.py:226, ported: the tuples are the registry's and
    the reference's."""
    assert ALL_METHODS == registry.methods() == jax_registry.methods()
    assert LAM_METHODS == registry.lam_methods() == jcore.LAM_METHODS
    assert COUNT_METHODS == registry.count_methods() == jcore.COUNT_METHODS
    assert set(registry.device_methods()) <= set(COUNT_METHODS)
    missing = set(jcore.__all__) - set(core.__all__)
    # the deprecated loose-kwargs shim is not ported
    assert missing == {"resolve_spec"}, missing


def _valid_spec(method: str) -> QuantSpec:
    if registry.get(method).param_kind == "count":
        return QuantSpec(method, num_values=10)
    return QuantSpec(method, lam=0.05)


@pytest.mark.parametrize("method", jax_registry.methods())
def test_every_method_end_to_end(method):
    """tests/test_core_quant.py:140 and tests/test_spec.py:187, ported:
    every registered method quantizes through the spec surface, its spec
    round-trips, value sharing holds, and a count method keeps its
    budget. Against the reference: equal n_values for the deterministic
    methods."""
    w = _data(11).astype(np.float32)
    spec = _valid_spec(method)
    assert QuantSpec.parse(str(spec)) == spec
    assert str(spec) == str(jcore.QuantSpec.parse(str(spec)))
    qt, info = quantize(T(w), spec)
    dense = qt.to_dense().numpy()
    assert dense.shape == w.shape and np.isfinite(dense).all()
    assert len(np.unique(dense)) == info["n_values"]
    assert info["l2_loss"] < float(np.sum(w.astype(np.float64) ** 2))
    if spec.param_kind == "count":
        assert info["n_values"] <= 10
    if method not in ("kmeans", "kmeans_ls", "mog", "dtc"):
        _, ref = jcore.quantize(w, str(spec))
        assert info["n_values"] == ref["n_values"], method


def test_count_methods_respect_l():
    """tests/test_core_quant.py:153, ported."""
    w = T(_data(12, n=200))
    for method in COUNT_METHODS:
        for l in (2, 5, 33):
            _, info = quantize(w, f"{method}@{l}")
            assert info["n_values"] <= l, (method, l)


def test_every_count_method_loses_at_least_dp():
    """dp is the lower bound of every count method at the same budget and
    weighting (what chip_smoke.py checks on the card)."""
    w = T(_data(13))
    for weighted in ("", ":weighted=true"):
        _, dp = quantize(w, "dp@8" + weighted)
        for method in COUNT_METHODS:
            _, info = quantize(w, f"{method}@8{weighted}")
            assert info["l2_loss_unique" if not weighted else "l2_loss"] \
                >= dp["l2_loss_unique" if not weighted else "l2_loss"] * (
                    1 - 1e-12), method


# ------------------------------------------------------------ kernel 4


def _padded_rows(seed=4, lengths=(60, 90)):
    rng = np.random.default_rng(seed)
    W = np.zeros((len(lengths), max(lengths)), np.float32)
    D, N = np.zeros_like(W), np.zeros_like(W)
    for i, m in enumerate(lengths):
        v = np.sort(rng.normal(size=m)).astype(np.float32)
        W[i, :m], N[i, :m] = v, 1.0
        D[i, :m] = np.diff(v, prepend=0.0)
    return W, D, N


def _fista_f64(W, D, N, n_iters, **opts):
    """solve_fista_batch's problem solved by the plain version in
    float64: the yardstick of two f32 summation orders."""
    from repro_torch.kernels.ops import fista_batch_problem
    from repro_torch.kernels.ref import ref_fista

    B, M = W.shape
    p = fista_batch_problem(T(W), T(D), T(N), 0.05, **opts)
    alpha = ref_fista(*(p[k].reshape(B, -1)[:, :M].double()
                        for k in ("w", "d", "n", "lam")),
                      p["eta"].double(), n_iters=n_iters)
    return (alpha / p["scale"].double()).numpy() * (N > 0)


@pytest.mark.parametrize("opts", [
    dict(precondition=False), dict(use_kernel=False),
    dict(precondition=False, use_kernel=False)])
def test_solve_fista_batch_options_match_reference(opts):
    W, D, N = _padded_rows()
    ref = jax_solve_fista_batch(W, D, N, 0.05, n_iters=200, interpret=True,
                                **opts)
    ours = solve_fista_batch(T(W), T(D), T(N), 0.05, n_iters=200,
                             **opts).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)
    assert np.all(ours[0, 60:] == 0)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_solve_fista_batch_unpenalized_first_column(use_kernel):
    """penalize_first=False: with column 0 free, 200 steps leave the
    iterates order-dependent beyond the elementwise bar (the reference's
    own kernel and plain version differ by 8.0e-4 here; the port by
    3.8e-4 from the kernel). So, as on tests/test_torch_fista.py's PTQ
    rows: the eq.-6 objective without column 0's penalty within 1e-3 of
    the reference kernel's, and no farther from a float64 run than 3x the
    reference kernel is; column 0 is not thresholded."""
    W, D, N = _padded_rows()
    kw = dict(penalize_first=False)
    ref = jax_solve_fista_batch(W, D, N, 0.05, n_iters=200, interpret=True,
                                **kw)
    ours = solve_fista_batch(T(W), T(D), T(N), 0.05, n_iters=200,
                             use_kernel=use_kernel, **kw).numpy()
    ref_plain = jax_solve_fista_batch(W, D, N, 0.05, n_iters=200,
                                      use_kernel=False, **kw)
    assert not np.allclose(ref_plain, ref, atol=2e-4, rtol=1e-3)
    exact = _fista_f64(W, D, N, 200, **kw)
    assert np.abs(ours - exact).max() <= 3 * np.abs(ref - exact).max()

    def f(a):
        r = W - np.cumsum(a * D, axis=1)
        return (0.5 * (N * r * r).sum(1)
                + 0.05 * np.abs(a[:, 1:] * (N[:, 1:] > 0)).sum(1))
    np.testing.assert_allclose(f(ours), f(ref), rtol=1e-3)
    assert np.all(ours[0, 60:] == 0) and np.all(ours[:, 0] != 0)
    default = solve_fista_batch(T(W), T(D), T(N), 0.05, n_iters=200)
    assert not np.allclose(ours, default.numpy(), atol=2e-4)


def _page_rows():
    """tests/test_torch_fista.py's rows: clusterable and gaussian."""
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


@pytest.mark.parametrize("opts", [
    dict(lloyd_rounds=1), dict(lloyd_rounds=2),
    dict(n_iters=50, bisect_steps=10),
    dict(n_iters=50, bisect_steps=10, lloyd_rounds=2)])
def test_quantize_pages_fista_options_match_reference(opts):
    rows = _page_rows()
    codes, cb = quantize_pages_fista(T(rows), num_values=16, **opts)
    assert codes.dtype == torch.uint8 and cb.shape == (4, 16)
    assert bool((cb.diff(dim=1) >= -1e-5).all())
    err = _row_mse(rows, codes.numpy(), cb.numpy())
    ref = _row_mse(rows, *jax_pages_fista(jnp.asarray(rows), num_values=16,
                                          **opts))
    np.testing.assert_allclose(err, ref, rtol=1e-4)
    if opts.get("lloyd_rounds"):
        # the polish lowers every row's MSE (Lloyd never raises it)
        base = _row_mse(rows, *quantize_pages_fista(
            T(rows), num_values=16, **dict(opts, lloyd_rounds=0)))
        assert np.all(err <= base * (1 + 1e-6))


# ------------------------------------------------------------ the dense oracles

ORACLE_TOL = 1e-9
ORACLE_REF_TOL = 1e-12


def _f64(problem):
    """The same problem held in float64 (the fast paths then solve in
    float64)."""
    return dataclasses.replace(problem, **{
        f.name: getattr(problem, f.name).double()
        for f in dataclasses.fields(problem)})


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [6, 7])
def test_refit_support_is_the_eq9_oracle(seed, weighted):
    """tests/test_core_quant.py:90, ported at float64: the closed-form
    refit on an l1 support against eq. 9 solved by lstsq."""
    jprob, prob = _problems(seed, weighted=weighted)
    alpha, _ = cd_solve(prob, 0.05)
    sup = support_of(alpha)
    assert 1 < int(sup.sum()) < prob.m
    w_star, alpha_star = refit_support(_f64(prob), sup)
    assert w_star.dtype == alpha_star.dtype == torch.float64
    oracle = refit_support_dense_reference(_f64(prob), sup)
    assert np.abs(w_star.numpy() - oracle).max() <= ORACLE_TOL
    ours = refit_support_dense_reference(prob, sup)
    ref = jax_refit_oracle(jprob, sup.numpy())
    assert np.abs(ours - ref).max() <= ORACLE_REF_TOL


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("l", [4, 7])
def test_kmeans_ls_is_the_eq18_20_oracle(l, weighted):
    """tests/test_core_quant.py:110, ported at float64: Algorithm 3's
    segment means against E and V-hat* materialized and solved by
    lstsq, on the assignment k-means chose."""
    jprob, prob = _problems(8, weighted=weighted)
    w_star, _, idx, _ = kmeans_ls_quantize(_f64(prob), l)
    assert w_star.dtype == torch.float64 and int(idx.max()) + 1 == l
    oracle = kmeans_ls_dense_reference(_f64(prob), idx)
    assert np.abs(w_star.numpy() - oracle).max() <= ORACLE_TOL
    ours = kmeans_ls_dense_reference(prob, idx)
    ref = jax_kmeans_ls_oracle(jprob, idx.numpy())
    assert np.abs(ours - ref).max() <= ORACLE_REF_TOL
