"""Solver registration (``core.registry.register`` and
``device_batch_solve``) against the reference's ``repro.core.registry``:
one toy count method, ``uniform`` (L evenly spaced levels over the
values' range, nearest assignment), registered in both packages, each
in its own arithmetic, through everything a built-in method reaches.

Tolerances: the toy's page codes and codebooks bitwise (the same f32
operations in both); ``quantize``'s n_values equal, the reconstruction
and l2 loss within 1e-6 relative (the solvers' bar for deterministic
methods, tests/test_torch_solvers.py); error texts equal. Every
registration is undone after each test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec as JaxSpec
from repro.core import quantize as jax_quantize
from repro.core import registry as jreg
from repro.quant.ptq import quantize_tree as jax_quantize_tree
from repro.serving import DEVICE_FREEZE_METHODS as JAX_DEVICE_FREEZE
from repro_torch.core import ALL_METHODS, QuantSpec, quantize, registry
from repro_torch.quant import quantize_tree
from repro_torch.serving import DEVICE_FREEZE_METHODS

torch.set_num_threads(1)

L = 16
RTOL = 1e-6
CALLS = {"port": 0}


# ------------------------------------------------------------ the toy method


def port_levels(lo, hi, n):
    step = (hi - lo) / (n - 1)
    step = torch.where(step > 0, step, torch.ones_like(step))
    return lo + step * torch.arange(n, dtype=lo.dtype, device=lo.device), step


def port_uniform_host(ctx, spec, **kw):
    w = ctx.problem.w_hat
    lo, hi = w.min().reshape(1), w.max().reshape(1)
    levels, step = port_levels(lo, hi, ctx.num_values)
    idx = torch.round((w - lo) / step).clamp(0, ctx.num_values - 1).long()
    return levels[idx], None


def port_uniform_pages(rows, spec):
    CALLS["port"] += 1
    x = rows.float()
    lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    cb, step = port_levels(lo, hi, spec.num_values)
    codes = torch.round((x - lo) / step).clamp(0, spec.num_values - 1)
    return codes.to(torch.uint8), cb


def jax_levels(lo, hi, n):
    step = (hi - lo) / (n - 1)
    step = jnp.where(step > 0, step, jnp.ones_like(step))
    return lo + step * jnp.arange(n, dtype=lo.dtype), step


def jax_uniform_host(ctx, spec, **kw):
    w = ctx.problem.w_hat
    lo, hi = w.min().reshape(1), w.max().reshape(1)
    levels, step = jax_levels(lo, hi, ctx.num_values)
    idx = jnp.clip(jnp.round((w - lo) / step), 0,
                   ctx.num_values - 1).astype(jnp.int32)
    return levels[idx], None


def jax_uniform_pages(rows, spec):
    x = rows.astype(jnp.float32)
    lo, hi = x.min(1, keepdims=True), x.max(1, keepdims=True)
    cb, step = jax_levels(lo, hi, spec.num_values)
    codes = jnp.clip(jnp.round((x - lo) / step), 0, spec.num_values - 1)
    return codes.astype(jnp.uint8), cb


@pytest.fixture(autouse=True)
def undo_registrations():
    saved = (dict(registry._REGISTRY), dict(registry._DEVICE_CACHE),
             dict(jreg._REGISTRY), dict(jreg._DEVICE_CACHE))
    CALLS["port"] = 0
    yield
    for live, old in zip((registry._REGISTRY, registry._DEVICE_CACHE,
                          jreg._REGISTRY, jreg._DEVICE_CACHE), saved):
        live.clear()
        live.update(old)


def register_both(name="uniform", device=True):
    """The toy in both packages; the reference's device solver by its
    "module:function" string (the only form it takes)."""
    registry.register(registry.Solver(
        name, "count", port_uniform_host,
        device_batch=port_uniform_pages if device else None))
    jreg.register(jreg.Solver(
        name, "count", jax_uniform_host,
        device_batch=(f"{__name__}:jax_uniform_pages" if device
                      else None)))


def _vec(seed=0, n=2000):
    return np.random.default_rng(seed).normal(0, 1, n).round(2)


# ------------------------------------------------------------ tests


def test_builtins_and_device_methods_are_the_references():
    assert registry.methods() == jreg.methods()
    assert registry.device_methods() == jreg.device_methods() == (
        "iter_l1", "kmeans_ls", "kmeans")
    assert DEVICE_FREEZE_METHODS == JAX_DEVICE_FREEZE
    for name in registry.device_methods():
        ours = registry.get(name).device_batch
        ref = jreg.get(name).device_batch
        assert ours == ref.replace("repro.", "repro_torch.", 1), name


@pytest.mark.parametrize("weighted", [False, True])
def test_registered_method_quantizes_as_the_reference(weighted):
    register_both()
    assert "uniform" in registry.methods() and "uniform" not in ALL_METHODS
    w = _vec(1)
    spec = f"uniform@{L}" + (":weighted=true" if weighted else "")
    jqt, jinfo = jax_quantize(w, spec)
    qt, info = quantize(torch.from_numpy(w), spec)
    assert info["n_values"] == jinfo["n_values"] == L
    np.testing.assert_allclose(qt.to_dense().numpy(),
                               np.asarray(jqt.to_dense()), rtol=RTOL,
                               atol=RTOL)
    assert abs(info["l2_loss"] / jinfo["l2_loss"] - 1) <= RTOL


def test_registered_method_validates_and_quantizes_a_tree():
    register_both()
    assert QuantSpec.parse("uniform@8") == QuantSpec("uniform", num_values=8)
    assert str(QuantSpec.parse("uniform@8:seed=3")) == str(
        JaxSpec.parse("uniform@8:seed=3"))
    for bad in ("uniform:lam=0.1", "uniform"):
        with pytest.raises(ValueError) as ours:
            QuantSpec.parse(bad)
        with pytest.raises(ValueError) as ref:
            JaxSpec.parse(bad)
        assert str(ours.value) == str(ref.value)
    rng = np.random.default_rng(2)
    tree = {"wq": rng.normal(size=(64, 32)).astype(np.float32),
            "norm": np.ones(32, np.float32)}
    jq, jrep = jax_quantize_tree({k: jnp.asarray(v) for k, v in tree.items()},
                                 f"uniform@{L}")
    q, rep = quantize_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                           f"uniform@{L}")
    assert set(rep) == set(jrep) == {"wq"}
    assert rep["wq"]["n_values"] == jrep["wq"]["n_values"]
    np.testing.assert_allclose(q["wq"].to_dense().numpy(),
                               np.asarray(jq["wq"].to_dense()), rtol=RTOL,
                               atol=RTOL)


@pytest.mark.parametrize("shape", [(6, 128), (12, 16 * 2 * 32)])
def test_page_codes_from_device_batch_solve_are_bitwise_the_references(
        shape):
    register_both()
    rows = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    rows[0] = 0.25                       # a constant row: step 1
    spec = QuantSpec("uniform", num_values=L)
    codes, cb = registry.device_batch_solve("uniform")(
        torch.from_numpy(rows), spec)
    jcodes, jcb = jreg.device_batch_solve("uniform")(
        jnp.asarray(rows), JaxSpec("uniform", num_values=L))
    assert codes.dtype == torch.uint8 and cb.dtype == torch.float32
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(cb.numpy(), np.asarray(jcb))
    # the spec's own route goes through the same resolution
    c2, cb2 = spec.device_solve(torch.from_numpy(rows))
    assert torch.equal(c2, codes) and torch.equal(cb2, cb)
    assert CALLS["port"] == 2


def test_module_function_string_resolves_lazily_and_is_cached():
    registry.register(registry.Solver(
        "uniform", "count", port_uniform_host,
        device_batch=f"{__name__}:port_uniform_pages"))
    registry.register(registry.Solver(
        "nowhere", "count", port_uniform_host,
        device_batch="repro_torch_no_such_module:solve"))
    assert "uniform" not in registry._DEVICE_CACHE
    assert registry.device_methods()[-2:] == ("uniform", "nowhere")
    fn = registry.device_batch_solve("uniform")
    assert fn is port_uniform_pages
    assert registry._DEVICE_CACHE["uniform"] is fn
    assert registry.device_batch_solve("uniform") is fn
    # registered without an import; the import fails at first use
    with pytest.raises(ModuleNotFoundError):
        registry.device_batch_solve("nowhere")
    # replacing an entry forgets the old resolution
    registry.register(registry.Solver("uniform", "count", port_uniform_host,
                                      device_batch=port_uniform_pages))
    assert "uniform" not in registry._DEVICE_CACHE


def test_error_texts_are_the_references():
    register_both()
    register_both("uniform_host_only", device=False)
    for call in (lambda r: r.get("no_such_method"),
                 lambda r: r.device_batch_solve("dtc"),
                 lambda r: r.device_batch_solve("uniform_host_only")):
        with pytest.raises(ValueError) as ours:
            call(registry)
        with pytest.raises(ValueError) as ref:
            call(jreg)
        assert str(ours.value) == str(ref.value)
    assert registry.device_methods() == jreg.device_methods()
    with pytest.raises(ValueError, match="param_kind"):
        registry.Solver("bad", "budget", port_uniform_host)


def _serve(kv):
    """The launcher's served run (``serve.serve``; its serving check's
    bound is calibrated for kmeans_ls, not for the toy)."""
    from repro_torch.launch import serve

    args = serve.parse_args([
        "--reduced", "--device", "cpu", "--kv-quant", kv, "--num-requests",
        "3", "--prompt-len", "32", "--gen", "8", "--block-size", "8",
        "--max-seq-len", "64", "--prefill-chunk", "8", "--request-rate",
        "100", "--seed", "0"])
    return serve.serve(args)[0]


def test_registered_method_serves_kv_quant_through_the_launcher():
    """``--kv-quant uniform@16`` on the CPU: every freeze through the
    registered device solver; a registered method without one freezes a
    page at a time on the host."""
    register_both()
    s = _serve("uniform@16")
    assert s["completed"] == 3 and s["freeze_installs"] > 0
    assert s["host_page_solves"] == 0
    assert CALLS["port"] == s["freeze_dispatches"] > 0
    register_both("uniform_host_only", device=False)
    CALLS["port"] = 0
    s = _serve("uniform_host_only@16")
    assert s["freeze_installs"] > 0 and s["host_page_solves"] > 0
    assert CALLS["port"] == 0
