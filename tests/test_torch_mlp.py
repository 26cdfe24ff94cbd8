"""The paper's MLP (``models/mlp.py``) and quantization-aware training
(``quant/qat.py``) against the reference, and the port's §4.1 loops
(``models/mlp.py``'s ``train_paper_mlp`` and ``qat_recover``, which
``chip_smoke.py``'s phase train (d) and
``examples/torch_train_quantized_mlp.py`` run) against the reference's
(``benchmarks/common.py``'s ``train_paper_mlp`` and
``examples/train_quantized_mlp.py``'s QAT), on the reference's own
initial weights.

Tolerances (f32): the logits at 1e-5 (atol and rtol; sums of up to 784
products in another order: one element of 5,120 reads 1.2e-6) and the
loss at 1e-6 relative; 50 SGD steps and 50 QAT steps by relative norm of the
params at 1e-5 (each step's grads differ by summation order; the readings
are ~1e-7 to 1e-6); accuracy equal. ``fake_quant`` is bitwise the
reference's, ties included, with the identity gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import synthetic_mnist as ref_synthetic_mnist
from benchmarks.common import train_paper_mlp as ref_train_paper_mlp
from repro.models import mlp as jmlp
from repro.quant.qat import fake_quant as jax_fake_quant
from repro.quant.qat import qat_params as jax_qat_params
from repro_torch.models import mlp, mlp_params_from_reference
from repro_torch.models.mlp import (qat_recover, synthetic_mnist,
                                    train_paper_mlp)
from repro_torch.quant.qat import fake_quant, qat_params

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

FWD_TOL = 1e-5
LOSS_RTOL = 1e-6
TRAIN_RTOL = 1e-5
N_STEPS = 50


def _rel_params(a, b) -> float:
    fa = np.concatenate([np.ravel(layer[k].detach().numpy()) for layer in a
                         for k in ("w", "b")]).astype(np.float64)
    fb = np.concatenate([np.ravel(np.asarray(layer[k])) for layer in b
                         for k in ("w", "b")]).astype(np.float64)
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = ref_synthetic_mnist(seed=0)
    return xtr, ytr, xte, yte


def test_synthetic_mnist_is_the_reference(data):
    (xtr, ytr), (xte, yte) = synthetic_mnist(seed=0)
    for a, b in zip((xtr, ytr, xte, yte), data):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mlp_forward_loss_accuracy_match_reference(data):
    xtr, ytr = data[:2]
    jp = jmlp.init_mlp(jax.random.PRNGKey(3))
    p = mlp_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    assert [tuple(layer["w"].shape) for layer in p] == [
        (a, b) for a, b in zip(mlp.PAPER_SIZES[:-1], mlp.PAPER_SIZES[1:])]
    x, y = torch.from_numpy(xtr[:512]), torch.from_numpy(ytr[:512])
    np.testing.assert_allclose(
        mlp.mlp_apply(p, x).numpy(),
        np.asarray(jmlp.mlp_apply(jp, jnp.asarray(xtr[:512]))),
        rtol=FWD_TOL, atol=FWD_TOL)
    ref = float(jmlp.mlp_loss(jp, jnp.asarray(xtr[:512]),
                              jnp.asarray(ytr[:512])))
    assert abs(float(mlp.mlp_loss(p, x, y)) / ref - 1) <= LOSS_RTOL
    assert float(mlp.mlp_accuracy(p, x, y)) == float(jmlp.mlp_accuracy(
        jp, jnp.asarray(xtr[:512]), jnp.asarray(ytr[:512])))


def test_init_mlp_is_he_normal_with_zero_biases():
    p = mlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    for layer, a in zip(p, mlp.PAPER_SIZES[:-1]):
        assert layer["w"].dtype == torch.float32
        assert abs(float(layer["w"].std()) / np.sqrt(2.0 / a) - 1) < 0.05
        assert not layer["b"].any()


def test_sgd_steps_match_reference(data):
    """``train_paper_mlp``'s loop, 50 steps from the reference's init."""
    xtr, ytr, xte, yte = data
    jp, _, _, _, acc_te = ref_train_paper_mlp(steps=N_STEPS, seed=0)
    p0 = mlp_params_from_reference(
        jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(0))),
        "cpu")
    p = train_paper_mlp(p0, torch.from_numpy(xtr), torch.from_numpy(ytr),
                        steps=N_STEPS)
    assert _rel_params(p, jp) <= TRAIN_RTOL
    assert float(mlp.mlp_accuracy(p, torch.from_numpy(xte),
                                  torch.from_numpy(yte))) == acc_te


def test_qat_steps_match_reference(data):
    """``examples/train_quantized_mlp.py``'s QAT loop on one codebook,
    50 steps, from the same trained weights."""
    xtr, ytr, xte, yte = data
    jp = ref_train_paper_mlp(steps=20, seed=0)[0]
    w = np.asarray(jp[-1]["w"])
    cb = np.quantile(w, np.linspace(0.05, 0.95, 8)).astype(np.float32)
    jcb = jnp.asarray(cb)
    xj, yj = jnp.asarray(xtr), jnp.asarray(ytr)

    def qat_loss(p, x, y):
        pq = [dict(layer) for layer in p]
        pq[-1]["w"] = jax_fake_quant(pq[-1]["w"], jcb)
        return jmlp.mlp_loss(pq, x, y)

    @jax.jit
    def step(p, i):
        idx = (jnp.arange(256) + i * 256) % xj.shape[0]
        g = jax.grad(qat_loss)(p, xj[idx], yj[idx])
        return jax.tree.map(lambda a, b: a - 3e-3 * b, p, g), None

    ref, _ = jax.lax.scan(step, [dict(layer) for layer in jp],
                          jnp.arange(N_STEPS))
    ref[-1]["w"] = jax_fake_quant(ref[-1]["w"], jcb)
    got = qat_recover(mlp_params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu"), torch.from_numpy(cb),
        torch.from_numpy(xtr), torch.from_numpy(ytr), steps=N_STEPS)
    assert _rel_params(got, ref) <= TRAIN_RTOL
    assert float(mlp.mlp_accuracy(got, torch.from_numpy(xte),
                                  torch.from_numpy(yte))) == float(
        jmlp.mlp_accuracy(ref, jnp.asarray(xte), jnp.asarray(yte)))


def test_fake_quant_bitwise_with_identity_gradient():
    r = np.random.default_rng(0)
    cb = r.normal(size=7).astype(np.float32)          # unsorted
    s = np.sort(cb)
    mids = (0.5 * (s[1:] + s[:-1])).astype(np.float32)
    x = np.concatenate([r.normal(size=(66,)) * 2, mids, s,
                        [-100.0, 100.0]]).astype(np.float32).reshape(9, 9)
    ref = np.asarray(jax_fake_quant(jnp.asarray(x), jnp.asarray(cb)))
    xt = torch.from_numpy(x).requires_grad_()
    got = fake_quant(xt, torch.from_numpy(cb))
    assert np.array_equal(got.detach().numpy(), ref)
    # a tie at a midpoint snaps to the lower value (left searchsorted)
    at_mid = fake_quant(torch.from_numpy(mids), torch.from_numpy(cb))
    assert np.array_equal(at_mid.numpy(), s[:-1])
    up = torch.from_numpy(r.normal(size=(9, 9)).astype(np.float32))
    (g,) = torch.autograd.grad((got * up).sum(), xt)
    assert torch.equal(g, up)


def test_qat_params_by_path_as_the_reference():
    r = np.random.default_rng(1)
    tree = [{"w": r.normal(size=(4, 3)).astype(np.float32),
             "b": r.normal(size=(3,)).astype(np.float32)}
            for _ in range(2)]
    cb = np.array([-0.5, 0.0, 0.5], np.float32)
    ref = jax_qat_params(jax.tree.map(jnp.asarray, tree),
                         {"[1]/w": jnp.asarray(cb)})
    got = qat_params(mlp_params_from_reference(tree, "cpu"),
                     {"1/w": torch.from_numpy(cb)})
    for layer_got, layer_ref in zip(got, ref):
        for k in ("w", "b"):
            assert np.array_equal(layer_got[k].numpy(),
                                  np.asarray(layer_ref[k])), k
    assert not np.array_equal(got[1]["w"].numpy(), tree[1]["w"])
    assert np.array_equal(got[0]["w"].numpy(), tree[0]["w"])
