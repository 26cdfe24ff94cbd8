"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the reduced granite (10 experts, top-4) and
deepseek (8 experts, top-3, 2 shared) configs, on the reference's own
parameters and seeded numpy inputs, f32.

Tolerance: atol/rtol 1e-4 on outputs (both run the same f32 math;
summation order moves them by ~1e-7). The dispatch plan is integer and
held exactly: the same (token, k) assignments drop at the default
capacity factor 1.25. Router logits are f32 from random weights, so
``jax.lax.top_k`` and ``torch.topk`` meet no ties here; the tests hold
the chosen experts equal, which a tie would break.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced_config
from repro_torch.models import moe
from repro_torch.models.convert import _tree

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
ARCHS = ["granite_moe_3b_a800m", "deepseek_v2_lite_16b"]
# the reference's functions jitted (one compile a shape instead of an
# eager dispatch an op)
_ref_moe = jax.jit(jmoe.moe_ffn, static_argnums=1)


def _params(arch):
    jcfg, cfg = jax_reduced_config(arch), get_reduced_config(arch)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3), jnp.float32)
    return jcfg, jp, cfg, _tree(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@jax.jit
def _ref_top(router, x):
    return jax.nn.softmax(jnp.einsum("bsd,de->bse", x, router), axis=-1)


def _ref_keep(jcfg, jp, x):
    """The reference's (B, S*K) kept-assignment mask and expert ids (its
    moe_ffn's router and dispatch steps)."""
    B, S, _ = x.shape
    E, K = jcfg.n_experts, jcfg.top_k
    _, top_i = jax.lax.top_k(_ref_top(jp["router"], jnp.asarray(x)), K)
    C = int(np.ceil(jcfg.capacity_factor * S * K / E))
    flat = top_i.reshape(B, S * K)
    _, _, pos = jax.jit(jax.vmap(lambda fe: jmoe._row_dispatch(fe, E, C)))(
        flat)
    return np.asarray(pos < C), np.asarray(flat)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 16), (3, 7), (1, 1)])
def test_moe_ffn_matches_reference_and_drops_the_same_assignments(arch, B,
                                                                  S):
    """Default capacity (1.25): outputs within 1e-4 and the same dropped
    (token, k) assignments; the 16-token rows do drop some."""
    jcfg, jp, cfg, p = _params(arch)
    x = _x(cfg, B, S)
    ref = np.asarray(_ref_moe(jp, jcfg, jnp.asarray(x)))
    got = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    want_keep, want_e = _ref_keep(jcfg, jp, x)
    _, top_i = moe.route(p, cfg, torch.from_numpy(x))
    flat = top_i.reshape(B, S * cfg.top_k)
    C = moe.capacity(cfg, S)
    _, _, pos = moe._row_dispatch(flat, cfg.n_experts, C)
    np.testing.assert_array_equal(flat.numpy(), want_e)
    np.testing.assert_array_equal((pos < C).numpy(), want_keep)
    if S == 16:
        assert not want_keep.all(), "the default capacity drops nothing"


# hand-made expert ids (E experts, capacity C): overflow past C, experts
# nobody picked, a single expert taking every assignment, one slot each
_DISPATCH = [
    (4, 2, [0, 1, 0, 0, 3, 1, 0, 2, 3, 3, 3, 1]),
    (5, 1, [2, 2, 2, 2]),
    (3, 4, [1, 0, 2, 1, 0]),
    (6, 3, [5, 5, 0, 5, 5, 1, 5, 0]),
    (8, 1, [7, 6, 5, 4, 3, 2, 1, 0]),
]


@pytest.mark.parametrize("E,C,ids", _DISPATCH)
def test_row_dispatch_matches_reference(E, C, ids):
    """slot_tok, slot_ok and tok_pos equal the reference's exactly."""
    ref = jax.jit(jmoe._row_dispatch, static_argnums=(1, 2))(
        jnp.asarray(ids, jnp.int32), E, C)
    got = moe._row_dispatch(torch.tensor(ids), E, C)
    for r, g, name in zip(ref, got, ("slot_tok", "slot_ok", "tok_pos")):
        r = np.asarray(r)
        if name == "slot_tok":       # only valid slots name an assignment
            ok = np.asarray(ref[1])
            np.testing.assert_array_equal(g.numpy()[ok], r[ok], err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_row_dispatch_rows_are_independent():
    """The batched plan of two rows is each row's plan alone."""
    a, b = [0, 1, 0, 0, 3, 1, 0, 2], [3, 3, 3, 3, 2, 2, 1, 0]
    both = moe._row_dispatch(torch.tensor([a, b]), 4, 2)
    for i, row in enumerate((a, b)):
        alone = moe._row_dispatch(torch.tensor(row), 4, 2)
        for x, y in zip(both, alone):
            assert torch.equal(x[i], y)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_per_call_as_in_the_reference(arch):
    """A 7-token slice computed alone drops other assignments than the
    same tokens inside the 16-token call: the port reproduces the
    reference's outputs for both calls, so the chunked difference is the
    reference's own."""
    jcfg, jp, cfg, p = _params(arch)
    x = _x(cfg, 1, 16, seed=4)
    for sl in (x, x[:, 9:]):
        ref = np.asarray(_ref_moe(jp, jcfg, jnp.asarray(sl)))
        got = moe.moe_ffn(p, cfg, torch.from_numpy(np.ascontiguousarray(sl)))
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    whole = moe.moe_ffn(p, cfg, torch.from_numpy(x))[:, 9:]
    part = moe.moe_ffn(p, cfg, torch.from_numpy(np.ascontiguousarray(
        x[:, 9:])))
    assert moe.capacity(cfg, 7) < moe.capacity(cfg, 16)
    assert not torch.allclose(whole, part, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_row_alone_equals_the_row_among_eight(arch):
    """At S = 1 a row's top-k are distinct experts, C >= 1, and nothing
    drops: a row decoded alone equals the same row among 8."""
    _, _, cfg, p = _params(arch)
    x = torch.from_numpy(_x(cfg, 8, 1, seed=5))
    C = moe.capacity(cfg, 1)
    _, top_i = moe.route(p, cfg, x)
    _, _, pos = moe._row_dispatch(top_i.reshape(8, -1), cfg.n_experts, C)
    assert bool((pos < C).all())
    both = moe.moe_ffn(p, cfg, x)
    for i in (0, 5):
        torch.testing.assert_close(both[i:i + 1],
                                   moe.moe_ffn(p, cfg, x[i:i + 1]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_aux_loss_matches_reference(arch):
    jcfg, jp, cfg, p = _params(arch)
    x = _x(cfg, 2, 9, seed=6)
    ref = float(jmoe.router_aux_loss(jp, jcfg, jnp.asarray(x)))
    got = float(moe.router_aux_loss(p, cfg, torch.from_numpy(x)))
    assert got == pytest.approx(ref, rel=1e-5)


def test_router_runs_in_f32_on_bf16_activations():
    """bf16 activations route through an f32 router: the weights are f32
    and match the f32 routing of the same (bf16-rounded) inputs."""
    _, _, cfg, p = _params("granite_moe_3b_a800m")
    x = torch.from_numpy(_x(cfg, 2, 5, seed=7)).to(torch.bfloat16)
    w, i = moe.route(p, cfg, x)
    w32, i32 = moe.route(p, cfg, x.float())
    assert w.dtype == torch.float32
    assert torch.equal(i, i32) and torch.equal(w, w32)
