"""Paged attention: the port's plain version and its wrapper on CPU tensors
against the JAX package's Pallas kernel (interpret mode) on the same
seeded inputs.

Tolerance: atol 2e-5 / rtol 1e-4 at f32, the reference's own bar for its
kernel against its oracle (tests/test_kernels.py); both sides compute the
same f32 math with sums in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pack4 as jax_pack4
from repro.kernels import paged_decode_attention as jax_paged_decode
from repro.kernels import paged_prefill_attention as jax_paged_prefill
from repro.kernels import modeled_hbm_bytes_per_token as jax_bytes_model
from repro.kernels import \
    modeled_prefill_hbm_bytes_per_token as jax_prefill_bytes_model
from repro_torch.kernels import (modeled_hbm_bytes_per_token,
                                 modeled_prefill_hbm_bytes_per_token, pack4,
                                 paged_decode_attention,
                                 paged_prefill_attention, ref_paged_decode,
                                 unpack4)

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def _state(rng, *, nb, bs, Hkv, Dh, L, quantized, packed, frozen_ids=()):
    """Pools as numpy arrays (the reference's test_kernels layout)."""
    kfp = rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32)
    vfp = rng.normal(size=(nb, bs, Hkv, Dh)).astype(np.float32)
    if quantized:
        kc = rng.integers(0, L, (nb, bs, Hkv, Dh)).astype(np.uint8)
        vc = rng.integers(0, L, (nb, bs, Hkv, Dh)).astype(np.uint8)
        if packed:
            kc = np.asarray(jax_pack4(jnp.asarray(kc)))
            vc = np.asarray(jax_pack4(jnp.asarray(vc)))
        kcb = rng.normal(size=(nb, L)).astype(np.float32)
        vcb = rng.normal(size=(nb, L)).astype(np.float32)
        blkq = np.zeros((nb,), bool)
        blkq[list(frozen_ids)] = True
    else:
        kc = vc = np.zeros((1, 1, 1, 1), np.uint8)
        kcb = vcb = np.zeros((1, 1), np.float32)
        blkq = np.zeros((1,), bool)
    return [kfp, vfp, kc, vc, kcb, vcb, blkq]


def _both(arrays):
    """(jax arrays, torch tensors) for one list of numpy arrays."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _check(out_port, out_ref):
    np.testing.assert_allclose(out_port.numpy(), np.asarray(out_ref),
                               atol=ATOL, rtol=RTOL)


CASES = [(True, True, None), (True, False, None), (False, True, None),
         (True, True, 30.0)]


@pytest.mark.parametrize("quantized,packed,softcap", CASES)
def test_decode_matches_reference_kernel(quantized, packed, softcap):
    """Mixed frozen/hot pages, per-sequence valid lengths, an idle slot on
    the null page: plain version and wrapper == the Pallas kernel."""
    rng = np.random.default_rng(0)
    nb, bs, Hkv, Dh, L, B, Hq = 7, 8, 2, 16, 16, 3, 4
    state = _state(rng, nb=nb, bs=bs, Hkv=Hkv, Dh=Dh, L=L,
                   quantized=quantized, packed=packed, frozen_ids=(1, 4, 5))
    table = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    valid = np.asarray([3 * bs, bs + 3, 1], np.int32)
    q = rng.normal(size=(B, Hq, Dh)).astype(np.float32)
    (jq, *js, jt, jv), (tq, *ts, tt, tv) = _both([q, *state, table, valid])
    ref = jax_paged_decode(jq, *js, jt, jv, softcap=softcap,
                           quantized=quantized, packed=packed,
                           interpret=True)
    kw = dict(softcap=softcap, quantized=quantized, packed=packed)
    _check(ref_paged_decode(tq, *ts, tt, tv, **kw), ref)
    _check(paged_decode_attention(tq, *ts, tt, tv, **kw), ref)


def test_window_matches_reference_kernel():
    """A W = 3 query window (causal within the window) over frozen and hot
    pages."""
    rng = np.random.default_rng(1)
    nb, bs, Hkv, Dh, L, B, Hq, W = 7, 8, 2, 16, 16, 2, 4, 3
    state = _state(rng, nb=nb, bs=bs, Hkv=Hkv, Dh=Dh, L=L, quantized=True,
                   packed=True, frozen_ids=(1, 5))
    table = np.asarray([[1, 2, 3], [5, 4, 0]], np.int32)
    valid = np.asarray([2 * bs + 5, bs + 3], np.int32)
    q = rng.normal(size=(B, W, Hq, Dh)).astype(np.float32)
    (jq, *js, jt, jv), (tq, *ts, tt, tv) = _both([q, *state, table, valid])
    ref = jax_paged_decode(jq, *js, jt, jv, quantized=True, interpret=True)
    _check(paged_decode_attention(tq, *ts, tt, tv, quantized=True), ref)


def test_prefill_chunk_matches_reference_kernel():
    """A prefill chunk of C = 5 queries at a nonzero q_offset, reading an
    earlier frozen page."""
    rng = np.random.default_rng(2)
    nb, bs, Hkv, Dh, L, Hq, C = 6, 8, 2, 16, 16, 4, 5
    state = _state(rng, nb=nb, bs=bs, Hkv=Hkv, Dh=Dh, L=L, quantized=True,
                   packed=True, frozen_ids=(2,))
    table = np.asarray([[2, 3, 4]], np.int32)
    q_off = np.asarray([11], np.int32)
    q = rng.normal(size=(1, C, Hq, Dh)).astype(np.float32)
    (jq, *js, jt, jo), (tq, *ts, tt, to) = _both([q, *state, table, q_off])
    ref = jax_paged_prefill(jq, *js, jt, jo, quantized=True, interpret=True)
    _check(paged_prefill_attention(tq, *ts, tt, to, quantized=True), ref)


def test_pages_past_valid_never_reach_the_output():
    """Poisoned pages past ceil(valid/bs) change nothing (the reference's
    skip test, run through the port's wrapper)."""
    rng = np.random.default_rng(1)
    nb, bs, Hkv, Dh, Hq = 5, 8, 2, 16, 4
    state = _state(rng, nb=nb, bs=bs, Hkv=Hkv, Dh=Dh, L=16, quantized=False,
                   packed=True)
    q = torch.from_numpy(rng.normal(size=(1, Hq, Dh)).astype(np.float32))
    valid = torch.tensor([bs + 2], dtype=torch.int32)
    ts = [torch.from_numpy(a) for a in state]
    clean = paged_decode_attention(
        q, *ts, torch.tensor([[1, 2, 3]], dtype=torch.int32), valid)
    poisoned = [t.clone() for t in ts]
    poisoned[0][4] = 1e9
    poisoned[1][4] = 1e9
    out = paged_decode_attention(
        q, *poisoned, torch.tensor([[1, 2, 4]], dtype=torch.int32), valid)
    np.testing.assert_allclose(out.numpy(), clean.numpy(), atol=1e-6)


@pytest.mark.parametrize("Dh", [2, 16, 128])
def test_pack4_bytes_match_reference(Dh):
    """Split-half nibble layout byte for byte, and unpack4 inverts it."""
    rng = np.random.default_rng(Dh)
    codes = rng.integers(0, 16, (3, 4, 2, Dh)).astype(np.uint8)
    ref = np.asarray(jax_pack4(jnp.asarray(codes)))
    got = pack4(torch.from_numpy(codes)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    assert np.array_equal(unpack4(torch.from_numpy(np.array(ref))).numpy(),
                          codes)


def test_bytes_model_matches_reference():
    """The analytic HBM bytes model is the reference's, unchanged."""
    table = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)
    lens = np.asarray([20, 9], np.int32)
    blkq = np.asarray([0, 1, 0, 0, 1, 0], bool)
    for path in ("fused", "gather"):
        kw = dict(block_size=8, n_kv_heads=2, head_dim=32, num_values=16,
                  quantized=True, packed=True, path=path, fp_bytes=2)

        assert (modeled_hbm_bytes_per_token(table, lens, blkq, **kw)
                == jax_bytes_model(table, lens, blkq, **kw))
