"""The hand-written CUDA kernel against its plain PyTorch version, at the
reduced config's shapes (Dh 32, block 8). Needs an NVIDIA GPU and nvcc:
CUDA kernels have no interpret mode, so without a card these tests skip.
Run them on the card with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py`` (this file imports no JAX).

Tolerance: atol 2e-5 / rtol 1e-4 at f32 (the reference's kernel bar).
"""
import pytest
import torch

from repro_torch.kernels import (pack4, paged_decode_attention,
                                 paged_prefill_attention, ref_paged_decode)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _pool(gen, nb=9, bs=8, Hkv=2, Dh=32, L=16):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    codes = torch.randint(0, L, (2, nb, bs, Hkv, Dh), generator=gen,
                          device="cuda", dtype=torch.uint8)
    blk_q = torch.zeros(nb, dtype=torch.bool, device="cuda")
    blk_q[[1, 4, 5]] = True
    return [rnd(nb, bs, Hkv, Dh), rnd(nb, bs, Hkv, Dh), pack4(codes[0]),
            pack4(codes[1]), rnd(nb, L), rnd(nb, L), blk_q]


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_kernel_matches_plain(gen, softcap):
    state = _pool(gen)
    table = torch.tensor([[1, 2, 3], [4, 5, 6], [0, 0, 0]], dtype=torch.int32,
                         device="cuda")
    valid = torch.tensor([24, 11, 1], dtype=torch.int32, device="cuda")
    q = torch.randn(3, 4, 32, generator=gen, device="cuda")
    kw = dict(softcap=softcap, quantized=True, packed=True)
    out = paged_decode_attention(q, *state, table, valid, **kw)
    ref = ref_paged_decode(q, *state, table, valid, **kw)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)


def test_prefill_kernel_chunks_are_bitwise_whole(gen):
    state = _pool(gen)
    table = torch.tensor([[2, 3, 4, 6]], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 30, 4, 32, generator=gen, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    whole = paged_prefill_attention(q, *state, table, zero, quantized=True)
    parts = torch.cat([paged_prefill_attention(
        q[:, o:o + 7], *state, table, zero + o, quantized=True)
        for o in range(0, 30, 7)], dim=1)
    assert torch.equal(whole, parts)
    ref = ref_paged_decode(q, *state, table, zero + 30, quantized=True)
    torch.testing.assert_close(whole, ref, atol=2e-5, rtol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    state = _pool(gen)
    q = torch.randn(1, 4, 32, generator=gen, device="cuda")
    table = torch.tensor([[1]], dtype=torch.int64, device="cuda")
    valid = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, *state, table, valid, quantized=True)
