"""Page freezing: the port's batched kmeans_ls solver against the JAX
package's ``quantize_pages_device`` on the same rows.

Codes must be equal: the DP's interval costs come from prefix sums taken
in the reference's CPU summation order, so both packages solve bitwise the
same DP, and argmin ties (rows with repeated values make many) resolve to
the first minimum in both. Codebooks within 1e-6: the LS refit's
per-cluster sums run in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize_pages_device as jax_quantize_pages
from repro_torch.core import QuantSpec
from repro_torch.kernels import quantize_pages_device
from repro_torch.kernels.page_quant import _cumsum

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)


def _rows(seed):
    """Gaussian rows (KV-like), clustered rows, and rows with only a few
    distinct values (exact DP ties), at two page sizes."""
    rng = np.random.default_rng(seed)
    gauss = rng.normal(size=(4, 512))
    centers = rng.normal(size=(2, 6)) * 3
    clustered = (centers[:, rng.integers(0, 6, 512)]
                 + rng.normal(size=(2, 512)) * 0.05)
    few = rng.integers(-3, 4, (2, 512)).astype(np.float64)
    return [np.concatenate([gauss, clustered, few]).astype(np.float32),
            rng.normal(size=(3, 1024)).astype(np.float32) * 2.0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("L", [16, 8])
def test_codes_and_codebooks_match_reference(seed, L):
    for rows in _rows(seed):
        rc, rcb = jax_quantize_pages(jnp.asarray(rows), num_values=L)
        pc, pcb = quantize_pages_device(torch.from_numpy(rows), num_values=L)
        assert pc.dtype == torch.uint8 and pcb.shape == (rows.shape[0], L)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
        np.testing.assert_allclose(pcb.numpy(), np.asarray(rcb), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("N", [5, 16, 64, 65, 300])
def test_prefix_sum_order_is_the_reference_cpu_order(N):
    x = np.random.default_rng(N).normal(size=(3, N)).astype(np.float32)
    np.testing.assert_array_equal(_cumsum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), 1)))



def test_spec_strings_match_reference():
    """kmeans_ls and kmeans specs parse and print as in the reference; any
    other method raises, naming the methods the port has."""
    from repro.core import QuantSpec as JaxSpec
    from repro_torch.core import as_spec

    for text in ("kmeans_ls@16", "kmeans_ls@8:weighted=true,seed=3",
                 "kmeans_ls@16:clip=-1.0..1.0", "kmeans@16"):
        ours = QuantSpec.parse(text)
        assert str(ours) == str(JaxSpec.parse(text)) and str(ours) == text
        assert QuantSpec.parse(str(ours)) == ours == as_spec(ours)
    assert as_spec("kmeans_ls@16", num_values=8).num_values == 8
    for bad in ("l1_ls:lam=0.02", "l0@16", "kmeans_ls"):
        with pytest.raises(ValueError, match="kmeans_ls"):
            QuantSpec.parse(bad)


def test_spec_clip_and_sorted_codebooks():
    rows = torch.from_numpy(_rows(3)[0])
    spec = QuantSpec.parse("kmeans_ls@16:clip=-1.0..1.0")
    assert QuantSpec.parse(str(spec)) == spec
    codes, cb = spec.device_solve(rows)
    assert cb.min() >= -1.0 and cb.max() <= 1.0
    assert bool((cb.diff(dim=1) >= 0).all()) and int(codes.max()) < 16
