"""The dequant kernel's launch plan (``repro_torch.kernels.quant_matmul.
plan``), on the CPU: the kernel's row independence rests on a plan that
never sees M or G, splits K into whole steps and fills the card at
qwen3-0.6B's projection shapes. The kernel itself, and the shared memory
it lays out for a plan, run only on the card (tests/test_torch_cuda.py)."""
import importlib
import inspect
import re

import pytest
import torch

# the module (the package's ``quant_matmul`` attribute is the function)
qmm = importlib.import_module("repro_torch.kernels.quant_matmul")
plan = qmm.plan

torch.set_num_threads(1)

# qwen3-0.6B's seven projections as (K, N): q, k, v, o, gate, up, down
PROJ = [(1024, 2048), (1024, 1024), (1024, 1024), (2048, 1024),
        (1024, 3072), (1024, 3072), (3072, 1024)]
DTYPES = [(torch.bfloat16, torch.uint8), (torch.float32, torch.uint8),
          (torch.bfloat16, torch.int32), (torch.float32, torch.int32)]
SHAPES = sorted(set(PROJ)) + [(33, 17), (1000, 1024), (64, 64), (65, 64),
                              (3072, 3072), (8192, 8192), (16, 100000)]


def test_plan_takes_no_m_and_no_g():
    assert list(inspect.signature(plan).parameters) == [
        "K", "N", "L", "x_dtype", "idx_dtype"]


@pytest.mark.parametrize("x_dtype,idx_dtype", DTYPES)
@pytest.mark.parametrize("K,N", SHAPES)
def test_splits_are_whole_steps_and_cover_k(K, N, x_dtype, idx_dtype):
    L = 16 if idx_dtype == torch.uint8 else 1000
    pl = plan(K, N, L, x_dtype, idx_dtype)
    steps = -(-K // pl.bk)
    assert 1 <= pl.splits <= qmm.MAX_SPLITS and pl.cluster == (pl.splits,
                                                                1, 1)
    assert (pl.splits - 1) * pl.split_steps < steps <= (
        pl.splits * pl.split_steps)
    ranges = pl.k_ranges(K)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c and a % pl.bk == 0 and b - a == (
            pl.split_steps * pl.bk)


@pytest.mark.parametrize("K,N", SHAPES)
def test_split_is_the_same_for_every_codebook_and_dtype(K, N):
    """A weight's f32 copy (the replays) and any codebook size are split as
    its bf16 uint8 codes are: L and the dtypes only size the kernel's
    shared memory, which fits at every split."""
    want = plan(K, N, 16, torch.bfloat16, torch.uint8)
    for L in (16, 1000, 32768):
        for x_dtype, idx_dtype in DTYPES:
            if idx_dtype == torch.uint8 and L > 256:
                continue                # uint8 codes address 256 entries
            assert plan(K, N, L, x_dtype, idx_dtype) == want


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", sorted(set(PROJ)))
def test_projection_shapes_fill_the_card(K, N, x_dtype):
    """At G = 1 every projection of qwen3-0.6B launches at least 128
    blocks (one row tile)."""
    pl = plan(K, N, 16, x_dtype, torch.uint8)
    assert pl.blocks_per_row_tile >= 128


def test_plan_is_the_same_for_every_m_and_g_on_the_wrapper_path():
    """The wrapper passes the plan of the weight alone: it reads only K, N,
    L and the dtypes, so the same (K, N) weight gets one plan for M = 1
    and M = 64, flat or stacked."""
    src = inspect.getsource(qmm._launch)
    call = re.search(r"plan\(([^)]*)\)", src).group(1)
    assert [a.strip() for a in call.split(",")] == [
        "K", "N", "L", "x.dtype", "idx.dtype"]


def test_split_k_owner_product_is_the_quotient():
    """The kernel finds the rank that owns row r of a tile as
    (r * ceil(2^16 / rpr)) >> 16 instead of r / rpr: equal for every row of
    a 64-row tile and every rows-per-rank."""
    for rpr in range(1, qmm.BM + 1):
        inv = -(-65536 // rpr)
        assert [(r * inv) >> 16 for r in range(qmm.BM)] == [
            r // rpr for r in range(qmm.BM)]
