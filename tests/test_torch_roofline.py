"""The port's roofline and step accounting (``repro_torch.analysis.roofline``
and ``analysis.hlo``) against the reference's ``repro.analysis.roofline``
and against closed forms.

Tolerances: none. The analytic counts are integer arithmetic, equal to
the reference's on every full config and cell; the roofline's terms at
the reference's v5e rates equal its terms; the accounting of a product
is exactly 2·m·n·k FLOPs a device, its collectives' bytes exactly their
operands'. The param-count band is the reference's own
(``tests/test_analysis.py:66``).
"""
import contextlib

import pytest
import torch

from repro.analysis.roofline import Roofline as JaxRoofline
from repro.analysis.roofline import model_flops as jax_model_flops
from repro.analysis.roofline import \
    model_params_active as jax_model_params_active
from repro.configs import get_config as jax_get_config
from repro_torch import device, models
from repro_torch.analysis.hlo import accounting
from repro_torch.analysis.roofline import (Roofline, model_flops,
                                           model_params_active)
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.train.step import SHAPES
from repro_torch.tree import leaves

torch.set_num_threads(1)

V5E = dict(peak_bf16=197e12, peak_f32=197e12, hbm_bw=819e9, link_bw=50e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert model_params_active(cfg) == jax_model_params_active(jcfg)
    for shape, info in SHAPES.items():
        args = (info["kind"], info["batch"], info["seq"])
        assert model_flops(cfg, *args) == jax_model_flops(jcfg, *args), shape


@pytest.mark.parametrize("terms", [
    dict(flops=197e12, hbm_bytes=819e9 / 2, collective_bytes=0,
         model_flops_per_device=197e12 * 0.75),
    dict(flops=3e12, hbm_bytes=5e12, collective_bytes=4e10,
         model_flops_per_device=1e12),
    dict(flops=1e9, hbm_bytes=1e6, collective_bytes=7e11),
])
def test_roofline_terms_equal_the_reference_at_its_rates(terms):
    got, ref = Roofline(**terms, **V5E), JaxRoofline(**terms)
    for k in ("t_compute", "t_memory", "t_collective", "dominant",
              "step_time_lower_bound", "roofline_fraction",
              "useful_flops_ratio"):
        assert getattr(got, k) == getattr(ref, k), k
    d, rd = got.as_dict(), ref.as_dict()
    assert set(rd) <= set(d)
    assert {k: d[k] for k in rd} == rd
    assert d["flops_f32_per_device"] == 0.0


def test_roofline_prices_f32_at_its_own_rate_and_defaults_to_the_h100():
    r = Roofline(flops=989e12 + 67e12, flops_f32=67e12, hbm_bytes=3.35e12,
                 collective_bytes=450e9 * 3)
    assert (r.peak_bf16, r.peak_f32, r.hbm_bw, r.link_bw) == (
        device.BF16_FLOPS, device.F32_FLOPS, device.HBM_BYTES_PER_S,
        device.LINK_BYTES_PER_S)
    assert r.t_compute == pytest.approx(2.0, rel=1e-12)
    assert r.t_memory == pytest.approx(1.0, rel=1e-12)
    assert r.t_collective == pytest.approx(3.0, rel=1e-12)
    assert r.dominant == "collective"
    assert r.roofline_fraction == pytest.approx(2 / 3, rel=1e-12)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "granite_moe_3b_a800m",
                                  "rwkv6_3b", "jamba_1_5_large_398b"])
def test_analytic_param_count_matches_the_ports_init(arch):
    """The reference's band (test_analysis.py:66) on the port's params."""
    cfg = get_reduced_config(arch)
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.device("meta"))
    actual = sum(t.numel() for t in leaves(params))
    total, active = model_params_active(cfg)
    assert active <= total
    assert 0.65 * actual < total < 1.25 * actual, (total, actual)


# ---------------------------------------------------------- the accounting


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accounting_of_a_plain_matmul(dtype):
    m, k, n = 48, 80, 24
    a, b = torch.ones(m, k, dtype=dtype), torch.ones(k, n, dtype=dtype)
    with accounting(a, b) as acc:
        out = a @ b
    st = acc.stats()
    assert out.shape == (m, n)
    assert st["flops"] == 2 * m * n * k
    assert st["flops_f32"] == (2 * m * n * k if dtype == torch.float32
                               else 0)
    e = a.element_size()
    assert st["hbm_bytes"] == (m * k + k * n + m * n) * e
    assert st["collective_bytes"] == 0 and st["per_collective"] == {}
    assert st["held_bytes"] == (m * k + k * n) * e
    assert st["peak_bytes"] == (m * k + k * n + m * n) * e


def test_accounting_splits_f32_from_bf16_and_skips_views():
    a32, a16 = torch.ones(16, 32), torch.ones(16, 32, dtype=torch.bfloat16)
    with accounting() as acc:
        a32 @ a32.t()                   # f32: 2*16*16*32; .t() a view
        (a16.t() @ a16).float()         # bf16 2*32*32*16, then a cast
        a32.reshape(32, 16)
    st = acc.stats()
    assert st["flops_f32"] == 2 * 16 * 16 * 32
    assert st["flops"] == 2 * 16 * 16 * 32 + 2 * 32 * 32 * 16
    # mm f32: 2 inputs of 2 KiB + 1 KiB out; mm bf16: 2 x 1 KiB in, 2 KiB
    # out; the cast 2 KiB in, 4 KiB out; the views nothing
    assert st["hbm_bytes"] == (2048 * 2 + 1024) + (1024 * 2 + 2048) + (
        2048 + 4096)


@contextlib.contextmanager
def _fake_group(n):
    import torch.distributed as dist

    from repro_torch.launch.mesh import join_fake

    join_fake(n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_accounting_of_a_dtensor_matmul_is_per_device():
    """A (4096, 4096) @ (4096, 4096) product on a fake 16 x 16 mesh: each
    device multiplies its (256, 256) block of a by b's (256, 4096) rows,
    2·256·256·4096 FLOPs, not the global 2·4096³; the all-reduce of the
    partial sums moves exactly its operand's bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    with _fake_group(256):
        mesh = make_production_mesh()
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(4096, 4096), mesh,
                                  (Shard(0), Shard(1)), src_data_rank=None)
            b = distribute_tensor(torch.empty(4096, 4096), mesh,
                                  (Replicate(), Shard(0)),
                                  src_data_rank=None)
            with accounting(a, b) as acc:
                c = a @ b                    # (Shard(0), Partial)
                c.redistribute(mesh, (Shard(0), Replicate()))
        st = acc.stats()
    assert st["flops"] == st["flops_f32"] == 2 * 256 * 256 * 4096
    # the all-reduce of the (256, 4096) f32 partial block
    assert st["per_collective"] == {"all-reduce": 256 * 4096 * 4}
    assert st["collective_bytes"] == 256 * 4096 * 4
    assert st["held_bytes"] == (256 * 256 + 256 * 4096) * 4


def test_accounting_counts_the_bf16_collectives_of_a_gather():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    with _fake_group(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        with FakeTensorMode():
            w = distribute_tensor(torch.empty(1024, 2048,
                                              dtype=torch.bfloat16), mesh,
                                  (Replicate(), Shard(0), Shard(1)),
                                  src_data_rank=None)
            with accounting() as acc:
                w.redistribute(mesh, (Replicate(),) * 3)
        st = acc.stats()
    # two gathers: the (64, 128) block over model, then (64, 2048) over
    # data
    assert st["per_collective"] == {"all-gather": (64 * 128 + 64 * 2048) * 2}
    assert st["flops"] == 0


def test_production_mesh_needs_its_group():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="join_fake\\(256\\)"):
        make_production_mesh()
    with _fake_group(256):
        with pytest.raises(RuntimeError, match="join_fake\\(512\\)"):
            make_production_mesh(multi_pod=True)
        assert make_production_mesh().shape == (16, 16)
