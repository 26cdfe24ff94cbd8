"""The dry run (``repro_torch.launch.dryrun``, ``launch.mesh``'s
``make_production_mesh`` and ``join_fake``) against the reference's
``repro.launch.dryrun`` placements, and two production cells end to end.

The reference's per-device shard shapes come from a child process that
sets ``XLA_FLAGS=--xla_force_host_platform_device_count=512`` before jax
starts (this worker's jax may hold 8 devices); the port's are the local
blocks of fake DTensors on a fake group of 256 or 512 ranks, in this
process. Tolerances: none; the shapes are equal leaf for leaf.

The cells run ``python -m repro_torch.launch.dryrun`` in child processes
that cannot import jax or the reference package: qwen3-0.6B's
``decode_32k`` on 2 x 16 x 16 (the reference's own dry-run test cell,
``tests/test_optim_data.py:86``, with the pod axis) and ``train_4k`` on
16 x 16 (forward, backward and AdamW). Both need the heads of a
projection to be split on a model axis wider than qwen3's 8 kv heads.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import _fake
from repro_torch.launch.mesh import join_fake, make_production_mesh
from repro_torch.runtime.sharding import (cache_shardings, distribute,
                                          param_shardings)
from repro_torch.train.step import SHAPES, cache_specs
from repro_torch.tree import items

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3_0_6b", "granite_moe_3b_a800m")
CACHE_SHAPES = ("decode_32k", "prefill_32k")

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    from repro import models
    from repro.configs import get_config
    from repro.launch.mesh import make_production_mesh
    from repro.runtime.sharding import cache_shardings, param_shardings
    from repro.train.step import SHAPES, cache_specs

    def flat(tree, shard):
        out = {}
        for (path, v), s in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree.leaves(shard)):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[key] = list(s.shard_shape(v.shape))
        return out

    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch)
        p = jax.eval_shape(lambda: models.init_params(cfg,
                                                      jax.random.PRNGKey(0)))
        for mp in (False, True):
            mesh = make_production_mesh(multi_pod=mp)
            out[f"{arch}/{mp}/params"] = flat(p, param_shardings(mesh, p))
            for shape in sys.argv[2].split(","):
                c = cache_specs(cfg, shape)
                out[f"{arch}/{mp}/{shape}"] = flat(c, cache_shardings(
                    mesh, cfg, c, batch_size=SHAPES[shape]["batch"]))
    json.dump(out, open(sys.argv[3], "w"))
""")

_BLOCKED = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "from repro_torch.launch.dryrun import main; "
            "sys.exit(main(sys.argv[1:]))")

# decode_32k also writes its op listing (``--save-hlo``)
CELLS = {"decode_32k.pod2x16x16": ["--shape", "decode_32k", "--multi-pod",
                                   "--save-hlo"],
         "train_4k.pod16x16": ["--shape", "train_4k"]}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The two cells, each in its own child process, run together."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _BLOCKED, "--arch", "qwen3_0_6b", "--out",
         str(d), *args], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in CELLS.items()}
    out = {"dir": d}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        path = d / f"qwen3_0_6b.{name}.json"
        out[name] = (p.returncode, stdout + stderr[-3000:],
                     json.loads(path.read_text()) if path.exists() else {})
    return out


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_shards")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run(
        [sys.executable, "-c", _REFERENCE, ",".join(ARCHS),
         ",".join(CACHE_SHAPES), str(d / "out.json")], env=env,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads((d / "out.json").read_text())


def _ref_key(path: str) -> tuple:
    """A port path -> (the reference's path, whether it is stacked): layer
    i of the port's list is a slice of the reference's ``groups/l0``
    stack (qwen3's and granite's groups hold one layer, no head
    layers)."""
    parts = path.split("/")
    if parts[0] == "layers":
        return "/".join(["groups", "l0", *parts[2:]]), True
    if parts[0].isdigit():                       # a cache layer
        return "/".join(["groups", "l0", *parts[1:]]), True
    return path, False


def _local_shapes(tree, shardings, mesh) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        placed = distribute(_fake(tree), mesh, shardings)
        return {k: list(v._local_tensor.shape) for k, v in items(placed)}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_equal_the_reference(reference_shards, arch,
                                          multi_pod):
    import torch.distributed as dist

    cfg = get_config(arch)
    join_fake(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        params = models.init_params(cfg, torch.Generator(),
                                    torch.device("meta"))
        trees = {"params": _local_shapes(
            params, param_shardings(mesh, params), mesh)}
        for shape in CACHE_SHAPES:
            cache = cache_specs(cfg, shape)
            trees[shape] = _local_shapes(cache, cache_shardings(
                mesh, cfg, cache, batch_size=SHAPES[shape]["batch"]), mesh)
    finally:
        dist.destroy_process_group()
    for name, got in trees.items():
        ref = reference_shards[f"{arch}/{multi_pod}/{name}"]
        seen = set()
        for path, shape in got.items():
            key, stacked = _ref_key(path)
            want = ref[key][1:] if stacked else ref[key]
            assert shape == want, (name, path, shape, want)
            seen.add(key)
        assert seen == set(ref), (name, set(ref) ^ seen)


def test_save_hlo_writes_the_op_listing_whose_sums_are_the_cells(cells):
    """``--save-hlo`` (the reference's flag; the port has no HLO) writes
    one JSON line per counted op beside the cell's JSON: the columns sum
    to the cell's ``hlo`` totals exactly and the lines are its
    ``n_ops``. Without the flag no listing is written."""
    import gzip

    rc, log, cell = cells["decode_32k.pod2x16x16"]
    assert rc == 0, log
    path = cells["dir"] / "qwen3_0_6b.decode_32k.pod2x16x16.ops.gz"
    assert f"op listing -> {path}" in log
    with gzip.open(path, "rt") as f:
        rows = [json.loads(line) for line in f]
    h = cell["hlo"]
    assert len(rows) == h["n_ops"]
    for k in ("flops", "flops_f32", "hbm_bytes", "collective_bytes"):
        assert sum(r[k] for r in rows) == h[k], k
    kinds = {}
    for r in rows:
        assert set(r) == {"op", "operands", "flops", "flops_f32",
                          "hbm_bytes", "collective", "collective_bytes"}
        if r["collective"] is None:
            assert r["collective_bytes"] == 0
        else:
            assert "c10d" in r["op"]
            kinds[r["collective"]] = (kinds.get(r["collective"], 0)
                                      + r["collective_bytes"])
    assert kinds == h["per_collective"]
    assert any(r["op"].startswith("aten::") and r["flops"] for r in rows)
    assert all(isinstance(o, str) and "[" in o for r in rows
               for o in r["operands"])
    assert not (cells["dir"]
                / "qwen3_0_6b.train_4k.pod16x16.ops.gz").exists()


@pytest.mark.parametrize("name", list(CELLS))
def test_production_cell_runs_without_jax(cells, name):
    rc, log, cell = cells[name]
    assert rc == 0, log
    assert "[dryrun] OK" in log
    multi_pod = name.endswith("pod2x16x16")
    assert cell["status"] == "ok" and cell["n_devices"] == (
        512 if multi_pod else 256)
    cfg = get_config("qwen3_0_6b")
    from repro_torch.analysis.roofline import model_params_active

    assert (cell["params_total"], cell["params_active"]) == \
        model_params_active(cfg)
    h, rl = cell["hlo"], cell["roofline"]
    assert h["flops"] > 0 and 0 <= h["flops_f32"] <= h["flops"]
    assert h["hbm_bytes"] > 0 and h["collective_bytes"] > 0
    assert h["collective_bytes"] == pytest.approx(
        sum(h["per_collective"].values()))
    assert rl["flops_per_device"] == h["flops"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    mem = cell["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_estimate"]
    info = SHAPES[name.split(".")[0]]
    # the model's FLOPs a device are at most what the device counts (the
    # counts hold remat, attention and redundant work besides)
    assert rl["model_flops_per_device"] == pytest.approx(
        (6 if info["kind"] == "train" else 2) * model_params_active(cfg)[1]
        * info["batch"] * (info["seq"] if info["kind"] == "train" else 1)
        / cell["n_devices"])
    assert rl["model_flops_per_device"] <= h["flops"]
    for k in ("t_compile_s", "cost_analysis"):
        assert k not in cell
    assert "while_trips" not in h


def test_one_device_step_count_holds_the_model_flops():
    """``train_step_counts`` on the reduced qwen3 (f32): every FLOP has
    f32 operands, at least the model's 6·N·D, and the roofline prices
    them at the f32 rate; no collective on one device."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from repro_torch.launch.dryrun import train_step_counts

    cfg = get_reduced_config("qwen3_0_6b")
    st, rl = train_step_counts(cfg, 2, 16)
    assert st["flops"] == st["flops_f32"] >= rl.model_flops_per_device > 0
    assert st["collective_bytes"] == 0 and st["per_collective"] == {}
    assert rl.t_compute == pytest.approx(st["flops"] / F32_FLOPS)
    assert rl.t_memory == pytest.approx(st["hbm_bytes"] / HBM_BYTES_PER_S)
    assert st["held_bytes"] < st["peak_bytes"]
