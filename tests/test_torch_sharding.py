"""The sharding rules (``runtime/sharding.py``, ``runtime/hints.py``,
``train/step.py``'s spec builders) against the reference, and the
sharded serving steps, reshard-on-load and the launcher on gloo ranks.

Specs, with no processes: every config at its full shapes (the port's
params and caches as meta tensors, the reference's by ``jax.eval_shape``),
on the meshes (2, 4), (16, 16) and (2, 16, 16) as shapes only
(``MeshShape`` and the reference's ``AbstractMesh``). Param, cache, hint,
batch and optimizer state specs equal the reference's leaf for leaf,
exactly. The port's params and caches hold a list of layers where the
reference stacks its groups: the stacked layout (``optim.stack_layers``)
is held leaf for leaf, and each layer of the list to its stacked leaf's
spec without the group entry.

On 4 gloo ranks on the CPU (one ``launch.mesh.spawn`` group, f32, the
reference's ``_small_cfg``): a prefill and 3 greedy decode steps on a
(2, 2) mesh give the one-device logits within 1e-5 of the largest
|logit| and the same tokens (qwen3, rwkv6); a sharded state saved on
(2, 2) restores bitwise onto (4, 1) and onto one device.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import models as jmodels
from repro.configs import get_config as jax_config
from repro.optim import for_config as jax_for_config
from repro.runtime import hints as jhints
from repro.runtime import sharding as jsharding
from repro.train.step import cache_specs as jax_cache_specs
from repro.train.step import input_specs as jax_input_specs
from repro.train.step import opt_state_shardings as jax_opt_state_shardings
from repro.train.step import train_state_specs as jax_train_state_specs
from repro_torch import models
from repro_torch.configs import ARCHS, get_config
from repro_torch.optim import for_config, stack_layers
from repro_torch.runtime import hints
from repro_torch.runtime.sharding import (MeshShape, batch_spec, cache_spec,
                                          hint_specs, param_spec,
                                          param_specs, placements, spec_of)
from repro_torch.train.step import (cache_specs, input_specs,
                                    opt_state_specs, train_state_specs)
from repro_torch.tree import items

import torch_dist_ranks as R

torch.set_num_threads(1)

DECODE_RTOL = 1e-5
MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CACHE_CELLS = ("decode_32k", "long_500k")    # batch 128 and batch 1


def _meshes(name):
    shape = MESHES[name]
    return (MeshShape(dict(shape)),
            AbstractMesh(tuple(shape.values()), tuple(shape)))


def _ref_spec(spec, ndim) -> tuple:
    """A reference PartitionSpec as the port's tuple, None-padded."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _ref_paths(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = get_config(arch)
    return cfg, models.init_params(cfg, torch.Generator(),
                                   torch.device("meta"))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    jcfg = jax_config(arch)
    return jcfg, _ref_paths(jax.eval_shape(
        lambda: jmodels.init_params(jcfg, jax.random.PRNGKey(0))))


def _layer_to_ref(cfg, i: int) -> str:
    """The reference's stacked path prefix of the port's layer ``i``."""
    n_head, glen = len(cfg.head_layers), len(cfg.group)
    return f"head_{i}" if i < n_head else f"groups/l{(i - n_head) % glen}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    mesh, amesh = _meshes(mesh_name)
    cfg, params = _port_params(arch)
    jcfg, ref = _ref_params(arch)
    stacked = dict(items(param_specs(mesh, stack_layers(params, cfg))))
    assert stacked.keys() == ref.keys()
    for path, leaf in ref.items():
        want = _ref_spec(jsharding.param_spec(
            amesh, [jax.tree_util.DictKey(k) for k in path.split("/")],
            leaf), leaf.ndim)
        assert stacked[path] == want, (path, stacked[path], want)
    # each layer of the port's list: its stacked leaf's spec without the
    # group entry (a head layer: the same spec)
    for path, leaf in items(params):
        spec = param_spec(mesh, path, leaf)
        parts = path.split("/")
        if parts[0] == "layers":
            ref_path = "/".join([_layer_to_ref(cfg, int(parts[1]))]
                                + parts[2:])
            want = stacked[ref_path]
            assert spec == (want[1:] if ref_path.startswith("groups")
                            else want), path
        elif parts[0] == "enc_layers":     # replicated (ROADMAP C)
            assert spec == (None,) * leaf.ndim, path
        else:
            assert spec == stacked[path], path
        assert len(spec) == leaf.ndim


def _cache_ref_path(cfg, path: str) -> str:
    """The port's cache path -> the reference's stacked path."""
    parts = path.split("/")
    if parts[0] == "cross":
        return "/".join(["cross", "l0"] + parts[2:])
    if parts[0] == "self":
        parts = parts[1:]
    return "/".join([_layer_to_ref(cfg, int(parts[0]))] + parts[1:])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    mesh, amesh = _meshes(mesh_name)
    cfg = get_config(arch)
    jcfg = jax_config(arch)
    for cell in CACHE_CELLS:
        B = 128 if cell == "decode_32k" else 1
        ref = _ref_paths(jax_cache_specs(jcfg, cell))
        ref_specs = {p: _ref_spec(jsharding.cache_spec(
            amesh, jcfg, [jax.tree_util.DictKey(k) for k in p.split("/")],
            leaf, batch_size=B), leaf.ndim) for p, leaf in ref.items()}
        seen = set()
        for path, leaf in items(cache_specs(cfg, cell)):
            rp = _cache_ref_path(cfg, path)
            seen.add(rp)
            want = ref_specs[rp]
            stacked = rp.startswith(("groups", "cross"))
            got = cache_spec(mesh, cfg, path, leaf, batch_size=B)
            assert got == (want[1:] if stacked else want), (cell, path)
            assert tuple(leaf.shape) == tuple(
                ref[rp].shape[1:] if stacked else ref[rp].shape), path
        assert seen == set(ref), cell
        # the reference's stacked layout itself, through the port's rule
        for rp, leaf in ref.items():
            meta = torch.empty(leaf.shape, device="meta")
            assert cache_spec(mesh, cfg, rp, meta, batch_size=B) == \
                ref_specs[rp], rp


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_hint_and_batch_specs_equal_the_reference(arch, mesh_name):
    mesh, amesh = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jax_config(arch)
    ref = jsharding.hint_specs(jcfg, amesh)
    mine = hint_specs(cfg, mesh)
    assert mine.keys() == ref.keys()
    for kind, spec in ref.items():
        assert mine[kind] == tuple(spec), kind
    assert hints.PAD_OK_KINDS == jhints.PAD_OK_KINDS
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        jspecs = jax_input_specs(jcfg, cell)
        ref_b = jsharding.batch_shardings(amesh, jspecs)
        specs = input_specs(cfg, cell)
        assert specs.keys() == jspecs.keys()
        for name, (shape, _) in specs.items():
            assert tuple(shape) == jspecs[name].shape
            assert batch_spec(mesh, name, shape) == _ref_spec(
                ref_b[name].spec, len(shape)), (cell, name)


@functools.lru_cache(maxsize=None)
def _ref_state_shapes(arch):
    """The reference's params and optimizer state as shapes (its
    ``train_state_specs``, once an arch: the shapes hold on any mesh;
    each mesh's shardings come from the same two calls it makes)."""
    jcfg = jax_config(arch)
    shape, _ = jax_train_state_specs(
        jcfg, AbstractMesh((1, 1), ("data", "model")), jax_for_config(jcfg))
    return shape["params"], shape["opt"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_equal_the_reference(arch, mesh_name):
    """Params and the optimizer state (AdamW's m/v, Adafactor's factored
    vr/vc on the stacked layout), through the placements and back."""
    mesh, amesh = _meshes(mesh_name)
    cfg = get_config(arch)
    opt = for_config(cfg)
    p_shape, o_shape = _ref_state_shapes(arch)
    jshard = jax_opt_state_shardings(
        amesh, jsharding.param_shardings(amesh, p_shape), o_shape)
    state, shard = train_state_specs(cfg, mesh, opt)
    ref = {p: _ref_spec(s.spec, leaf.ndim) for (p, s), (_, leaf) in zip(
        _ref_paths(jshard).items(), _ref_paths(o_shape).items())}
    mine = dict(items(shard["opt"]))
    assert mine.keys() == ref.keys()
    for path, leaf in items(state["opt"]):
        got = spec_of(mesh, mine[path], leaf.ndim)
        assert got == ref[path], (path, got, ref[path])
        assert tuple(leaf.shape) == tuple(_ref_paths(o_shape)[path]
                                          .shape), path
    # the same specs straight from the rule, without placements
    pspec = param_specs(mesh, stack_layers(state["params"], cfg))
    direct = dict(items(opt_state_specs(mesh, pspec, state["opt"])))
    for path, leaf in items(state["opt"]):
        assert direct[path] + (None,) * (leaf.ndim - len(direct[path])) \
            == ref[path], path
    for path, leaf in items(state["params"]):
        assert spec_of(mesh, dict(items(shard["params"]))[path],
                       leaf.ndim) == param_spec(mesh, path, leaf), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fit_replicates_what_the_axis_does_not_divide(mesh_name):
    """glm4's 2 kv heads, granite's 40 experts and rwkv's 40 heads on a
    model axis they do not divide."""
    mesh, _ = _meshes(mesh_name)
    msize = MESHES[mesh_name]["model"]
    glm = get_config("glm4_9b")
    assert glm.n_kv_heads == 2
    k = torch.empty((128, 1024, glm.n_kv_heads, glm.head_dim), device="meta")
    spec = cache_spec(mesh, glm, "0/k", k, batch_size=128)
    kv = hint_specs(glm, mesh)["kv"]
    if 2 % msize:
        assert spec[2] is None and spec[1] == "model"
        assert kv[2] is None
    gcfg, gp = _port_params("granite_moe_3b_a800m")
    w = gp["layers"][0]["ffn"]["w_gate"]
    assert w.shape[0] == gcfg.n_experts == 40
    assert param_spec(mesh, "layers/0/ffn/w_gate", w)[0] == (
        "model" if 40 % msize == 0 else None)
    rw = get_config("rwkv6_3b")
    H = rw.d_model // rw.rwkv_head_dim
    assert H == 40
    s = torch.empty((128, H, rw.rwkv_head_dim, rw.rwkv_head_dim),
                    device="meta")
    assert cache_spec(mesh, rw, "0/s", s, batch_size=128)[1] == (
        "model" if H % msize == 0 else None)


def test_placements_round_trip_to_the_spec():
    """Every spec the rules give, on each mesh: ``placements`` and back,
    a dim over two axes included (data-major, as the reference's)."""
    for name in MESHES:
        mesh, _ = _meshes(name)
        for arch in ARCHS:
            cfg, params = _port_params(arch)
            specs = [param_spec(mesh, p, leaf) for p, leaf in
                     items(stack_layers(params, cfg))]
            specs += [s for s in hint_specs(cfg, mesh).values()]
            specs += [cache_spec(mesh, cfg, p, leaf, batch_size=1)
                      for p, leaf in items(cache_specs(cfg, "long_500k"))]
            for spec in specs:
                pl = placements(mesh, spec)
                assert len(pl) == len(MESHES[name])
                assert spec_of(mesh, pl, len(spec)) == spec, (arch, spec)
    two = placements(MeshShape({"data": 2, "model": 4}),
                     (("data", "model"), None))
    assert [p.dim for p in two] == [0, 0]


def test_hint_is_a_no_op_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert hints.hint(x, "hidden") is x
    assert hints.model_axis_size() == 1 and hints.current_mesh() is None
    mesh = MeshShape({"data": 2, "model": 4})
    with hints.hint_context(mesh, hint_specs(get_config("qwen3_0_6b"),
                                             mesh)):
        assert hints.model_axis_size() == 4
        assert hints.current_mesh() is mesh
        assert hints.hint(x, "hidden") is x      # a plain tensor passes
    assert hints.current_mesh() is None


# ----------------------------------------------------------- gloo ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The decode and reshard rank results, from one group of 4 ranks."""
    ckpt_dir = str(tmp_path_factory.mktemp("reshard"))
    prompt = np.random.default_rng(3).integers(0, 512, (4, 8)).astype(
        np.int32)
    calls = []
    for arch in ("qwen3_0_6b", "rwkv6_3b"):
        cfg = R.small_cfg(arch)
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        ref_tree = {k: v.numpy() for k, v in
                    items(stack_layers(params, cfg))}
        calls.append((arch, R.decode, (arch, (2, 2),
                                        _nest(ref_tree), prompt, 3)))
    calls.append(("reshard", R.reshard, ("qwen3_0_6b", ckpt_dir, (2, 2),
                                         (4, 1))))
    from repro_torch.launch.mesh import spawn

    out = spawn(R.several, 4, calls, device="cpu", timeout=600)[0]
    out["ckpt_dir"] = ckpt_dir
    return out


def _nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "rwkv6_3b"])
def test_sharded_decode_matches_one_device(ranks, arch):
    got = ranks[arch]
    one, mesh = got["one"], got["mesh"]
    assert one.shape == mesh.shape and np.isfinite(mesh).all()
    err = np.abs(mesh - one).max() / np.abs(one).max()
    assert err <= DECODE_RTOL, err
    np.testing.assert_array_equal(mesh.argmax(-1), one.argmax(-1))
    np.testing.assert_array_equal(got["mesh_next"], got["one_next"])


def test_reshard_on_load_is_bitwise(ranks):
    """Saved on (2, 2), restored onto (4, 1) by ``restore(shardings=)``
    and onto one device by a plain ``restore``: bitwise."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.train.step import make_train_step

    got = ranks["reshard"]
    assert got["step"] == 1
    assert got["saved"].keys() == got["restored"].keys()
    for k, v in got["saved"].items():
        np.testing.assert_array_equal(got["restored"][k], v, err_msg=k)
    # on (4, 1) the embedding ("model", "data") shards its dim 1 over
    # data; the model axis, of size 1, replicates
    placed = dict(got["placements"])
    assert placed["embed"][0].is_shard(1) and placed["embed"][1].is_replicate()
    assert placed["layers/0/mixer/wq"][0].is_shard(0)
    cfg = R.small_cfg("qwen3_0_6b")
    _, opt = make_train_step(cfg)
    p = models.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    like = {"params": p, "opt": opt.init(p),
            "step": torch.zeros((), dtype=torch.int32)}
    one, at = ckpt.restore(like, ranks["ckpt_dir"])
    assert at == 1
    for k, v in items(one):
        np.testing.assert_array_equal(v.float().numpy(), got["saved"][k],
                                      err_msg=k)


def test_launcher_trains_on_a_mesh_and_resumes_at_1x1(tmp_path, capfd):
    from repro_torch.launch import train

    base = ["--reduced", "--device", "cpu", "--batch", "8", "--seq", "16",
            "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)]
    r = train.main(base + ["--steps", "2", "--data-par", "2",
                           "--model-par", "2", "--host-devices", "4"])
    out = capfd.readouterr().out
    assert "[mesh] spawning 4 ranks, backend=gloo" in out
    assert "mesh={'data': 2, 'model': 2}, steps=2" in out
    assert out.count("[train] done: loss") == 1          # rank 0 prints
    assert [m["step"] for m in r["metrics_log"]] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in r["metrics_log"])
    assert r["step"] == 2 and len(r["ranks"]) == 4
    assert all(x["metrics_log"] == r["metrics_log"] for x in r["ranks"])
    # the checkpoint written on the mesh resumes on one device
    r2 = train.main(base + ["--steps", "3"])
    assert [m["step"] for m in r2["trainer"].metrics_log] == [2]
    assert int(r2["state"]["step"]) == 3


def test_one_rank_mesh_step_is_bitwise_the_one_device_step(tmp_path):
    """A 1 x 1 DeviceMesh on a one-rank gloo group: 3 sharded steps end
    in the ``mesh=None`` steps' state bit for bit (the card's phase
    ``dist`` (a) on NCCL)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import batch_axes, make_host_mesh
    from repro_torch.runtime.sharding import distribute
    from repro_torch.train.step import distribute_batch, make_train_step

    cfg = R.small_cfg("qwen3_0_6b")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert batch_axes(mesh) == ("data",)
        res = {}
        for name, m in (("one", None), ("mesh", mesh)):
            step, opt = make_train_step(cfg, m, lr=3e-3)
            p = models.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            st = {"params": p, "opt": opt.init(p),
                  "step": torch.zeros((), dtype=torch.int32)}
            if m is not None:
                st = distribute(st, m, train_state_specs(cfg, m, opt)[1])
            r = np.random.default_rng(0)
            for _ in range(3):
                t = torch.from_numpy(r.integers(0, 512, (8, 16)).astype(
                    np.int32))
                b = {"tokens": t, "labels": t.roll(-1, 1)}
                st, _ = step(st, b if m is None else distribute_batch(b, m))
            res[name] = {k: v.full_tensor() if hasattr(v, "full_tensor")
                         else v for k, v in items(st)}
    finally:
        dist.destroy_process_group()
    assert res["one"].keys() == res["mesh"].keys()
    for k, v in res["one"].items():
        assert torch.equal(res["mesh"][k], v), k


def test_mesh_batch_rows_are_the_reference_shards():
    """On a mesh the reference draws each batch shard's token rows from
    the stream of its first row (``make_array_from_callback``); the
    port's ``next_batch(..., shards)`` is those shards in order, and
    ``batch_shards`` counts them as ``batch_spec`` places the batch."""
    from repro.configs import get_reduced_config as jax_reduced
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM

    from repro_torch.configs import get_reduced_config
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import batch_shards

    B, S = 8, 16
    ref = JaxSyntheticLM(jax_reduced("qwen3_0_6b"), B, S)
    pipe = SyntheticLM(get_reduced_config("qwen3_0_6b"), B, S)
    specs = {"tokens": ((B, S), torch.int32),
             "labels": ((B, S), torch.int32)}
    for shape, n in (({"data": 2, "model": 2}, 2),
                     ({"pod": 2, "data": 2, "model": 1}, 4),
                     ({"data": 16, "model": 16}, 1)):
        assert batch_shards(MeshShape(shape), B) == n
        for step in (0, 3):
            got = pipe.next_batch(step, specs, "cpu", n)
            rows = B // n
            tok = np.concatenate([ref._host_tokens(step, lo, lo + rows, S)
                                  for lo in range(0, B, rows)])
            np.testing.assert_array_equal(got["tokens"].numpy(), tok)
            np.testing.assert_array_equal(got["labels"].numpy(),
                                          np.roll(tok, -1, axis=1))
