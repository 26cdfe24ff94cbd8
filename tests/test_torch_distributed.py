"""The distribution layer on gloo ranks on the CPU (``launch/mesh.py``,
sharded ``train/step.py``, ``quant/gradcomp.py``, ``runtime/pipeline.py``,
``launch/train.py`` on a mesh) against the reference.

The reference's outputs on meshes larger than one device (its (2, 2)
train step, its ``shard_map`` gradient exchange over 2, 3 and 4 pods and its
``pipeline_forward``) come from one child process that sets
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` before jax starts
(this worker's jax may already hold one device); its 1 x 1 step runs in
this process. The port's ranks run in one ``launch.mesh.spawn`` group of
4 (``tests/torch_dist_ranks.py``, one intra-op thread each), so DTensor's
first-dispatch cost is paid once.

Tolerances (f32, those of ``tests/test_torch_train.py``): a sharded step
on (2, 2), (4, 1) and (1, 4) holds the loss within 1e-5 relative, the
params after 3 steps within 1e-5 by relative norm over the whole tree
and 1e-3 per leaf (sharding changes only the order of the sums that
cross shards); the int8 codes are bitwise the reference's and the
exchanged mean within 1e-6 relative of it, and within 0.02 of the exact
mean (the reference's own bound, ``tests/test_fault_tolerance.py:147``);
the pipeline within 1e-6 of the sequential stages.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import models
from repro_torch.launch.mesh import spawn
from repro_torch.optim import stack_layers
from repro_torch.quant.gradcomp import _quantize_int8
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.tree import items

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
PARAM_LEAF_RTOL = 1e-3
EXCHANGE_RTOL = 1e-6
EXACT_BOUND = 0.02
PIPE_ATOL = 1e-6
LR = 3e-3
B, S = 8, 16
MESHES = [(2, 2), (4, 1), (1, 4)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_tree_close(got: dict, ref: dict, what: str):
    assert got.keys() == ref.keys(), what
    worst = max((_rel(got[k], ref[k]), k) for k in ref)
    assert worst[0] <= PARAM_LEAF_RTOL, f"{what}: {worst}"
    whole = _rel(np.concatenate([got[k].ravel() for k in ref]),
                 np.concatenate([ref[k].ravel() for k in ref]))
    assert whole <= PARAM_RTOL, f"{what}: {whole}"


def _batches(n=3, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = r.integers(0, 512, (B, S)).astype(np.int32)
        out.append({"tokens": t, "labels": np.roll(t, -1, 1)})
    return out


def _jax_small(arch):
    return dataclasses.replace(jax_reduced_config(arch), d_model=64,
                               n_heads=4, n_kv_heads=4, head_dim=16,
                               d_ff=128, vocab=512)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


_REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import models
    from repro.configs import get_reduced_config
    from repro.launch.mesh import make_host_mesh
    from repro.quant.gradcomp import _quantize_int8, pod_quantized_allreduce
    from repro.runtime.pipeline import pipeline_forward
    from repro.runtime.sharding import batch_shardings
    from repro.train.step import make_train_step, train_state_specs

    inp = dict(np.load(sys.argv[1]))
    out = {}
    def flat(prefix, tree):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[prefix + key] = np.asarray(v, np.float32)

    cfg = dataclasses.replace(get_reduced_config("qwen3_0_6b"), d_model=64,
                              n_heads=4, n_kv_heads=4, head_dim=16,
                              d_ff=128, vocab=512)
    mesh = make_host_mesh(2, 2)
    step_fn, opt = make_train_step(cfg, mesh, lr=float(inp["lr"]))
    _, shard = train_state_specs(cfg, mesh, opt)
    B, S = inp["b0_tokens"].shape
    specs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    bshard = batch_shardings(mesh, specs)
    with jax.set_mesh(mesh):
        params = models.init_params(cfg, jax.random.PRNGKey(0))
        flat("p0/", params)
        params = jax.device_put(params, shard["params"])
        state = {"params": params,
                 "opt": jax.device_put(opt.init(params), shard["opt"]),
                 "step": jnp.zeros((), jnp.int32)}
        jit = jax.jit(step_fn, in_shardings=(shard, bshard),
                      out_shardings=(shard, None))
        for i in range(3):
            b = {k: jax.device_put(inp[f"b{i}_{k}"], bshard[k])
                 for k in specs}
            state, m = jit(state, b)
            for k, v in m.items():
                out[f"m{i}/{k}"] = np.float32(v)
        flat("p3/", state["params"])

    for n in (2, 3, 4):
        pm = jax.make_mesh((n,), ("pod",), devices=jax.devices()[:n],
                           axis_types=(jax.sharding.AxisType.Auto,))
        g, e = inp[f"g{n}"], inp[f"e{n}"]
        fn = jax.shard_map(
            lambda gs, es: pod_quantized_allreduce(gs, es), mesh=pm,
            in_specs=({"w": P("pod")}, {"w": P("pod")}),
            out_specs=({"w": P("pod")}, {"w": P("pod")}), check_vma=False)
        codes = jax.shard_map(
            lambda gs, es: _quantize_int8(gs["w"] + es["w"])[0], mesh=pm,
            in_specs=({"w": P("pod")}, {"w": P("pod")}),
            out_specs=P("pod"), check_vma=False)
        with jax.set_mesh(pm):
            o, err = fn({"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})
            c = codes({"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})
        out[f"gc{n}/out"] = np.asarray(o["w"])
        out[f"gc{n}/err"] = np.asarray(err["w"])
        out[f"gc{n}/codes"] = np.asarray(c).astype(np.int8)

    sm = jax.make_mesh((4,), ("stage",),
                       axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(sm):
        y = pipeline_forward(lambda w, h: jnp.tanh(h @ w),
                             jnp.asarray(inp["ws"]), jnp.asarray(inp["x"]),
                             mesh=sm, n_stages=4)
    out["pipe"] = np.asarray(y)
    np.savez(sys.argv[2], **out)
""")


def _grads_in():
    r = np.random.default_rng(7)
    return {n: (r.normal(size=(n, 64, 32)).astype(np.float32),
                (r.normal(size=(n, 64, 32)) * 1e-3).astype(np.float32))
            for n in (2, 4, 3)}


def _pipe_in():
    r = np.random.default_rng(0)
    n_stages, n_micro, mb, d = 4, 8, 2, 16
    ws = (r.normal(size=(n_stages, d, d)) / np.sqrt(d)).astype(np.float32)
    x = r.normal(size=(n_micro, mb, d)).astype(np.float32)
    return ws, x


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """Start the child process that computes the reference's
    multi-device outputs (8 host devices); it runs beside the ranks."""
    d = tmp_path_factory.mktemp("ref")
    inp = {"lr": np.float32(LR)}
    for i, b in enumerate(_batches()):
        for k, v in b.items():
            inp[f"b{i}_{k}"] = v
    for n, (g, e) in _grads_in().items():
        inp[f"g{n}"], inp[f"e{n}"] = g, e
    inp["ws"], inp["x"] = _pipe_in()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run, ranks):
    """The reference's multi-device outputs (waits for the child)."""
    proc, out = reference_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(out))


def _qwen3_params():
    """The reference's initial params (PRNGKey(0)), as numpy."""
    return jax.tree.map(np.asarray, jmodels.init_params(
        _jax_small("qwen3_0_6b"), jax.random.PRNGKey(0)))


def _ref_tree(reference, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def ranks(reference_run, tmp_path_factory):
    """Every gloo-rank result of this file, from one group of 4 ranks
    (the reference's child process runs meanwhile)."""
    p0 = _qwen3_params()
    jg = jmodels.init_params(_jax_small("granite_moe_3b_a800m"),
                             jax.random.PRNGKey(1))
    granite = jax.tree.map(np.asarray, jg)
    calls = [(f"qwen3 {m}", R.train_steps,
              ("qwen3_0_6b", m, p0, _batches(), LR)) for m in MESHES]
    calls.append(("granite", R.train_steps,
                  ("granite_moe_3b_a800m", (2, 2), granite, _batches(), LR)))
    for n, (g, e) in _grads_in().items():
        calls.append((f"gc{n}", R.gradcomp, (g, e, n)))
    calls.append(("pod", R.pod_step, ("qwen3_0_6b", p0, _batches(1)[0], 2,
                                      2)))
    calls.append(("pipe", R.pipeline, _pipe_in()))
    calls.append(("uneven heads", R.train_steps_uneven_heads,
                  ((1, 4), _batches(), LR)))
    # last: the group joins again through the host-staging backend
    calls.append(("staged", R.staged,
                  (str(tmp_path_factory.mktemp("staged") / "store"),
                   "qwen3_0_6b", (2, 2), p0, _batches(), LR)))
    out = spawn(R.several, 4, calls, device="cpu", timeout=600)[0]
    out["granite_params"] = granite
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_train_step_matches_the_reference(reference, ranks, mesh):
    """qwen3 (the reference's ``_small_cfg``) over 3 steps on a mesh,
    against the reference's (2, 2) step."""
    got = ranks[f"qwen3 {mesh}"]
    assert got["step"] == 3
    # the ranks started from the child's initial params
    _assert_tree_close(_flat(_qwen3_params()), _ref_tree(reference, "p0/"),
                       "initial params")
    for i, m in enumerate(got["metrics"]):
        for k in ("loss", "ce", "zloss"):
            ref = float(reference[f"m{i}/{k}"])
            assert abs(m[k] / ref - 1) <= LOSS_RTOL, (i, k, m[k], ref)
    _assert_tree_close(got["params"], _ref_tree(reference, "p3/"),
                       f"params after 3 steps on {mesh}")
    # the state keeps its params' shardings (no partial sums left)
    assert all(not any(p.is_partial() for p in pl)
               for _, pl in got["placements"])
    sharded = [k for k, pl in got["placements"]
               if any(p.is_shard() for p in pl)]
    assert "embed" in sharded and any("wq" in k for k in sharded)


def test_sharded_step_where_heads_do_not_divide_the_model_axis(ranks):
    """6 query and 2 kv heads on a (1, 4) mesh: each projection's output
    is gathered over ``model`` before it splits into heads
    (``hints.split_heads``), as GSPMD reshards, and the grad before it
    merges back (``hints.merge_heads``). Held to the one-device step over
    3 steps at the mesh tests' tolerances."""
    got = ranks["uneven heads"]
    assert "error" not in got, got.get("error")
    cfg = R.uneven_heads_cfg()
    step, opt = make_train_step(cfg, lr=LR)
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    for i, b in enumerate(_batches()):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "ce", "zloss"):
            assert abs(got["metrics"][i][k] / float(m[k]) - 1) <= LOSS_RTOL
    one = {k: v.detach().numpy() for k, v in
           items(stack_layers(state["params"], cfg))}
    _assert_tree_close(got["params"], one, "uneven heads after 3 steps")


def test_sharded_moe_train_step_matches_the_reference_1x1(ranks):
    """granite-moe (the reference's ``_small_cfg``) on (2, 2) over 3
    steps, against the reference's 1 x 1 step in this process."""
    jcfg = _jax_small("granite_moe_3b_a800m")
    mesh = jax_host_mesh(1, 1)
    jstep, jopt = jax_make_train_step(jcfg, mesh, lr=LR)
    jit = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, ranks["granite_params"])
    js = {"params": jp, "opt": jopt.init(jp),
          "step": jnp.zeros((), jnp.int32)}
    got = ranks["granite"]
    for i, b in enumerate(_batches()):
        with jax.set_mesh(mesh):
            js, jm = jit(js, jax.tree.map(jnp.asarray, b))
        for k in ("loss", "ce", "zloss"):
            assert abs(got["metrics"][i][k] / float(jm[k]) - 1) <= LOSS_RTOL
    _assert_tree_close(got["params"], _flat(js["params"]),
                       "granite params after 3 steps")


@pytest.mark.parametrize("n_pods", [2, 3, 4])
def test_gradient_exchange_matches_the_reference(reference, ranks, n_pods):
    g, e = _grads_in()[n_pods]
    got = ranks[f"gc{n_pods}"]
    per_rank = len(got) // n_pods
    exact = g.mean(0)
    for rank, res in enumerate(got):
        pod = rank // per_rank
        np.testing.assert_array_equal(
            res["codes"], reference[f"gc{n_pods}/codes"][pod])
        ref_out = reference[f"gc{n_pods}/out"][pod]
        assert _rel(res["out"], ref_out) <= EXCHANGE_RTOL
        assert _rel(res["err"], reference[f"gc{n_pods}/err"][pod]) \
            <= EXCHANGE_RTOL
        # every pod holds the same mean; the compression within the
        # reference's bound of the exact one (error feedback folded in)
        np.testing.assert_array_equal(res["out"], got[0]["out"])
        exact_fb = (g + e).mean(0)
        assert np.abs(res["out"] - exact_fb).max() / np.abs(
            exact_fb).max() < EXACT_BOUND
        assert np.abs(res["out"] - exact).max() / np.abs(exact).max() \
            < EXACT_BOUND
        assert np.abs(res["err"]).max() > 0
        # bytes: int8 codes + one f32 scale against f32 values
        assert res["stats"] == {"bytes": g[0].size + 4,
                                "bytes_grad_dtype": g[0].size * 4,
                                "bytes_f32": g[0].size * 4}


def test_pod_train_step_exchanges_int8_grads(reference, ranks):
    """``wrap_pod_train_step`` on (pod 2, data 1, model 2): each pod's
    grads of its half of the batch, on its sub-mesh, exchanged as int8;
    held to the one-device grads of each half."""
    got = ranks["pod"]
    cfg = R.small_cfg("qwen3_0_6b")
    # the ranks' params: the reference's initial params
    params = models.params_from_reference(_qwen3_params(), cfg, "cpu")
    b = _batches(1)[0]
    halves, losses = [], []
    for p in range(2):
        rows = {k: torch.from_numpy(v[p * B // 2:(p + 1) * B // 2])
                for k, v in b.items()}
        loss, _, grads = value_and_grad(params, cfg, rows)
        halves.append({k: v.numpy() for k, v in
                       items(stack_layers(grads, cfg))})
        losses.append(float(loss))
    assert abs(got["metrics"]["loss"] / np.mean(losses) - 1) <= LOSS_RTOL
    assert got["grads"].keys() == halves[0].keys()
    for k, mean in got["grads"].items():
        exact = (halves[0][k] + halves[1][k]) / 2
        scale = max(np.abs(halves[0][k]).max(), np.abs(halves[1][k]).max())
        # each pod's dequantized grad is within half a code step of its
        # grad: the mean within that of the exact mean
        assert np.abs(mean - exact).max() <= scale / 127 * 0.5 + 1e-6, k
        # the error state is what pod 0's codes left out: the one-device
        # residual, or one code step off where a grad sits within
        # rounding of a code boundary
        q, step = _quantize_int8(torch.from_numpy(halves[0][k]))
        resid = halves[0][k] - q.numpy() * float(step)
        assert np.abs(got["err"][k] - resid).max() <= float(step) * 1.001, k
    # int8 codes + a scale a leaf: about a quarter of the f32 bytes
    assert got["stats"]["bytes"] < got["stats"]["bytes_f32"] / 3
    assert any(np.abs(v).max() > 0 for v in got["err"].values())


def test_pipeline_matches_sequential_stages(reference, ranks):
    ws, x = _pipe_in()
    ref = x
    for i in range(4):
        ref = np.tanh(ref @ ws[i])
    outs = ranks["pipe"]
    n_stages, n_micro = ws.shape[0], x.shape[0]
    for out, stats in outs:          # every rank returns the last stage's
        np.testing.assert_allclose(out, ref, atol=PIPE_ATOL, rtol=0)
        np.testing.assert_allclose(out, reference["pipe"], atol=PIPE_ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(out, outs[0][0])
        # one hand-off a schedule step, none staged through the host on
        # the CPU
        assert stats == {"sent": (n_micro + n_stages - 1) * x[0].nbytes}


def test_host_staged_backend_carries_collectives_and_the_sharded_step(
        ranks):
    """The ``gloo_host`` backend (``launch/host_gloo.py``, what ranks
    sharing a GPU join through), here staging CPU tensors through copies
    as it stages CUDA tensors: every c10d collective gives its result on
    every rank, and the (2, 2) sharded step over it is bitwise the same
    step over plain gloo, with bytes staged both ways."""
    got, plain = ranks["staged"], ranks["qwen3 (2, 2)"]
    assert got["backend"] == "gloo_host_cpu"
    for rank, sweep in enumerate(got["sweeps"]):
        assert sweep and all(sweep.values()), (rank, sweep)
    assert got["metrics"] == plain["metrics"]
    assert got["params"].keys() == plain["params"].keys()
    for k, v in plain["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    assert got["placements"] == plain["placements"]
    assert min(got["staged"]) > 0
