"""The training path (``optim``, ``train/step.py``, ``data/pipeline.py``,
``launch/train.py``, remat in ``models``) against the reference on its own
parameters (converted by ``params_from_reference``) and seeded inputs,
f32 reduced configs.

Tolerances (f32): the loss within 1e-5 relative; grads within 1e-4 by
relative norm per leaf; the params after 3 steps within 1e-5 by
relative norm over the whole tree, and each leaf within 1e-3 (Adam's
m/sqrt(v) turns a rounding-level difference of a near-zero grad into a
step of up to lr on that element: the zero-initialized norm scales read
1.3e-4 per leaf, the tree 4.9e-6); the optimizers alone on given grads at 1e-6; the moments after 3 train
steps at 1e-3 per leaf (the grads of steps 2-3 are taken at params that
already differ as above: m of the embedding reads 1.1e-4); a bf16 optimizer state within 2^-7 by
relative norm (one bf16 ulp: an f32 value a rounding apart may round to
the neighbouring bf16, and Adafactor's momentum carries it on). Tokens are
bitwise the reference's.
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

from repro import models as jmodels
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_reduced_config as jax_reduced_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import cosine_with_warmup as jcosine
from repro.train.step import input_specs as jax_input_specs
from repro.train.step import lm_loss as jax_lm_loss
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import models
from repro_torch.configs import ARCHS, get_reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.optim import (Optimizer, adafactor, adamw,
                               cosine_with_warmup, stack_layers)
from repro_torch.train.step import input_specs, lm_loss, make_train_step
from repro_torch.tree import items, tree_map, unflatten

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-5
PARAM_LEAF_RTOL = 1e-3
MOMENT_RTOL = 1e-3
OPT_RTOL = 1e-6
BF16_REL = 2.0 ** -7
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_flat(tree) -> dict:
    """The reference tree's leaves by ``/``-joined path."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_tree_close(got, ref, rtol, what, *, leaf_rtol=None):
    """``got``: a port tree in the reference's layout; ``ref``: the
    reference's tree. Every leaf within ``leaf_rtol`` (default ``rtol``)
    by relative norm, and the whole tree within ``rtol``."""
    flat = _ref_flat(ref)
    mine = {k: v.detach().float().numpy() for k, v in items(got)}
    assert mine.keys() == flat.keys(), what
    worst = max((_rel(mine[k], flat[k].astype(np.float32)), k)
                for k in flat)
    assert worst[0] <= (leaf_rtol or rtol), f"{what}: {worst}"
    whole = _rel(np.concatenate([mine[k].ravel() for k in flat]),
                 np.concatenate([flat[k].astype(np.float32).ravel()
                                 for k in flat]))
    assert whole <= rtol, f"{what}: {whole}"


def _batch(cfg, seed=0):
    """Seeded numpy inputs for any reduced config (the smoke test's
    kinds: embeds + M-RoPE positions, enc-dec, tokens)."""
    r = np.random.default_rng(seed)
    out = {}
    if cfg.input_kind == "embeds" and cfg.family != "encdec":
        out["embeds"] = r.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        if cfg.mrope_sections is not None:
            out["positions"] = np.broadcast_to(
                np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    elif cfg.family == "encdec":
        out["enc_embeds"] = r.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
        out["tokens"] = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        out["tokens"] = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out["labels"] = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return out


def _both(arch, seed=0):
    jcfg = jax_reduced_config(arch)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = get_reduced_config(arch)
    return jcfg, jparams, cfg, models.params_from_reference(
        _np(jparams), cfg, "cpu")


def _port_grads(params, loss_fn):
    """(loss, grads) by autograd on a grad-requiring copy of ``params``."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = [t for _, t in items(p)]
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), unflatten(p, [
        torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)])


# ------------------------------------------------------------ optimizers


def _opt_tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(8, 4)).astype(np.float32),
            "b": r.normal(size=(4,)).astype(np.float32),
            "k": r.normal(size=(3, 5, 6)).astype(np.float32)}


@pytest.mark.parametrize("kind,state_dtype", [
    ("adamw", "float32"), ("adamw", "bfloat16"),
    ("adafactor", "float32"), ("adafactor", "bfloat16")])
def test_optimizer_matches_reference_over_steps(kind, state_dtype):
    jmod = {"adamw": jadamw, "adafactor": jadafactor}[kind]
    params = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jmod.init(jp, jnp.dtype(state_dtype))
    opt = Optimizer(kind, state_dtype, weight_decay=0.05)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = opt.init(tp)
    for step in range(4):
        g = _opt_tree(step + 1)
        jp, js = jmod.update(jax.tree.map(jnp.asarray, g), js, jp, lr=0.01,
                             weight_decay=0.05)
        tp, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp, lr=0.01)
    _assert_tree_close(tp, jp, OPT_RTOL if state_dtype == "float32"
                       else 1e-3, f"{kind} params")
    flat, mine = _ref_flat(js), dict(items(ts))
    assert mine.keys() == flat.keys()
    for k, ref in flat.items():
        got = mine[k]
        assert str(got.dtype).split(".")[-1] == ref.dtype.name, k
        if k != "count":
            tol = BF16_REL if ref.dtype.name == "bfloat16" else OPT_RTOL
            assert _rel(got.float().numpy(), ref.astype(np.float32)) <= tol, k
    assert int(ts["count"]) == int(js["count"]) == 4


def test_adafactor_state_is_factored_as_the_reference():
    params = {"w": torch.zeros(64, 32), "b": torch.zeros(32),
              "k": torch.zeros(2, 6, 5)}
    state = adafactor.init(params)
    assert state["v"]["w"]["vr"].shape == (64,)
    assert state["v"]["w"]["vc"].shape == (32,)
    assert state["v"]["b"]["v"].shape == (32,)
    assert state["v"]["k"]["vr"].shape == (2, 6)
    assert state["v"]["k"]["vc"].shape == (2, 5)
    ref = jadafactor.init({"w": jnp.zeros((64, 32))}, use_momentum=False)
    assert "m" not in adafactor.init({"w": torch.zeros(64, 32)},
                                     use_momentum=False)
    assert "m" not in ref


def test_adamw_weight_decay_decoupled():
    new_p, _ = adamw.update({"w": torch.zeros(4)},
                            adamw.init({"w": torch.ones(4)}),
                            {"w": torch.ones(4)}, lr=0.1, weight_decay=0.5)
    np.testing.assert_allclose(new_p["w"].numpy(), 0.95)  # 1 - lr*wd


def test_cosine_schedule_matches_reference():
    for t in (0, 3, 10, 11, 50, 99, 100, 140):
        kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
        ref = float(jcosine(jnp.float32(t), **kw))
        assert abs(float(cosine_with_warmup(t, **kw)) - ref) <= 1e-6, t


def test_optimizer_state_from_reference_resumes_the_same():
    """A reference state mid-run, converted, continues as the reference."""
    jcfg, jparams, cfg, params = _both("qwen3_0_6b")
    jcfg = dataclasses.replace(jcfg, optimizer="adafactor")
    cfg = dataclasses.replace(cfg, optimizer="adafactor")
    jstep, jopt = jax_make_train_step(jcfg, make_host_mesh(1, 1))
    step, opt = make_train_step(cfg)
    mesh = make_host_mesh(1, 1)
    b0, b1 = _batch(cfg, 1), _batch(cfg, 2)
    js = {"params": jparams, "opt": jopt.init(jparams),
          "step": jnp.zeros((), jnp.int32)}
    with jax.set_mesh(mesh):
        js, _ = jax.jit(jstep)(js, jax.tree.map(jnp.asarray, b0))
    state = {"params": models.params_from_reference(
                 _np(js["params"]), cfg, "cpu"),
             "opt": models.opt_state_from_reference(_np(js["opt"]), "cpu"),
             "step": torch.tensor(1, dtype=torch.int32)}
    assert {k: tuple(v.shape) for k, v in items(state["opt"])} == {
        k: v.shape for k, v in _ref_flat(js["opt"]).items()}
    with jax.set_mesh(mesh):
        js, jm = jax.jit(jstep)(js, jax.tree.map(jnp.asarray, b1))
    state, m = step(state, {k: torch.from_numpy(v) for k, v in b1.items()})
    assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= LOSS_RTOL
    _assert_tree_close(stack_layers(state["params"], cfg), js["params"],
                       PARAM_RTOL, "params", leaf_rtol=PARAM_LEAF_RTOL)


# ------------------------------------------------------------ the step


def test_lm_loss_and_grads_match_reference_over_two_chunks():
    """S = 1024: two 512-token chunks, each under checkpoint."""
    jcfg, jparams, cfg, params = _both("qwen3_0_6b")
    r = np.random.default_rng(3)
    toks = r.integers(0, cfg.vocab, (1, 1024)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, jcfg, jb), has_aux=True))(jparams)
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    aux = {}

    def loss_fn(p):
        loss, a = lm_loss(p, cfg, tb)
        aux.update({k: v.detach() for k, v in a.items()})
        return loss

    loss, grads = _port_grads(params, loss_fn)
    assert abs(float(loss) / float(jl) - 1) <= LOSS_RTOL
    for k in ("ce", "zloss"):
        assert abs(float(aux[k]) / float(jaux[k]) - 1) <= LOSS_RTOL, k
    _assert_tree_close(stack_layers(grads, cfg), jg, GRAD_RTOL, "grads")


@pytest.mark.parametrize("opt_kind", ["adamw", "adafactor-bf16"])
def test_train_step_matches_reference_over_three_steps(opt_kind):
    jcfg, jparams, cfg, params = _both("qwen3_0_6b")
    if opt_kind == "adafactor-bf16":
        over = dict(optimizer="adafactor", opt_state_dtype="bfloat16")
        jcfg = dataclasses.replace(jcfg, **over)
        cfg = dataclasses.replace(cfg, **over)
    mesh = make_host_mesh(1, 1)
    jstep, jopt = jax_make_train_step(jcfg, mesh, lr=3e-3)
    jit = jax.jit(jstep)
    step, opt = make_train_step(cfg, lr=3e-3)
    js = {"params": jparams, "opt": jopt.init(jparams),
          "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        b = _batch(cfg, 10 + i)
        with jax.set_mesh(mesh):
            js, jm = jit(js, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        for k in ("loss", "ce", "zloss", "grad_norm"):
            tol = GRAD_RTOL if k == "grad_norm" else LOSS_RTOL
            assert abs(float(m[k]) / float(jm[k]) - 1) <= tol, (i, k)
    assert int(state["step"]) == int(js["step"]) == 3
    _assert_tree_close(stack_layers(state["params"], cfg), js["params"],
                       PARAM_RTOL, "params after 3 steps",
                       leaf_rtol=PARAM_LEAF_RTOL)
    mine = dict(items(state["opt"]))
    for k, ref in _ref_flat(js["opt"]).items():
        if k != "count":
            tol = BF16_REL if ref.dtype.name == "bfloat16" else MOMENT_RTOL
            assert _rel(mine[k].float().numpy(),
                        ref.astype(np.float32)) <= tol, k


@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_matches_reference_for_every_arch(arch):
    jcfg, jparams, cfg, params = _both(arch, seed=1)
    nb = _batch(cfg, 5)
    jb = jax.tree.map(jnp.asarray, nb)

    def jloss(p):
        logits = jmodels.forward(p, jcfg, jb, train=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(
            logp, jb["labels"][..., None], axis=-1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}

    def loss_fn(p):
        logits = models.forward(p, cfg, tb, train=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.mean(torch.gather(logp, -1,
                                        tb["labels"].long()[..., None]))

    loss, grads = _port_grads(params, loss_fn)
    assert abs(float(loss) / float(jl) - 1) <= LOSS_RTOL
    _assert_tree_close(stack_layers(grads, cfg), jg, GRAD_RTOL, arch)


def test_arch_lists_agree():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "jamba_1_5_large_398b",
                                  "whisper_tiny"])
def test_remat_on_and_off_give_equal_loss_and_grads(arch):
    """"none", "full" and "dots" recompute the same ops on the same
    inputs: equal bits. jamba: an 8-kind heterogeneous group; whisper: the
    decoder's groups with cross-attention."""
    _, _, cfg, params = _both(arch, seed=2)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 6).items()}
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = _port_grads(params, lambda p, c=c: lm_loss(
            p, c, tb)[0])
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for (k, a), (_, b) in zip(items(out[remat][1]),
                                  items(out["none"][1])):
            assert torch.equal(a, b), (remat, k)


def test_remat_keeps_fewer_activations_and_leaves_inference_alone():
    """"full" saves only each group's input: fewer saved tensors than
    "none". Under no_grad the forward takes the plain path (equal
    logits) whatever ``remat``."""
    _, _, cfg, params = _both("qwen3_0_6b", seed=2)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 6).items()}
    saved = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        n = [0]

        def pack(t, n=n):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            models.forward(p, c, tb, train=True, return_hidden=True)
        saved[remat] = n[0]
    assert saved["full"] < saved["none"] / 4, saved
    with torch.no_grad():
        a = models.forward(params, cfg, tb, train=True)
        b = models.forward(params, dataclasses.replace(cfg, remat="none"),
                           tb, train=False)
    assert torch.equal(a, b)


def test_no_kernel_launches_through_a_train_step():
    from repro_torch.kernels import (fista_quant, paged_decode_attention,
                                     quant_matmul, quant_matmul_stacked)
    from repro_torch.kernels.fista_quant import fista_freeze

    kernels = (paged_decode_attention, quant_matmul, quant_matmul_stacked,
               fista_quant, fista_freeze)
    before = [k.launches for k in kernels]
    _, _, cfg, params = _both("qwen3_0_6b")
    step, opt = make_train_step(cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step(state, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    assert [k.launches for k in kernels] == before == [0] * len(kernels)


# ------------------------------------------------------------ data


def test_input_specs_match_reference():
    for arch in ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            ref = jax_input_specs(jax_reduced_config(arch), shape)
            got = input_specs(get_reduced_config(arch), shape)
            assert list(got) == list(ref), (arch, shape)
            for k, (shp, dt) in got.items():
                assert shp == ref[k].shape, (arch, shape, k)
                assert str(dt).split(".")[-1] == ref[k].dtype.name


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen2_vl_72b",
                                  "whisper_tiny"])
def test_synthetic_batches_bitwise_the_reference(arch):
    """Tokens and labels for (seed, step) bitwise the reference's on a
    1 x 1 mesh; embeds, M-RoPE positions and encoder embeds too, within
    one process (their seeds hash the input's name)."""
    jcfg, cfg = jax_reduced_config(arch), get_reduced_config(arch)
    mesh = make_host_mesh(1, 1)
    jpipe, pipe = JaxSyntheticLM(jcfg, 3, 20, seed=4), \
        SyntheticLM(cfg, 3, 20, seed=4)
    jspecs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in
              jax_input_specs(jcfg, "train_4k").items()}
    jspecs = {k: jax.ShapeDtypeStruct(
        (3, 3, 20) if k == "positions" else (3, 20) + v.shape[2:], v.dtype)
        for k, v in jspecs.items()}
    specs = pipe.batch_specs()
    assert {k: v[0] for k, v in specs.items()} == {
        k: v.shape for k, v in jspecs.items()}
    for step in (0, 7):
        with jax.set_mesh(mesh):
            ref = jpipe.next_batch(step, mesh, jspecs)
        got = pipe.next_batch(step, specs, "cpu")
        for k in specs:
            assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    got = pipe.next_batch(7, specs, "cpu")
    if "tokens" in got:
        assert np.array_equal(got["labels"].numpy()[:, :-1],
                              got["tokens"].numpy()[:, 1:])
        assert not torch.equal(got["tokens"],
                               pipe.next_batch(8, specs, "cpu")["tokens"])


def test_reference_embeds_change_with_the_hash_seed():
    """The reference seeds ``embeds`` from ``hash(name) % 997``: two
    processes with different ``PYTHONHASHSEED`` draw different embeds for
    the same (seed, step) (ROADMAP C); tokens do not depend on it."""
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_reduced_config
        from repro.data.pipeline import SyntheticLM
        from repro.launch.mesh import make_host_mesh
        cfg = get_reduced_config("qwen2_vl_72b")
        mesh = make_host_mesh(1, 1)
        specs = {"embeds": jax.ShapeDtypeStruct((2, 4, cfg.d_model),
                                                jnp.float32)}
        with jax.set_mesh(mesh):
            b = SyntheticLM(cfg, 2, 4).next_batch(0, mesh, specs)
        print(float(np.asarray(b["embeds"]).sum()), hash("embeds") % 997)
    """)
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout.split())
    assert outs[0][1] != outs[1][1] and outs[0][0] != outs[1][0], outs


# ------------------------------------------------------------ launcher


def test_launcher_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path)]
    r = train.main(argv)
    out = capsys.readouterr().out
    assert "[train] qwen3-reduced:" in out and "steps=4" in out
    assert "[train] done: loss" in out and "restarts=0" in out
    log = r["trainer"].metrics_log
    assert [row["step"] for row in log] == [0, 1, 2, 3]
    assert all(np.isfinite(row["loss"]) for row in log)
    assert int(r["state"]["step"]) == 4
    # a rerun to step 6 resumes from the step-4 checkpoint
    r2 = train.main(argv[:4] + ["6"] + argv[5:])
    assert [row["step"] for row in r2["trainer"].metrics_log] == [4, 5]
    assert int(r2["state"]["step"]) == 6


def test_launcher_refuses_a_mesh_and_defaults_to_the_card(tmp_path):
    """A mesh is taken (one rank a device); a rank count that does not
    match it, or a size below 1, is refused. The default device is the
    card, on a mesh too."""
    from repro_torch.launch import train

    args = train.parse_args(["--reduced", "--data-par", "2",
                             "--model-par", "4", "--host-devices", "8"])
    assert (args.data_par, args.model_par, args.host_devices) == (2, 4, 8)
    for flags in (["--data-par", "2", "--host-devices", "8"],
                  ["--model-par", "4", "--host-devices", "2"],
                  ["--data-par", "0"]):
        with pytest.raises(SystemExit, match="refused"):
            train.parse_args(["--reduced"] + flags)
    args = train.parse_args(["--reduced"])
    assert args.device == "cuda" and args.host_devices is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.run(args)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--reduced", "--data-par", "2"])


def test_training_modules_run_without_jax(tmp_path):
    """With jax blocked: import every training and distribution module of
    the port, run the launcher on the CPU, then on a 1 x 2 mesh of two
    spawned gloo ranks."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)
        import repro_torch.checkpoint.ckpt, repro_torch.models.mlp
        import repro_torch.optim, repro_torch.quant.qat
        import repro_torch.runtime.ftolerance, repro_torch.train.step
        import repro_torch.launch.mesh, repro_torch.runtime.sharding
        import repro_torch.runtime.hints, repro_torch.runtime.pipeline
        import repro_torch.quant.gradcomp, repro_torch.launch.host_gloo
        from repro_torch.launch import train
        if __name__ == "__main__":
            r = train.main(["--reduced", "--device", "cpu", "--steps", "2",
                            "--batch", "2", "--seq", "8", "--ckpt-dir",
                            {str(tmp_path / "one")!r}])
            assert len(r["trainer"].metrics_log) == 2
            r = train.main(["--reduced", "--device", "cpu", "--steps", "2",
                            "--batch", "2", "--seq", "8", "--model-par",
                            "2", "--ckpt-dir", {str(tmp_path / "mesh")!r}])
            assert r["step"] == 2 and len(r["ranks"]) == 2
            assert not any(m == "repro" or m.startswith(("repro.", "jax"))
                           for m in sys.modules
                           if sys.modules[m] is not None)
            print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-2000:]
