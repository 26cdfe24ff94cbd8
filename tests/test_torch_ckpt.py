"""Checkpoints (``checkpoint/ckpt.py``) and the crash-recovering Trainer
(``runtime/ftolerance.py``) against the reference.

Exact throughout: a round trip is bitwise for every dtype (bf16 as its
uint16 bits), each package restores the other's checkpoint of the
reference's toy state bitwise, and a run with injected failures ends in
the uninterrupted run's state bit for bit (the CPU's ops are
deterministic, and the data stream is a function of (seed, step)).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch import models
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.runtime.ftolerance import (SimulatedFailure,
                                            StragglerMonitor, Trainer)
from repro_torch.train.step import make_train_step
from repro_torch.tree import items

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)


def _jax_toy_state(seed=0):
    """``tests/test_fault_tolerance.py``'s ``_toy_state``."""
    k = jax.random.PRNGKey(seed)
    return {"params": {"w": jax.random.normal(k, (16, 8)),
                       "b": jnp.zeros((8,))},
            "opt": {"m": {"w": jnp.ones((16, 8)), "b": jnp.zeros((8,))},
                    "count": jnp.zeros((), jnp.int32)},
            "step": jnp.zeros((), jnp.int32)}


def _toy_state(seed=0):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                        _jax_toy_state(seed))


def _mixed_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": torch.randn(5, 4, generator=g).to(
                           torch.bfloat16),
                       "layers": [{"w": torch.randn(4, 3, generator=g)},
                                  {"w": torch.randn(4, 3, generator=g)}]},
            "opt": {"m": torch.randn(2, 4, 3, generator=g).to(
                        torch.bfloat16),
                    "count": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(3, dtype=torch.int32)}


def items_like(tree):
    """A tree of (replicated) placements shaped like ``tree``."""
    from torch.distributed.tensor import Replicate

    from repro_torch.tree import tree_map

    return tree_map(lambda _: (Replicate(),), tree)


def _assert_bitwise(a, b):
    la, lb = items(a), items(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y), k


def test_roundtrip_bitwise_atomic_and_keep_last(tmp_path):
    d = str(tmp_path)
    s = _mixed_state()
    for step in (10, 20, 30, 40):
        ckpt.save(s, d, step, keep_last=2)
    assert ckpt.latest_step(d) == 40
    assert sorted(os.listdir(d)) == ["step_00000030", "step_00000040"]
    with open(os.path.join(d, "step_00000040", "manifest.json")) as f:
        tree = json.load(f)["tree"]
    assert tree["params::embed"]["dtype"] == "bfloat16"
    assert tree["params::layers::1::w"]["shape"] == [4, 3]
    restored, step = ckpt.restore(_mixed_state(seed=1), d)
    assert step == 40
    _assert_bitwise(restored, s)
    # a write cut before its rename leaves a .tmp that nothing reads
    os.makedirs(os.path.join(d, "step_00000050.tmp"))
    assert ckpt.latest_step(d) == 40
    ckpt.save(s, d, 60, keep_last=2)
    assert ckpt.latest_step(d) == 60 and not os.path.exists(
        os.path.join(d, "step_00000030"))


def test_async_save_and_log(tmp_path):
    log = []
    t = ckpt.save(_mixed_state(), str(tmp_path), 5, async_=True, log=log)
    t.join(timeout=60)
    assert not t.is_alive()
    assert [r["step"] for r in log] == [5]
    assert log[0]["bytes"] == 5 * 4 * 2 + 2 * 12 * 4 + 24 * 2 + 4 + 4
    restored, _ = ckpt.restore(_mixed_state(seed=2), str(tmp_path))
    _assert_bitwise(restored, _mixed_state())


def test_restore_validates_tree_shapes_and_refuses_shardings(tmp_path):
    d = str(tmp_path)
    ckpt.save(_mixed_state(), d, 1)
    other = _mixed_state()
    other["params"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(other, d)
    other = _mixed_state()
    other["params"]["layers"][0]["w"] = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore(other, d)
    # reshard-on-load takes a tree of placements matching the state's,
    # and a mesh (given, or a DTensor leaf's)
    with pytest.raises(ValueError, match="shardings/tree mismatch"):
        ckpt.restore(_mixed_state(), d, shardings={})
    with pytest.raises(ValueError, match="no mesh"):
        ckpt.restore(_mixed_state(), d, shardings=items_like(
            _mixed_state()))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_mixed_state(), str(tmp_path / "none"))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_restores_the_others_toy_state(tmp_path, writer):
    d = str(tmp_path)
    if writer == "reference":
        jckpt.save(_jax_toy_state(), d, 12)
        restored, step = ckpt.restore(_toy_state(seed=1), d)
        _assert_bitwise(restored, _toy_state())
    else:
        ckpt.save(_toy_state(), d, 12)
        restored, step = jckpt.restore(_jax_toy_state(seed=1), d)
        ref = jax.tree.map(np.asarray, _jax_toy_state())
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref)):
            assert np.asarray(a).dtype == b.dtype
            assert np.array_equal(np.asarray(a), b)
    assert step == 12


# ------------------------------------------------------------- trainer


def _toy_trainer(path, fail_at=None):
    """``tests/test_fault_tolerance.py``'s toy trainer."""
    def init_state():
        return {"x": torch.zeros(()), "step": torch.zeros((),
                                                          dtype=torch.int32)}

    def step_fn(state, batch):
        x = state["x"] + batch
        return {"x": x, "step": state["step"] + 1}, {"loss": x}

    return Trainer(step_fn=step_fn, init_state_fn=init_state,
                   next_batch_fn=lambda step: torch.tensor(float(step + 1)),
                   ckpt_dir=str(path), ckpt_every=5, fail_at=fail_at)


def test_trainer_crash_recovery_equivalence(tmp_path):
    """As the reference's ``test_trainer_crash_recovery_equivalence``."""
    clean = _toy_trainer(tmp_path / "clean").run(23)
    tr = _toy_trainer(tmp_path / "faulty", fail_at={7, 12, 12, 19})
    faulty = tr.run(23)
    assert tr.restarts >= 2
    assert float(faulty["x"]) == float(clean["x"]) == sum(range(1, 24))
    assert int(faulty["step"]) == int(clean["step"]) == 23


def test_trainer_gives_up_after_max_restarts(tmp_path):
    tr = _toy_trainer(tmp_path, fail_at={1, 2, 3})
    with pytest.raises(SimulatedFailure):
        tr.run(4, max_restarts=2)


def _lm_trainer(path, fail_at=None, async_ckpt=False):
    cfg = get_reduced_config("qwen3_0_6b")
    step_fn, opt = make_train_step(cfg, lr=1e-3)
    pipe = SyntheticLM(cfg, 2, 16, seed=1)
    specs = pipe.batch_specs()
    params0 = models.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")

    def init_state():
        return {"params": params0, "opt": opt.init(params0),
                "step": torch.zeros((), dtype=torch.int32)}

    return Trainer(step_fn=step_fn, init_state_fn=init_state,
                   next_batch_fn=lambda s: pipe.next_batch(s, specs, "cpu"),
                   ckpt_dir=str(path), ckpt_every=2, fail_at=fail_at,
                   async_ckpt=async_ckpt)


def test_lm_trainer_recovers_to_the_uninterrupted_state(tmp_path):
    """A reduced qwen3 trained 6 steps with failures at steps 3 and 5
    (restored from steps 2 and 4, async checkpoints) ends in the
    uninterrupted run's params and optimizer state, bit for bit."""
    clean = _lm_trainer(tmp_path / "clean").run(6)
    tr = _lm_trainer(tmp_path / "faulty", fail_at={3, 5}, async_ckpt=True)
    faulty = tr.run(6)
    assert tr.restarts == 2
    assert [r["step"] for r in tr.metrics_log] == [0, 1, 2, 2, 3, 4, 4, 5]
    _assert_bitwise(faulty, clean)
    assert len(tr.ckpt_log) == 4 and all(r["bytes"] > 0 for r in tr.ckpt_log)


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(threshold=2.0, warmup=2)
    for i in range(10):
        m.record(i, 0.1)
    m.record(10, 0.5)      # 5x the EMA
    assert m.flagged and m.flagged[-1][0] == 10
    m.record(11, 0.1)      # EMA not poisoned by the outlier
    assert abs(m.ema - 0.1) < 0.02
