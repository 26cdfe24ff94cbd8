"""Deterministic synthetic LM batches (port of
``repro/data/pipeline.py``).

Deterministic in (seed, step): a restart resumes mid-stream without
state. Tokens are the reference's host stream bit for bit: each batch
shard's rows from the stream of its first row (one shard, rows 0..B, on
a 1 x 1 mesh); labels are the tokens rolled left by one. Any other input
(``embeds``, ``positions``, ``enc_embeds``) is a seeded standard normal
drawn, as the reference draws it, from ``(seed, step, hash(name) %
997)``: Python salts ``str`` hashes per process, so those streams agree
with the reference's within one process but not across a restart
(ROADMAP C).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    cfg: object
    batch: int
    seq: int
    seed: int = 0

    def _host_tokens(self, step: int, lo: int, hi: int,
                     seq: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step, lo))
        # markov-ish stream so the loss is learnable, not pure noise
        v = self.cfg.vocab
        base = rng.integers(0, v, size=(hi - lo, seq), dtype=np.int64)
        drift = np.arange(seq)[None, :] * 31
        return ((base + drift) % v).astype(np.int32)

    def batch_specs(self) -> dict:
        """The config's train inputs at this pipeline's (batch, seq) (the
        reference's gives the train_4k cell's 256 x 4096 whatever its
        own batch and seq)."""
        from repro_torch.train.step import input_specs  # no import cycle

        return input_specs(self.cfg, "train_4k", batch=self.batch,
                           seq=self.seq)

    def next_batch(self, step: int, specs: dict, device,
                   shards: int = 1) -> dict:
        """specs: name -> (shape, dtype) (``batch_specs`` or any train
        shape). Built on the host, then moved to ``device``. ``shards``:
        the batch's shards on a mesh (``batch_shards``); the reference
        draws each shard's token rows from its own stream, so the batch
        of a mesh is its batch on that mesh."""
        out = {}
        for name, (shape, dtype) in specs.items():
            if name in ("tokens", "labels"):
                rows = shape[0] // shards
                tok = np.concatenate([
                    self._host_tokens(step, lo, lo + rows, shape[1])
                    for lo in range(0, shape[0], rows)])
                arr = tok if name == "tokens" else np.roll(tok, -1, axis=1)
                t = torch.from_numpy(arr)
            else:
                rng = np.random.default_rng((self.seed, step,
                                             hash(name) % 997))
                a = rng.normal(0, 1, size=shape)     # f64, as the reference
                t = torch.from_numpy(a.astype(
                    np.float32 if dtype.is_floating_point else np.int32))
            out[name] = t.to(device=device, dtype=dtype)
        return out


def batch_shards(mesh, batch: int) -> int:
    """How many shards a mesh cuts a batch of ``batch`` rows into: the
    product of its ``pod`` and ``data`` axes where it divides the batch,
    else 1 (replicated), as ``runtime.sharding.batch_spec`` places it."""
    if mesh is None:
        return 1
    from repro_torch.runtime.sharding import _axsize, _batch_axes, axis_sizes

    n = _axsize(axis_sizes(mesh), _batch_axes(mesh))
    return n if batch % n == 0 else 1
