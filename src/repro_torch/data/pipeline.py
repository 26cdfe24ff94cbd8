"""Deterministic synthetic LM batches on one device (port of
``repro/data/pipeline.py``).

Deterministic in (seed, step): a restart resumes mid-stream without
state. Tokens are the reference's host stream bit for bit (its batch on a
1 x 1 mesh: one shard, rows 0..B); labels are the tokens rolled left by
one. Any other input (``embeds``, ``positions``, ``enc_embeds``) is a
seeded standard normal drawn, as the reference draws it, from
``(seed, step, hash(name) % 997)``: Python salts ``str`` hashes per
process, so those streams agree with the reference's within one process
but not across a restart (ROADMAP C).
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

    def next_batch(self, step: int, specs: dict, device) -> dict:
        """specs: name -> (shape, dtype) (``batch_specs`` or any train
        shape). Built on the host, then moved to ``device``."""
        out = {}
        for name, (shape, dtype) in specs.items():
            if name in ("tokens", "labels"):
                tok = self._host_tokens(step, 0, shape[0], shape[1])
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
