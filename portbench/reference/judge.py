"""What decides ``correct`` in a serving cell.

Once the window has closed, a sample of the finished requests, drawn
from the seed and holding the longest one, is run through the plain
reference, each prompt with the tokens the program served. At every
served position the reading is the gap by which the served token's
reference logit lies below the reference's best logit there; the
number compared is the widest gap of the sample.

The program reads a full page frozen once its asynchronous freeze has
landed, some steps after the page filled, and that timing moves the
logits by more than rounding does (on glm4-9b by several logits). So
each position is scored under the freeze lags ``LAGS`` and its gap is
the smallest of them: the freezes landed at one of them, and a token
that none of them puts near the top was not produced by this model.

The control is the reference itself at fp8 in the program's place: the
token it puts first at each position is scored the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import served_logits

#: the freeze lags a served position is scored under (``model.py``): 0,
#: the synchronous freeze; 1, the asynchronous one landing at the poll
#: after its dispatch; 2 and 3, a solve that took a step or two longer
LAGS = (0, 1, 2, 3)
CONTROL_LAG = 1


def sample(done: list[dict], k: int, seed: int) -> list[dict]:
    """``k`` finished requests, the longest (prompt plus served tokens)
    first and the rest drawn from ``seed``."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-(len(r["prompt"])
                                          + len(r["served"])), r["id"]))
    rest = order[1:]
    rng = np.random.default_rng((seed, 7))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [order[0]] + [rest[i] for i in sorted(pick)]


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    best = logits.max(dim=-1).values
    return best - logits.gather(1, tokens[:, None])[:, 0]


def readings(weights: dict, dims: dict, requests: list[dict], *,
             block: int, num_values: int, device, lags=LAGS,
             control: str | None = None) -> dict:
    """``max_gap``, the widest gap of a served token (logit units), and
    the ``positions`` compared; with ``control``, ``control_max_gap``, the
    widest gap of the token the control (at lag ``CONTROL_LAG``) puts
    first."""
    worst = ctrl_worst = 0.0
    positions = 0
    kw = dict(block=block, num_values=num_values)
    for r in requests:
        served = torch.as_tensor(np.asarray(r["served"]), device=device)
        seq = torch.cat([torch.as_tensor(np.asarray(r["prompt"]),
                                         device=device), served[:-1]])
        P = len(r["prompt"])
        ref = served_logits(weights, dims, seq, P, lags=lags, **kw)

        def gap(tokens):
            return torch.stack([_gaps(lg, tokens)
                                for lg in ref.values()]).min(dim=0).values

        worst = max(worst, float(gap(served).max()))
        positions += int(served.shape[0])
        if control:
            low = served_logits(weights, dims, seq, P, lags=(CONTROL_LAG,),
                                lowp=control, **kw)[CONTROL_LAG]
            ctrl_worst = max(ctrl_worst, float(gap(low.argmax(-1)).max()))
            del low
        del ref
    out = {"max_gap": worst, "positions": positions}
    if control:
        out["control_max_gap"] = ctrl_worst
    return out
