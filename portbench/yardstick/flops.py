"""The H100's published peaks and the work the traffic needs, counted from
the requests' lengths and the configuration, never from what a kernel
happens to read or how often it is launched.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit), copied
from the program's ``device.py``: 989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3.

The model FLOPs follow the program's ``analysis/roofline.py:
model_params_active``/``model_flops`` (2 FLOPs a parameter a token to
infer, 6 to train) for a dense attention LM, with two differences: the
embedding lookup is no matmul and is not counted (the head is), and
attention's score and value products are added (4 H Dh FLOPs a layer for
every key a query reads, causal).
"""
from __future__ import annotations

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12

#: bytes of a frozen page's codebook entry (f32) and the codebook width
CODEBOOK_BYTES = 4
CODEBOOK_VALUES = 16
#: bytes of an fp (bf16) K/V element and of an activation element
FP_BYTES = 2


def projection_params(dims: dict) -> int:
    """Parameters of every layer's seven projections."""
    D, F, Dh = dims["d_model"], dims["d_ff"], dims["head_dim"]
    H, Hkv = dims["n_heads"], dims["n_kv_heads"]
    per_layer = D * (H + 2 * Hkv) * Dh + H * Dh * D + 3 * D * F
    return dims["n_layers"] * per_layer


def head_flops(dims: dict) -> float:
    """FLOPs of one token's logits: a (D, V) product."""
    return 2.0 * dims["d_model"] * dims["vocab"]


def attention_flops(dims: dict, first: int, last: int) -> float:
    """Score and value FLOPs of the queries at positions ``first`` ..
    ``last - 1``, each reading every key up to its own position."""
    keys = (last * (last + 1) - first * (first + 1)) // 2
    return 4.0 * dims["n_heads"] * dims["head_dim"] * dims["n_layers"] * keys


def serve_request_flops(dims: dict, prompt_len: int, n_out: int) -> float:
    """Model FLOPs of one served request: its prompt through the model
    and the head at its last position, then ``n_out - 1`` decode steps,
    each through the model and the head."""
    if n_out <= 0:
        return 0.0
    fed = prompt_len + n_out - 1
    return (2.0 * projection_params(dims) * fed
            + attention_flops(dims, 0, fed) + head_flops(dims) * n_out)


def train_step_flops(dims: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recomputation): 6 a parameter a token, the head at every position,
    and causal attention three times over."""
    tokens = batch * seq
    return (6.0 * (projection_params(dims) * tokens + dims["d_model"]
                   * dims["vocab"] * tokens)
            + 3.0 * batch * attention_flops(dims, 0, seq))


# ------------------------------------------------------- kernel 2 (qmm)

def qmm_bound(dims: dict, rows: int) -> float:
    """Least seconds of one model call's projections at ``rows`` rows:
    each layer's uint8 codes and its codebook read once, x read and the
    output written once in bf16, each launch bounded by the larger of its
    FLOPs at the bf16 peak and its bytes at the HBM rate (bytes below
    ~150 rows, FLOPs above)."""
    t = 0.0
    for K, N in _shapes(dims):
        t += max(2.0 * rows * K * N / PEAK_BF16,
                 (K * N + CODEBOOK_VALUES * CODEBOOK_BYTES
                  + FP_BYTES * rows * (K + N)) / HBM_BYTES_PER_S)
    return dims["n_layers"] * t


def _shapes(dims: dict) -> list[tuple[int, int]]:
    D, F, Dh = dims["d_model"], dims["d_ff"], dims["head_dim"]
    q, kv = dims["n_heads"] * Dh, dims["n_kv_heads"] * Dh
    return [(D, q), (D, kv), (D, kv), (q, D), (D, F), (D, F), (F, D)]


# ------------------------------------------------- kernel 1 (attention)

def pa_rows(dims: dict, block: int, context: int, queries: int,
            ) -> tuple[float, float]:
    """(FLOPs, bytes) a layer of ``queries`` query rows that end at
    ``context`` keys: every full page read as 4-bit codes plus its K and
    V codebooks, the rows past the last full page in bf16, the queries
    read and the outputs written in bf16. The queries attend causally."""
    H, Hkv, Dh = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
    full = context // block
    hot = context - full * block
    page = 2 * (block * Hkv * Dh // 2 + CODEBOOK_VALUES * CODEBOOK_BYTES)
    nbytes = (full * page + hot * 2 * Hkv * Dh * FP_BYTES
              + 2 * queries * H * Dh * FP_BYTES)
    first = context - queries
    keys = (context * (context + 1) - first * (first + 1)) // 2
    return 4.0 * H * Dh * keys, float(nbytes)


def pa_bound(flops: float, nbytes: float, layers: int) -> float:
    """Least seconds of ``layers`` launches of (``flops``, ``nbytes``)
    each: a decode step's are byte-bound, a long prefill chunk's
    FLOP-bound."""
    return layers * max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)
