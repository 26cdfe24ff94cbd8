"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the CUDA
kernels from this checkout (paged attention, the codebook-dequant matmul
and batched FISTA, one nvcc each, in parallel, beside the phases that
launch no kernel: ``train``, ``static-ssm``, ``static-families``,
``dist`` and ``dryrun``, which run first), holds each against its
plain PyTorch version, times it, checks the page-freeze solver on the card
against the CPU, then serves qwen3-0.6B (full width and depth, bf16,
seeded random weights) through continuous batching with chunked prefill:
with kmeans_ls@16 KV pages once from dense weights, and once, the main
path, from kmeans_ls@16 PTQ'd weights served as codes, with the launcher's
replay checks; then the same weights traced (phase ``trace``: the
launcher's ``--trace-out`` and ``--metrics-jsonl`` on the main path, and
the preempt, serve-spec and disagg-frozen flags traced, each trace
reconciled with the engine's counters); then the stacked qmatmul path
over the 28 layers' codes;
then the same PTQ'd weights with iter_l1@16 KV pages (every freeze's
solve, power iteration and 14-step lambda bisection, one launch of the
FISTA kernel's freeze entry), with the replay checks; then the same
weights with kmeans_ls@16 pages, speculative decoding (``--speculate 3``,
the half-depth draft: verify windows of 4 through the attention kernel)
and prefix sharing over a trace whose prompts share 192 tokens (prefills
start past spliced frozen pages), with its replays. Between those two,
the same weights and trace through the disaggregated engine (a prefill
worker with its own fp pool hands each prompt's pages to a decode worker
as fp rows; then two decode workers), fp page migration between pools of
different layer strides on its own (bitwise), the disaggregated engine
against the colocated one in f32, and the static engine (the reference
launcher's default: a fixed batch on the dense ring cache) against the
continuous one. After serve-disagg, phase ``serve-disagg-frozen`` serves
the trace through frozen migration (each prompt's pages solved on the
prefill worker's pool and crossing as codes + codebooks; kmeans_ls@16,
then iter_l1@16 through ``fista_freeze``), and phase ``overload``
demotes and restores the longest sequence at decode steps 3 and 7
(colocated and disagg frozen; tokens equal the uninterrupted run's),
serves the trace with ``--preempt --offload-pages`` and half the
requests best_effort, and with ``--admission slo``. Then a batched l1_ls
PTQ of the whole model in one FISTA launch, served for a few requests.
Then the other configs: glm4-9b at full width and depth from kmeans_ls@16
codes (its f32 replays on its first 8 layers), yi-34b and gemma2-27b at
full width with their depth cut to 4 layers; last, each count method
without a device solver (dp, tv_iter, mog, dtc, l0) as ``--kv-quant``
through the per-page host freeze, on full-width qwen3-0.6B pages. Then
the model families: granite-moe-3b-a800m (attention + MoE, 40 experts
top-8) at full width and depth through the continuous engine and the
attention kernel, on fp and on kmeans_ls@16 pages (phase
``serve-granite``), and phase ``static-families``: deepseek-v2-lite-16b
(MLA + MoE) at full width and depth and whisper-tiny (encoder-decoder)
on the static engine, qwen2-vl-72b (M-RoPE, the int8 ring cache) at full
width on 2 layers through the model facade, and the reduced configs
(those three, rwkv6 and jamba) on the card against the CPU. Phase
``static-ssm``: the state-space family on the static engine, rwkv6-3b at
full width and depth and jamba-1.5-large at full width on its first five
layers (every layer kind it has), and decode against forward in f32 at
full width (rwkv6-3b whole, jamba's first layer). Phase ``train``:
the training launcher on qwen3-0.6B at full width and depth (6 steps of
8 x 1024 tokens, checkpoints under build/train_ckpt/, removed after), a
Trainer's crash recovery against two clean runs (full width, 2 layers),
Adafactor with bf16 factored state on qwen2-vl-72b at full width on 2
layers, and the paper's MLP trained on the card against the CPU, its
last layer PTQ'd with kmeans_ls and recovered by QAT; no kernel
launches there. Phase ``dist``: 4 ranks sharing the card (one spawn; a
1 x 1 DeviceMesh on a one-rank NCCL group bitwise the one-device step,
the (2, 1) and (1, 2) meshes against one rank, the launcher at full
width and depth on 2 x 1 with its checkpoint restored at 1 x 1, the int8
cross-pod exchange of full grads against the CPU's, GPipe over 4 stages
against the sequential forward); no kernel launches there either.
Phase ``dryrun`` runs in a child process beside them (at the compilers'
nice 10; no card): qwen3-0.6B's train_4k and decode_32k cells on a fake
group of 256 ranks and granite's prefill_32k on 512
(``launch/dryrun.py``), then train (a)'s own step counted on one fake
device, whose roofline bound is held to the step the card measured.
The kernel phase also holds the attention kernel against its plain
version over head dims 8-256 and blocks of 1-128 keys, and times it at
glm4-9b's decode shape.
Before serving, the phase ``solvers`` runs the paper's twelve methods on
its data on the card against the CPU, the seven solvers this port added
last on a full-width projection served through the dequant kernel, and
kernel 4's page-solver and batch-solve options.
Before serving it runs the card tests (``pytest -m cuda
tests/test_torch_cuda.py``) in a child process.
Phase ``examples`` runs the port's five examples (``examples/torch_*.py``)
through their ``main()`` on the card: quickstart, train_lm (with a
crash recovered) and train_quantized_mlp beside the kernel build (no
kernel launches), serve_quantized and trace_serving after it (kernel 1
reads their frozen pages; the trace reconciles); then a count method
registered at run time (``uniform``: L evenly spaced levels, nearest
assignment, a torch device solver) freezes the pages of the reduced
qwen3 served with ``--kv-quant uniform@16`` on the fused engine, and its
fused-vs-gather replay is held to a limit.

    python3 chip_smoke.py
    python3 chip_smoke.py --ssm-readings   # static-ssm's readings alone
    python3 chip_smoke.py --mlp-readings   # train (d)'s readings alone
    python3 chip_smoke.py --dist           # phase dist alone
    python3 chip_smoke.py --dryrun         # phase dryrun's cells (no card)
    python3 chip_smoke.py --examples       # phase examples alone
    python3 chip_smoke.py --uniform-readings  # its replay's readings

Every phase prints its own line; any failure exits non-zero. The last line
is ``{"ok": true, "device": {...}}``; the line before it holds the card's
name and power limit, and the one before that the per-kernel JSON record.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100 SXM's peaks (HBM3 rate; f32 outside the tensor cores, bf16 on
# them), defined once for every roofline of the port
from repro_torch.device import (BF16_FLOPS, F32_FLOPS,  # noqa: E402
                                HBM_BYTES_PER_S, card_line)
from repro_torch.models.mlp import MLP_STEPS  # noqa: E402
# kernel vs plain version: f32 pools at the reference's bar
# (tests/test_kernels.py); bf16 pools: both compute in f32 and round the
# output once to bf16, so they differ by at most a bf16 ulp or two
F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -6)
# fused vs gather engine replays, in f32 on an f32 copy of the weights.
# fp pool: the two read paths differ only in summation order (~1e-7 per
# op); bf16 runs of this model showed its 28 layers amplify op-level
# differences ~100x, and 1e-3 of the logit range leaves 10x above that.
# kmeans_ls@16 pool: the solver's discrete cluster choices turn those
# differences in the pages it freezes into quantization-sized ones
# (0.11-0.18% of the range on the H100); 1% lies between them and what a
# fused path reading a wrong page's codebook gives (PERF.md).
# iter_l1@16 pool: the lambda bisection turns those differences into
# whole-codebook changes of a page row where the DP flips a few codes:
# 1.13-1.22% of the range on prompt seeds 0-2, 13.7% with the next page's
# K codebook planted in the fused kernel (tools/replay_readings.py on the
# H100, PERF.md); 4% lies between them.
REPLAY_REL_TOL = {None: 1e-3, "kmeans_ls@16": 0.01, "iter_l1@16": 0.04}
# The serve-spec replays' limits, from tools/replay_readings.py
# --speculate on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 17),
# prompt seeds 0-2 and a copy of src/ with one line planted. The
# speculative replays (auto and untied draft) are held to the launcher's
# SPEC_REL_TOL, beside its readings in serve.py.
# Fused vs gather of speculative engines, kmeans_ls@16, f32: sound
# 0.0384%, 0.0697%, 0.1656%; the kernel's window dropping its own key
# (valid - 1 for W > 1) 0.8669%, its greedy tokens unchanged (a random
# model's argmax is mostly its input token, by a wide margin).
SPEC_FVG_REL_TOL = 0.004
# Shared vs unshared prompt pages, fp pool, f32: sound 0 (bitwise) on
# seeds 0-2; a shared prefill reading its tokens from position 0 instead
# of the splice offset 95.99%, 16 of 56 tokens differ. The chunked
# replay's fp bar.
PREFIX_REPLAY_REL_TOL = 1e-4
# quant_matmul vs its plain version: f32 at the reference's bar
# (tests/test_kernels.py:32, 1e-4); bf16 as BF16_TOL (both sum exact
# products in f32 and round once to bf16)
QMM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: BF16_TOL}
SPIN_CYCLES = 4_000_000        # ~2 ms at the H100's 1.98 GHz boost clock

SHAPES = dict(Hq=16, Hkv=8, Dh=128, bs=16, L=16)   # qwen3-0.6B, block 16
SERVE_ARGS = ["--engine", "continuous", "--kv-quant", "kmeans_ls@16",
              "--prefill-chunk", "64", "--num-requests", "8",
              "--prompt-len", "256", "--gen", "32", "--max-slots", "4",
              "--block-size", "16", "--max-seq-len", "512",
              "--request-rate", "8", "--attn-impl", "auto", "--seed", "0"]
QUANT_ARGS = SERVE_ARGS + ["--quantize", "kmeans_ls@16"]
# argparse keeps a flag's last value
ITER_ARGS = QUANT_ARGS + ["--kv-quant", "iter_l1@16"]
# speculative decoding with the half-depth draft plus prefix sharing: 12
# of each 256-token prompt's 16 pages are shareable
SPEC_K = 3
SPEC_ARGS = QUANT_ARGS + ["--speculate", str(SPEC_K), "--draft-config",
                          "auto", "--prefix-cache", "--shared-prefix-len",
                          "192"]
# the main path's trace through the disaggregated engine: a prefill worker
# with an fp pool of its own hands each prompt's pages, as fp rows, to a
# decode worker (kmeans_ls@16 pages, the PTQ'd weights); without
# --prefill-chunk, which disagg refuses, so each prompt prefills whole
_CHUNK = QUANT_ARGS.index("--prefill-chunk")
DISAGG_ARGS = (QUANT_ARGS[:_CHUNK] + QUANT_ARGS[_CHUNK + 2:]
               + ["--engine", "disagg", "--prefill-workers", "1",
                  "--decode-workers", "1", "--migrate", "fp"])
# the same through frozen migration: each prompt's 16 full pages are solved
# on the prefill worker's (quantized) pool behind its prefill and cross as
# packed codes + codebooks, 16,512 B a page and layer against 65,536 B of
# bf16 rows (3.97x)
DISAGG_FROZEN_ARGS = DISAGG_ARGS + ["--migrate", "frozen"]
# overload. The forced restore (the longest sequence demoted at decode
# steps 3 and 7 and restored at once) runs with synchronous freezes and a
# freeze budget that covers every queued page, so in both runs each page
# freezes at the flush after it fills; a smaller budget re-queues a
# victim's deferred pages behind others' at restore, which changes when
# they freeze, not what the restore lands.
FORCED_STEPS = (3, 7)
FORCED_ARGS = ["--freeze-page-budget", "64"]
# the main path's trace with preemption: on seed 0, requests 3, 5 and 7 are
# best_effort, and request 4 (latency) arrives at 0.284 s into 4 full slots
PREEMPT_ARGS = QUANT_ARGS + ["--preempt", "--offload-pages",
                             "--best-effort-frac", "0.5"]
# SLO admission with an inter-token p99 target no step meets: best_effort
# arrivals shed once the policy's window holds 16 gaps (its min_samples),
# so the trace runs at 2 req/s (the best_effort requests 5 and 7 arrive at
# 1.95 and 2.66 s; at 8 req/s they come before 16 gaps can exist)
SLO_ARGS = QUANT_ARGS + ["--admission", "slo", "--itl-slo", "0.001",
                         "--best-effort-frac", "0.5", "--request-rate", "2"]
# disagg vs colocated on an fp pool, f32, the same deterministic batch
# (serve.disagg_replay): the pages cross unchanged, so only the decode
# batches' composition can move a logit. Readings (tools/replay_readings.py
# --disagg on the H100, NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0, bitwise,
# on prompt seeds 0-2; 4.6067% with the tail rows spliced one page off.
# The chunked replay's fp bar, 1e-4, lies between.
DISAGG_REL_TOL = 1e-4
# the static engine (the reference launcher's default): the main path's
# PTQ'd codes dequantized, 4 prompts of 64 tokens and 32 greedy steps on
# the dense ring cache; against the continuous engine on an fp pool in
# f32 at the chunked replay's fp bar (read 9.302e-07 of the range on the
# H100, PERF.md: the two differ in summation order only)
STATIC_ARGS = ["--engine", "static", "--quantize", "kmeans_ls@16",
               "--batch", "4", "--prompt-len", "64", "--gen", "32",
               "--seed", "0"]
STATIC_REL_TOL = 1e-4
# batched l1_ls PTQ of the whole model: lambda for the weighted objective
# (counts of up to 88M weights a group) that leaves every group <= 256
# values (uint8 codes); the short serve from its codes
PTQ_LAM = 20.0
PTQ_SPEC = f"l1_ls:lam={PTQ_LAM},weighted=true"
PTQB_ARGS = SERVE_ARGS + ["--num-requests", "4", "--gen", "16",
                          "--quantize", PTQ_SPEC]
# FISTA kernel vs plain version: the reference's bar (tests/test_kernels.py
# :67). On the preconditioned PTQ problems f32 FISTA after 1000 steps
# depends on summation order beyond that bar (two f32 plain versions
# already do on the CPU: tests/test_torch_fista.py), so there the kernel
# is held to the plain version's eq.-6 objective and to its distance from
# a float64 run, at the bounds that test holds the two plain versions to
FISTA_TOL = dict(atol=2e-4, rtol=1e-3)
FISTA_OBJ_RTOL = 1e-3
FISTA_F64_RATIO = 3.0
FISTA_OPS_PER_COL = 18         # f32 operations per column and step
POWER_OPS_PER_COL = 12         # the same per power iteration of a freeze
# the seven projections of a qwen3-0.6B layer as (K, N): q, k, v, o, gate,
# up, down
PROJ_SHAPES = [(1024, 2048), (1024, 1024), (1024, 1024), (2048, 1024),
               (1024, 3072), (1024, 3072), (3072, 1024)]


def ptxas_by_kernel(name: str) -> dict:
    """Registers and spills of each kernel in ``csrc/<name>.cu``'s build log
    (nvcc -Xptxas -v), by mangled entry name."""
    from repro_torch.kernels import build

    out, entry = {}, None
    log = build.library_path(name).with_suffix(".log").read_text()
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        elif entry and "spill" in ln:
            out[entry] = ln.strip()
        elif entry and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[entry] = f"{regs} registers, {out.get(entry, '')}"
            entry = None
    return out


def qmm_ptxas() -> dict:
    """quant_matmul_kernel's ptxas line per instantiation, as
    "<x dtype>/<code dtype>/<tensor copies or element loads>"."""
    names = {"13__nv_bfloat16": "bf16", "f": "f32", "h": "uint8",
             "i": "int32", "1": "tma", "0": "elementwise"}
    out = {}
    for entry, line in ptxas_by_kernel("quant_matmul").items():
        m = re.search(r"quant_matmul_kernelI(13__nv_bfloat16|f)([hi])Lb([01])E",
                      entry)
        if m:
            out["/".join(names[g] for g in m.groups())] = line
    return out


def qmm_plan(K: int, N: int, x_dtype, idx_dtype=torch.uint8, *, M: int = 4,
             G: int = 1, L: int = 16) -> dict:
    """The dequant kernel's launch plan for a (K, N) weight and the blocks
    it launches for (G, M, K) activations."""
    from repro_torch.kernels.quant_matmul import kernel_smem, plan

    pl = plan(K, N, L, x_dtype, idx_dtype)
    stages, smem = kernel_smem(pl, L, x_dtype, idx_dtype)
    return dict(splits=pl.splits, split_steps=pl.split_steps,
                stages=stages, cluster=list(pl.cluster), smem=smem,
                blocks=pl.blocks_per_row_tile * -(-M // 64) * G)


def plan_text(r: dict) -> str:
    return (f"S={r['splits']} x {r['split_steps']} steps, {r['stages']} "
            f"stages, cluster {tuple(r['cluster'])}, {r['smem']} B smem, "
            f"{r['blocks']} blocks")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


# ------------------------------------------------------------ kernel inputs


def make_pool(gen, *, valid, dtype, frozen_frac=0.5, mb=None, shapes=SHAPES,
              pool="packed"):
    """Pools, codes, codebooks and a block table for sequences of the given
    valid lengths (valid 0 = an idle slot parked on the null page with
    valid 1), at the head shape ``shapes``. About ``frozen_frac`` of the
    live pages are frozen; ``pool`` is "packed" (two codes a byte),
    "unpacked" or "fp" (no page served from codes)."""
    from repro_torch.kernels import pack4

    Hkv, Dh, bs, L = (shapes[k] for k in ("Hkv", "Dh", "bs", "L"))
    pages = [-(-max(v, 1) // bs) for v in valid]
    mb = mb or max(pages)
    nb = 1 + sum(p for p, v in zip(pages, valid) if v)
    dev = "cuda"
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    k_fp = rnd(nb, bs, Hkv, Dh).to(dtype)
    v_fp = rnd(nb, bs, Hkv, Dh).to(dtype)
    codes = torch.randint(0, L, (2, nb, bs, Hkv, Dh), generator=gen,
                          device=dev, dtype=torch.uint8)
    if pool == "packed":
        k_codes, v_codes = pack4(codes[0]), pack4(codes[1])
    else:
        k_codes, v_codes = codes[0].clone(), codes[1].clone()
    k_cb = torch.sort(rnd(nb, L), dim=1).values
    v_cb = torch.sort(rnd(nb, L), dim=1).values
    blk_q = torch.rand(nb, generator=gen, device=dev) < frozen_frac
    blk_q[0] = False
    table = torch.zeros((len(valid), mb), dtype=torch.int32)
    nxt = 1
    for b, (p, v) in enumerate(zip(pages, valid)):
        if v:
            table[b, :p] = torch.arange(nxt, nxt + p)
            nxt += p
    lens = torch.tensor([max(v, 1) for v in valid], dtype=torch.int32)
    return dict(k_fp=k_fp, v_fp=v_fp, k_codes=k_codes, v_codes=v_codes,
                k_cb=k_cb, v_cb=v_cb, blk_q=blk_q,
                block_table=table.to(dev), kv_valid_len=lens.to(dev),
                quantized=pool != "fp", packed=pool == "packed")


def pool_args(p):
    return (p["k_fp"], p["v_fp"], p["k_codes"], p["v_codes"], p["k_cb"],
            p["v_cb"], p["blk_q"], p["block_table"])


def kernel(q, p, valid=None, softcap=None):
    from repro_torch.kernels import paged_decode_attention

    return paged_decode_attention(
        q, *pool_args(p), p["kv_valid_len"] if valid is None else valid,
        softcap=softcap, quantized=p["quantized"], packed=p["packed"])


def plain(q, p, valid=None, softcap=None):
    from repro_torch.kernels import ref_paged_decode

    return ref_paged_decode(
        q, *pool_args(p), p["kv_valid_len"] if valid is None else valid,
        softcap=softcap, quantized=p["quantized"], packed=p["packed"])


def gather_sdpa(q, p):
    """The library yardstick: the gather read path (dense pages from the
    fp pool, where installed pages hold their reconstruction) plus
    torch's scaled_dot_product_attention. Timed only, never used by the
    port."""
    import torch.nn.functional as F

    t = p["block_table"].long()
    B, mb = t.shape
    bs, Hkv, Dh = p["k_fp"].shape[1:]
    k = p["k_fp"][t].reshape(B, mb * bs, Hkv, Dh).transpose(1, 2)
    v = p["v_fp"][t].reshape(B, mb * bs, Hkv, Dh).transpose(1, 2)
    W = q.shape[1]
    pos = torch.arange(mb * bs, device=q.device)
    valid = p["kv_valid_len"][:, None] - (W - 1 - torch.arange(
        W, device=q.device))[None]
    mask = pos[None, None] < valid[:, :, None]             # (B, W, S)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None], enable_gqa=True)


def time_ms(fn, *, reps=20, flush=None) -> float:
    """Median device time of ``fn``: CUDA events around each call, the L2
    flushed between calls (each layer finds its own pool cold). A spin
    kernel keeps the card busy while the host enqueues the events and the
    call, so the host's launch overhead is not counted as device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(p, q, out_bytes, keys) -> tuple[float, str]:
    """Least time for the call: bytes it must move (each live page once,
    as codes + codebooks when frozen, fp otherwise; q; the output; table
    and lengths) over HBM bandwidth, vs its operations at the card's peak
    for their types. QK^T multiplies q by K in the pool's dtype; P@V
    multiplies f32 probabilities by V in the pool's dtype. With bf16 pools
    both are priced at the bf16 tensor-core rate, one product per
    multiply-add: the least costly way of doing the work (the kernel runs
    P@V as two bf16 products, P's hi and lo halves, for f32 accuracy), so
    the bound stays a lower bound; with f32 pools both at the f32 rate.
    2 flops per multiply-add, per query head and live key (``keys`` counts
    (row, key) pairs)."""
    bs, Hkv, Dh = p["k_fp"].shape[1:]
    fp_page = 2 * bs * Hkv * Dh * p["k_fp"].element_size()
    code_page = 2 * (bs * Hkv * p["k_codes"].shape[-1]
                     + p["k_cb"].shape[1] * 4)
    table = p["block_table"].cpu().numpy()
    frozen = p["blk_q"].cpu().numpy()
    total = q.numel() * q.element_size() + out_bytes
    total += table.nbytes + p["kv_valid_len"].numel() * 4
    for b, v in enumerate(p["kv_valid_len"].cpu().numpy()):
        for j in range(-(-int(v) // bs)):
            page = table[b, j]
            total += 1 + (code_page if p["quantized"] and frozen[page]
                          else fp_page)
    t_bytes = total / HBM_BYTES_PER_S * 1e3
    flops = 2.0 * q.shape[-2] * Dh * keys            # each of QK^T, P@V
    bf16 = q.dtype == p["k_fp"].dtype == torch.bfloat16
    t_ops = 2 * flops / (BF16_FLOPS if bf16 else F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def model_ms(p, valid=None) -> float:
    """The K/V page reads of one call by the reference's bytes model
    (``modeled_hbm_bytes_per_token``, fused path) at HBM bandwidth."""
    from repro_torch.kernels import modeled_hbm_bytes_per_token

    valid = p["kv_valid_len"] if valid is None else valid
    B = valid.numel()
    per_seq = modeled_hbm_bytes_per_token(
        p["block_table"].cpu().numpy(), (valid - 1).cpu().numpy(),
        p["blk_q"].cpu().numpy(), block_size=SHAPES["bs"],
        n_kv_heads=SHAPES["Hkv"], head_dim=SHAPES["Dh"],
        num_values=SHAPES["L"], quantized=True, packed=True, path="fused",
        fp_bytes=p["k_fp"].element_size())
    return per_seq * B / HBM_BYTES_PER_S * 1e3


def live_keys(valid, W: int) -> int:
    """(query row, key) pairs the causal mask lets through."""
    return sum(max(int(v) - (W - 1 - w), 0) for v in valid for w in range(W))


def pa_plan(p, W: int, dtype, shapes=SHAPES) -> dict:
    """The attention kernel's launch plan for a call of W queries over the
    pool ``p``: keys a split, splits of the longest sequence, the blocks
    that compute a split and the blocks launched, shared memory a block
    (``shapes``: the head shape, qwen3-0.6B's by default)."""
    from repro_torch.kernels.paged_attention import kernel_smem, plan

    Hq, Hkv, Dh, bs, L = (shapes[k] for k in ("Hq", "Hkv", "Dh", "bs", "L"))
    pl = plan(bs, Dh, dtype)
    rows = W * Hq // Hkv
    tiles = -(-rows // pl.tile_rows)
    working = 0
    for v in p["kv_valid_len"].tolist():
        for t in range(tiles):      # the tile's longest row sees these keys
            last_w = (min((t + 1) * pl.tile_rows, rows) - 1) // (Hq // Hkv)
            n = max(0, v - (W - 1 - last_w))
            working += max(1, len(pl.split_ranges(n)))
    B = p["kv_valid_len"].numel()
    return dict(split_keys=pl.split_keys, tile_rows=pl.tile_rows,
                cluster=pl.cluster,
                splits=len(pl.split_ranges(max(p["kv_valid_len"].tolist()))),
                working_blocks=working * Hkv,
                blocks=pl.blocks(B, rows, Hkv),
                smem=kernel_smem(pl, bs, Dh, L, dtype))


def pa_plan_text(r: dict) -> str:
    return (f"{r['split_keys']} keys a split, {r['splits']} splits, "
            f"tiles of {r['tile_rows']} rows, cluster {r['cluster']}, "
            f"{r['working_blocks']} working of {r['blocks']} blocks, "
            f"{r['smem']} B smem")


def host_us(fn, *, calls=200, reps=25) -> tuple[float, float]:
    """The host's time of one call, in us: ``calls`` calls enqueued back to
    back after a sync (fewer than the launch queue holds, so none waits for
    the device), on the CPU clock; the median and the least of ``reps``
    (the least is the one other work on the host disturbed least)."""
    for _ in range(calls):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times)), float(np.min(times))


# ------------------------------------------------------------ phases


def check_kernel(gen) -> dict:
    """Kernel vs plain version at qwen3-0.6B shapes; bitwise identities;
    times at the serve path's shapes."""
    from repro_torch.kernels import paged_prefill_attention

    Hq, Dh = SHAPES["Hq"], SHAPES["Dh"]
    worst = 0.0
    # decode, W = 1, B = 8: ragged lengths 1..2048 and an idle slot
    valid = [2048, 1, 1500, 777, 33, 16, 0, 257]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        p = make_pool(gen, valid=valid, dtype=dtype)
        q = torch.randn(len(valid), Hq, Dh, generator=gen,
                        device="cuda").to(dtype)
        for softcap in (None, 30.0):
            got, ref = kernel(q, p, softcap=softcap), plain(q, p,
                                                             softcap=softcap)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(got.float(), ref.float(), **tol)
            if dtype == torch.float32:
                worst = max(worst, err)
            phase("kernel", f"decode B=8 valid 1..2048 {dtype} softcap="
                  f"{softcap}: max|err| {err:.3g} vs plain (atol "
                  f"{tol['atol']}, rtol {tol['rtol']:.3g}) OK")
    # prefill chunk W = C = 64 at q_offset 192, two sequences
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        p = make_pool(gen, valid=[256, 300], dtype=dtype)
        q = torch.randn(2, 64, Hq, Dh, generator=gen, device="cuda").to(dtype)
        off = torch.tensor([192, 236], dtype=torch.int32, device="cuda")
        got = paged_prefill_attention(q, *pool_args(p), off, quantized=True)
        ref = plain(q, p, valid=off + 64)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(got.float(), ref.float(), **tol)
        if dtype == torch.float32:
            worst = max(worst, err)
        phase("kernel", f"prefill chunk C=64 q_offset=(192, 236) {dtype}: "
              f"max|err| {err:.3g} vs plain OK")
    # bitwise: chunked prefill == whole prompt; a W-row window == W single
    # rows
    for dtype in (torch.float32, torch.bfloat16):
        p = make_pool(gen, valid=[256], dtype=dtype)
        q = torch.randn(1, 256, Hq, Dh, generator=gen,
                        device="cuda").to(dtype)
        zero = torch.zeros(1, dtype=torch.int32, device="cuda")
        whole = paged_prefill_attention(q, *pool_args(p), zero,
                                        quantized=True)
        chunks = torch.cat([paged_prefill_attention(
            q[:, o:o + 64], *pool_args(p), zero + o, quantized=True)
            for o in range(0, 256, 64)], dim=1)
        if not torch.equal(whole, chunks):
            raise AssertionError(f"chunked prefill != whole prompt ({dtype})")
        W = 4
        pw = make_pool(gen, valid=[700, 90, 5], dtype=dtype)
        qw = torch.randn(3, W, Hq, Dh, generator=gen, device="cuda").to(dtype)
        win = kernel(qw, pw)
        rows = torch.stack([kernel(qw[:, w], pw,
                                   valid=pw["kv_valid_len"] - (W - 1 - w))
                            for w in range(W)], dim=1)
        if not torch.equal(win, rows):
            raise AssertionError(f"W-row window != W single rows ({dtype})")
        phase("kernel", f"{dtype}: chunked prefill (4 x 64) == whole 256-"
              f"token prompt, and a W=4 window == 4 single-row calls: "
              f"bitwise")
    # timings at the serve path's shapes: a decode step of 4 slots
    # mid-generation (272 tokens each), and one 64-token prefill chunk at
    # offset 192 of a 256-token prompt
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    p = make_pool(gen, valid=[272, 272, 272, 272], dtype=torch.bfloat16)
    q = torch.randn(4, Hq, Dh, generator=gen, device="cuda").to(torch.bfloat16)
    ms = time_ms(lambda: kernel(q, p), flush=flush)
    plain_ms = time_ms(lambda: plain(q, p), flush=flush)
    lib_ms = time_ms(lambda: gather_sdpa(q[:, None], p), flush=flush)
    b_ms, b_by = bound(p, q, q.numel() * 2,
                       live_keys(p["kv_valid_len"].tolist(), 1))
    # the serve path's longest decode step: 4 slots at max_seq_len 512
    p5 = make_pool(gen, valid=[512, 512, 512, 512], dtype=torch.bfloat16)
    d512 = dict(ms=time_ms(lambda: kernel(q, p5), flush=flush),
                plain_ms=time_ms(lambda: plain(q, p5), flush=flush),
                library_ms=time_ms(lambda: gather_sdpa(q[:, None], p5),
                                   flush=flush))
    d512["bound_ms"], d512["bound_by"] = bound(
        p5, q, q.numel() * 2, live_keys(p5["kv_valid_len"].tolist(), 1))
    # the speculative verify window: 4 slots at 272 tokens, W = 4
    qv = torch.randn(4, 4, Hq, Dh, generator=gen,
                     device="cuda").to(torch.bfloat16)
    ver = dict(ms=time_ms(lambda: kernel(qv, p), flush=flush),
               plain_ms=time_ms(lambda: plain(qv, p), flush=flush),
               library_ms=time_ms(lambda: gather_sdpa(qv, p), flush=flush))
    ver["bound_ms"], ver["bound_by"] = bound(
        p, qv, qv.numel() * 2, live_keys(p["kv_valid_len"].tolist(), 4))
    pp = make_pool(gen, valid=[256], dtype=torch.bfloat16)
    qp = torch.randn(1, 64, Hq, Dh, generator=gen,
                     device="cuda").to(torch.bfloat16)
    off = torch.tensor([192], dtype=torch.int32, device="cuda")
    pre = lambda: paged_prefill_attention(qp, *pool_args(pp), off,
                                          quantized=True)
    pre_ms = time_ms(pre, flush=flush)
    pre_plain = time_ms(lambda: plain(qp, pp, valid=off + 64), flush=flush)
    pre_lib = time_ms(lambda: gather_sdpa(qp, pp), flush=flush)
    pb_ms, pb_by = bound(pp, qp, qp.numel() * 2, live_keys([256], 64))
    plans = {"decode": pa_plan(p, 1, torch.bfloat16),
             "decode_512": pa_plan(p5, 1, torch.bfloat16),
             "prefill": pa_plan(dict(kv_valid_len=off + 64), 64,
                                torch.bfloat16)}
    host = host_us(lambda: kernel(q, p))[1]
    ptxas = {}
    for k, v in ptxas_by_kernel("paged_attention").items():
        # <dtype>/Dh=<padded width>/<exact or general> per instantiation
        m = re.search(r"paged_attention_kernelI(13__nv_bfloat16|f)Li(\d+)"
                      r"ELb([01])E", k)
        if m:
            dt = "f32" if m.group(1) == "f" else "bf16"
            kind = "general" if m.group(3) == "1" else "exact"
            ptxas[f"{dt}/Dh={m.group(2)}/{kind}"] = v
    card = card_line()
    for name, r in plans.items():
        phase("kernel", f"plan {name}: {pa_plan_text(r)}")
    phase("kernel", "ptxas paged_attention_kernel: " + "; ".join(
        f"{k} {v}" for k, v in sorted(ptxas.items())))
    phase("kernel", f"decode B=4 x 272 tokens bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, gather+sdpa {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; bytes model {model_ms(p):.4f} ms) on "
          f"{card}")
    phase("kernel", f"decode B=4 x 512 tokens bf16: kernel "
          f"{d512['ms']:.4f} ms, plain {d512['plain_ms']:.4f} ms, "
          f"gather+sdpa {d512['library_ms']:.4f} ms, bound "
          f"{d512['bound_ms']:.4f} ms ({d512['bound_by']}) on {card}")
    phase("kernel", f"verify window B=4 x W=4 at 272 tokens bf16: kernel "
          f"{ver['ms']:.4f} ms, plain {ver['plain_ms']:.4f} ms, gather+sdpa "
          f"{ver['library_ms']:.4f} ms, bound {ver['bound_ms']:.5f} ms "
          f"({ver['bound_by']}) on {card}")
    phase("kernel", f"prefill chunk 64 @ 192 bf16: kernel {pre_ms:.4f} ms, "
          f"plain {pre_plain:.4f} ms, gather+sdpa {pre_lib:.4f} ms, bound "
          f"{pb_ms:.5f} ms ({pb_by}; bytes model "
          f"{model_ms(pp, off + 64):.4f} ms) on {card}")
    phase("kernel", f"wrapper host time, decode B=4 x 272: {host:.2f} us a "
          f"call (least of 25 x 200 calls) on {card}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, prefill_ms=pre_ms,
                prefill_plain_ms=pre_plain, prefill_bound_ms=pb_ms,
                prefill_bound_by=pb_by, prefill_library_ms=pre_lib,
                decode_512=d512, verify=ver, host_us_per_call=host,
                plan=plans,
                ptxas=ptxas)


# kernel 1 at the reference's shapes: every head_dim 1-256 (even when
# packed) and block 1-128 it takes, sampled so each of these appears
SWEEP_DH = (8, 16, 24, 40, 64, 80, 128, 192, 256)
SWEEP_BS = (1, 5, 8, 12, 16, 32, 64, 128)
# glm4-9b's attention at full width: 32 query heads over 2 kv heads
GLM4_SHAPES = dict(Hq=32, Hkv=2, Dh=128, bs=16, L=16)


def check_kernel_shapes(gen) -> dict:
    """Kernel 1 against its plain version over SWEEP_DH x SWEEP_BS
    (paired cyclically: every head_dim and every block size at least
    once), on fp, packed and unpacked (200-entry codebooks) pools: a
    decode step over ragged lengths and an idle slot, a W = 4 window, a
    64-token prefill chunk at offset 192; then decode timed at glm4-9b's
    full shape (B 4 x 272 tokens, Hq 32 over Hkv 2, Dh 128, bf16)."""
    from repro_torch.kernels import paged_prefill_attention

    worst, calls = 0.0, 0
    for i, Dh in enumerate(SWEEP_DH):
        bs = SWEEP_BS[i % len(SWEEP_BS)]
        for pool in ("fp", "packed", "unpacked"):
            shapes = dict(Hq=8, Hkv=2, Dh=Dh, bs=bs,
                          L=200 if pool == "unpacked" else 16)
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                p = make_pool(gen, valid=[1, 65, 300, 0], dtype=dtype,
                              shapes=shapes, pool=pool)
                pp = make_pool(gen, valid=[256], dtype=dtype, shapes=shapes,
                               pool=pool)
                off = torch.tensor([192], dtype=torch.int32, device="cuda")
                rnd = lambda *sh: torch.randn(*sh, generator=gen,
                                              device="cuda").to(dtype)
                q1, qw, qp = rnd(4, 8, Dh), rnd(4, 4, 8, Dh), rnd(1, 64, 8,
                                                                   Dh)
                pairs = [(kernel(q1, p, softcap=30.0),
                          plain(q1, p, softcap=30.0)),
                         (kernel(qw, p), plain(qw, p)),
                         (paged_prefill_attention(
                             qp, *pool_args(pp), off,
                             quantized=pp["quantized"],
                             packed=pp["packed"]),
                          plain(qp, pp, valid=off + 64))]
                torch.cuda.synchronize()
                for got, ref in pairs:
                    torch.testing.assert_close(got.float(), ref.float(),
                                               **tol)
                    if dtype == torch.float32:
                        worst = max(worst, (got.float() - ref.float())
                                    .abs().max().item())
                calls += len(pairs)
    phase("kernel", f"shape sweep: head_dim {SWEEP_DH} x block {SWEEP_BS} "
          f"(paired), fp/packed/unpacked pools, f32 and bf16, decode + W=4 "
          f"window + prefill chunk: {calls} calls == plain, worst f32 "
          f"max|err| {worst:.3g} (atol {F32_TOL['atol']})")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    p = make_pool(gen, valid=[272] * 4, dtype=torch.bfloat16,
                  shapes=GLM4_SHAPES)
    q = torch.randn(4, GLM4_SHAPES["Hq"], GLM4_SHAPES["Dh"], generator=gen,
                    device="cuda").to(torch.bfloat16)
    torch.testing.assert_close(kernel(q, p).float(), plain(q, p).float(),
                               **BF16_TOL)
    g = dict(ms=time_ms(lambda: kernel(q, p), flush=flush),
             plain_ms=time_ms(lambda: plain(q, p), flush=flush),
             library_ms=time_ms(lambda: gather_sdpa(q[:, None], p),
                                flush=flush))
    g["bound_ms"], g["bound_by"] = bound(p, q, q.numel() * 2,
                                         live_keys([272] * 4, 1))
    g["plan"] = pa_plan(p, 1, torch.bfloat16, shapes=GLM4_SHAPES)
    phase("kernel", f"plan glm4 decode: {pa_plan_text(g['plan'])}")
    phase("kernel", f"glm4-9b decode B=4 x 272 tokens (Hq 32 / Hkv 2, Dh "
          f"128) bf16: kernel {g['ms']:.4f} ms, plain {g['plain_ms']:.4f} "
          f"ms, gather+sdpa {g['library_ms']:.4f} ms, bound "
          f"{g['bound_ms']:.5f} ms ({g['bound_by']}) on {card_line()}")
    return dict(shape_sweep_max_abs_err=worst, shape_sweep_calls=calls,
                glm4_decode=g)


def qmm_inputs(gen, M, K, N, dtype, *, L=16, G=None,
               idx_dtype=torch.uint8):
    """Activations ~N(0, 1), codes uniform over L, an ascending codebook at
    the scale of a PTQ'd projection."""
    lead = () if G is None else (G,)
    x = torch.randn(*lead, M, K, generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, L, (*lead, K, N), generator=gen, device="cuda",
                        dtype=torch.int64).to(idx_dtype)
    cb = torch.sort(torch.randn(*lead, L, generator=gen, device="cuda"),
                    dim=-1).values / K ** 0.5
    return x, idx, cb


def qmm_bound(x, idx, cb) -> tuple[float, str]:
    """Least time for y = x @ cb[idx]: x, codes and codebook read once and
    the output written once at HBM bandwidth, vs 2*G*M*K*N operations at
    the card's peak for x's dtype (bf16 tensor cores or f32)."""
    G = x.shape[0] if x.dim() == 3 else 1
    M, K = x.shape[-2:]
    N = idx.shape[-1]
    nbytes = (x.numel() * x.element_size() + idx.numel() * idx.element_size()
              + cb.numel() * 4 + G * M * N * x.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
    t_ops = 2.0 * G * M * K * N / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_qmm(gen) -> dict:
    """Kernels 2 and 3 (quant_matmul, quant_matmul_stacked) vs their plain
    versions on the card: the main path's five projection shapes at M = 4
    (a decode step of 4 slots) and M = 64 (a prefill chunk), ragged
    (5, 33, 17), int32 codes with L = 1000 and 32768, stacked G = 4; bf16
    and f32. Rows bitwise independent of M. Each shape's launch plan and
    the kernel's registers; times at the main path's shapes."""
    from repro_torch.kernels import (quant_matmul, quant_matmul_stacked,
                                     ref_quant_matmul,
                                     ref_quant_matmul_stacked)

    worst = 0.0

    def hold(name, got, ref, dtype):
        nonlocal worst
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(got.float(), ref.float(), **QMM_TOL[dtype])
        if dtype == torch.float32:
            worst = max(worst, err)
        return f"{name}: max|err| {err:.3g}"

    for dtype in (torch.float32, torch.bfloat16):
        msgs = []
        for K, N in sorted(set(PROJ_SHAPES)):
            for M in (4, 64):
                x, idx, cb = qmm_inputs(gen, M, K, N, dtype)
                out = quant_matmul(x, idx, cb)
                msgs.append(hold(f"({M},{K},{N})", out,
                                 ref_quant_matmul(x, idx, cb), dtype))
                if M == 64:      # rows bitwise independent of M
                    for m in (1, 4):
                        for r0 in (0, 29, 64 - m):
                            if not torch.equal(
                                    quant_matmul(x[r0:r0 + m], idx, cb),
                                    out[r0:r0 + m]):
                                raise AssertionError(
                                    f"quant_matmul rows {r0}..{r0 + m} at "
                                    f"M={m} != the same rows at M=64 "
                                    f"({K}x{N}, {dtype})")
        x, idx, cb = qmm_inputs(gen, 5, 33, 17, dtype)
        msgs.append(hold("ragged (5,33,17)", quant_matmul(x, idx, cb),
                         ref_quant_matmul(x, idx, cb), dtype))
        for L in (1000, 32768):
            x, idx, cb = qmm_inputs(gen, 16, 1024, 1024, dtype, L=L,
                                    idx_dtype=torch.int32)
            msgs.append(hold(f"int32 codes L={L} (16,1024,1024)",
                             quant_matmul(x, idx, cb),
                             ref_quant_matmul(x, idx, cb), dtype))
        x, idx, cb = qmm_inputs(gen, 64, 1024, 1024, dtype, G=4)
        st = quant_matmul_stacked(x, idx, cb)
        msgs.append(hold("stacked G=4 (64,1024,1024)", st,
                         ref_quant_matmul_stacked(x, idx, cb), dtype))
        for g in range(4):
            if not torch.equal(st[g], quant_matmul(x[g], idx[g], cb[g])):
                raise AssertionError(f"stacked group {g} != flat ({dtype})")
        tol = QMM_TOL[dtype]
        phase("qmm", f"{dtype} vs plain (atol {tol['atol']}, rtol "
              f"{tol['rtol']:.3g}) OK: " + "; ".join(msgs))
        phase("qmm", f"{dtype}: rows of M=64 calls == the same rows at M=1 "
              f"and M=4, bitwise, at all five projection shapes; each "
              f"stacked group == the flat kernel, bitwise")
    # the gathered weight is rounded to bf16 before the product (the
    # reference's w_tile.astype(x.dtype)): with x = diag(v) every output is
    # one exact f32 product, so the kernel must give v * bf16(W) rounded to
    # bf16 bit for bit; the f32 codebook value in the product differs in
    # the last bit of most entries, within the tolerance above
    for L, idx_dtype in ((16, torch.uint8), (1000, torch.int32)):
        _, idx, cb = qmm_inputs(gen, 1, 1024, 1024, torch.bfloat16, L=L,
                                idx_dtype=idx_dtype)
        v = torch.randn(1024, generator=gen, device="cuda")
        x = torch.diag(v).to(torch.bfloat16)
        w = cb[idx.long()]
        vx = x.float().diagonal()[:, None]
        want = (vx * w.to(torch.bfloat16).float()).to(torch.bfloat16)
        miss = (want != (vx * w).to(torch.bfloat16)).float().mean().item()
        got = quant_matmul(x, idx, cb)
        bad = (got != want).sum().item()
        if bad:
            raise AssertionError(
                f"quant_matmul bf16 with x = diag(v), L={L}: {bad} outputs "
                f"!= v * bf16(codebook[idx]) (the gathered weight is not "
                f"rounded to bf16 before the product)")
        phase("qmm", f"bf16 x = diag(v) (1024,1024,1024), L={L}: every "
              f"output == v * bf16(codebook[idx]) bitwise (the unrounded "
              f"weight differs at {miss:.1%} of them)")
    # the launch plan of each projection shape (from K, N, L and the dtypes
    # alone) and the kernel's registers and spills
    ptxas = qmm_ptxas()
    for K, N in sorted(set(PROJ_SHAPES)):
        phase("qmm", f"plan ({K},{N}) bf16 L=16: " + "; ".join(
            f"M={M}: " + plan_text(qmm_plan(K, N, torch.bfloat16, M=M))
            for M in (4, 64)))
    phase("qmm", "ptxas: " + "; ".join(f"{k} {v}" for k, v in
                                       sorted(ptxas.items())))
    # times: the seven projections of one layer, bf16, at a decode step
    # (M = 4), a verify window of 4 slots x 4 rows (M = 16) and a prefill
    # chunk (M = 64)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    card = card_line()
    per_shape, tot = {}, {}
    for M in (4, 16, 64):
        for K, N in sorted(set(PROJ_SHAPES)):
            x, idx, cb = qmm_inputs(gen, M, K, N, torch.bfloat16)
            dense = cb[idx.long()].to(x.dtype)
            r = dict(ms=time_ms(lambda: quant_matmul(x, idx, cb),
                                flush=flush),
                     plain_ms=time_ms(lambda: ref_quant_matmul(x, idx, cb),
                                      flush=flush),
                     library_ms=time_ms(lambda: torch.matmul(x, dense),
                                        flush=flush))
            r["bound_ms"], r["bound_by"] = qmm_bound(x, idx, cb)
            r["plan"] = qmm_plan(K, N, torch.bfloat16, M=M)
            per_shape[(M, K, N)] = r
            phase("qmm", f"bf16 ({M},{K},{N}): kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, torch.matmul on the dense "
                  f"weight {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}) on {card}")
        tot[M] = {k: sum(per_shape[(M, K, N)][k] for K, N in PROJ_SHAPES)
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        phase("qmm", f"one layer's seven projections at M={M}, bf16: kernel "
              f"{tot[M]['ms']:.4f} ms, plain {tot[M]['plain_ms']:.4f} ms, "
              f"library {tot[M]['library_ms']:.4f} ms, bound "
              f"{tot[M]['bound_ms']:.5f} ms on {card}")
    by = {per_shape[(4, K, N)]["bound_by"] for K, N in PROJ_SHAPES}
    return dict(max_abs_err=worst, **tot[4],
                ptxas=ptxas["bf16/uint8/tma"],
                bound_by="bytes" if by == {"bytes"} else "operations",
                prefill_ms=tot[64]["ms"], prefill_plain_ms=tot[64]["plain_ms"],
                prefill_library_ms=tot[64]["library_ms"],
                prefill_bound_ms=tot[64]["bound_ms"],
                verify={k: tot[16][k] for k in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms")},
                shapes=[{"M": M, "K": K, "N": N, **r}
                        for (M, K, N), r in per_shape.items()])


def check_freeze(gen) -> None:
    """quantize_pages_device on the card == on the CPU for the same rows:
    one flush at the serve path's shape (2 x 28 layers x 4 pages of
    16 x 8 x 128 values)."""
    from repro_torch.kernels import quantize_pages_device

    E = SHAPES["bs"] * SHAPES["Hkv"] * SHAPES["Dh"]
    rows = torch.randn(2 * 28 * 4, E, generator=gen, device="cuda")
    rows[::3] *= torch.linspace(0.1, 3.0, E, device="cuda")   # skewed rows
    t0 = time.perf_counter()
    codes, cb = quantize_pages_device(rows, num_values=16)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c_cpu, cb_cpu = quantize_pages_device(rows.cpu(), num_values=16)
    mism = int((codes.cpu() != c_cpu).sum())
    if mism:
        raise AssertionError(f"page freeze: {mism} codes differ card vs CPU")
    torch.testing.assert_close(cb.cpu(), cb_cpu, atol=1e-5, rtol=0)
    phase("freeze", f"quantize_pages_device {tuple(rows.shape)} on the card "
          f"== CPU: codes equal, codebooks within 1e-5 "
          f"({dt * 1e3:.1f} ms on the card incl. first-call setup)")


def counting_launches(fn):
    """``fn()`` with every kernel's launch count set to 0 just before;
    returns (its result, launches by kernel and dense fallbacks, read just
    after)."""
    from repro_torch.kernels import (fista_freeze, fista_quant,
                                     paged_decode_attention, quant_matmul,
                                     quant_matmul_stacked)
    from repro_torch.quant import fallback_count

    kernels = (paged_decode_attention, quant_matmul, quant_matmul_stacked,
               fista_quant, fista_freeze)
    for k in kernels:
        k.launches = 0
    fb0 = fallback_count()
    out = fn()
    launches = {k.__name__: k.launches for k in kernels}
    launches["fallbacks"] = fallback_count() - fb0
    return out, launches


def serve_once(argv, params=None) -> tuple:
    """Serve SERVE_ARGS-style ``argv`` through the port's entry point
    (from ``params`` if given) with every launch count set to 0 just
    before; returns (summary, params, cfg, args, launches by kernel) read
    just after."""
    from repro_torch.launch import serve

    args = serve.parse_args(argv)
    (s, params, cfg), launches = counting_launches(
        lambda: serve.serve(args, params))
    return s, params, cfg, args, launches


def check_launches(s, cfg, launches, quantized: bool, *, fista: bool = False,
                   requests: int = 8, spec: int = 0,
                   host: bool = False, frozen: bool = True) -> str:
    """Paged attention: full-context layers x (decode steps + prefill
    chunks) (a local-window layer reads by gather); the dequant matmul: 7
    projections x layers x that from codes, 0 from dense weights. On the
    disaggregated engine (a summary with ``prefills_done``) the prefill
    workers' whole-prompt prefills read their own pools by gather (no
    attention launch) and each runs every projection once: the dequant
    matmul adds 7 x layers x prefills. FISTA:
    one launch of its freeze entry per freeze dispatch on an iter_l1 pool
    (and per frozen migration's solve on a prefill worker,
    ``migrate_solves``), else 0, and none of its fista_quant entry; no
    stacked launch and no
    dense fallback on the serving path. With ``spec`` = k, a decode step
    is one verify window of the target (the same launches), and the draft
    (gather path: no attention launch) makes one call per request's
    attach and k per decode step, each 7 dequant launches a draft layer
    from the target's codes. The per-page host freeze solves rows only on
    a ``host`` method's pool (``host_page_solves`` > 0 there, 0 on every
    device method's). An fp pool (``frozen=False``) freezes nothing."""
    from repro_torch.launch.serve import full_context_layers

    steps = s["decode_steps"] + s["prefill_chunks"]
    prefills = s.get("prefills_done", 0)
    fc = full_context_layers(cfg)
    draft_calls = 0
    if spec:
        draft_calls = s["draft_prefills"] + s["draft_steps"]
        if s["draft_steps"] != spec * s["decode_steps"] \
                or s["draft_prefills"] != requests:
            raise AssertionError(
                f"serve: {s['draft_steps']} draft windows for "
                f"{s['decode_steps']} verify steps (want {spec} each), "
                f"{s['draft_prefills']} draft prefills for {requests} "
                f"requests")
    draft_mm = 7 * s.get("draft_layers", 0) * draft_calls
    expect = {"paged_decode_attention": fc * steps,
              "quant_matmul": (7 * cfg.n_layers * (steps + prefills)
                               + draft_mm if quantized else 0),
              "quant_matmul_stacked": 0,
              "fista_quant": 0,
              "fista_freeze": (s["freeze_dispatches"]
                               + s.get("migrate_solves", 0)) if fista else 0,
              "fallbacks": 0}
    if s["completed"] != requests \
            or (s["freeze_installs"] > 0) != frozen \
            or (s["freeze_dispatches"] > 0) != frozen \
            or (s["host_page_solves"] > 0) != host:
        raise AssertionError(f"serve: completed {s['completed']}/{requests}"
                             f", {s['freeze_dispatches']} freeze dispatches"
                             f", {s['freeze_installs']} installs, "
                             f"{s['host_page_solves']} host page solves")
    if s["attn_impl"] != "fused" or launches != expect \
            or s["paged_attention_launches"] != expect[
                "paged_decode_attention"] \
            or s["quant_matmul_launches"] != expect["quant_matmul"] \
            or s["qmatmul_dequant_fallback"] != 0:
        raise AssertionError(f"serve: launches {launches} (summary: "
                             f"{s['paged_attention_launches']} paged, "
                             f"{s['quant_matmul_launches']} quant_matmul, "
                             f"{s['qmatmul_dequant_fallback']} fallbacks), "
                             f"expected {expect}")
    return (f"{expect['paged_decode_attention']} paged-attention launches = "
            f"{fc} full-context layers x ({s['decode_steps']} "
            + ("verify steps" if spec else "decode steps")
            + f" + {s['prefill_chunks']} prefill chunks); "
            f"{expect['quant_matmul']} quant_matmul launches"
            + (" = 7 x that" if quantized and not prefills else "")
            + (f" = 7 x {cfg.n_layers} layers x ({s['decode_steps']} decode "
               f"steps + {prefills} whole-prompt prefills on the prefill "
               f"workers, which read by gather)" if quantized and prefills
               else "")
            + (f" + 7 x {s.get('draft_layers', 0)} draft layers x "
               f"({s['draft_prefills']} draft prefills + "
               f"{s['draft_steps']} draft windows)" if spec else "")
            + f"; {expect['fista_freeze']} fista_freeze launches"
            + (f" = 1 x ({s['freeze_dispatches']} freeze dispatches + "
               f"{s.get('migrate_solves', 0)} prefill-side migration "
               f"solves)" if fista else "") + "; 0 fista_quant launches"
            + f"; qmatmul_dequant_fallback=0; {s['freeze_installs']} freeze "
            f"installs; {s['host_page_solves']} host page solves")


def serve_line(s) -> str:
    return (f"TTFT mean {s['ttft_mean_s'] * 1e3:.1f} ms p99 "
            f"{s['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50 "
            f"{s['tpot_p50_s'] * 1e3:.2f} ms p99 {s['tpot_p99_s'] * 1e3:.2f} "
            f"ms, {s['throughput_tok_s']:.1f} gen tok/s on {card_line()}")


def check_serve_fp() -> None:
    """Slice 1's path: the same trace from dense bf16 weights (full width
    and depth); its replays run on the main path below."""
    s, _, cfg, _, launches = serve_once(SERVE_ARGS)
    phase("serve-fp", check_launches(s, cfg, launches, quantized=False))
    phase("serve-fp", serve_line(s))


def check_serve() -> dict:
    """The main path: PTQ every projection to kmeans_ls@16 on the card,
    serve the trace from the codes, run the launcher's replay checks, the
    fused-vs-gather replay and the profile."""
    from repro_torch.launch import serve

    s, params, cfg, args, launches = serve_once(QUANT_ARGS)
    ptq = s["ptq"]
    if ptq["tensors"] != 7 * cfg.n_layers:
        raise AssertionError(f"PTQ quantized {ptq['tensors']} tensors, "
                             f"expected 7 x {cfg.n_layers}")
    phase("serve", f"PTQ kmeans_ls@16: {ptq['tensors']} projections in "
          f"{ptq['time_s']:.1f} s on the card, {ptq['compression']:.2f}x "
          f"smaller than bf16")
    phase("serve", check_launches(s, cfg, launches, quantized=True))
    serve.verify(params, cfg, args)      # the launcher's replay checks
    check_fused_vs_gather(params, cfg, args, (None, "kmeans_ls@16"))
    profile_engine(params, cfg, args)
    phase("serve", serve_line(s))
    return dict(launches=launches, params=params, cfg=cfg, summary=s)


# the page-freeze lifecycle's terminal states (analysis/spans.py)
FREEZE_STATES = {"installed", "dropped", "rolled_back", "offloaded"}
# observability on the main path: the trace, the metrics JSONL every
# 0.1 s and its Prometheus file, under build/ (git-ignored)
TRACE_DIR = os.path.join(HERE, "build", "trace")
METRICS_JSONL = os.path.join(TRACE_DIR, "main.jsonl")
TRACE_ARGS = QUANT_ARGS + ["--metrics-jsonl", METRICS_JSONL,
                           "--metrics-interval", "0.1"]


def strict_constant(c):
    raise AssertionError(f"a metrics line holds {c}: not strict JSON")


def trace_events(trace: dict, name: str, ph: str) -> list[dict]:
    from repro_torch.obs import select_events

    return select_events(trace["traceEvents"], name=name, ph=ph)


def trace_tracks(trace: dict) -> set[str]:
    return {e["args"]["name"] for e in trace["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}


def span_ms(trace: dict, track: str, name: str) -> list[float]:
    """Durations (ms, host clock) of the complete spans ``name`` on
    ``track``."""
    tid = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
           if e["ph"] == "M" and e["name"] == "thread_name"}[track]
    return [e["dur"] / 1e3 for e in trace["traceEvents"]
            if e["ph"] == "X" and e["name"] == name and e["tid"] == tid]


def span_breakdown(trace: dict) -> str:
    """Mean and total host time of the decode step and its phases, the
    freeze flushes and the prefill chunks."""
    parts = []
    for track, name in (("decode/w0", "decode_step"), ("decode/w0",
                        "dispatch"), ("decode/w0", "sync"),
                        ("decode/w0", "commit"), ("freeze/w0", "flush"),
                        ("prefill/w0", "prefill_chunk")):
        d = span_ms(trace, track, name)
        if d:
            parts.append(f"{name} {sum(d) / len(d):.3f} ms x {len(d)} = "
                         f"{sum(d):.1f} ms")
    return "; ".join(parts)


def serve_traced(argv, params, tag: str) -> tuple:
    """``serve_once(argv + --trace-out build/trace/<tag>.json, params)``,
    its output echoed; fails unless the launcher printed "reconciled"
    (its trace's counts equal the engine's counters). Returns (summary,
    cfg, args, launches, the trace)."""
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{tag}.json")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            s, _, cfg, args, launches = serve_once(
                argv + ["--trace-out", path], params)
    finally:
        sys.stdout.write(buf.getvalue())
    if "-> reconciled" not in buf.getvalue():
        raise AssertionError(f"trace {tag}: the launcher did not print "
                             f"reconciled")
    with open(path) as f:
        return s, cfg, args, launches, json.load(f)


def freeze_span_line(trace: dict) -> str:
    """Every page_freeze span opened ends once, in a declared state."""
    begins = {e["id"] for e in trace_events(trace, "page_freeze", "b")}
    ends: dict = {}
    for e in trace_events(trace, "page_freeze", "e"):
        if e["id"] in ends:
            raise AssertionError(f"page_freeze span {e['id']} ended twice")
        ends[e["id"]] = e["args"]["state"]
    bad = set(ends.values()) - FREEZE_STATES
    if set(ends) != begins or bad:
        raise AssertionError(f"page_freeze spans: {len(begins)} opened, "
                             f"{len(ends)} ended, states {bad or ''}")
    counts = {st: list(ends.values()).count(st) for st in sorted(
        set(ends.values()))}
    return (f"{len(begins)} page_freeze spans, each ended once ("
            + ", ".join(f"{k} {v}" for k, v in counts.items()) + ")")


def check_trace(params, cfg) -> dict:
    """The phase ``trace``: the launcher's --trace-out and --metrics-jsonl
    on the main path's weights at full width and depth. (a) the main
    path's flags: tracks router, decode/w0 and freeze/w0, every
    page_freeze span ended once in a declared state, >= 2 strict-JSON
    metrics lines whose last has 8 completed and 256 tokens and the
    hbm_bytes_per_token gauge set, the .prom file; TPOT p50 beside an
    untraced run of the same flags (no gate). (b) the overload phase's
    preempt trace: page_offload begins == ends == restored ends ==
    offloaded_pages == restored_pages. (c) serve-spec's flags: accept ==
    spec_steps, rollback == spec_rollbacks, prefix_match == prefix_hits.
    (d) disagg with frozen migration: tracks router, prefill/w0,
    decode/w0, transfer, and every extract frozen. Every run reconciles
    and keeps its launch gates. Returns (a)'s launches."""
    name = "trace"
    t0 = time.perf_counter()
    # traced first, then untraced: the runs of one call in the other
    # order read the traced TPOT 5-7% above the untraced one (PERF.md)
    s, cfg, args, launches, trace = serve_traced(TRACE_ARGS, params, "main")
    plain, *_ = serve_once(QUANT_ARGS, params)
    phase(name, "(a) " + check_launches(s, cfg, launches, quantized=True))
    want = {"router", "decode/w0", "freeze/w0"}
    if not want <= trace_tracks(trace):
        raise AssertionError(f"(a) tracks {sorted(trace_tracks(trace))}")
    spans = freeze_span_line(trace)
    with open(METRICS_JSONL) as f:
        rows = [json.loads(ln, parse_constant=strict_constant)
                for ln in f.read().splitlines()]
    last = rows[-1] if rows else {}
    gauge = last.get("hbm_bytes_per_token", {})
    prom = METRICS_JSONL + ".prom"
    if len(rows) < 2 or last.get("completed") != args.num_requests \
            or last.get("gen_tokens") != args.num_requests * args.gen \
            or not gauge.get("n") or not os.path.isfile(prom):
        raise AssertionError(f"(a) metrics: {len(rows)} lines, last "
                             f"completed {last.get('completed')}, gen_tokens "
                             f"{last.get('gen_tokens')}, hbm gauge {gauge}, "
                             f".prom {os.path.isfile(prom)}")
    phase(name, f"(a) reconciled: {len(trace['traceEvents'])} events on "
          f"tracks {sorted(trace_tracks(trace))}; {spans}; "
          f"{len(trace_events(trace, 'decode_step', 'X'))} decode_step, "
          f"{len(trace_events(trace, 'prefill_chunk', 'X'))} prefill_chunk "
          f"and {len(trace_events(trace, 'flush', 'X'))} flush spans; "
          f"{len(rows)} strict-JSON metrics lines (last: {last['completed']}"
          f" completed, {last['gen_tokens']} tokens), hbm_bytes_per_token "
          f"gauge {gauge['n']} samples, last {gauge['last']:.0f} B "
          f"(t_memory {last['t_memory_s']['last'] * 1e6:.3f} us at "
          f"{HBM_BYTES_PER_S:.3g} B/s), {os.path.basename(prom)} written")
    phase(name, f"(a) host-clock spans (the enqueue on the card; sync "
          f"absorbs the device time queued before it): "
          f"{span_breakdown(trace)}; makespan {s['makespan_s'] * 1e3:.1f} ms")
    phase(name, f"(a) TPOT p50 traced {s['tpot_p50_s'] * 1e3:.2f} ms, "
          f"untraced {plain['tpot_p50_s'] * 1e3:.2f} ms (one run each, no "
          f"gate); traced {serve_line(s)}")
    sb, cfg, _, lb, tb = serve_traced(PREEMPT_ARGS, params, "preempt")
    check_launches(sb, cfg, lb, quantized=True)
    ob = len(trace_events(tb, "page_offload", "b"))
    oe = trace_events(tb, "page_offload", "e")
    restored = sum(e["args"]["state"] == "restored" for e in oe)
    if sb["preemptions"] < 1 or not (ob == len(oe) == restored
                                     == sb["offloaded_pages"]
                                     == sb["restored_pages"]):
        raise AssertionError(f"(b) page_offload {ob} begins, {len(oe)} "
                             f"ends, {restored} restored; counters "
                             f"{sb['offloaded_pages']} offloaded, "
                             f"{sb['restored_pages']} restored")
    phase(name, f"(b) preempt trace reconciled: {sb['preemptions']} "
          f"preemptions; page_offload {ob} begins == {len(oe)} ends == "
          f"{restored} restored == offloaded_pages == restored_pages; "
          f"{freeze_span_line(tb)}")
    sc, cfg, _, lc, tc = serve_traced(SPEC_ARGS, params, "spec")
    check_launches(sc, cfg, lc, quantized=True, spec=SPEC_K)
    n_acc = len(trace_events(tc, "accept", "i"))
    n_rb = len(trace_events(tc, "rollback", "i"))
    n_pm = len(trace_events(tc, "prefix_match", "X"))
    if n_acc != sc["spec_steps"] or n_rb != sc["spec_rollbacks"] \
            or n_pm != sc["prefix_hits"] or n_pm < 1:
        raise AssertionError(f"(c) accept {n_acc} / {sc['spec_steps']}, "
                             f"rollback {n_rb} / {sc['spec_rollbacks']}, "
                             f"prefix_match {n_pm} / {sc['prefix_hits']}")
    phase(name, f"(c) serve-spec trace reconciled: accept {n_acc} == "
          f"spec_steps, rollback {n_rb} == spec_rollbacks, prefix_match "
          f"{n_pm} == prefix_hits; {freeze_span_line(tc)}")
    sd, cfg, _, ld, td = serve_traced(DISAGG_FROZEN_ARGS, params, "disagg")
    check_launches(sd, cfg, ld, quantized=True)
    want = {"router", "prefill/w0", "decode/w0", "transfer"}
    ex = trace_events(td, "extract", "X")
    if not want <= trace_tracks(td) or len(ex) != sd["prefills_done"] \
            or any(e["args"]["mode"] != "frozen" for e in ex):
        raise AssertionError(f"(d) tracks {sorted(trace_tracks(td))}, "
                             f"extract modes "
                             f"{[e['args']['mode'] for e in ex]}")
    phase(name, f"(d) disagg frozen trace reconciled: tracks "
          f"{sorted(trace_tracks(td))}, {len(ex)} extract spans, all "
          f"frozen; {freeze_span_line(td)}")
    phase(name, f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, tpot_p50_ms=s["tpot_p50_s"] * 1e3,
                untraced_tpot_p50_ms=plain["tpot_p50_s"] * 1e3)


def check_stacked_path(params, cfg, gen) -> dict:
    """qmatmul's stacked branch over the served model's codes: the 28
    layers' w_gate stacked (codebooks (28, 16), codes (28, 1024*3072)),
    one decode step's activations per layer (28, 4, 1024) bf16, then one
    layer's (4, 1024) with no group axis. One stacked launch each, no
    dense fallback, each group bitwise the flat kernel on that layer's
    codes, the first held against the plain version."""
    from repro_torch.core import stack_quantized
    from repro_torch.kernels import (quant_matmul, quant_matmul_stacked,
                                     ref_quant_matmul_stacked)
    from repro_torch.quant import fallback_count, qmatmul

    ws = [layer["ffn"]["w_gate"] for layer in params["layers"]]
    st = stack_quantized(ws)
    G, (K, N) = len(ws), st.shape
    x = torch.randn(G, 4, K, generator=gen, device="cuda").to(torch.bfloat16)
    fb0 = fallback_count()
    quant_matmul_stacked.launches = 0
    y = qmatmul(x, st)
    launches = quant_matmul_stacked.launches
    if launches != 1 or fallback_count() != fb0:
        raise AssertionError(f"stacked qmatmul: {launches} stacked launches, "
                             f"{fallback_count() - fb0} fallbacks")
    idx = st.indices.reshape(G, K, N)
    # one decode step's x without the group axis: x @ W[g] for every layer,
    # x copied to each group, again one stacked launch and no fallback
    yb = qmatmul(x[0], st)
    if quant_matmul_stacked.launches != 2 or fallback_count() != fb0:
        raise AssertionError("qmatmul with no group axis: "
                             f"{quant_matmul_stacked.launches - 1} stacked "
                             f"launches, {fallback_count() - fb0} fallbacks")
    for g in range(G):
        if not torch.equal(yb[g], quant_matmul(x[0], idx[g], st.codebook[g])):
            raise AssertionError(f"broadcast stacked group {g} != the flat "
                                 f"kernel")
    launches = quant_matmul_stacked.launches
    ref = ref_quant_matmul_stacked(x, idx, st.codebook)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(y.float(), ref.float(), **BF16_TOL)
    for g in range(G):
        if not torch.equal(y[g], quant_matmul(x[g], idx[g], st.codebook[g])):
            raise AssertionError(f"stacked group {g} != the flat kernel")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    dense = torch.take_along_dim(st.codebook, st.indices.long(), dim=1
                                 ).reshape(G, K, N).to(x.dtype)
    r = dict(ms=time_ms(lambda: quant_matmul_stacked(x, idx, st.codebook),
                        flush=flush),
             plain_ms=time_ms(lambda: ref_quant_matmul_stacked(
                 x, idx, st.codebook), flush=flush),
             library_ms=time_ms(lambda: torch.bmm(x, dense), flush=flush))
    r["bound_ms"], r["bound_by"] = qmm_bound(x, idx, st.codebook)
    r["plan"] = qmm_plan(K, N, x.dtype, idx.dtype, M=4, G=G,
                         L=st.codebook.shape[1])
    phase("stacked", f"plan ({K},{N}) G={G} M=4: {plan_text(r['plan'])}")
    phase("stacked", f"qmatmul over {G} stacked w_gate codes, x ({G},4,{K}) "
          f"and x (4,{K}) bf16: 1 stacked launch each, 0 fallbacks, max|err| "
          f"{err:.3g} vs plain (bf16 tolerance), each group == the flat "
          f"kernel bitwise")
    phase("stacked", f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
          f" torch.bmm on the dense weights {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.5f} ms ({r['bound_by']}) on {card_line()}")
    return dict(launches=launches, max_abs_err=err, **r)


def fused_vs_gather(params, cfg, args, kv) -> dict:
    """The fused engine and the gather engine on one deterministic batch
    (synchronous freezing), full width and depth in f32 (``params`` and
    ``cfg`` already f32), on a ``kv`` pool (None: fp): the deviation of
    ``compare_replays`` plus whether the greedy tokens are equal."""
    from repro_torch.launch import serve

    prompts = serve._replay_prompts(cfg, args)
    runs = []
    for impl in ("fused", "gather"):
        eng = serve._make_engine(params, cfg, args, kv_quant=kv,
                                 record_logits=True, freeze_async=False,
                                 attn_impl=impl)
        runs.append((eng, eng.generate(prompts, max_new_tokens=args.gen)))
    (fe, fo), (ge, go) = runs
    r = serve.compare_replays(fe, ge, fo, go)
    r["tokens_equal"] = fo == go
    return r


def check_fused_vs_gather(params, cfg, args, kvs, name="serve",
                          tols=None) -> None:
    """``fused_vs_gather`` on each pool of ``kvs`` (speculative engines
    when ``args.speculate``): same greedy tokens, logits within ``tols``
    (default REPLAY_REL_TOL) of the logit range."""
    from repro_torch.launch import serve

    params, cfg = serve.f32_copy(params, cfg)
    for kv in kvs:
        tol = (tols or REPLAY_REL_TOL)[kv]
        r = fused_vs_gather(params, cfg, args, kv)
        if not r["tokens_equal"] or r["rel"] > tol:
            raise AssertionError(
                f"fused vs gather (kv={kv or 'fp'}): tokens "
                f"{r['agree']}/{r['total']}, max|dlogit| {r['dmax']:.4g} "
                f"rel {r['rel']:.4%} (tolerance {tol:.2%})")
        phase(name, f"fused vs gather replay (f32, kv={kv or 'fp'}"
              + (f", speculate={args.speculate}" if args.speculate else "")
              + "): "
              f"greedy tokens {r['agree']}/{r['total']} equal, max|dlogit| "
              f"{r['dmax']:.4g} rel {r['rel']:.4%} (tolerance {tol:.2%})")


def profile_engine(params, cfg, args) -> None:
    """Where a served batch's time goes: torch.profiler over one
    generate() of 4 prompts x 256 tokens, 16 new tokens each (after a
    warm-up run). Prints the device's busy share of the window (union of
    kernel intervals over the host-timed window) and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 256).tolist() for _ in range(4)]

    def once():
        eng = serve._make_engine(params, cfg, args, kv_quant=args.kv_quant)
        eng.generate(prompts, max_new_tokens=16)
        return eng

    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng = once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + (b - a))
    if not spans:
        phase("profile", "not measured: the profiler saw no device events")
        return
    spans.sort()
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    steps = eng.counters["decode_steps"] + eng.prefill.counters[
        "prefill_chunks"]
    phase("profile", f"{steps} engine steps in {wall_us / 1e3:.1f} ms: device "
          f"busy {busy / 1e3:.1f} ms ({busy / wall_us:.1%}), idle "
          f"{1 - busy / wall_us:.1%}; {len(spans)} kernels")
    for name, (n, t) in top:
        phase("profile", f"  {t / 1e3:8.2f} ms  {n:6d}x  {name[:90]}")
    for kname in ("paged_attention_kernel", "quant_matmul_kernel"):
        n = sum(c for k, (c, _) in by_name.items() if kname in k)
        t = sum(v for k, (_, v) in by_name.items() if kname in k)
        phase("profile", f"{kname}: {t / 1e3:.2f} ms over {n} launches, "
              f"{t / busy:.1%} of the device's busy time")


def fista_bound(args, n_iters) -> tuple[float, str]:
    """Least time for ``n_iters`` FISTA steps: FISTA_OPS_PER_COL f32
    operations per live column (n > 0) and step at the f32 peak, vs w, d,
    n, lam read and alpha written once (and eta) at HBM bandwidth."""
    w = args[0]
    live = int((args[2] > 0).sum())
    t_ops = FISTA_OPS_PER_COL * live * n_iters / F32_FLOPS * 1e3
    t_bytes = (5 * w.numel() * 4 + args[4].numel() * 4) / HBM_BYTES_PER_S \
        * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def freeze_bound(w, n) -> tuple[float, str]:
    """Least time for a freeze's solve: per live column, POWER_ITERS power
    iterations and BISECT_STEPS x FISTA_ITERS FISTA steps at the f32 peak,
    vs w, d, n, x0 read and best, eta, lam_hi written once."""
    from repro_torch.kernels.fista_quant import (BISECT_STEPS, FISTA_ITERS,
                                                 POWER_ITERS)

    live = int((n > 0).sum())
    t_ops = live * (POWER_ITERS * POWER_OPS_PER_COL + BISECT_STEPS
                    * FISTA_ITERS * FISTA_OPS_PER_COL) / F32_FLOPS * 1e3
    t_bytes = (4 * w.numel() + w.shape[1] + 2 * w.shape[0]) * 4 \
        / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fista_objective(args, alpha) -> torch.Tensor:
    """Eq. 6 per row in float64 on the kernel's (preconditioned) inputs:
    0.5 * sum n (w - cumsum(alpha d))^2 + sum lam |alpha|."""
    B = alpha.shape[0]
    w, d, n, lam = (a.reshape(B, -1).double() for a in args[:4])
    a = alpha.reshape(B, -1).double()
    r = w - torch.cumsum(a * d, dim=1)
    return 0.5 * (n * r * r).sum(1) + (lam * a.abs()).sum(1)


def page_rows(gen, R=224):
    """A freeze's rows at the serve path's shape: R = 2 x 28 layers x 4
    pages rows of 16 x 8 x 128 values, every third skewed."""
    E = SHAPES["bs"] * SHAPES["Hkv"] * SHAPES["Dh"]
    rows = torch.randn(R, E, generator=gen, device="cuda")
    rows[::3] *= torch.linspace(0.1, 3.0, E, device="cuda")
    return rows


def fista_page_inputs(gen, R=224):
    """A page freeze's kernel inputs at the serve path's shape, sketched
    to 128 columns, at a lambda halfway to each row's lam_hi (a bisection
    step)."""
    from repro_torch.kernels.page_quant import fista_page_problem

    p = fista_page_problem(page_rows(gen, R))
    lam = (0.5 * p["lam_hi"])[:, None] / p["scale"] * (p["n"] > 0)
    blk = lambda a: a.reshape(R, 1, 128).contiguous()
    return (blk(p["w"]), blk(p["dt"]), blk(p["n"]), blk(lam), p["eta"])


def count_ops(fn) -> int:
    """aten ops ``fn()`` dispatches (what the host enqueues)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.ops


def check_fista(gen) -> dict:
    """Kernel 4 on the card. fista_quant vs its plain version to the
    reference's bar: the page freeze's shape (224, 1, 128) at 100 steps
    and the batched PTQ's (7, 32, 128) at 1000 steps (the reference's
    kernel test inputs); a row alone bitwise the same row in the batch;
    solve_fista_batch's padding tail 0. fista_freeze (one launch for a
    freeze's solve) bitwise the torch composition with BISECT_STEPS
    fista_quant launches, in best, eta, lam_hi, codes and codebooks; a row
    alone the same row among 224; a freeze with no host sync; its host
    time and aten ops. Times at the page freeze's shape (batched PTQ's on
    its own problems, check_ptq_batched). Returns the two entries'
    records."""
    from repro_torch.kernels import (fista_freeze, fista_quant,
                                     power_iter_lipschitz,
                                     quantize_pages_fista, ref_fista,
                                     solve_fista_batch)
    from repro_torch.kernels.fista_quant import (BISECT_STEPS, freeze_plain,
                                                 nnz_of, plan, start_vector)
    from repro_torch.kernels.page_quant import (fista_page_problem,
                                                fista_page_refit,
                                                fista_page_sketch)

    def plain(args, n_iters):
        B = args[0].shape[0]
        return ref_fista(*[a.reshape(B, -1) for a in args[:4]], args[4],
                         n_iters=n_iters).reshape(args[0].shape)

    page = fista_page_inputs(gen)
    # the reference kernel test's inputs (tests/test_kernels.py:47): sorted
    # normal rows, unit weights, lambda 0.05, no preconditioning
    w = torch.sort(torch.randn(7, 4096, generator=gen, device="cuda"),
                   dim=1).values
    d = torch.diff(w, dim=1, prepend=torch.zeros(7, 1, device="cuda"))
    n = torch.ones_like(w)
    eta = (1.0 / (power_iter_lipschitz(d, n) * 1.01)).float()
    ptq = tuple(a.reshape(7, 32, 128) for a in (w, d, n, torch.full_like(
        w, 0.05))) + (eta.reshape(7, 1, 1),)
    worst = 0.0
    for name, args, n_iters in (("page freeze (224,1,128)", page, 100),
                                ("batched PTQ (7,32,128)", ptq, 1000)):
        got = fista_quant(*args, n_iters=n_iters)
        ref = plain(args, n_iters)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **FISTA_TOL)
        worst = max(worst, err)
        for i in (0, 3, args[0].shape[0] - 1):
            alone = fista_quant(*(a[i:i + 1].contiguous() for a in args),
                                n_iters=n_iters)
            if not torch.equal(alone[0], got[i]):
                raise AssertionError(f"fista_quant {name}: row {i} alone "
                                     f"!= the same row in the batch")
        Mp = args[0].shape[1] * args[0].shape[2]
        phase("fista", f"{name} x {n_iters} steps: max|err| {err:.3g} vs "
              f"plain (atol {FISTA_TOL['atol']}, rtol {FISTA_TOL['rtol']}) "
              f"OK; rows 0, 3, last alone == in the batch, bitwise; plan "
              f"{plan(Mp)._asdict()}, {plan(Mp).blocks(args[0].shape[0])} "
              f"blocks")
    # the freeze's solve in one launch == the composition, bitwise
    rows = page_rows(gen)
    sk = fista_page_sketch(rows)
    fargs = (sk["w"], sk["d"], sk["n"], start_vector(128, rows.device))
    fused = fista_freeze(*fargs, num_values=16)
    composed = freeze_plain(*fargs, num_values=16)
    pp = fista_page_problem(rows)
    same = [torch.equal(a, b) for a, b in zip(fused, composed)] + [
        torch.equal(fused[1], pp["eta"]),
        torch.equal(fused[2], pp["lam_hi"])]
    same += [torch.equal(a, b) for a, b in zip(
        fista_page_refit(rows, sk, fused[0], 16),
        fista_page_refit(rows, sk, composed[0], 16))]
    for i in (0, 3, rows.shape[0] - 1):
        one = fista_freeze(*(sk[k][i:i + 1] for k in "wdn"), fargs[3],
                           num_values=16)
        same += [torch.equal(a[0], b[i]) for a, b in zip(one, fused)]
    if not all(same):
        raise AssertionError(f"fista_freeze vs the composition (best, eta, "
                             f"lam_hi; eta, lam_hi vs fista_page_problem; "
                             f"codes, codebooks; rows 0, 3, last alone): "
                             f"{same}")
    f_err = max((a - b).abs().max().item() for a, b in zip(fused, composed))
    support = int((fused[0].abs() > 1e-12).sum())
    phase("fista", f"fista_freeze (224 rows, one launch) == the composition "
          f"with {BISECT_STEPS} fista_quant launches, bitwise (max|err| "
          f"{f_err:.3g}): best ({support} support columns), eta, lam_hi (== "
          f"fista_page_problem's), codes and codebooks; rows 0, 3, last "
          f"alone == among 224")
    # the freeze against its plain version on the CPU (ref_fista's cumsum
    # order) on 16 rows: the power iteration's eta and lam_hi to rtol 1e-5,
    # every row's support within L levels and its level count within 1 of
    # the CPU's (f32 against f64 FISTA on the CPU moves no row's count)
    cpu = freeze_plain(*(a[:16].cpu() for a in fargs[:3]), fargs[3].cpu(),
                       num_values=16)
    for k, (a, b) in enumerate(zip(fused[1:], cpu[1:])):
        torch.testing.assert_close(a[:16].cpu(), b, rtol=1e-5, atol=0,
                                   msg=f"fista_freeze vs CPU plain "
                                       f"{('eta', 'lam_hi')[k]}")
    nnz_gpu, nnz_cpu = nnz_of(fused[0][:16])[0].cpu(), nnz_of(cpu[0])[0]
    nnz_gap = int((nnz_gpu - nnz_cpu).abs().max())
    if nnz_gap > 1 or int(nnz_gpu.max()) > 16:
        raise AssertionError(f"fista_freeze vs CPU plain: levels "
                             f"{nnz_gpu.tolist()} vs {nnz_cpu.tolist()}")
    phase("fista", f"fista_freeze vs its plain version on the CPU, rows "
          f"0-15: eta, lam_hi within rtol 1e-5; levels {nnz_gpu.tolist()} "
          f"(CPU {nnz_cpu.tolist()}, tolerance 1, at most 16)")
    # a freeze (sketch, solve, refit) makes no host sync: it stays one
    # asynchronous dispatch on the side stream
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        quantize_pages_fista(rows, num_values=16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    freeze = lambda: quantize_pages_fista(rows, num_values=16)
    ops = count_ops(freeze)
    h_med, h_min = (t / 1e3 for t in host_us(freeze, calls=1, reps=20))
    phase("fista", f"quantize_pages_fista (224 rows): no host sync (CUDA "
          f"sync debug mode 'error'); {ops} aten ops; host {h_med:.3f} ms "
          f"(least {h_min:.3f}) a freeze")
    m1, m2 = 60, 90           # the reference's padding-mask test, on the card
    W = torch.zeros(2, m2, device="cuda")
    D, N = torch.zeros_like(W), torch.zeros_like(W)
    for i, m in enumerate((m1, m2)):
        v = torch.sort(torch.randn(m, generator=gen, device="cuda")).values
        W[i, :m], N[i, :m] = v, 1.0
        D[i, :m] = torch.diff(v, prepend=v.new_zeros(1))
    a2 = solve_fista_batch(W, D, N, 0.05, n_iters=200)
    a1 = solve_fista_batch(W[:1, :m1], D[:1, :m1], N[:1, :m1], 0.05,
                           n_iters=200)
    torch.testing.assert_close(a2[0, :m1], a1[0], atol=1e-4, rtol=0)
    if not bool((a2[0, m1:] == 0).all()):
        raise AssertionError("solve_fista_batch: padding tail is not 0")
    phase("fista", "solve_fista_batch rows of 60 and 90: the short row's "
          "padding tail stays 0, its columns within 1e-4 of the row solved "
          "alone")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    q = dict(ms=time_ms(lambda: fista_quant(*page, n_iters=100),
                        flush=flush),
             plain_ms=time_ms(lambda: plain(page, 100), flush=flush))
    q["bound_ms"], q["bound_by"] = fista_bound(page, 100)
    phase("fista", f"page freeze (224,1,128) x 100 steps: kernel "
          f"{q['ms']:.4f} ms, plain {q['plain_ms']:.4f} ms, bound "
          f"{q['bound_ms']:.5f} ms ({q['bound_by']}), library: none (no "
          f"single PyTorch call computes FISTA) on {card_line()}")
    f = dict(ms=time_ms(lambda: fista_freeze(*fargs, num_values=16),
                        flush=flush, reps=10),
             plain_ms=time_ms(lambda: freeze_plain(*fargs, num_values=16),
                              flush=flush, reps=10),
             freeze_ms=time_ms(freeze, flush=flush, reps=10),
             freeze_ops=ops, freeze_host_ms=h_med, freeze_host_min_ms=h_min,
             plan=plan(128)._asdict())
    f["bound_ms"], f["bound_by"] = freeze_bound(sk["w"], sk["n"])
    phase("fista", f"fista_freeze (224 rows, {BISECT_STEPS} x 100 steps): "
          f"kernel {f['ms']:.4f} ms, the composition {f['plain_ms']:.4f} ms"
          f" (events, host gaps included), bound {f['bound_ms']:.5f} ms "
          f"({f['bound_by']}); the whole freeze {f['freeze_ms']:.4f} ms, "
          f"library: none on {card_line()}")
    return dict(quant=dict(max_abs_err=worst, library_ms=None, **q),
                freeze=dict(max_abs_err=f_err, library_ms=None, **f))


def check_card_tests() -> None:
    """The card tests (``pytest -q -m cuda tests/test_torch_cuda.py``) in a
    child process; any failure fails the run."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src")] + [p for p in [os.environ.get(
            "PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    if res.returncode != 0:
        print(res.stdout[-6000:], res.stderr[-2000:], file=sys.stderr)
        raise AssertionError(f"card tests failed (rc {res.returncode}): "
                             f"{lines[-1] if lines else ''}")
    phase("card-tests", f"{lines[-1]} ({time.perf_counter() - t0:.1f} s)")


def check_serve_iter_l1(params) -> dict:
    """The main path's PTQ'd weights served with iter_l1@16 KV pages: every
    freeze's solve (power iteration, 14-step lambda bisection) one launch
    of the FISTA kernel's freeze entry on the side stream. Launch counts,
    then the launcher's replay checks and the fused-vs-gather replay on an
    fp and an iter_l1@16 pool."""
    from repro_torch.launch import serve

    s, params, cfg, args, launches = serve_once(ITER_ARGS, params)
    phase("serve-iter_l1", check_launches(s, cfg, launches, quantized=True,
                                          fista=True))
    serve.verify(params, cfg, args)      # the launcher's replay checks
    check_fused_vs_gather(params, cfg, args, (None, "iter_l1@16"))
    phase("serve-iter_l1", serve_line(s))
    return dict(launches=launches["fista_freeze"],
                freeze_dispatches=s["freeze_dispatches"],
                tpot_p50_ms=s["tpot_p50_s"] * 1e3)


def check_serve_disagg(params, main: dict) -> dict:
    """The main path's weights and trace through ``--engine disagg`` (one
    prefill worker, one decode worker, fp migration): launch gates, the
    migration counters (8 handoffs, bytes crossed == fp-equivalent bytes
    == the prompts' K/V rows), the serving check and the fused-vs-gather
    replay on the disagg composition; then two decode workers: every
    request finishes, the handoffs counted per worker."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    s, params, cfg, args, launches = serve_once(DISAGG_ARGS, params)
    phase("serve-disagg", check_launches(s, cfg, launches, quantized=True))
    rows = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2   # bf16
    want = args.num_requests * args.prompt_len * rows
    if (s["migrated_seqs"], s["prefills_done"]) != (8, 8) \
            or not s["migrate_bytes"] == s["migrate_fp_equiv_bytes"] == want:
        raise AssertionError(
            f"serve-disagg: {s['prefills_done']} prefills, "
            f"{s['migrated_seqs']} handoffs, {s['migrate_bytes']} bytes "
            f"crossed, {s['migrate_fp_equiv_bytes']} fp-equivalent (want 8,"
            f" 8, {want}, {want})")
    phase("serve-disagg", f"{s['prefills_done']} prefills -> "
          f"{s['migrated_seqs']} handoffs, {s['migrated_pages']} pages, "
          f"{s['migrate_bytes'] / 1e6:.3f} MB crossed == fp-equivalent "
          f"(migrate_compression {s['migrate_compression']:.1f})")
    serve.verify(params, cfg, args)      # the serving check, disagg
    check_fused_vs_gather(params, cfg, args, (None, "kmeans_ls@16"),
                          name="serve-disagg")
    phase("serve-disagg", f"disagg    {serve_line(s)}")
    phase("serve-disagg", f"main path {serve_line(main['summary'])}")
    s2, _, cfg2, _, launches2 = serve_once(
        DISAGG_ARGS + ["--decode-workers", "2"], params)
    check_launches(s2, cfg2, launches2, quantized=True)
    per = [w["migrated_seqs"] for w in s2["per_worker"]["decode"]]
    if s2["completed"] != 8 or sum(per) != 8 or min(per) < 1:
        raise AssertionError(f"serve-disagg, 2 decode workers: completed "
                             f"{s2['completed']}/8, handoffs per worker "
                             f"{per}")
    phase("serve-disagg", "2 decode workers: 8/8 completed, handoffs per "
          f"decode worker {per}, MB in "
          + str([round(w["migrate_bytes"] / 1e6, 3)
                 for w in s2["per_worker"]["decode"]])
          + f"; {serve_line(s2)}")
    phase("serve-disagg", f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, tpot_p50_ms=s["tpot_p50_s"] * 1e3,
                tpot_p99_ms=s["tpot_p99_s"] * 1e3,
                ttft_mean_ms=s["ttft_mean_s"] * 1e3,
                two_decode_handoffs=per)


def check_serve_disagg_frozen(params) -> dict:
    """The main path's weights and trace through ``--engine disagg
    --migrate frozen``: launch gates, the migration counters (8 handoffs,
    128 pages, the bytes exactly the frozen pages' codes and codebooks,
    one solve a prompt on the prefill worker, no host page solve), the
    serving check and fused vs gather on that composition; then the same
    with iter_l1@16 pages, whose prefill-side solves are ``fista_freeze``
    launches too."""
    from repro_torch.launch import serve
    from repro_torch.serving import page_bytes

    name = "serve-disagg-frozen"
    t0 = time.perf_counter()
    s, params, cfg, args, launches = serve_once(DISAGG_FROZEN_ARGS, params)
    phase(name, check_launches(s, cfg, launches, quantized=True))
    pb = page_bytes(cfg, args.block_size, quantized=True, num_values=16)
    pages = args.num_requests * (args.prompt_len // args.block_size)
    n = args.num_requests
    want = (n, n, pages, pages * pb["frozen"], pages * pb["fp"], n, 0)
    got = (s["prefills_done"], s["migrated_seqs"], s["migrated_pages"],
           s["migrate_bytes"], s["migrate_fp_equiv_bytes"],
           s["migrate_solves"], s["host_page_solves"])
    if got != want:
        raise AssertionError(f"{name}: (prefills, handoffs, pages, bytes, "
                             f"fp-equivalent, prefill-side solves, host "
                             f"page solves) {got}, want {want}")
    phase(name, f"{s['prefills_done']} prefills -> {s['migrated_seqs']} "
          f"handoffs, {s['migrated_pages']} pages, {s['migrate_bytes']:,} B "
          f"crossed against {s['migrate_fp_equiv_bytes']:,} B of fp rows "
          f"(migrate_compression {s['migrate_compression']:.4f}); "
          f"{s['migrate_solves']} solves on the prefill worker, 0 host page "
          f"solves")
    serve.verify(params, cfg, args)      # the serving check, disagg frozen
    check_fused_vs_gather(params, cfg, args, ("kmeans_ls@16",), name=name)
    phase(name, f"disagg frozen {serve_line(s)}")
    s2, _, cfg2, _, launches2 = serve_once(
        DISAGG_FROZEN_ARGS + ["--kv-quant", "iter_l1@16"], params)
    line = check_launches(s2, cfg2, launches2, quantized=True, fista=True)
    if s2["migrate_solves"] != n or s2["host_page_solves"] != 0:
        raise AssertionError(f"{name} iter_l1@16: {s2['migrate_solves']} "
                             f"prefill-side solves, {s2['host_page_solves']} "
                             f"host page solves")
    phase(name, f"iter_l1@16: {line}; migrate_compression "
          f"{s2['migrate_compression']:.4f}; {serve_line(s2)}")
    phase(name, f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, iter_launches=launches2,
                migrate_bytes=s["migrate_bytes"],
                compression=s["migrate_compression"],
                tpot_p50_ms=s["tpot_p50_s"] * 1e3)


def forced_offload(eng, requests, worker, at_steps=FORCED_STEPS):
    """Run ``requests`` on ``eng``, demoting the longest live sequence of
    ``worker`` to the host tier at each decode step in ``at_steps`` (the
    next step reads its pages: the restore has no slack). Returns (outputs,
    summary); fails if the fault never fired or the host tier did not
    drain."""
    om = eng.overload
    orig_step = worker.step
    fired = set()

    def step(now_fn):
        n = worker.counters["decode_steps"]
        if n in at_steps and n not in fired and worker.sched.active:
            fired.add(n)
            slot = max(worker.sched.active,
                       key=lambda i: (int(worker.lens[i]), i))
            st = worker.sched.active[slot]
            if not st.done and worker.slots[slot].out:
                entry = worker.preempt(st, "restore", now_fn())
                om.store.put(entry)
                om.resume.append(entry)
        orig_step(now_fn)

    worker.step = step
    summary = eng.run(requests)
    if not fired or len(om.store) or om.resume:
        raise AssertionError(f"forced offload fired at steps {sorted(fired)}"
                             f", {len(om.store)} entries left demoted")
    return dict(eng.outputs), summary


def check_forced_restore(params, cfg, argv, tag) -> tuple[str, dict]:
    """The replay batch on the composition ``argv`` asks for (synchronous
    freezes), uninterrupted and with the longest sequence demoted and
    restored at decode steps 3 and 7: greedy tokens equal, every demoted
    page and byte restored. Returns (the phase line, launches)."""
    from repro_torch.launch import serve
    from repro_torch.serving import make_requests

    args = serve.parse_args(argv + FORCED_ARGS + ["--offload-pages"])
    prompts = serve._replay_prompts(cfg, args)
    kw = dict(kv_quant=args.kv_quant, freeze_async=False, record_logits=True)
    golden = serve._make_engine(params, cfg, args, **kw)
    golden.generate(prompts, max_new_tokens=args.gen)
    eng = serve._make_engine(params, cfg, args, overload=True, **kw)
    worker = eng.decode[0] if args.engine == "disagg" else eng.worker
    (outs, s), launches = counting_launches(lambda: forced_offload(
        eng, make_requests(prompts, args.gen), worker))
    r = serve.compare_replays(golden, eng, dict(golden.outputs), outs)
    if outs != dict(golden.outputs) \
            or not s["preempt_offloads"] == s["restored_seqs"] >= 1 \
            or s["offloaded_pages"] != s["restored_pages"] \
            or not s["offload_bytes"] == s["restore_bytes"] > 0:
        raise AssertionError(
            f"forced restore ({tag}): tokens {r['agree']}/{r['total']}, "
            f"{s['preempt_offloads']} offloads, {s['restored_seqs']} "
            f"restores, pages {s['offloaded_pages']}/{s['restored_pages']},"
            f" bytes {s['offload_bytes']}/{s['restore_bytes']}")
    return (f"forced restore at decode steps {list(FORCED_STEPS)} ({tag}, "
            f"{len(prompts)} x {args.prompt_len} + {args.gen}, "
            f"{cfg.compute_dtype}): greedy tokens {r['agree']}/{r['total']} "
            f"equal the uninterrupted run's, max|dlogit| {r['dmax']:.4g} "
            f"(rel {r['rel']:.4%}); {s['preempt_offloads']} offloads == "
            f"{s['restored_seqs']} restores, {s['offloaded_pages']} pages "
            f"and {s['offload_bytes']:,} B each way, offload_compression "
            f"{s['offload_compression']:.4f}"), launches


def check_overload(params, cfg) -> dict:
    """Overload at full width on the main path's weights: (1) the forced
    restore on the colocated main path and on disagg frozen migration;
    (2) the main path's trace with ``--preempt --offload-pages
    --best-effort-frac 0.5``: every request completes, at least one
    preemption, never a recompute (a quantized pool restores), launch
    gates; (3) ``--admission slo --itl-slo 0.001``: best_effort arrivals
    shed, every latency request completes."""
    name = "overload"
    t0 = time.perf_counter()
    launches = []
    for tag, argv in (("colocated main path", QUANT_ARGS),
                      ("disagg, frozen migration", DISAGG_FROZEN_ARGS)):
        line, l = check_forced_restore(params, cfg, argv, tag)
        launches.append(l)
        phase(name, line)
    s, _, cfg, _, l2 = serve_once(PREEMPT_ARGS, params)
    line = check_launches(s, cfg, l2, quantized=True)
    if s["preemptions"] < 1 or s["preempt_recomputes"] != 0 \
            or s["preempt_offloads"] != s["restored_seqs"]:
        raise AssertionError(f"{name}: {s['preemptions']} preemptions, "
                             f"{s['preempt_recomputes']} recomputes, "
                             f"{s['preempt_offloads']} offloads, "
                             f"{s['restored_seqs']} restores")
    phase(name, f"--preempt --offload-pages: 8/8 completed, "
          f"{s['preemptions']} preemptions ({s['preempt_offloads']} "
          f"offloaded, {s['preempt_recomputes']} recomputed), "
          f"{s['offloaded_pages']} pages / {s['offload_bytes']:,} B to the "
          f"host tier (offload_compression "
          f"{s.get('offload_compression', 0.0):.4f}), {s['restored_seqs']} "
          f"restored; {line}")
    phase(name, f"preempt   {serve_line(s)}")
    s3, _, _, args3, l3 = serve_once(SLO_ARGS, params)
    shed = s3.get("shed_slo", 0)
    line = check_launches(s3, cfg, l3, quantized=True,
                          requests=s3["completed"])
    if shed < 1 or s3["rejected"] != shed \
            or s3["completed"] + shed != args3.num_requests:
        raise AssertionError(f"{name} slo: shed {shed}, rejected "
                             f"{s3['rejected']}, completed "
                             f"{s3['completed']}/{args3.num_requests}")
    phase(name, f"--admission slo --itl-slo 0.001: {shed} best_effort "
          f"arrivals shed, {s3['completed']}/{args3.num_requests} completed "
          f"(every latency request); {line}")
    launches += [l2, l3]
    phase(name, f"{time.perf_counter() - t0:.1f} s")
    return dict(launches={k: sum(l[k] for l in launches)
                          for k in launches[0]},
                preemptions=s["preemptions"], shed_slo=shed,
                offload_compression=s.get("offload_compression"))


def transfer_case(cfg, bs: int, P: int, gen) -> dict:
    """fp migration of a ``P``-token sequence from a prefill-sized fp pool
    to a decode-sized kmeans_ls@16 pool (padded to another layer stride),
    on the card: the landed pages and tail rows bitwise the source, the
    rest of the destination untouched, the kernel's decode over the landed
    pages bitwise its decode over the source; one cold pass timed."""
    from repro_torch.kernels import paged_decode_attention
    from repro_torch.serving import (extract_pages, init_paged_cache,
                                     splice_payload)

    mb = -(-512 // bs)
    src = init_paged_cache(cfg, num_blocks=2 * mb + 1, block_size=bs,
                           device="cuda")
    dst = init_paged_cache(cfg, num_blocks=4 * mb + 1, block_size=bs,
                           quantized=True, num_values=16, device="cuda")
    if src.k_fp.stride(0) == dst.k_fp.stride(0):
        raise AssertionError("transfer: the pools share a layer stride")
    for pool in (src, dst):
        for t in (pool.k_fp, pool.v_fp):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    dst.k_codes.random_(0, 256, generator=gen)
    dst.blk_q[::3] = True
    n_full, r = divmod(P, bs)
    n_pages = n_full + (1 if r else 0)
    blocks = list(range(src.k_fp.shape[1] - 1, 0, -1))[:n_pages]
    new = [b for b in range(1, dst.k_fp.shape[1]) if b % 3][:n_pages]
    before = {n: getattr(dst, n).clone() for n in
              ("k_fp", "v_fp", "k_codes", "k_cb", "blk_q")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = extract_pages(src, blocks, P, block_size=bs, mode="fp")
    t1 = time.perf_counter()
    payload.event.synchronize()
    t2 = time.perf_counter()
    payload.to_host()
    t3 = time.perf_counter()
    splice_payload(dst, payload, new)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    for name in ("k_fp", "v_fp"):
        sv, d, d0 = getattr(src, name), getattr(dst, name), before[name]
        ok = all(torch.equal(d[:, new[j]], sv[:, blocks[j]])
                 for j in range(n_full))
        if r:
            ok = ok and torch.equal(d[:, new[n_full], :r],
                                    sv[:, blocks[n_full], :r]) \
                and torch.equal(d[:, new[n_full], r:], d0[:, new[n_full], r:])
        rest = [b for b in range(d.shape[1]) if b not in new]
        if not (ok and torch.equal(d[:, rest], d0[:, rest])):
            raise AssertionError(f"transfer ({cfg.name}, block {bs}): "
                                 f"{name} not landed bitwise")
    for name in ("k_codes", "k_cb", "blk_q"):
        if not torch.equal(getattr(dst, name), before[name]):
            raise AssertionError(f"transfer: the destination's {name} moved")
    q = torch.randn(1, cfg.n_heads, cfg.head_dim, generator=gen,
                    device="cuda").to(src.k_fp.dtype)
    valid = torch.tensor([P], dtype=torch.int32, device="cuda")

    def decode(pool, table):
        bt = torch.tensor([table], dtype=torch.int32, device="cuda")
        return [paged_decode_attention(
            q, pool.k_fp[i], pool.v_fp[i], pool.k_codes[i], pool.v_codes[i],
            pool.k_cb[i], pool.v_cb[i], pool.blk_q, bt, valid,
            quantized=False) for i in range(cfg.n_layers)]
    if not all(torch.equal(a, b) for a, b in zip(decode(src, blocks),
                                                 decode(dst, new))):
        raise AssertionError(f"transfer ({cfg.name}, block {bs}): the "
                             f"decode over the landed pages differs")
    mb_ = payload.nbytes / 1e6
    return dict(mb=mb_, pages=n_pages, extract_ms=(t1 - t0) * 1e3,
                gather_ms=(t2 - t0) * 1e3, to_host_ms=(t3 - t2) * 1e3,
                splice_ms=(t4 - t3) * 1e3,
                strides=(src.k_fp.stride(0), dst.k_fp.stride(0)))


def check_transfer(gen) -> dict:
    """``transfer_case`` at qwen3-0.6B's full shape (28 layers, bf16,
    block 16; 256 + 7 tokens) and at reduced glm4's at block 5 (13 + 3),
    where the packed decode pool pads its layers to another stride."""
    from repro_torch.configs import get_config, get_reduced_config

    t0 = time.perf_counter()
    out = {}
    for cfg, bs, P in ((get_config("qwen3_0_6b"), 16, 263),
                       (get_reduced_config("glm4_9b"), 5, 43)):
        r = transfer_case(cfg, bs, P, gen)
        out[cfg.name] = r
        phase("transfer", f"{cfg.name} ({cfg.n_layers} layers, "
              f"{str(cfg.dtype('compute'))[6:]}, block {bs}), {P} tokens "
              f"= {r['pages']} pages, {r['mb']:.3f} MB, layer strides "
              f"{r['strides'][0]} / {r['strides'][1]} elements: landed "
              f"pages and tail rows bitwise, the rest untouched, the "
              f"kernel's decode over them bitwise; one cold pass: extract "
              f"enqueued in {r['extract_ms']:.3f} ms, gathered by "
              f"{r['gather_ms']:.3f} ms, to_host {r['to_host_ms']:.3f} ms, "
              f"splice {r['splice_ms']:.3f} ms")
    phase("transfer", f"{time.perf_counter() - t0:.1f} s")
    return out


def check_disagg_vs_colocated(params) -> dict:
    """``serve.disagg_replay`` at full width and depth: greedy tokens
    equal, logits within DISAGG_REL_TOL of the range."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    args = serve.parse_args(DISAGG_ARGS)
    from repro_torch.configs import get_config
    r = serve.disagg_replay(params, get_config(args.arch), args)
    if not r["tokens_equal"] or r["rel"] > DISAGG_REL_TOL \
            or r["handoffs"] != 3:
        raise AssertionError(
            f"disagg vs colocated: tokens {r['agree']}/{r['total']}, rel "
            f"{r['rel']:.4g} (tolerance {DISAGG_REL_TOL:g}), "
            f"{r['handoffs']} handoffs")
    phase("disagg-vs-colocated", f"fp pool, f32, prompts of "
          f"{r['prompt_lens']} + {args.gen} tokens: greedy tokens "
          f"{r['agree']}/{r['total']} equal, max|dlogit| {r['dmax']:.4g} "
          f"rel {r['rel']:.4g} (tolerance {DISAGG_REL_TOL:g}), "
          f"{r['handoffs']} handoffs; {time.perf_counter() - t0:.1f} s")
    return r


def check_static(params) -> dict:
    """``--engine static`` from the main path's PTQ'd codes (dequantized,
    as the reference's static path does): no kernel launch, finite
    logits; then the static engine against the continuous engine on an
    fp pool in f32 at full depth: equal greedy tokens, logits within
    STATIC_REL_TOL of the range."""
    from repro_torch.launch import serve
    from repro_torch.launch.static_steps import static_generate
    from repro_torch.serving import ContinuousBatchingEngine

    t0 = time.perf_counter()
    args = serve.parse_args(STATIC_ARGS)
    r, launches = counting_launches(lambda: serve.run_static(args, params))
    if any(launches.values()) or tuple(r["tokens"].shape) != (4, 32):
        raise AssertionError(f"static: launches {launches}, tokens "
                             f"{tuple(r['tokens'].shape)}")
    phase("static", f"{args.batch} x ({args.prompt_len} + {args.gen}) "
          f"tokens at full width and depth from dequantized kmeans_ls@16 "
          f"codes in {r['seconds']:.2f} s, first call included; no kernel "
          f"launch ({launches})")
    p32, c32 = serve.f32_copy(r.pop("params"), r["cfg"])
    tokens = serve.static_prompts(c32, args, "cuda")
    out, logits = static_generate(p32, c32, tokens, args.gen)
    eng = ContinuousBatchingEngine(p32, c32, device="cuda",
                                   max_slots=args.batch, block_size=16,
                                   max_seq_len=128, record_logits=True)
    got = eng.generate(tokens.tolist(), max_new_tokens=args.gen)
    want = out.tolist()
    scale = float(logits.abs().max())
    dmax = max(float(abs(eng.request_logits[i]
                         - logits[i].cpu().numpy()).max())
               for i in range(args.batch))
    equal = [got[i] for i in range(args.batch)] == want
    if not equal or dmax > STATIC_REL_TOL * scale:
        raise AssertionError(f"static vs continuous: tokens "
                             f"{'equal' if equal else 'DIFFER'}, max|dlogit|"
                             f" {dmax:.4g} of {scale:.4g}")
    phase("static", f"static vs continuous (fused, fp pool), f32, "
          f"{c32.n_layers} layers: greedy tokens equal, max|dlogit| "
          f"{dmax:.4g} rel {dmax / scale:.4g} (tolerance "
          f"{STATIC_REL_TOL:g}); {time.perf_counter() - t0:.1f} s")
    return dict(seconds=r["seconds"], rel=dmax / scale)


def untied_draft(params, cfg) -> tuple:
    """The half-depth draft with an untied random head: the auto draft of
    random weights agrees with the target at every position (both mostly
    repeat their input token), this one at almost none."""
    import dataclasses

    from repro_torch.serving import derive_draft

    dparams, dcfg = derive_draft(params, cfg)
    dev = params["embed"].device
    g = torch.Generator(device=dev).manual_seed(11)
    head = torch.randn(cfg.d_model, cfg.vocab, generator=g, device=dev)
    dparams = dict(dparams, lm_head=(head / math.sqrt(cfg.d_model)).to(
        params["embed"].dtype))
    return dparams, dataclasses.replace(dcfg, tie_embeddings=False)


def rollback_run(params, cfg, args) -> tuple[dict, list, int]:
    """Full width with ``untied_draft``, so nearly every verify window
    rolls back, through the kernel, on a kmeans_ls@16 pool whose freezes
    run on the side stream: 4 requests of ``--prompt-len`` + 24 tokens,
    the rollback watermark (``frozen_past_watermark``) read after every
    step. Returns the engine's summary, the violations and the steps."""
    from repro_torch.serving import ContinuousBatchingEngine, make_requests

    eng = ContinuousBatchingEngine(
        params, cfg, device=args.device, max_slots=args.max_slots,
        block_size=args.block_size, max_seq_len=args.max_seq_len,
        kv_quant=args.kv_quant, prefill_chunk=args.prefill_chunk,
        speculate=SPEC_K, draft=untied_draft(params, cfg), prefix_cache=True)
    w, violations, steps = eng.worker, [], [0]
    step = w.step

    def checked_step(now_fn):
        step(now_fn)
        steps[0] += 1
        violations.extend(w.frozen_past_watermark())

    w.step = checked_step
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len).tolist()
               for _ in range(4)]
    return eng.run(make_requests(prompts, 24)), violations, steps[0]


def spec_replay_line(r, what) -> str:
    """``serve.speculative_replay``'s result held to the launcher's limit
    (SPEC_REL_TOL): the phase line, or AssertionError."""
    from repro_torch.launch import serve

    line = (f"{what} speculative vs non-speculative replay (f32, "
            f"kv=kmeans_ls@16): greedy tokens {r['agree']}/{r['total']} "
            f"{'identical' if r['tokens_equal'] else 'DIFFER'}, max|dlogit| "
            f"{r['dmax']:.4g} rel {r['rel']:.4%} (tolerance "
            f"{serve.SPEC_REL_TOL:.2%}); acceptance {r['acceptance']:.1%}, "
            f"{r['rollbacks']} rollbacks")
    if not r["tokens_equal"] or r["rel"] > serve.SPEC_REL_TOL:
        raise AssertionError(line)
    return line


def check_serve_spec(params, main: dict) -> dict:
    """The main path's weights and pages with speculative decoding (k = 3,
    the half-depth draft from the same codes) and prefix sharing over a
    trace whose prompts share 192 tokens: the launch gate on the verify,
    draft and shared-prefix paths, acceptance and prefix hits; a rollback
    run with a draft that disagrees, the rollback watermark after each of
    its steps; the launcher's speculative replay with either draft, its
    prefix replay and the fused-vs-gather replay of speculative engines;
    and the served numbers beside the main path's."""
    from repro_torch.launch import serve

    s, params, cfg, args, launches = serve_once(SPEC_ARGS, params)
    (rb, violations, steps), rb_launches = counting_launches(
        lambda: rollback_run(params, cfg, args))
    if violations:
        raise AssertionError(f"frozen past the accepted seq_lens "
                             f"(page, slot, index, lens): {violations[:8]}")
    phase("serve-spec", f"rollback run: no page frozen, queued or in "
          f"flight past a slot's accepted seq_lens after any of {steps} "
          f"steps")
    phase("serve-spec", check_launches(s, cfg, launches, quantized=True,
                                       spec=SPEC_K))
    if not rb["spec_rollbacks"] > rb["completed"]:
        raise AssertionError(f"rollback run: {rb['spec_rollbacks']} "
                             f"rollbacks over {rb['completed']} requests")
    phase("serve-spec", f"rollback run (a draft with an untied random "
          f"head): acceptance {rb['spec_acceptance_rate']:.1%}, "
          f"{rb['spec_rollbacks']} rollbacks in {rb['spec_steps']} verify "
          f"slices, {rb['freeze_installs']} freeze installs; "
          + check_launches(rb, cfg, rb_launches, quantized=True, spec=SPEC_K,
                           requests=4))
    phase("serve-spec", f"speculative: acceptance "
          f"{s['spec_acceptance_rate']:.1%} ({s['spec_accepted']}/"
          f"{s['spec_proposed']} drafts), {s['spec_rollbacks']} rollbacks, "
          f"tokens/step {s['tokens_per_step']:.3f}; prefix cache: "
          f"{s['prefix_hits']} hits, {s['prefix_shared_pages']} pages "
          f"spliced shared, {s['cow_copies']} copy-on-write; "
          f"{s['prefill_chunks']} prefill chunks for {s['completed']} "
          f"prompts of {args.prompt_len} tokens")
    if not (s["spec_accepted"] > 0 and s["tokens_per_step"] > 1
            and s["prefix_hits"] >= 1):
        raise AssertionError("serve-spec took neither mechanism's path: "
                             f"{s['spec_accepted']} accepted, tokens/step "
                             f"{s['tokens_per_step']}, {s['prefix_hits']} "
                             f"prefix hits")
    phase("serve-spec", spec_replay_line(
        serve.speculative_replay(params, cfg, args), "auto draft:"))
    r = serve.speculative_replay(params, cfg, args, untied_draft)
    if not r["rollbacks"] > len(serve._replay_prompts(cfg, args)):
        raise AssertionError(f"untied-draft replay: {r['rollbacks']} "
                             f"rollbacks")
    phase("serve-spec", spec_replay_line(r, "untied draft:"))
    p = serve.prefix_replay(params, cfg, args)
    if not (p["tokens_equal"] and p["drained"] and p["prefix_hits"] >= 1
            and p["rel"] <= PREFIX_REPLAY_REL_TOL):
        raise AssertionError(f"prefix replay: {p}")
    phase("serve-spec", f"shared vs unshared replay (f32, fp pool): "
          f"{p['prefix_hits']} hits, {p['prefix_shared_pages']} pages "
          f"shared, {p['cow_copies']} copy-on-write, greedy tokens "
          f"{p['agree']}/{p['total']} identical, max|dlogit| "
          f"{p['dmax']:.4g} rel {p['rel']:.3g} (tolerance "
          f"{PREFIX_REPLAY_REL_TOL:g})")
    check_fused_vs_gather(params, cfg, args, ("kmeans_ls@16",),
                          name="serve-spec",
                          tols={"kmeans_ls@16": SPEC_FVG_REL_TOL})
    m = main["summary"]
    phase("serve-spec", f"serve-spec {serve_line(s)}")
    phase("serve-spec", f"main path  {serve_line(m)}")
    return dict(launches=launches, steps=s["decode_steps"],
                chunks=s["prefill_chunks"],
                tpot_p50_ms=s["tpot_p50_s"] * 1e3,
                main_tpot_p50_ms=m["tpot_p50_s"] * 1e3,
                acceptance=s["spec_acceptance_rate"],
                tokens_per_step=s["tokens_per_step"],
                prefix_hits=s["prefix_hits"])


def check_ptq_batched(cfg, gen) -> dict:
    """Batched l1_ls PTQ of the whole model on the card: the seven problems
    (each projection's 28 layers as one vector), kernel vs plain version
    on them (the eq.-6 objective within FISTA_OBJ_RTOL, and no farther
    from a float64 run than FISTA_F64_RATIO x the f32 plain version: on
    these rows the iterates after 1000 steps depend on summation order
    beyond the elementwise bar) and their times; then ``quantize_tree(...,
    batched=True)`` through the entry point (one FISTA launch, every
    group <= 256 values), then a short serve from its codes."""
    from repro_torch import models
    from repro_torch.core import QuantSpec
    from repro_torch.kernels import fista_quant, ref_fista
    from repro_torch.kernels.ops import fista_batch_problem
    from repro_torch.launch.serve import PTQ_SKIP
    from repro_torch.quant import compression_ratio, quantize_tree
    from repro_torch.quant.ptq import tree_problems

    dense = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    _, W, D, N = tree_problems(dense, QuantSpec.parse(PTQ_SPEC),
                               skip_patterns=PTQ_SKIP)
    p = fista_batch_problem(W, D, N, PTQ_LAM)
    args = (p["w"], p["d"], p["n"], p["lam"], p["eta"])
    B = args[0].shape[0]
    plain = lambda: ref_fista(*[a.reshape(B, -1) for a in args[:4]],
                              args[4], n_iters=1000).reshape(args[0].shape)
    got, ref = fista_quant(*args, n_iters=1000), plain()
    exact = ref_fista(*[a.reshape(B, -1).double() for a in args[:4]],
                      args[4].double(), n_iters=1000).reshape(got.shape)
    fk, fr = fista_objective(args, got), fista_objective(args, ref)
    gap = ((fk - fr).abs() / fr.abs()).max().item()
    err = (got - ref).abs().max().item()
    err_k = (got - exact).abs().max().item()
    err_p = (ref - exact).abs().max().item()
    if gap > FISTA_OBJ_RTOL or err_k > FISTA_F64_RATIO * err_p:
        raise AssertionError(
            f"fista_quant on the PTQ problems: objective {fk.tolist()} vs "
            f"plain {fr.tolist()}; max|kernel - f64| {err_k:.4g} vs "
            f"max|plain - f64| {err_p:.4g}")
    phase("ptq-batched", f"fista_quant on the {B} PTQ problems "
          f"{tuple(args[0].shape)} x 1000 steps: eq.-6 objective within "
          f"{gap:.2e} of the plain version's (limit {FISTA_OBJ_RTOL:g}); "
          f"max|kernel - plain| {err:.4g}; against the plain version in "
          f"float64: kernel {err_k:.4g}, plain f32 {err_p:.4g} (limit "
          f"{FISTA_F64_RATIO:g}x), max|alpha| {exact.abs().max().item():.4g}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    r = dict(ms=time_ms(lambda: fista_quant(*args, n_iters=1000),
                        flush=flush, reps=10),
             plain_ms=time_ms(plain, flush=flush, reps=5))
    r["bound_ms"], r["bound_by"] = fista_bound(args, 1000)
    phase("ptq-batched", f"batched PTQ {tuple(args[0].shape)} x 1000 steps: "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library: none on "
          f"{card_line()}")

    fista_quant.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams, report = quantize_tree(dense, PTQ_SPEC, batched=True,
                                    skip_patterns=PTQ_SKIP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fista_quant.launches
    groups = {}
    for row in report.values():
        groups.setdefault(row["group"], set()).add(row["n_values"])
    if launches != 1 or len(report) != 7 * cfg.n_layers \
            or len(groups) != 7 or any(
                len(v) != 1 or max(v) > 256 for v in groups.values()):
        raise AssertionError(f"batched PTQ: {launches} FISTA launches, "
                             f"{len(report)} tensors, groups {groups}")
    del dense
    nv = ", ".join(f"{k.split('/')[-1]} {v.pop()}" for k, v in
                   groups.items())
    phase("ptq-batched", f"quantize_tree({PTQ_SPEC!r}, batched=True): "
          f"{len(report)} tensors in {len(groups)} shared-codebook groups, "
          f"1 FISTA launch, lambda {PTQ_LAM:g}, n_values per group: {nv}; "
          f"{compression_ratio(report):.2f}x smaller than bf16, "
          f"{dt:.2f} s on the card")
    s, _, cfg, _, sl = serve_once(PTQB_ARGS, qparams)
    phase("ptq-batched", check_launches(s, cfg, sl, quantized=True,
                                        requests=4))
    phase("ptq-batched", serve_line(s))
    return dict(ptq_launches=launches, ptq_ms=r["ms"],
                ptq_plain_ms=r["plain_ms"], ptq_bound_ms=r["bound_ms"],
                ptq_bound_by=r["bound_by"], ptq_objective_gap=gap)


# ------------------------------------------------------------ solvers

# the paper's data (benchmarks/common.py:45-58 and :79-87, copied: this
# script imports nothing of the JAX package's benchmarks)


# ------------------------------------------------------------ other configs
# glm4-9b at full width and depth (40 layers, 2 kv heads: G = 16) from
# kmeans_ls@16 codes, the main path's trace; its f32 replays on a depth cut
# (an f32 copy of the whole model's dense embed and head is 5 GB, and 40
# layers of f32 replays would take most of the run)
GLM4_ARGS = QUANT_ARGS + ["--arch", "glm4_9b"]
GLM4_REPLAY_LAYERS = 8
# yi-34b (56 query heads over 8: G = 7) and gemma2-27b (softcaps, window
# 4096 on its local layers, post-block norms, GeGLU) at full width, their
# depth cut to 4 layers (gemma2: two local + global pairs), dense bf16
# weights with kmeans_ls@16 pages, 4 requests of the main path's trace
WIDE_LAYERS = 4
WIDE_ARGS = SERVE_ARGS + ["--num-requests", "4", "--layers", str(WIDE_LAYERS)]
# the per-page host freeze: each count method without a device solver as
# --kv-quant on packed pages, full-width qwen3-0.6B pages (16 x 8 x 128 =
# 16,384 values a row), the depth cut to 2 layers; 2 requests of 32 + 8
# tokens (l0, the slowest solve: 1 request of 16 + 8)
HOST_METHODS = ("dp", "tv_iter", "mog", "dtc", "l0")
KVHOST_ARGS = ["--engine", "continuous", "--prefill-chunk", "16",
               "--num-requests", "2", "--prompt-len", "32", "--gen", "8",
               "--max-slots", "2", "--block-size", "16", "--max-seq-len",
               "64", "--request-rate", "8", "--attn-impl", "auto", "--seed",
               "0", "--layers", "2"]
KVHOST_L0_ARGS = KVHOST_ARGS + ["--num-requests", "1", "--max-slots", "1",
                                "--prompt-len", "16"]


def gib(n: int) -> float:
    return n / 2 ** 30


def check_serve_glm4() -> dict:
    """glm4-9b at full width and depth: PTQ of its 280 projections to
    kmeans_ls@16 on the card, the trace served from the codes through
    kernels 1 and 2 (exact launch gates, no dense fallback), the serving
    check at full depth, the f32 replays (chunked vs single, fused vs
    gather) on its first GLM4_REPLAY_LAYERS layers."""
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s, params, cfg, args, launches = serve_once(GLM4_ARGS)
    ptq = s["ptq"]
    if ptq["tensors"] != 7 * cfg.n_layers:
        raise AssertionError(f"PTQ quantized {ptq['tensors']} tensors, "
                             f"expected 7 x {cfg.n_layers}")
    peak = gib(torch.cuda.max_memory_allocated())
    phase("serve-glm4", f"{cfg.name} at full width and depth ({cfg.n_layers}"
          f" layers, d_model {cfg.d_model}, {cfg.n_heads} query heads over "
          f"{cfg.n_kv_heads} kv heads, Dh {cfg.head_dim}, bf16); PTQ "
          f"kmeans_ls@16: {ptq['tensors']} projections in "
          f"{ptq['time_s']:.1f} s on the card, {ptq['compression']:.2f}x "
          f"smaller than bf16; peak memory {peak:.1f} GiB")
    phase("serve-glm4", check_launches(s, cfg, launches, quantized=True))
    if not serve._verify_serving(params, cfg, args):
        raise AssertionError("glm4-9b: the quantized-KV serving check failed")
    cut = serve.cut_depth(cfg, GLM4_REPLAY_LAYERS)
    cp = serve.cut_params(params, GLM4_REPLAY_LAYERS)
    phase("serve-glm4", f"the f32 replays below run on a depth cut: the "
          f"first {cut.n_layers} of {cfg.n_layers} layers, full width")
    if not serve._verify_chunked(cp, cut, args):
        raise AssertionError("glm4-9b: the chunked-prefill replay failed")
    check_fused_vs_gather(cp, cut, args, (None, "kmeans_ls@16"),
                          name="serve-glm4")
    phase("serve-glm4", serve_line(s))
    return dict(launches=launches, tpot_p50_ms=s["tpot_p50_s"] * 1e3,
                ptq_s=ptq["time_s"], peak_gib=peak)


def check_serve_wide(name: str, arch: str) -> dict:
    """``arch`` at full width with its depth cut to WIDE_LAYERS, dense
    bf16 weights, kmeans_ls@16 pages: the launch gates (kernel 1 on its
    full-context layers), the serving check and both f32 replays."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    s, params, cfg, args, launches = serve_once(WIDE_ARGS + ["--arch", arch])
    full = get_config(arch)
    phase(name, f"{cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} query heads over {cfg.n_kv_heads} kv heads, Dh "
          f"{cfg.head_dim}, softcap {cfg.attn_softcap}), depth cut to the "
          f"first {cfg.n_layers} of {full.n_layers} layers "
          f"({[sp.window for sp in cfg.layer_specs()]} windows)")
    phase(name, check_launches(s, cfg, launches, quantized=False,
                               requests=4))
    if not serve._verify_serving(params, cfg, args):
        raise AssertionError(f"{arch}: the quantized-KV serving check failed")
    if not serve._verify_chunked(params, cfg, args):
        raise AssertionError(f"{arch}: the chunked-prefill replay failed")
    check_fused_vs_gather(params, cfg, args, (None, "kmeans_ls@16"),
                          name=name)
    phase(name, serve_line(s))
    return dict(launches=launches, tpot_p50_ms=s["tpot_p50_s"] * 1e3)


def check_kv_host() -> dict:
    """Each count method without a device solver as --kv-quant through the
    fused engine on packed pages: launch gates with host_page_solves > 0,
    the serving check, and the seconds a row solve takes (the host
    freeze's time over its row solves, from a timer around it)."""
    from repro_torch.launch import serve
    from repro_torch.serving import kv_cache

    torch.cuda.empty_cache()
    solve = kv_cache._solve_pages_host
    spent = [0.0, 0]

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = solve(*a, **k)
        spent[0] += time.perf_counter() - t0
        spent[1] += out[2]
        return out

    out, params = {}, None
    kv_cache._solve_pages_host = timed
    try:
        for m in HOST_METHODS:
            t0 = time.perf_counter()
            spent[:] = [0.0, 0]
            argv = (KVHOST_L0_ARGS if m == "l0" else KVHOST_ARGS) + [
                "--kv-quant", f"{m}@16"]
            s, params, cfg, args, launches = serve_once(argv, params)
            phase("kv-host", f"{m}@16: " + check_launches(
                s, cfg, launches, quantized=False, host=True,
                requests=args.num_requests))
            if not serve._verify_serving(params, cfg, args):
                raise AssertionError(f"kv-host {m}@16: the serving check "
                                     f"failed")
            per = spent[0] / max(spent[1], 1)
            phase("kv-host", f"{m}@16 on {cfg.name} pages ({args.block_size}"
                  f" x {cfg.n_kv_heads} x {cfg.head_dim} values a row, "
                  f"{cfg.n_layers} layers): {s['host_page_solves']} row "
                  f"solves served, {spent[1]} with the serving check, "
                  f"{per:.3f} s a row solve; phase {time.perf_counter() - t0:.1f}"
                  f" s")
            out[m] = dict(host_page_solves=s["host_page_solves"],
                          s_per_row_solve=per,
                          paged_attention_launches=launches[
                              "paged_decode_attention"])
    finally:
        kv_cache._solve_pages_host = solve
    return out


# granite-moe-3b-a800m at full width and depth (32 layers, 40 experts
# top-8, Hq 24 over Hkv 8, Dh 64): the serve phases' trace through the
# continuous engine with whole-prompt prefills (a prefill reads the pool by
# gather: MoE capacity is per call, so a chunked prefill routes differently
# from a whole one, in both packages), dense bf16 weights (--quantize is
# refused with an MoE FFN on a paged engine, as the reference fails there)
GRANITE_ARGS = ["--arch", "granite_moe_3b_a800m", "--engine", "continuous",
                "--num-requests", "8", "--prompt-len", "256", "--gen", "32",
                "--max-slots", "4", "--block-size", "16", "--max-seq-len",
                "512", "--request-rate", "8", "--attn-impl", "auto",
                "--seed", "0"]
GRANITE_KV_ARGS = GRANITE_ARGS + ["--kv-quant", "kmeans_ls@16"]
# MoE decode: S = 1, top-8 of 40 at capacity factor 1.25 gives C = 1 and
# eight distinct experts a token, so nothing drops and a row's output is
# the same alone or among 8. f32 on the card with TF32 off: the expert
# products of 1 and 8 rows may take other cuBLAS kernels, so the rows are
# held at the f32 model tests' bar rather than bitwise
MOE_ROW_TOL = dict(atol=1e-4, rtol=1e-4)
# the static families: deepseek-v2-lite-16b at full width and depth (MLA +
# MoE; ~31 GB of bf16 weights) and whisper-tiny at full size on the
# static engine, qwen2-vl-72b at full width on its first 2 layers through
# the facade (embeds, 3-stream M-RoPE positions, the int8 ring cache)
DEEPSEEK_ARGS = ["--arch", "deepseek_v2_lite_16b", "--engine", "static",
                 "--batch", "4", "--prompt-len", "16", "--gen", "16",
                 "--seed", "0"]
WHISPER_ARGS = DEEPSEEK_ARGS[:1] + ["whisper_tiny"] + DEEPSEEK_ARGS[2:]
VL_LAYERS = 2
# card vs CPU on the reduced configs, f32: the CPU model tests' bar. The
# int8 ring cache's path takes its own: a K/V value whose t / s lies at a
# rounding tie in one package's matmul order and not the other's takes
# codes one apart (one step is max|t| / 127 of its head), which moved
# reduced qwen2-vl's prefill/decode logits by 1.26e-3 on the H100 (NVIDIA
# H100 80GB HBM3, 700 W) while its forward agreed within 1e-4; the codes
# are held within one step, and the logits at 1% of the largest |logit|
FAMILY_TOL = dict(atol=1e-4, rtol=1e-4)
INT8_REL_TOL = 0.01


def logits_finite(params, cfg, args) -> int:
    """The replay prompts through the engine ``args`` asks for (fp pool,
    8 new tokens, logits recorded): raises unless every logit is finite;
    returns the count of logit rows read."""
    from repro_torch.launch import serve

    eng = serve._make_engine(params, cfg, args, kv_quant=None,
                             record_logits=True, speculate=0,
                             freeze_async=False)
    eng.generate(serve._replay_prompts(cfg, args), max_new_tokens=8)
    rows = [np.asarray(v) for v in eng.request_logits.values()]
    if not all(np.isfinite(r).all() for r in rows):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return sum(len(r) for r in rows)


def moe_row_alone_vs_among(params, cfg) -> dict:
    """Layer 0's MoE FFN (f32 copies) on 8 decode rows (S = 1) against
    row 0 alone: no assignment drops, and row 0 agrees at MOE_ROW_TOL."""
    from repro_torch.models import moe

    p = {k: v.float() for k, v in params["layers"][0]["ffn"].items()}
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 1, cfg.d_model), generator=g, device="cuda")
    C = moe.capacity(cfg, 1)
    _, top_i = moe.route(p, cfg, x)
    _, _, pos = moe._row_dispatch(top_i.reshape(8, -1), cfg.n_experts, C)
    drops = int((pos >= C).sum())
    both = moe.moe_ffn(p, cfg, x)
    alone = moe.moe_ffn(p, cfg, x[:1])
    err = float((both[:1] - alone).abs().max())
    if drops or not torch.allclose(both[:1], alone, **MOE_ROW_TOL):
        raise AssertionError(f"MoE decode rows: {drops} drops at C={C}, "
                             f"alone vs among 8 max|err| {err:.3g}")
    return dict(C=C, drops=drops, err=err)


def check_serve_granite() -> dict:
    """granite-moe-3b-a800m at full width and depth through the continuous
    engine and kernel 1: fp pages, then kmeans_ls@16 pages with the
    launcher's serving check. Gates: kernel 1 at 32 x (decode steps +
    prefill chunks; whole-prompt prefills read by gather, so 0 chunks),
    no other kernel and no dense fallback, no host page solve, finite
    logits; MoE decode rows alone == among 8."""
    from repro_torch.launch import serve

    name = "serve-granite"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s, params, cfg, args, launches = serve_once(GRANITE_ARGS)
    peak = gib(torch.cuda.max_memory_allocated())
    phase(name, f"{cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} query heads over "
          f"{cfg.n_kv_heads} kv heads, Dh {cfg.head_dim}, {cfg.n_experts} "
          f"experts top-{cfg.top_k} of width {cfg.expert_ff}, bf16, seeded "
          f"random weights); peak memory {peak:.1f} GiB")
    phase(name, "fp pages: " + check_launches(s, cfg, launches,
                                              quantized=False, frozen=False))
    phase(name, f"fp pages: {serve_line(s)}")
    n = logits_finite(params, cfg, args)
    m = moe_row_alone_vs_among(params, cfg)
    phase(name, f"{n} logit rows of the replay prompts finite; MoE decode "
          f"(layer 0, f32, C={m['C']}): {m['drops']} drops, row 0 alone vs "
          f"among 8 max|err| {m['err']:.3g}")
    out = dict(launches=launches, fp=s)
    s, _, cfg, args, launches = serve_once(GRANITE_KV_ARGS, params)
    phase(name, "kmeans_ls@16 pages: " + check_launches(
        s, cfg, launches, quantized=False))
    if not serve._verify_serving(params, cfg, args):
        raise AssertionError("granite: the quantized-KV serving check "
                             "failed")
    phase(name, f"kmeans_ls@16 pages: {serve_line(s)}")
    out.update(kv_launches=launches, kv=s)
    return out


def static_family(argv, name: str = "static-families") -> dict:
    """One static run (``serve.run_static``) at full size: no kernel
    launch, finite logits (the launcher checks), the tokens' shape."""
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve.parse_args(argv)
    r, launches = counting_launches(lambda: serve.run_static(args))
    cfg = r["cfg"]
    if any(launches.values()) or tuple(r["tokens"].shape) != (args.batch,
                                                               args.gen):
        raise AssertionError(f"static {cfg.name}: launches {launches}, "
                             f"tokens {tuple(r['tokens'].shape)}")
    peak = gib(torch.cuda.max_memory_allocated())
    n = sum(t.numel() * t.element_size() for t in _leaves(r["params"]))
    from repro_torch.configs import get_config

    phase(name, f"{cfg.name} ({cfg.n_layers} layers of "
          f"{get_config(args.arch).n_layers}, d_model {cfg.d_model}, "
          f"{gib(n):.1f} GiB of {cfg.param_dtype} weights; peak "
          f"{peak:.1f} GiB): {args.batch} x ({args.prompt_len}"
          f" + {args.gen}) tokens in {r['seconds']:.2f} s, first call "
          f"included, finite logits, no kernel launch")
    return dict(seconds=r["seconds"], peak_gib=peak, launches=launches)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def vl_run(params, cfg, dev, *, B=2, S=32) -> dict:
    """qwen2-vl through the facade on seeded embeds with 3-stream M-RoPE
    positions: the forward's logits, then a prefill of the first S - 1
    embeds into the config's ring cache and one decode step of a token
    whose embedding is the forward's last input. Returns the logits."""
    from repro_torch import models

    g = torch.Generator().manual_seed(3)
    emb = torch.randn((B, S, cfg.d_model), generator=g)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=g).to(dev)
    emb = emb.to(dev).to(cfg.dtype("compute"))
    emb[:, -1] = params["embed"][tok[:, 0]].to(emb.dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, None].expand(
        3, B, S)
    full = models.forward(params, cfg, {"embeds": emb, "positions": pos})
    cache = models.init_cache(cfg, B, S, dev)
    pre, cache = models.prefill(params, cfg, {"embeds": emb[:, :-1],
                                              "positions": pos[:, :, :-1]},
                                cache)
    step, _ = models.decode_step(params, cfg, tok, cache, S - 1)
    return dict(forward=full, prefill=pre, step=step, cache=cache)


def check_vl_full() -> dict:
    """qwen2-vl-72b at full width on its first VL_LAYERS layers (bf16,
    int8 ring cache as its config sets): finite logits of the expected
    shapes; the decode step's deviation from the forward (the int8 cache's
    error) is read, not bounded."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    cfg = serve.cut_depth(get_config("qwen2_vl_72b"), VL_LAYERS)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.perf_counter()
    r = vl_run(params, cfg, "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    B, S = r["forward"].shape[:2]
    ok = (tuple(r["forward"].shape) == (B, S, cfg.vocab)
          and tuple(r["step"].shape) == (B, 1, cfg.vocab)
          and r["cache"][0]["k"].dtype == torch.int8
          and all(bool(torch.isfinite(r[k]).all())
                  for k in ("forward", "prefill", "step")))
    if not ok:
        raise AssertionError(f"qwen2-vl: shapes {tuple(r['forward'].shape)} "
                             f"/ {tuple(r['step'].shape)}, cache "
                             f"{r['cache'][0]['k'].dtype}, or non-finite")
    last = r["forward"][:, -1]
    rel = float((r["step"][:, 0] - last).abs().max() / last.abs().max())
    phase("static-families", f"{cfg.name} at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} query heads over {cfg.n_kv_heads}, "
          f"M-RoPE sections {tuple(cfg.mrope_sections)}), first {VL_LAYERS} "
          f"of 80 layers, bf16: forward ({B}, {S}) on embeds + prefill "
          f"{S - 1} + 1 decode step on the int8 ring cache in {dt:.2f} s, "
          f"finite; decode vs forward (the int8 cache's error) "
          f"{rel:.3%} of the largest |logit|")
    return dict(rel=rel, seconds=dt)


def check_families_card_vs_cpu() -> dict:
    """The reduced deepseek, whisper, rwkv6 and jamba (static engine) in
    f32, one set of weights made on the CPU, on the card and on the CPU:
    equal greedy tokens and logits within FAMILY_TOL; then qwen2-vl
    (``check_vl_card_vs_cpu``)."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.launch.static_steps import static_generate

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    out = {}
    for arch in ("deepseek_v2_lite_16b", "whisper_tiny", "rwkv6_3b",
                 "jamba_1_5_large_398b"):
        cfg = get_reduced_config(arch)
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        runs = []
        for dev in ("cpu", "cuda"):
            p = to(params, dev)
            args = serve.parse_args(["--arch", arch, "--reduced",
                                     "--engine", "static", "--device", dev])
            tokens = serve.static_prompts(cfg, args, "cpu").to(dev)
            enc = serve.static_encoder_input(cfg, args, "cpu")
            enc = None if enc is None else enc.to(dev)
            toks, logits = static_generate(p, cfg, tokens, args.gen, enc)
            runs.append((toks.cpu(), logits.cpu()))
        (t_cpu, l_cpu), (t_gpu, l_gpu) = runs
        err = float((l_cpu - l_gpu).abs().max())
        same = torch.equal(t_cpu, t_gpu)
        if not same or not torch.allclose(l_gpu, l_cpu, **FAMILY_TOL):
            raise AssertionError(f"{arch} reduced: card vs CPU tokens "
                                 f"{'equal' if same else 'DIFFER'}, "
                                 f"max|dlogit| {err:.3g}")
        out[arch] = err
    vl = check_vl_card_vs_cpu(to)
    phase("static-families", "reduced configs, f32, card vs CPU (atol "
          f"{FAMILY_TOL['atol']:g}, rtol {FAMILY_TOL['rtol']:g}): " + "; ".join(
              f"{a} max|dlogit| {e:.3g}" for a, e in out.items())
          + f", greedy tokens equal; qwen2_vl_72b forward max|dlogit| "
          f"{vl['forward']:.3g}, on the int8 ring {vl['int8']:.3g} "
          f"({vl['int8_rel']:.3%} of the largest |logit|, limit "
          f"{INT8_REL_TOL:.0%}), {vl['flips']} of {vl['codes']} codes one "
          f"step apart")
    return dict(out, qwen2_vl_72b=vl)


def check_vl_card_vs_cpu(to) -> dict:
    """The reduced qwen2-vl with the int8 ring cache, weights made on the
    CPU, through ``vl_run`` on the card and the CPU: the forward within
    FAMILY_TOL; the cache codes at most one step apart and the prefill and
    decode logits within INT8_REL_TOL of the largest |logit|."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config

    cfg = dataclasses.replace(get_reduced_config("qwen2_vl_72b"),
                              kv_cache_dtype="int8")
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu, gpu = (vl_run(to(params, dev), cfg, dev) for dev in ("cpu", "cuda"))
    fwd = float((cpu["forward"] - gpu["forward"].cpu()).abs().max())
    got = torch.cat([gpu["prefill"], gpu["step"]], 1).cpu()
    want = torch.cat([cpu["prefill"], cpu["step"]], 1)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    steps = [(a[k].cpu().int() - b[k].int()).abs()
             for a, b in zip(gpu["cache"], cpu["cache"]) for k in ("k", "v")]
    flips = sum(int((d > 0).sum()) for d in steps)
    ok = (torch.allclose(gpu["forward"].cpu(), cpu["forward"], **FAMILY_TOL)
          and rel <= INT8_REL_TOL and max(int(d.max()) for d in steps) <= 1)
    if not ok:
        raise AssertionError(f"qwen2_vl_72b reduced, card vs CPU: forward "
                             f"{fwd:.3g}, int8 path {err:.3g} ({rel:.3%}), "
                             f"codes apart by up to "
                             f"{max(int(d.max()) for d in steps)}")
    return dict(forward=fwd, int8=err, int8_rel=rel, flips=flips,
                codes=sum(d.numel() for d in steps))


def check_static_families() -> dict:
    t0 = time.perf_counter()
    out = {"deepseek": static_family(DEEPSEEK_ARGS),
           "whisper": static_family(WHISPER_ARGS),
           "qwen2_vl": check_vl_full(),
           "card_vs_cpu": check_families_card_vs_cpu()}
    phase("static-families", f"{time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------ state-space
# rwkv6-3b at full width and depth (32 layers, 3.07 B params) and
# jamba-1.5-large at full width on its first five layers (mamba/dense,
# mamba/moe, mamba/dense, mamba/moe, attn/dense: every layer kind of the
# model; 24.1 B params, ~48 GB bf16) on the static engine: 4 prompts of
# 200 tokens (past rwkv's 64-token chunk and into jamba's second 128-token
# one, the last chunk padded in both) + 16 new tokens
SSM_STATIC = ["--engine", "static", "--batch", "4", "--prompt-len", "200",
              "--gen", "16"]
RWKV_ARGS = SSM_STATIC + ["--arch", "rwkv6_3b"]
JAMBA_ARGS = SSM_STATIC + ["--arch", "jamba_1_5_large_398b", "--layers",
                           "5"]
# decode vs forward, f32, at full width: rwkv6-3b at full depth (12.3 GB)
# and jamba's first layer (mamba + dense, 8.4 GB). A prefill of
# SSM_PREFILL tokens (the chunked scans, padded), then SSM_STEPS
# teacher-forced decode steps (the O(1) updates), each step's logits held
# against the forward's over all SSM_PREFILL + SSM_STEPS tokens at its
# position, relative to the forward's logit range. Readings (``python3
# chip_smoke.py --ssm-readings``; PERF.md; NVIDIA H100 80GB HBM3, 700 W):
# rwkv6-3b 2.68e-6, 2.88e-6, 2.44e-6 and jamba 1.41e-6, 1.06e-6, 1.20e-6
# on seeds 0-2; Mamba's dt padded before its softplus (the pads decay
# the state) 5.50e-3 on jamba, the u bonus dropped from the sequential
# WKV 6.19e-3 on rwkv6 (seed 0). 1e-4 lies between.
SSM_F32 = (("rwkv6_3b", None), ("jamba_1_5_large_398b", 1))
SSM_PREFILL, SSM_STEPS = 200, 8
SSM_DECODE_REL_TOL = 1e-4


def ssm_f32_model(arch: str, layers: int | None) -> tuple:
    """``arch`` at full width in f32 (its first ``layers`` layers, or all),
    seeded random weights on the card; returns (params, cfg)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    if layers:
        cfg = serve.cut_depth(cfg, layers)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    return params, cfg


@torch.inference_mode()
def ssm_decode_vs_forward(params, cfg, *, seed: int = 0, B: int = 4) -> dict:
    """Prefill SSM_PREFILL seeded tokens into ``models.init_cache``, then
    SSM_STEPS decode steps on the next tokens; returns max|dlogit| of the
    steps against ``models.forward`` over all the tokens at the same
    positions, the forward's logit range over them, and their ratio."""
    from repro_torch import models

    T = SSM_PREFILL + SSM_STEPS
    dev = params["embed"].device
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, T), generator=g).to(dev)
    full = models.forward(params, cfg, {"tokens": toks})[:, SSM_PREFILL:]
    cache = models.init_cache(cfg, B, T, dev)
    _, cache = models.prefill(params, cfg,
                              {"tokens": toks[:, :SSM_PREFILL]}, cache)
    steps = []
    for i in range(SSM_PREFILL, T):
        logits, cache = models.decode_step(params, cfg, toks[:, i:i + 1],
                                           cache, i)
        steps.append(logits[:, 0])
    dmax = float((torch.stack(steps, 1) - full).abs().max())
    span = float(full.max() - full.min())
    return dict(dmax=dmax, range=span, rel=dmax / span)


def ssm_readings(seeds=(0, 1, 2)) -> int:
    """``--ssm-readings``: the decode-vs-forward readings of SSM_F32 for
    several prompt seeds, printed without a bound (run it from a copy of
    the repository with one line of ``src/`` changed to read a planted
    fault)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    for arch, layers in SSM_F32:
        params, cfg = ssm_f32_model(arch, layers)
        for seed in seeds:
            r = ssm_decode_vs_forward(params, cfg, seed=seed)
            print(f"seed {seed} decode vs forward (f32) {cfg.name} "
                  f"{cfg.n_layers} layers: rel {r['rel']:.4e} max|dlogit| "
                  f"{r['dmax']:.4g} range {r['range']:.4g}", flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


def check_static_ssm() -> dict:
    """The state-space family on the card: (a) rwkv6-3b at full width and
    depth and (b) jamba-1.5-large at full width on 5 layers through the
    static engine (no kernel launch, finite logits, the tokens' shape; the
    earlier phases' weights freed first, the peak printed); (c) decode vs
    forward in f32 at full width under SSM_DECODE_REL_TOL. (d), the
    reduced configs card vs CPU, runs in ``check_families_card_vs_cpu``."""
    import gc

    from repro_torch.configs import get_config

    name = "static-ssm"
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase(name, f"held on the card before the phase: "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB")
    out = {"rwkv6_3b": static_family(RWKV_ARGS, name)}
    out["jamba_1_5_large_398b"] = static_family(JAMBA_ARGS, name)
    for arch, layers in SSM_F32:
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        params, cfg = ssm_f32_model(arch, layers)
        r = ssm_decode_vs_forward(params, cfg)
        del params
        ok = r["rel"] <= SSM_DECODE_REL_TOL
        phase(name, f"decode vs forward, f32, {cfg.name} ({cfg.n_layers} "
              f"of {get_config(arch).n_layers} layers, d_model "
              f"{cfg.d_model}): prefill {SSM_PREFILL} + {SSM_STEPS} steps, "
              f"max|dlogit| {r['dmax']:.4g} of range {r['range']:.4g}, rel "
              f"{r['rel']:.3e} (limit {SSM_DECODE_REL_TOL:g}) -> "
              f"{'OK' if ok else 'EXCEEDED'}; "
              f"{time.perf_counter() - t1:.1f} s")
        if not ok:
            raise AssertionError(f"{arch}: decode vs forward rel "
                                 f"{r['rel']:.3e}")
        out[f"{arch}_f32"] = r
    torch.cuda.empty_cache()
    out["launches"] = {k: sum(out[a]["launches"][k] for a in (
        "rwkv6_3b", "jamba_1_5_large_398b"))
        for k in out["rwkv6_3b"]["launches"]}
    phase(name, f"{time.perf_counter() - t0:.1f} s")
    return out


def synthetic_distributions(n: int = 500, seed: int = 0) -> dict:
    """MoG / uniform / single Gaussian, 500 samples in [0, 100] (the
    paper's fig. 7)."""
    rng = np.random.default_rng(seed)
    mog = np.concatenate([
        rng.normal(20, 5, n // 3), rng.normal(50, 8, n // 3),
        rng.normal(80, 4, n - 2 * (n // 3))])
    uni = rng.uniform(0, 100, n)
    gauss = rng.normal(50, 15, n)
    return {"mog": np.clip(mog, 0, 100), "uniform": uni,
            "gaussian": np.clip(gauss, 0, 100)}


def synthetic_image(seed: int = 0) -> np.ndarray:
    """A 28 x 28 digit-like grayscale image in [0, 1] (fig. 5/6)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    img = (np.exp(-((xx - 0.5) ** 2 + (yy - 0.35) ** 2) / 0.02)
           + 0.8 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.7) ** 2) / 0.03))
    img = img / img.max() + rng.normal(0, 0.02, (28, 28))
    return np.clip(img, 0, 1).astype(np.float32)


# methods whose k-means++ seeding draws from a torch.Generator: the
# card's Philox draws other seeds than the CPU's, so these are held by
# loss, the others (host solves on the same problem) by their values
SEEDED_METHODS = ("kmeans_ls", "kmeans", "mog", "dtc")
# host solvers card vs CPU, loss relative: the same problem (unique
# values, counts and the f32 problem are exact on both) and the same host
# code; only the refit's float64 prefix sums add in another order on the
# card. Read 3.9e-16 at most (this phase on the H100, NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md PR 20), with equal n_values everywhere
SOLVER_HOST_RTOL = 1e-12
# seeded methods card vs CPU, loss ratio either way: another generator's
# k-means++ seeds find other local optima. Read (same run) kmeans and
# kmeans_ls x1.0249, dtc x1.0894, mog x1.2124
SOLVER_SEEDED_RATIO = 1.5
# (b): lambdas for the full-width projection's unweighted problem (3,885
# unique bf16 values of std 1/32) that give 16-256 values (uint8 codes):
# tv 115 and l1l2 140 (this phase on the H100, PERF.md PR 20)
WIDE_SPECS = ("l1l2:lam=0.001", "tv:lam=0.001", "l0@16", "tv_iter@16",
              "mog@16", "dtc@16", "dp@16")


def paper_data() -> dict:
    return dict(synthetic_distributions(), image=synthetic_image())


def paper_specs(name: str) -> list[str]:
    """(a)'s specs of every method on one input: count methods at 4 and
    16 values, lam methods at 2.0 and 32.0 (the image, in [0, 1]: 0.02)."""
    from repro_torch.core import registry

    lams = (0.02,) if name == "image" else (2.0, 32.0)
    out = []
    for m in registry.methods():
        if registry.get(m).param_kind == "count":
            out += [f"{m}@{l}" for l in (4, 16)]
        else:
            out += [f"{m}:lam={lam!r}" for lam in lams]
    return out


def paper_runs(dev) -> dict:
    """Every method on the paper's data through ``core.quantize`` on
    ``dev`` tensors: {(data, spec): (n_values, l2_loss_unique)}."""
    from repro_torch.core import quantize

    out = {}
    for name, x in paper_data().items():
        w = torch.from_numpy(x).to(dev)
        for spec in paper_specs(name):
            _, info = quantize(w, spec)
            out[(name, spec)] = (info["n_values"], info["l2_loss_unique"])
    return out


def check_paper_checks(runs: dict) -> str:
    """The paper's orderings on one device's runs: every count method's
    loss at least dp's at the same budget; l1l2 no denser than l1 at
    equal lam1 (the reference's tests/test_core_quant.py:61)."""
    from repro_torch.core import registry

    worst = {}
    for (name, spec), (nv, loss) in runs.items():
        method, _, rest = spec.partition("@")
        if rest:
            dp = runs[(name, f"dp@{rest}")][1]
            if loss < dp * (1 - 1e-12):
                raise AssertionError(f"{name} {spec}: loss {loss} below "
                                     f"dp's {dp}")
            worst[method] = min(worst.get(method, math.inf),
                                loss / max(dp, 1e-300))
        elif spec.startswith("l1l2:"):
            l1 = runs[(name, "l1:" + spec.split(":", 1)[1])][0]
            if nv > l1:
                raise AssertionError(f"{name} {spec}: {nv} values, l1 {l1}")
    return ", ".join(f"{m} {worst[m]:.4g}" for m in registry.count_methods())


def check_tv_vs_cd(dev) -> float:
    """The reference's tests/test_core_quant.py:69 on the paper's three
    distributions: tv's eq.-6 objective (no penalty on the first
    coordinate) at most CD's with penalize_first=False, both evaluated in
    float64. Returns the least (CD - tv) / CD. Not on the image: its
    smallest value is 0, so d_1 = 0, V's first column is zero and eq. 6
    pins the first value to 0, which tv leaves free (tv's objective is
    above CD's there in both packages: tests/test_torch_solvers.py)."""
    from repro_torch.core import (cd_solve, make_problem, objective,
                                  tv_solve_problem, unique_with_counts)

    least = math.inf
    for name, x in synthetic_distributions().items():
        vals, counts, _ = unique_with_counts(torch.from_numpy(x).to(dev))
        prob = make_problem(vals, counts)
        d = prob.d.double()
        for lam in (2.0, 32.0):
            a_cd, _ = cd_solve(prob, lam, penalize_first=False,
                               max_sweeps=300, tol=1e-9)
            u = tv_solve_problem(prob, lam)
            a_tv = torch.diff(u, prepend=u.new_zeros(1)) / torch.where(
                d == 0, torch.ones_like(d), d)
            f = lambda a: float(objective(prob, a.double(), lam,
                                          penalize_first=False))
            f_cd, f_tv = f(a_cd), f(a_tv)
            if f_tv > f_cd + 1e-4 * abs(f_cd):
                raise AssertionError(f"{name} lam {lam}: tv objective "
                                     f"{f_tv} above CD's {f_cd}")
            least = min(least, (f_cd - f_tv) / abs(f_cd))
    return least


def check_solvers_paper() -> None:
    """(a): all 12 methods on the paper's data on the card against the
    same calls on the CPU, and the paper's orderings."""
    t0 = time.perf_counter()
    card = paper_runs("cuda")
    t_card = time.perf_counter() - t0
    cpu = paper_runs("cpu")
    host_gap, ratio, bad = {}, {}, []
    for key, (nv, loss) in card.items():
        nv_c, loss_c = cpu[key]
        method = key[1].split(":")[0].split("@")[0]
        if method in SEEDED_METHODS:
            r = max(loss, 1e-300) / max(loss_c, 1e-300)
            ratio[method] = max(ratio.get(method, 1.0), r, 1 / r)
            if max(r, 1 / r) > SOLVER_SEEDED_RATIO:
                bad.append(f"{key}: loss card {loss}, CPU {loss_c}")
        else:
            gap = abs(loss - loss_c) / max(abs(loss_c), 1e-300)
            host_gap[method] = max(host_gap.get(method, 0.0), gap)
            if nv != nv_c or gap > SOLVER_HOST_RTOL:
                bad.append(f"{key}: card {nv} values, loss {loss}; CPU "
                           f"{nv_c}, {loss_c}")
    if bad:
        raise AssertionError("(a) card vs CPU:\n" + "\n".join(bad))
    worst = check_paper_checks(card)
    check_paper_checks(cpu)
    tv_gain = check_tv_vs_cd("cuda")
    phase("solvers", f"(a) 12 methods x mog/uniform/gaussian (500 points) "
          f"and the 28x28 image, {len(card)} specs, {t_card:.1f} s on the "
          f"card: host solvers == CPU (equal n_values; loss, relative: "
          + ", ".join(f"{m} {g:.3g}" for m, g in host_gap.items())
          + f"; limit {SOLVER_HOST_RTOL:g}); seeded methods' loss, card/CPU"
          f" either way: " + ", ".join(f"{m} x{r:.4f}" for m, r in
                                       ratio.items())
          + f" (limit {SOLVER_SEEDED_RATIO:g}); least loss/dp per count "
          f"method: "
          f"{worst}; l1l2 no denser than l1; tv's objective <= CD's "
          f"(penalize_first=False), by {tv_gain:.3g} relative at least")


def check_solvers_wide(cfg, gen) -> dict:
    """(b): layer 0's wq of the serve's seeded qwen3-0.6B, (1024, 2048)
    bf16, quantized by each new method on the card, then served through
    kernel 2 at M = 4 against the plain path. Returns its launches."""
    from repro_torch import models
    from repro_torch.core import quantize
    from repro_torch.kernels import ref_quant_matmul
    from repro_torch.quant import qmatmul

    dense = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    wq = dense["layers"][0]["mixer"]["wq"].clone()
    del dense
    qts, dp = {}, None
    for spec in WIDE_SPECS[::-1]:            # dp first: loss/dp below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qt, info = quantize(wq, spec)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss = info["l2_loss_unique"]
        dp = dp or loss
        if not 1 <= qt.num_values <= 256 or qt.indices.dtype != torch.uint8 \
                or not bool(torch.isfinite(qt.codebook).all()):
            raise AssertionError(f"{spec}: {qt.num_values} values, "
                                 f"{qt.indices.dtype}")
        if spec.endswith("@16") and (qt.num_values > 16
                                     or loss < dp * (1 - 1e-12)):
            raise AssertionError(f"{spec}: {qt.num_values} values, loss "
                                 f"{loss} vs dp {dp}")
        qts[spec] = qt
        extra = {k: info[k] for k in ("nnz", "iters", "lam2", "sweeps")
                 if k in info}
        phase("solvers", f"(b) wq {tuple(wq.shape)} {str(wq.dtype)[6:]} "
              f"({info['m_unique']} unique) {spec}: {dt:.2f} s on the card "
              f"(host solve included), {info['n_values']} values, loss "
              f"{loss:.6g} (unweighted SSE on the unique values), loss/dp "
              f"{loss / dp:.4f}, full loss {info['l2_loss']:.6g} {extra}")
    x = torch.randn(4, wq.shape[0], generator=gen, device="cuda").to(
        torch.bfloat16)
    outs, launches = counting_launches(
        lambda: [qmatmul(x, qt) for qt in qts.values()])
    err = 0.0
    for (spec, qt), out in zip(qts.items(), outs):
        ref = ref_quant_matmul(x, qt.indices.reshape(qt.shape), qt.codebook,
                               out_dtype=x.dtype)
        torch.testing.assert_close(out, ref, **QMM_TOL[torch.bfloat16],
                                   msg=f"qmatmul of {spec}'s codes")
        err = max(err, (out.float() - ref.float()).abs().max().item())
    if launches["quant_matmul"] != len(qts) or launches["fallbacks"] or any(
            v for k, v in launches.items()
            if k not in ("quant_matmul", "fallbacks")):
        raise AssertionError(f"(b) qmatmul launches {launches}")
    phase("solvers", f"(b) the {len(qts)} codes served through qmatmul at "
          f"M=4: {launches['quant_matmul']} quant_matmul launches, 0 dense "
          f"fallbacks, max|err| {err:.3g} vs the plain path (atol "
          f"{BF16_TOL['atol']}, rtol {BF16_TOL['rtol']:.4g})")
    return launches


def check_solvers_fista(gen) -> dict:
    """(c): kernel 4's new options. quantize_pages_fista(n_iters=50,
    bisect_steps=10, lloyd_rounds=2) on the 224-row page shape: one
    fista_freeze launch, no host sync, its refit from the card's support
    == the CPU's (codes equal, codebooks within 1e-5) and every row within
    one level of the CPU's solve; solve_fista_batch with
    penalize_first=False and with precondition=False at the PTQ shape
    against use_kernel=False on the card, at the PTQ rows' objective
    bounds. Returns the launches."""
    from repro_torch.kernels import (fista_freeze, quantize_pages_fista,
                                     ref_fista, solve_fista_batch)
    from repro_torch.kernels.fista_quant import (freeze_plain, nnz_of,
                                                 start_vector)
    from repro_torch.kernels.ops import fista_batch_problem
    from repro_torch.kernels.page_quant import (fista_page_refit,
                                                fista_page_sketch)

    kw = dict(n_iters=50, bisect_steps=10)
    rows = page_rows(gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (codes, cb), launches = counting_launches(
            lambda: quantize_pages_fista(rows, num_values=16, lloyd_rounds=2,
                                         **kw))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if launches["fista_freeze"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"(c) quantize_pages_fista launches {launches}")
    sk = fista_page_sketch(rows)
    best = fista_freeze(sk["w"], sk["d"], sk["n"],
                        start_vector(128, rows.device), num_values=16,
                        **kw)[0]
    card = fista_page_refit(rows, sk, best, 16, lloyd_rounds=2)
    sk_c = {k: v.cpu() for k, v in sk.items()}
    cpu = fista_page_refit(rows.cpu(), sk_c, best.cpu(), 16, lloyd_rounds=2)
    if not (torch.equal(card[0], codes) and torch.equal(card[1], cb)
            and torch.equal(card[0].cpu(), cpu[0])):
        raise AssertionError("(c) the freeze's refit: card vs CPU codes")
    cb_err = (card[1].cpu() - cpu[1]).abs().max().item()
    torch.testing.assert_close(card[1].cpu(), cpu[1], atol=1e-5, rtol=0)
    plain = freeze_plain(*(sk_c[k] for k in "wdn"),
                         start_vector(128, "cpu"), num_values=16, **kw)[0]
    lv, lv_cpu = nnz_of(best)[0].cpu(), nnz_of(plain)[0]
    gap = int((lv - lv_cpu).abs().max())
    same = int((best.cpu() == plain).all(dim=1).sum())     # f32 orders
    if gap > 1 or int(lv.max()) > 16:
        raise AssertionError(f"(c) levels {lv.tolist()} vs CPU "
                             f"{lv_cpu.tolist()}")
    mse = lambda c, b: (torch.gather(b, 1, c.long()) - rows).pow(2).mean(1)
    base = quantize_pages_fista(rows, num_values=16, **kw)
    gain = (mse(codes, cb) / mse(*base)).max().item()
    if gain > 1 + 1e-6:
        raise AssertionError(f"(c) Lloyd rounds raised a row's MSE x{gain}")
    phase("solvers", f"(c) quantize_pages_fista (224 rows, n_iters=50, "
          f"bisect_steps=10, lloyd_rounds=2): 1 fista_freeze launch, no "
          f"host sync; its refit from the card's support == the CPU's "
          f"(codes equal, codebooks max|err| {cb_err:.3g}, limit 1e-5); "
          f"levels within {gap} of the CPU solve's (limit 1; its alphas "
          f"bitwise in {same} of 224 rows); the rounds' MSE at most "
          f"x{gain:.6f} the "
          f"unpolished")
    # the reference kernel test's rows at batched PTQ's width
    w = torch.sort(torch.randn(7, 4096, generator=gen, device="cuda"),
                   dim=1).values
    d = torch.diff(w, dim=1, prepend=torch.zeros(7, 1, device="cuda"))
    n = torch.ones_like(w)
    for opts in (dict(penalize_first=False), dict(precondition=False)):
        run = lambda k: solve_fista_batch(w, d, n, 0.05, n_iters=1000,
                                          use_kernel=k, **opts)
        got, ln = counting_launches(lambda: run(True))
        ref, ln0 = counting_launches(lambda: run(False))
        if ln["fista_quant"] != 1 or ln0["fista_quant"] != 0:
            raise AssertionError(f"(c) solve_fista_batch {opts}: {ln}, {ln0}")
        launches["fista_quant"] += 1
        p = fista_batch_problem(w, d, n, 0.05, **opts)
        exact = ref_fista(*(p[k].reshape(7, -1)[:, :4096].double()
                            for k in ("w", "d", "n", "lam")),
                          p["eta"].double(), n_iters=1000) \
            / p["scale"].double()
        lam = torch.full_like(exact, 0.05)
        if not opts.get("penalize_first", True):
            lam[:, 0] = 0.0

        def f(a):
            r = w.double() - torch.cumsum(a.double() * d.double(), dim=1)
            return 0.5 * (r * r).sum(1) + (lam * a.double().abs()).sum(1)
        fk, fr = f(got), f(ref)
        obj = ((fk - fr).abs() / fr.abs()).max().item()
        err_k = (got - exact).abs().max().item()
        err_p = (ref - exact).abs().max().item()
        if obj > FISTA_OBJ_RTOL or err_k > FISTA_F64_RATIO * err_p:
            raise AssertionError(f"(c) solve_fista_batch {opts}: objective "
                                 f"gap {obj:.3g}, f64 errors {err_k:.4g} "
                                 f"vs {err_p:.4g}")
        phase("solvers", f"(c) solve_fista_batch {opts} (7, 4096) x 1000 "
              f"steps: 1 fista_quant launch vs use_kernel=False (0 "
              f"launches): objective within {obj:.3g} (limit "
              f"{FISTA_OBJ_RTOL:g}); from a float64 run kernel "
              f"{err_k:.4g}, plain {err_p:.4g} (limit {FISTA_F64_RATIO:g}x)")
    return launches


def check_solvers(cfg, gen) -> dict:
    """The phase ``solvers``: (a) the paper's data, (b) full width, (c)
    kernel 4's new options. Returns the launches of (b) and (c)."""
    t0 = time.perf_counter()
    check_solvers_paper()
    wide = check_solvers_wide(cfg, gen)
    fista = check_solvers_fista(gen)
    phase("solvers", f"{time.perf_counter() - t0:.1f} s")
    return dict(quant_matmul=wide["quant_matmul"],
                fista_freeze=fista["fista_freeze"],
                fista_quant=fista["fista_quant"])


# ------------------------------------------------------------ phase train

TRAIN_DIR = os.path.join(HERE, "build", "train_ckpt")
# (a) qwen3-0.6B at full width and depth through the launcher: seq 1024
# takes lm_loss through its two 512-token chunks at the full vocabulary
TRAIN_ARGS = ["--arch", "qwen3_0_6b", "--steps", "6", "--batch", "8",
              "--seq", "1024", "--ckpt-every", "3"]
# (b) crash recovery at full width on the first 2 layers
RECOVER_LAYERS, RECOVER_STEPS, RECOVER_EVERY = 2, 8, 2
RECOVER_FAIL = {5}
RECOVER_B, RECOVER_S = 8, 1024
# (c) Adafactor with bf16 factored state: qwen2-vl-72b at full width
VL_TRAIN_LAYERS, VL_TRAIN_B, VL_TRAIN_S, VL_TRAIN_STEPS = 2, 1, 512, 3
# (d) the paper's MLP (models/mlp.py: train_paper_mlp, then the PTQ + QAT
# of the last layer of examples/torch_train_quantized_mlp.py)
QAT_SPECS = tuple(f"kmeans_ls@{n}:weighted=true" for n in (4, 8, 16))
# card vs CPU by relative norm, from ``--mlp-readings`` on seeds 0-2
# (NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6). The first step's grads
# read 1.92-2.50e-7, and 1.36-2.61e-2 with TF32 left on for the card's
# matmuls (a copy with one line changed): 5e-5 lies 200x above the one
# and 270x below the other. The weights after MLP_STEPS steps read
# 0.81-3.64e-5, and 0.83-1.03e-4 with TF32 on: 400 SGD steps grow f32
# rounding nearly as far as TF32's, so this bound catches only gross
# faults and the grads' bound is the sharp one.
MLP_GRAD_REL_TOL = 5e-5
MLP_REL_TOL = 1e-4


def mlp_run(dev, seed: int = 0) -> dict:
    """The MLP from seed ``seed``'s CPU-drawn init, trained on ``dev``:
    the trained params and their train/test accuracies."""
    from repro_torch.models.mlp import (init_mlp, mlp_accuracy,
                                        synthetic_mnist, train_paper_mlp)
    from repro_torch.tree import tree_map

    (xtr, ytr), (xte, yte) = synthetic_mnist(seed=seed)
    data = [torch.from_numpy(a).to(dev) for a in (xtr, ytr, xte, yte)]
    p0 = init_mlp(torch.Generator().manual_seed(seed), device="cpu")
    params = train_paper_mlp(tree_map(lambda t: t.to(dev), p0), *data[:2])
    return dict(params=params, data=data,
                acc_tr=float(mlp_accuracy(params, *data[:2])),
                acc_te=float(mlp_accuracy(params, *data[2:])))


def mlp_rel(a: list, b: list) -> float:
    """Relative norm of the difference of two MLPs' weights (all
    leaves), b the base."""
    from repro_torch.tree import leaves

    fa = torch.cat([t.detach().double().cpu().ravel() for t in leaves(a)])
    fb = torch.cat([t.detach().double().cpu().ravel() for t in leaves(b)])
    return float((fa - fb).norm() / fb.norm())


def mlp_first_grads(dev, seed: int = 0) -> list:
    """The grads of ``train_paper_mlp``'s first step (seed ``seed``'s
    CPU-drawn init, the first 256 rows) computed on ``dev``."""
    from repro_torch.models.mlp import (MLP_BATCH, init_mlp, mlp_loss,
                                        synthetic_mnist)
    from repro_torch.tree import leaves, tree_map, unflatten

    (xtr, ytr), _ = synthetic_mnist(seed=seed)
    x, y = (torch.from_numpy(a[:MLP_BATCH]).to(dev) for a in (xtr, ytr))
    p = tree_map(lambda t: t.to(dev).requires_grad_(),
                 init_mlp(torch.Generator().manual_seed(seed), device="cpu"))
    return unflatten(p, torch.autograd.grad(mlp_loss(p, x, y), leaves(p)))


def mlp_readings(seeds=(0, 1, 2)) -> int:
    """``--mlp-readings``: phase train (d)'s card-vs-CPU readings of the
    trained MLP for several seeds, printed without a bound (run it from a
    copy with one line changed to read a planted fault)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    for seed in seeds:
        card, cpu = mlp_run("cuda", seed), mlp_run("cpu", seed)
        g = mlp_rel(mlp_first_grads("cuda", seed), mlp_first_grads("cpu",
                                                                   seed))
        print(f"seed {seed} MLP card vs CPU: first-step grads rel {g:.4e}; "
              f"weights after {MLP_STEPS} steps rel "
              f"{mlp_rel(card['params'], cpu['params']):.4e}; test acc card "
              f"{card['acc_te']:.4f} CPU {cpu['acc_te']:.4f}", flush=True)
    return 0


def state_diff(a, b) -> tuple[float, bool]:
    """(max |a - b| over every leaf, bitwise equal) of two train states."""
    from repro_torch.tree import items

    dmax, same = 0.0, True
    for (k, x), (k2, y) in zip(items(a), items(b)):
        assert k == k2, (k, k2)
        same = same and torch.equal(x, y)
        if x.is_floating_point():
            dmax = max(dmax, float((x.float() - y.float()).abs().max()))
        else:
            dmax = max(dmax, float((x - y).abs().max()))
    return dmax, same


def recover_trainer(cfg, params0, d, fail_at=None):
    """(b)'s Trainer: the launcher's loop (async checkpoints) on ``cfg``
    from ``params0``, the synthetic stream of seed 0."""
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime.ftolerance import Trainer
    from repro_torch.train.step import make_train_step

    step_fn, opt = make_train_step(cfg)
    pipe = SyntheticLM(cfg, RECOVER_B, RECOVER_S)
    specs = pipe.batch_specs()
    return Trainer(step_fn=step_fn, init_state_fn=lambda: {
        "params": params0, "opt": opt.init(params0),
        "step": torch.zeros((), dtype=torch.int32, device="cuda")},
        next_batch_fn=lambda s: pipe.next_batch(s, specs, "cuda"),
        ckpt_dir=d, ckpt_every=RECOVER_EVERY, fail_at=fail_at,
        async_ckpt=True)


def check_train_launcher(name: str) -> dict:
    """(a): ``repro_torch.launch.train`` in-process, qwen3-0.6B at full
    width and depth, bf16 weights, f32 AdamW state."""
    from repro_torch.launch import train

    d = os.path.join(TRAIN_DIR, "qwen3")
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = train.parse_args(TRAIN_ARGS + ["--ckpt-dir", d])
    r = train.run(args)
    peak = gib(torch.cuda.max_memory_allocated())
    tr = r["trainer"]
    for row in tr.metrics_log:
        ok = all(math.isfinite(row[k]) for k in ("loss", "grad_norm"))
        phase(name, f"(a) step {row['step']}: loss {row['loss']:.4f} (ce "
              f"{row['ce']:.4f}), grad norm {row['grad_norm']:.4f}"
              f"{'' if ok else ' NOT FINITE'}")
        if not ok:
            raise AssertionError(f"train (a): step {row}")
    times = sorted(tr.step_times)
    med = times[len(times) // 2]
    tokens = args.batch * args.seq
    phase(name, f"(a) {r['cfg'].name}: {r['n_params'] / 1e6:.1f} M params, "
          f"{len(tr.step_times)} steps of {tokens} tokens: step "
          f"{', '.join(f'{t:.3f}' for t in tr.step_times)} s (median "
          f"{med:.3f} s, {tokens / med:.0f} tokens/s); peak {peak:.2f} GiB")
    for c in tr.ckpt_log:
        phase(name, f"(a) checkpoint step {c['step']}: {c['bytes']:,} B, "
              f"to host {c['host_s']:.2f} s, write {c['write_s']:.2f} s "
              f"({c['bytes'] / c['write_s'] / 1e9:.2f} GB/s)")
    shutil.rmtree(d, ignore_errors=True)
    return dict(median_s=med, peak_gib=peak, ckpt=tr.ckpt_log,
                loss=[row["loss"] for row in tr.metrics_log])


def check_train_recovery(name: str) -> dict:
    """(b): a Trainer failing at RECOVER_FAIL against two clean runs, at
    full width on RECOVER_LAYERS layers; the recovered state is held to
    the clean one bitwise, or, if two clean runs differ (an atomic sum),
    within their spread."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    cfg = serve.cut_depth(get_config("qwen3_0_6b"), RECOVER_LAYERS)
    params0 = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    runs = {}
    for tag, fail in (("clean", None), ("clean2", None),
                      ("recovered", set(RECOVER_FAIL))):
        d = os.path.join(TRAIN_DIR, tag)
        shutil.rmtree(d, ignore_errors=True)
        tr = recover_trainer(cfg, params0, d, fail)
        runs[tag] = (tr.run(RECOVER_STEPS), tr)
        shutil.rmtree(d, ignore_errors=True)
    spread, same2 = state_diff(runs["clean2"][0], runs["clean"][0])
    dmax, same = state_diff(runs["recovered"][0], runs["clean"][0])
    tr = runs["recovered"][1]
    ok = tr.restarts == len(RECOVER_FAIL) and (same or (
        not same2 and dmax <= spread))
    phase(name, f"(b) {cfg.name} at full width, {RECOVER_LAYERS} of "
          f"{get_config('qwen3_0_6b').n_layers} layers, {RECOVER_STEPS} steps, checkpoints every "
          f"{RECOVER_EVERY}, failure at {sorted(RECOVER_FAIL)}: "
          f"{tr.restarts} restart(s), steps run "
          f"{[r['step'] for r in tr.metrics_log]}; final params + AdamW "
          f"state vs the clean run: max|diff| {dmax:.3g}, bitwise {same}; "
          f"clean vs clean: max|diff| {spread:.3g}, bitwise {same2} -> "
          f"{'OK' if ok else 'MISMATCH'}; {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError(f"train (b): recovered {dmax} vs spread "
                             f"{spread}")
    return dict(dmax=dmax, bitwise=same, spread=spread)


def check_train_adafactor(name: str) -> dict:
    """(c): qwen2-vl-72b at full width on VL_TRAIN_LAYERS layers, embeds
    and M-RoPE positions from SyntheticLM, bf16 factored Adafactor
    state."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = serve.cut_depth(get_config("qwen2_vl_72b"), VL_TRAIN_LAYERS)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n = sum(t.numel() for t in leaves(params))
    step_fn, opt = make_train_step(cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    del params
    pipe = SyntheticLM(cfg, VL_TRAIN_B, VL_TRAIN_S)
    specs = pipe.batch_specs()
    losses, times = [], []
    for s in range(VL_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step_fn(state, pipe.next_batch(s, specs, "cuda"))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = gib(torch.cuda.max_memory_allocated())
    free = gib(torch.cuda.mem_get_info()[1]) - peak
    st = sorted({str(t.dtype).split(".")[-1] for t in leaves(state["opt"])})
    ok = opt.kind == "adafactor" and all(math.isfinite(x) for x in losses)
    phase(name, f"(c) {cfg.name} at full width, {cfg.n_layers} of 80 "
          f"layers ({n / 1e9:.3f} B params), {opt.kind} state {st}, inputs "
          f"{sorted(specs)}, B={VL_TRAIN_B} S={VL_TRAIN_S}: loss "
          f"{', '.join(f'{x:.4f}' for x in losses)}"
          f"{'' if ok else ' NOT FINITE'}; step "
          f"{', '.join(f'{t:.2f}' for t in times)} s; peak {peak:.2f} GiB, "
          f"{free:.2f} GiB of the card left")
    if not ok:
        raise AssertionError(f"train (c): {opt.kind}, losses {losses}")
    del state
    torch.cuda.empty_cache()
    return dict(losses=losses, peak_gib=peak, free_gib=free)


def check_train_mlp(name: str) -> dict:
    """(d): the paper's §4.1 on the card: the MLP trained MLP_STEPS steps
    (held against the same run on the CPU), the last layer PTQ'd with
    kmeans_ls at 4, 8 and 16 values through ``core.quantize`` and
    recovered with models.mlp.QAT_STEPS steps of QAT."""
    from repro_torch.core import quantize
    from repro_torch.models.mlp import mlp_accuracy, qat_recover

    t0 = time.perf_counter()
    card, cpu = mlp_run("cuda"), mlp_run("cpu")
    rel = mlp_rel(card["params"], cpu["params"])
    grel = mlp_rel(mlp_first_grads("cuda"), mlp_first_grads("cpu"))
    ok = rel <= MLP_REL_TOL and grel <= MLP_GRAD_REL_TOL
    phase(name, f"(d) MLP 784-256-128-64-10, {MLP_STEPS} SGD steps on the "
          f"card: train acc {card['acc_tr']:.4f}, test acc "
          f"{card['acc_te']:.4f} (CPU {cpu['acc_te']:.4f}); card vs CPU: "
          f"first-step grads rel {grel:.3e} (limit {MLP_GRAD_REL_TOL:g}), "
          f"trained weights rel {rel:.3e} (limit {MLP_REL_TOL:g}) -> "
          f"{'OK' if ok else 'EXCEEDED'}")
    if not ok:
        raise AssertionError(f"train (d): card vs CPU grads {grel:.3e}, "
                             f"weights {rel:.3e}")
    params, (xtr, ytr, xte, yte) = card["params"], card["data"]
    out = {}
    for spec in QAT_SPECS:
        qt, info = quantize(params[-1]["w"].detach(), spec)
        ptq = params[:-1] + [dict(params[-1], w=qt.to_dense())]
        acc_q = float(mlp_accuracy(ptq, xte, yte))
        qat = qat_recover(params, qt.codebook, xtr, ytr)
        acc_qat = float(mlp_accuracy(qat, xte, yte))
        out[spec] = (acc_q, acc_qat)
        phase(name, f"(d) {spec}: PTQ test acc {acc_q:.4f} -> "
              f"QAT-recovered {acc_qat:.4f} (n_values {info['n_values']}, "
              f"l2 {info['l2_loss']:.4f})")
    phase(name, f"(d) {time.perf_counter() - t0:.1f} s")
    return dict(rel=rel, acc_te=card["acc_te"], qat=out)


def check_train() -> dict:
    """Phase ``train``: (a) the launcher on qwen3-0.6B at full width and
    depth, (b) crash recovery, (c) Adafactor on qwen2-vl-72b at full
    width, (d) the paper's MLP with PTQ and QAT. Training reaches no
    kernel: every kernel's count stays 0 over the phase. The earlier
    phases' weights are freed first; the checkpoints go under
    build/train_ckpt/ and are removed."""
    import gc

    name = "train"
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase(name, f"held on the card before the phase: "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB")

    def run():
        return dict(a=check_train_launcher(name),
                    b=check_train_recovery(name),
                    c=check_train_adafactor(name), d=check_train_mlp(name))

    out, launches = counting_launches(run)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if any(launches.values()):
        raise AssertionError(f"train: kernel launches {launches}")
    phase(name, f"kernel launches over the phase: {launches} (none "
          f"expected: training reaches no kernel); "
          f"{time.perf_counter() - t0:.1f} s")
    out["launches"] = launches
    return out


# ------------------------------------------------------------- phase dist

DIST_DIR = os.path.join(HERE, "build", "dist")
# (a), (b): qwen3-0.6B at full width on its first 2 layers, f32, 3 steps
DIST_LAYERS, DIST_STEPS, DIST_B, DIST_S, DIST_LR = 2, 3, 4, 256, 3e-4
# (b) the launcher at full width and depth, bf16, on a 2 x 1 mesh: one
# checkpoint, at the end, from the sharded state
DIST_TRAIN_ARGS = ["--arch", "qwen3_0_6b", "--steps", "4", "--batch", "8",
                   "--seq", "1024", "--ckpt-every", "1000", "--data-par",
                   "2", "--device", "cuda"]
# (c) each pod's grads: full width and depth, bf16, its half of 8 x 512
GC_B, GC_S = 8, 512
# (d) 4 stages of 7 full-width layers (all 28), f32, 8 microbatches
PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_S = 4, 8, 1, 256
# tolerances of tests/test_torch_train.py (a sharded step changes only the
# order of the sums that cross shards) and the reference's own bound for
# the int8 exchange against the exact mean (tests/test_fault_tolerance.py)
DIST_LOSS_RTOL, DIST_PARAM_RTOL, DIST_LEAF_RTOL = 1e-5, 1e-5, 1e-3
GC_EXCHANGE_RTOL, GC_EXACT_BOUND, PIPE_ATOL = 1e-6, 0.02, 1e-6


def dist_cfg():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    return dataclasses.replace(
        serve.cut_depth(get_config("qwen3_0_6b"), DIST_LAYERS),
        param_dtype="float32", compute_dtype="float32")


def dist_batches(cfg, dev):
    from repro_torch.data import SyntheticLM

    pipe = SyntheticLM(cfg, DIST_B, DIST_S)
    specs = {"tokens": ((DIST_B, DIST_S), torch.int32),
             "labels": ((DIST_B, DIST_S), torch.int32)}
    return [pipe.next_batch(s, specs, dev) for s in range(DIST_STEPS)]


def dist_run(cfg, mesh, dev, whole: bool = True) -> tuple:
    """DIST_STEPS train steps from seed 0 on ``mesh`` (None: one device).
    Returns (losses, the final state as full tensors: the whole state, or
    only its params)."""
    from repro_torch import models
    from repro_torch.runtime.sharding import distribute
    from repro_torch.train.step import (distribute_batch, make_train_step,
                                        train_state_specs)
    from repro_torch.tree import tree_map

    step, opt = make_train_step(cfg, mesh, lr=DIST_LR)
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if mesh is not None:
        state = distribute(state, mesh,
                           train_state_specs(cfg, mesh, opt)[1])
    losses = []
    for b in dist_batches(cfg, dev):
        if mesh is not None:
            b = distribute_batch(b, mesh)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    full = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, state if whole else {"params": state["params"]})
    return losses, full


def tree_rel(a, b) -> tuple[float, float]:
    """(worst leaf, whole tree) relative norm of ``a - b`` over the
    floating leaves of two trees."""
    from repro_torch.tree import items

    worst, num, den = 0.0, 0.0, 0.0
    for (k, x), (_, y) in zip(items(a), items(b)):
        if not x.is_floating_point():
            continue
        d = float((x.double() - y.double()).norm())
        n = float(y.double().norm())
        worst = max(worst, d / max(n, 1e-30))
        num, den = num + d * d, den + n * n
    return worst, math.sqrt(num) / max(math.sqrt(den), 1e-30)


def dist_part_a() -> tuple:
    """(a), in a one-rank NCCL group: the sharded step on a 1 x 1
    DeviceMesh against ``mesh=None``, bitwise. Returns its record and the
    one-device run (losses, params), the one rank (b)'s meshes are held
    to."""
    from repro_torch.launch.mesh import make_host_mesh

    cfg = dist_cfg()
    t0 = time.perf_counter()
    plain, s0 = dist_run(cfg, None, "cuda")
    meshed, s1 = dist_run(cfg, make_host_mesh(1, 1), "cuda")
    dmax, same = state_diff(s1, s0)
    return (dict(plain=plain, meshed=meshed, dmax=dmax, same=same,
                 s=time.perf_counter() - t0), (plain, s0["params"]))


def _launches_zeroed():
    from repro_torch.kernels import (fista_freeze, fista_quant,
                                     paged_decode_attention, quant_matmul,
                                     quant_matmul_stacked)

    ks = (paged_decode_attention, quant_matmul, quant_matmul_stacked,
          fista_quant, fista_freeze)
    for k in ks:
        k.launches = 0
    return ks


def dist_part_meshes(ref) -> dict:
    """(b)'s meshes in a group of two ranks sharing the card (gloo, CUDA
    tensors staged through the host): (2, 1) and (1, 2), each held on the
    group's rank 0 to ``ref``, the one-device run (losses, params)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    rank, out = dist.get_rank(), {}
    cfg = dist_cfg()
    t0 = time.perf_counter()
    for shape in ((2, 1), (1, 2)):
        mesh = make_host_mesh(*shape)
        losses, st = dist_run(cfg, mesh, "cuda", whole=False)
        if rank == 0:
            worst, whole = tree_rel(st["params"], ref[1])
            out[shape] = dict(losses=losses, ref=ref[0], worst=worst,
                              whole=whole)
        del st
    torch.cuda.empty_cache()
    out["meshes_s"] = time.perf_counter() - t0
    return out


def dist_part_launcher() -> dict:
    """(b)'s launcher in a group of two ranks sharing the card: full width
    and depth on 2 x 1, bf16, and its checkpoint restored at 1 x 1. Rank 0
    returns the checkpoint's record too."""
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.launch.mesh import host_bytes
    from repro_torch.tree import items, tree_map

    rank, out = dist.get_rank(), {}
    # the launcher at full width and depth on 2 x 1, bf16
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    d = os.path.join(DIST_DIR, "ckpt")
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    dist.barrier()
    args = train.parse_args(DIST_TRAIN_ARGS + ["--ckpt-dir", d])
    staged0 = host_bytes()
    r = train.run(args)
    staged1 = host_bytes()
    sm = train.summary(r)
    out["launcher"] = dict(step_times=sm["step_times"],
                           peak=torch.cuda.max_memory_allocated(),
                           losses=[m["loss"] for m in sm["metrics_log"]],
                           ckpt=sm["ckpt_log"], n_params=sm["n_params"],
                           staged=(staged1[0] - staged0[0],
                                   staged1[1] - staged0[1]),
                           s=time.perf_counter() - t0)
    # the checkpoint (from the sharded state) restored at 1 x 1 on each
    # rank, each rank's shard of every leaf held to the restored tensor's
    # block, bitwise: the two ranks cover every leaf whole
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    t0 = time.perf_counter()
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cuda"), r["state"])
    restored = dict(items(ckpt.restore(like, d)[0]))
    del like
    n_same = n_leaves = 0
    for k, v in items(r["state"]):
        full = restored.pop(k)
        if hasattr(v, "to_local"):
            shape, off = compute_local_shape_and_global_offset(
                v.shape, v.device_mesh, v.placements)
            full = full[tuple(slice(o, o + n) for o, n in zip(off, shape))]
            v = v.to_local()
        n_leaves += 1
        n_same += int(torch.equal(v, full))
        del full
    out["restore"] = (n_same, n_leaves)
    out["restore_s"] = time.perf_counter() - t0
    del r, restored
    torch.cuda.empty_cache()
    return out


def dist_part_c() -> dict:
    """(c) in a group of two ranks sharing the card, one a pod: the int8
    exchange of full-width, full-depth grads; the group's rank 0 holds
    it to the same exchange on the CPU."""
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.quant.gradcomp import (_quantize_int8,
                                            pod_quantized_allreduce)
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import items, leaves, tree_map

    out = {}
    t0 = time.perf_counter()
    pmesh = make_host_mesh(1, 1, pod=2)
    pod = pmesh.get_local_rank("pod")
    gcfg = get_config("qwen3_0_6b")
    params = models.init_params(
        gcfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, gcfg.vocab, (GC_B, GC_S)).astype(np.int32)).cuda()
    halves = []
    for p in range(2):        # both pods' grads, on every rank
        rows = tok[p * GC_B // 2:(p + 1) * GC_B // 2]
        _, _, g = value_and_grad(params, gcfg, {
            "tokens": rows, "labels": torch.roll(rows, -1, 1)})
        halves.append(g)
    del params
    err = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                         device="cuda"), halves[pod])
    stats = {}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mean, new_err = pod_quantized_allreduce(halves[pod], err,
                                            group=pmesh.get_group("pod"),
                                            stats=stats)
    torch.cuda.synchronize()
    out["gc_s"] = time.perf_counter() - t1
    out["gc_stats"] = stats
    if dist.get_rank() == 0:  # the same exchange on the CPU
        codes_same = n = 0
        worst_ex, worst_exact = 0.0, 0.0
        for (k, g0), (_, g1), (_, m) in zip(items(halves[0]),
                                            items(halves[1]), items(mean)):
            qs, ss = [], []
            for g in (g0, g1):
                qc, sc = _quantize_int8(g.float())
                qh, sh = _quantize_int8(g.float().cpu())
                codes_same += int(torch.equal(qc.cpu(), qh)
                                  and torch.equal(sc.cpu(), sh))
                qs.append(qh)
                ss.append(sh)
                n += 1
            cpu = (torch.tensordot(torch.stack(ss),
                                   torch.stack(qs).float(), dims=([0], [0]))
                   / 2).to(g0.dtype)
            mc = m.cpu().float()
            worst_ex = max(worst_ex, float((mc - cpu.float()).norm()
                                           / max(float(cpu.float().norm()),
                                                 1e-30)))
            exact = (g0.float().cpu() + g1.float().cpu()) / 2
            worst_exact = max(worst_exact, float(
                (mc - exact).abs().max() / max(float(exact.abs().max()),
                                               1e-30)))
        out["gc"] = dict(codes_same=codes_same, n=n, worst_ex=worst_ex,
                         worst_exact=worst_exact,
                         n_params=sum(t.numel() for t in leaves(mean)))
    del halves, mean, new_err, err
    torch.cuda.empty_cache()
    out["c_s"] = time.perf_counter() - t0
    return out


def dist_part_d() -> dict:
    """(d) on the 4 ranks: 4 stages of 7 full-width layers, GPipe over 8
    microbatches, against the sequential forward on rank 0."""
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import host_bytes
    from repro_torch.models.transformer import apply_layer
    from repro_torch.runtime.pipeline import pipeline_forward
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("qwen3_0_6b"),
                              param_dtype="float32", compute_dtype="float32")
    per = cfg.n_layers // PIPE_STAGES
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
    layers, specs = params["layers"], cfg.layer_specs()
    del params
    stacked = {f"l{j}": tree_map(lambda *ts: torch.stack(ts),
                                 *[layers[s * per + j]
                                   for s in range(PIPE_STAGES)])
               for j in range(per)}
    x = torch.randn((PIPE_MICRO, PIPE_MB, PIPE_S, cfg.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda")
    pos = torch.arange(PIPE_S, device="cuda")[None].expand(PIPE_MB, PIPE_S)

    def stage_fn(p, h):
        for j in range(per):
            h, _ = apply_layer(p[f"l{j}"], cfg, specs[j], h, pos)
        return h

    out = {"s": []}
    for _ in range(2):             # the first run pays the first calls
        stats = {}
        staged0 = host_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            y = pipeline_forward(stage_fn, stacked, x,
                                 group=dist.group.WORLD,
                                 n_stages=PIPE_STAGES, stats=stats)
        torch.cuda.synchronize()
        out["s"].append(time.perf_counter() - t0)
        staged1 = host_bytes()
    out["stats"] = stats
    out["staged"] = (staged1[0] - staged0[0], staged1[1] - staged0[1])
    if dist.get_rank() == 0:
        with torch.no_grad():
            ref = []
            for m in range(PIPE_MICRO):
                h = x[m]
                for i, lp in enumerate(layers):
                    h, _ = apply_layer(lp, cfg, specs[i], h, pos)
                ref.append(h)
            ref = torch.stack(ref)
        out["err"] = float((y - ref).abs().max())
        out["scale"] = float(ref.abs().max())
        out["bitwise"] = bool(torch.equal(y, ref))
    return out


def dist_rank(stores: str) -> dict:
    """Phase dist on each of 4 ranks sharing the card, one process each
    (each process's start, first CUDA calls and first DTensor dispatch
    paid once): ranks 0 and 1 run (b)'s launcher as a group of two;
    beside them rank 2 runs (a) as a one-rank NCCL group, then ranks 2
    and 3 run (b)'s meshes against (a)'s one-device run, and (c), as a
    group of two; then the 4 run (d) together. Groups join through file
    stores under ``stores``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import regroup

    started = time.time()
    rank, out = dist.get_rank(), {}
    if rank >= 2:      # the launcher's ranks are the phase's longest path
        os.nice(5)
    ks = _launches_zeroed()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if rank < 2:
        regroup(os.path.join(stores, "launcher"), rank, 2)
        out.update(dist_part_launcher())
    else:
        ref = None
        if rank == 2:
            regroup(os.path.join(stores, "a"), 0, 1)
            out["a"], ref = dist_part_a()
        regroup(os.path.join(stores, "bc"), rank - 2, 2)
        out.update(dist_part_meshes(ref))
        del ref
        out.update(dist_part_c())
    out["abc_s"] = time.perf_counter() - t0
    regroup(os.path.join(stores, "d"), rank, PIPE_STAGES)
    t0 = time.perf_counter()
    out["d"] = dist_part_d()
    out["d_s"] = time.perf_counter() - t0
    out["launches"] = {k.__name__: k.launches for k in ks}
    out["started"] = started
    return out


def check_dist() -> dict:
    """Phase ``dist``, in one spawn of 4 ranks sharing the card
    (``dist_rank``): (a) a 1 x 1 DeviceMesh on a one-rank NCCL group,
    bitwise the one-device step; (b) groups of two ranks over gloo (NCCL
    refuses two ranks on one GPU), CUDA tensors staged through the host
    by ``launch/host_gloo.py``: the (2, 1) and (1, 2) meshes held
    to (a)'s one-device run, and the launcher at full width and depth on
    2 x 1 with its checkpoint restored at 1 x 1 bitwise; (c) the int8 cross-pod exchange
    over 2 pods of full-width, full-depth grads against the CPU's; (d)
    the GPipe pipeline on 4 ranks against the sequential forward. No
    kernel launches in any rank."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    name = "dist"
    t0 = time.perf_counter()
    os.makedirs(DIST_DIR, exist_ok=True)
    stores = tempfile.mkdtemp(prefix="stores_", dir=DIST_DIR)
    t_spawn = time.time()
    rs = spawn(dist_rank, PIPE_STAGES, stores, device="cuda")
    r0, r2 = rs[0], rs[2]
    a = r2["a"]
    ok = a["same"] and a["plain"] == a["meshed"]
    phase(name, f"(a) {DIST_LAYERS} layers of qwen3-0.6b at full width, "
          f"f32, {DIST_STEPS} steps of {DIST_B} x {DIST_S} on a 1 x 1 "
          f"DeviceMesh (one-rank NCCL group): loss "
          f"{', '.join(f'{x:.6f}' for x in a['meshed'])}; state vs "
          f"mesh=None max|diff| {a['dmax']:.3g}, bitwise {a['same']}; "
          f"{a['s']:.1f} s -> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"dist (a): {a}")
    for shape in ((2, 1), (1, 2)):
        m = r2[shape]
        dl = max(abs(x / y - 1) for x, y in zip(m["losses"], m["ref"]))
        ok = (dl <= DIST_LOSS_RTOL and m["whole"] <= DIST_PARAM_RTOL
              and m["worst"] <= DIST_LEAF_RTOL)
        phase(name, f"(b) mesh {shape} on 2 ranks sharing the card: loss "
              f"{', '.join(f'{x:.6f}' for x in m['losses'])} vs one rank's "
              f"(max rel {dl:.2e}, limit {DIST_LOSS_RTOL:g}); params after "
              f"{DIST_STEPS} steps rel {m['whole']:.2e} (limit "
              f"{DIST_PARAM_RTOL:g}), worst leaf {m['worst']:.2e} (limit "
              f"{DIST_LEAF_RTOL:g}) -> {'OK' if ok else 'EXCEEDED'}")
        if not ok:
            raise AssertionError(f"dist (b) {shape}: {m}")
    phase(name, f"(b) both meshes: {r2['meshes_s']:.1f} s")
    tokens = 8 * 1024
    for rank, rr in enumerate(rs[:2]):
        lr = rr["launcher"]
        times = sorted(lr["step_times"])
        phase(name, f"(b) launcher rank {rank}: qwen3-0.6b "
              f"{lr['n_params'] / 1e6:.1f} M params, mesh 2 x 1, bf16, "
              f"{len(times)} steps of {tokens} tokens: step "
              f"{', '.join(f'{t:.3f}' for t in lr['step_times'])} s (median "
              f"{times[len(times) // 2]:.3f} s); loss "
              f"{', '.join(f'{x:.4f}' for x in lr['losses'])}; peak "
              f"{gib(lr['peak']):.2f} GiB; staged through the host "
              f"{lr['staged'][0] / 1e9:.2f} GB down, "
              f"{lr['staged'][1] / 1e9:.2f} GB up (the checkpoint's "
              f"gathers included); {lr['s']:.1f} s in all")
    for c in r0["launcher"]["ckpt"]:
        phase(name, f"(b) checkpoint step {c['step']} from the sharded "
              f"state: {c['bytes']:,} B, to host {c['host_s']:.2f} s, write "
              f"{c['write_s']:.2f} s")
    same = [rr["restore"][0] for rr in rs[:2]]
    n = r0["restore"][1]
    ok = all(x == n for x in same)
    phase(name, f"(b) restored at 1 x 1 on each rank: its shard of "
          f"{', '.join(map(str, same))} of {n} leaves bitwise the sharded "
          f"state (the ranks' shards cover each leaf); "
          f"{r0['restore_s']:.1f} s -> {'OK' if ok else 'MISMATCH'}")
    if not ok or not all(math.isfinite(x) for x in
                         r0["launcher"]["losses"]):
        raise AssertionError(f"dist (b): restore {same}/{n}, "
                             f"{r0['launcher']['losses']}")
    gc, st = r2["gc"], r2["gc_stats"]
    ok = (gc["codes_same"] == gc["n"] and gc["worst_ex"] <= GC_EXCHANGE_RTOL
          and gc["worst_exact"] <= GC_EXACT_BOUND)
    phase(name, f"(c) int8 exchange over 2 pods, qwen3-0.6b full width and "
          f"depth grads ({gc['n_params'] / 1e6:.1f} M params, each pod "
          f"{GC_B // 2} x {GC_S} tokens): codes and scales bitwise the "
          f"CPU's {gc['codes_same']} of {gc['n']}; output vs the CPU "
          f"exchange worst leaf rel {gc['worst_ex']:.2e} (limit "
          f"{GC_EXCHANGE_RTOL:g}); vs the exact mean {gc['worst_exact']:.4f}"
          f" of the largest (limit {GC_EXACT_BOUND:g}) -> "
          f"{'OK' if ok else 'EXCEEDED'}")
    phase(name, f"(c) bytes a pod sends: {st['bytes']:,} B of int8 codes "
          f"+ scales ({st['bytes'] / 1e9:.3f} GB) against "
          f"{st['bytes_grad_dtype']:,} B of bf16 grads "
          f"({st['bytes_grad_dtype'] / 1e9:.3f} GB) and {st['bytes_f32']:,}"
          f" B in f32 ({st['bytes_f32'] / 1e9:.3f} GB); exchange "
          f"{r2['gc_s']:.2f} s; (c) {r2['c_s']:.1f} s in all")
    if not ok:
        raise AssertionError(f"dist (c): {gc}")
    d0 = r0["d"]
    ok = d0["err"] <= PIPE_ATOL
    phase(name, f"(d) GPipe on {PIPE_STAGES} ranks sharing the card, "
          f"{PIPE_STAGES} stages of {28 // PIPE_STAGES} full-width layers "
          f"(f32), {PIPE_MICRO} microbatches of {PIPE_MB} x {PIPE_S}: "
          f"{d0['s'][0]:.2f} s, again {d0['s'][1]:.2f} s; vs the sequential "
          f"forward max|diff| "
          f"{d0['err']:.3g} of {d0['scale']:.3g} (limit {PIPE_ATOL:g}), "
          f"bitwise {d0['bitwise']}; rank 0 sent {d0['stats']['sent']:,} B "
          f"of hand-offs, staged through the host {d0['staged'][0]:,} B "
          f"down, {d0['staged'][1]:,} B up -> {'OK' if ok else 'EXCEEDED'}")
    if not ok:
        raise AssertionError(f"dist (d): {d0}")
    starts = ", ".join(f"{rr['started'] - t_spawn:.1f}" for rr in rs)
    abc = ", ".join(f"{rr['abc_s']:.1f}" for rr in rs)
    dd = ", ".join(f"{rr['d_s']:.1f}" for rr in rs)
    phase(name, f"time by rank: start {starts} s after the spawn; (a)-(c) "
          f"{abc} s; (d) {dd} s")
    launches = dict.fromkeys(rs[0]["launches"], 0)
    for rr in rs:
        for k, v in rr["launches"].items():
            launches[k] += v
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    if any(launches.values()):
        raise AssertionError(f"dist: kernel launches {launches}")
    phase(name, f"kernel launches over the phase, every rank: {launches} "
          f"(none expected: no kernel on this path); "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(a=a, launches=launches)


# ----------------------------------------------------------- phase dryrun

# production cells on fake ranks (launch/dryrun.py): qwen3-0.6B's train
# and decode cells on 16 x 16 (8 kv heads on a 16-wide model axis) and
# granite's prefill on 2 x 16 x 16 (24 heads, 40 experts)
DRYRUN_CELLS = (("qwen3_0_6b", "train_4k", False),
                ("qwen3_0_6b", "decode_32k", False),
                ("granite_moe_3b_a800m", "prefill_32k", True))
# train (a)'s step counted on one fake device: its roofline bound may not
# exceed the step the card measured, beyond the spread of the median
DRYRUN_SHARE_LIMIT = 1.05


def dryrun_main() -> int:
    """``--dryrun``: phase dryrun's work, on the host (no card needed):
    the production cells on a fake group of 256 or 512 ranks, then the
    count of train (a)'s step (qwen3-0.6B full, one device, 8 x 1024).
    Prints a line a cell; the last line is one JSON object of the
    results, kernel launches included."""
    import logging

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (mesh_name, run_cell, summary,
                                           train_step_counts)
    from repro_torch.launch.mesh import join_fake

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    torch.set_num_threads(1)
    t0 = time.perf_counter()

    def run():
        cells = []
        for arch, shape, mp in DRYRUN_CELLS:
            join_fake(512 if mp else 256)
            cell = run_cell(arch, shape, multi_pod=mp)
            cells.append(cell)
            phase("dryrun", f"{arch} {shape} {mesh_name(mp)}: "
                  f"{summary(cell)}")
            if cell["status"] != "ok":
                raise AssertionError(f"dryrun: {cell}")
        dist.destroy_process_group()
        st, rl = train_step_counts(get_config("qwen3_0_6b"), 8, 1024)
        return cells, st, rl

    (cells, st, rl), launches = counting_launches(run)
    print(json.dumps({"cells": cells, "train_a": dict(
        st, bound_s=rl.step_time_lower_bound, roofline=rl.as_dict()),
        "launches": launches, "s": time.perf_counter() - t0}))
    return 0


def start_dryrun():
    """Phase dryrun in a child process (``--dryrun``) at nice 10, as the
    kernel build's compilers: it runs beside the kernel-free phases."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: os.nice(10))


def check_dryrun(proc, train_median_s: float) -> dict:
    """Wait for phase dryrun's child; print its cells, and train (a)'s
    counted FLOPs and bytes and their bound beside the step the card
    measured. Fails if a cell failed, a kernel launched, or the bound
    exceeds the measured step by more than ``DRYRUN_SHARE_LIMIT``."""
    name = "dryrun"
    t0 = time.perf_counter()
    out, err = proc.communicate()
    waited = time.perf_counter() - t0
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"dryrun: rc {proc.returncode}\n{out[-3000:]}"
                             f"\n{err[-3000:]}")
    for line in lines[:-1]:
        print(line)
    r = json.loads(lines[-1])
    a = r["train_a"]
    share = a["bound_s"] / train_median_s
    rl = a["roofline"]
    phase(name, f"train (a)'s step counted (qwen3-0.6b, 1 x 1, bf16, 8 x "
          f"1024, fake): {a['flops'] - a['flops_f32']:.6g} bf16 FLOPs, "
          f"{a['flops_f32']:.6g} f32 FLOPs, {a['hbm_bytes']:.6g} HBM B, "
          f"{a['n_ops']} ops, peak {a['peak_bytes'] / 2**30:.2f} GiB; "
          f"t_compute {rl['t_compute_s']:.4f} s, t_memory "
          f"{rl['t_memory_s']:.4f} s: bound {a['bound_s']:.4f} s "
          f"({rl['dominant']}) against the measured median step "
          f"{train_median_s:.4f} s: share {share:.4f} (limit "
          f"{DRYRUN_SHARE_LIMIT})")
    if share > DRYRUN_SHARE_LIMIT:
        raise AssertionError(f"dryrun: the bound's share {share:.4f} of "
                             f"the measured step: the count is wrong")
    if any(r["launches"].values()):
        raise AssertionError(f"dryrun: kernel launches {r['launches']}")
    phase(name, f"kernel launches in the child: {r['launches']}; the "
          f"child's {r['s']:.1f} s beside the other phases, "
          f"{waited:.1f} s waited for after them")
    return dict(r, share=share, waited_s=waited)


# ------------------------------------------------------------ phase examples

EXAMPLES = os.path.join(HERE, "examples")
EXAMPLES_OUT = os.path.join(HERE, "build", "examples")
# train_lm at its defaults (the ~100M LM, 40 steps of 8 x 128, checkpoints
# every 20) with a crash at step 25, recovered from step 20's checkpoint
TRAIN_LM_ARGS = ["--fail-at", "25"]
# the registered count method on the reduced qwen3, continuous batching,
# chunked prefill, the fused engine: 4 full pages a prompt freeze at attach
UNIFORM_ARGS = ["--reduced", "--engine", "continuous", "--kv-quant",
                "uniform@16", "--prefill-chunk", "16", "--num-requests", "8",
                "--prompt-len", "64", "--gen", "32", "--max-slots", "4",
                "--block-size", "16", "--max-seq-len", "128",
                "--request-rate", "8", "--attn-impl", "auto", "--seed", "0"]
# fused vs gather on the uniform@16 pool, f32 (``--uniform-readings`` on
# the H100, NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6, PR 30): sound
# 2.96e-7, 2.96e-7, 3.23e-7 of the logit range on prompt seeds 0-2; each
# page read with the next page's K codebook 13.46%, 15.47%, 15.17% (31 of
# 96 tokens differ on seed 1). 1% (the kmeans_ls@16 replay's limit) lies
# 3e4x above the one and 13x below the other.
UNIFORM_REPLAY_REL_TOL = 0.01
UNIFORM_CALLS = {"n": 0}


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module (its ``main`` is not
    run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(EXAMPLES, f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def uniform_levels(lo, hi, L: int):
    """L evenly spaced levels from lo to hi (per row), and their step
    (1 where the row is constant)."""
    step = (hi - lo) / (L - 1)
    step = torch.where(step > 0, step, torch.ones_like(step))
    return lo + step * torch.arange(L, dtype=lo.dtype, device=lo.device), step


def uniform_host(ctx, spec, **kw):
    """``uniform``'s host solve: the nearest of L evenly spaced levels
    over the unique values' range."""
    w = ctx.problem.w_hat
    lo, hi = w.min().reshape(1), w.max().reshape(1)
    levels, step = uniform_levels(lo, hi, ctx.num_values)
    idx = torch.round((w - lo) / step).clamp(0, ctx.num_values - 1).long()
    return levels[idx], None


def uniform_pages(rows, spec):
    """``uniform``'s device solver: every row's L levels over its own
    range, codes the nearest level's index (uint8), codebooks f32.
    Counts its calls."""
    UNIFORM_CALLS["n"] += 1
    L = spec.num_values
    x = rows.float()
    lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    cb, step = uniform_levels(lo, hi, L)
    codes = torch.round((x - lo) / step).clamp(0, L - 1).to(torch.uint8)
    return codes, cb


def register_uniform() -> None:
    from repro_torch.core import registry

    registry.register(registry.Solver(
        "uniform", "count", uniform_host, device_batch=uniform_pages,
        description="L evenly spaced levels, nearest assignment"))


def check_examples_free() -> dict:
    """Phase examples, beside the kernel build: quickstart, train_lm and
    train_quantized_mlp through their ``main()`` on the card; each
    launches no kernel."""
    name = "examples"
    t0 = time.perf_counter()
    out = {}
    runs = (("quickstart", ["--device", "cuda"]),
            ("train_lm", ["--device", "cuda", "--ckpt-dir",
                          os.path.join(EXAMPLES_OUT, "lm_ckpt")]
             + TRAIN_LM_ARGS),
            ("train_quantized_mlp", ["--device", "cuda"]))
    shutil.rmtree(os.path.join(EXAMPLES_OUT, "lm_ckpt"), ignore_errors=True)
    for ex, argv in runs:
        t1 = time.perf_counter()
        r, launches = counting_launches(
            lambda: load_example(ex).main(argv))
        if r["device"] != "cuda" or any(launches.values()):
            raise AssertionError(f"examples {ex}: device {r['device']}, "
                                 f"launches {launches}")
        out[ex] = dict(r, launches=launches, s=time.perf_counter() - t1)
    shutil.rmtree(os.path.join(EXAMPLES_OUT, "lm_ckpt"), ignore_errors=True)
    qs = out["quickstart"]
    phase(name, f"quickstart: {len(qs['methods'])} methods on the card, "
          + ", ".join(f"{k} {v['n_values']} values l2 {v['l2_loss']:.4f} "
                      f"{v['time_s'] * 1e3:.1f} ms"
                      for k, v in qs["methods"].items())
          + f"; kmeans_ls@16 {qs['kmeans_ls16']['ratio']:.2f}x; "
          f"{qs['s']:.1f} s")
    lm = out["train_lm"]
    first, replayed = {}, []
    for st, loss in zip(lm["steps_run"], lm["losses"]):
        if st in first:
            replayed.append(first[st] == loss)
        first.setdefault(st, loss)
    ok = (lm["restarts"] == 1 and replayed and all(replayed)
          and all(math.isfinite(x) for x in lm["losses"]))
    phase(name, f"train_lm: {lm['n_params']:,} params, mesh "
          f"{lm['mesh'][0]} x {lm['mesh'][1]}, {len(lm['losses'])} steps "
          f"run (crash at {TRAIN_LM_ARGS[1]}: {lm['restarts']} restart, "
          f"{len(replayed)} steps replayed from the checkpoint, their "
          f"losses {'equal to' if all(replayed) else 'NOT'} the first "
          f"pass's), loss {lm['losses'][0]:.4f} -> {lm['losses'][-1]:.4f} "
          f"(mean of the first 5 {sum(lm['losses'][:5]) / 5:.4f}, of the "
          f"last 5 {sum(lm['losses'][-5:]) / 5:.4f}), median step "
          f"{lm['median_step_s'] * 1e3:.2f} ms; {lm['s']:.1f} s")
    if not ok:
        raise AssertionError(f"examples train_lm: restarts "
                             f"{lm['restarts']}, replays {replayed}, "
                             f"losses {lm['losses']}")
    mlp = out["train_quantized_mlp"]
    phase(name, f"train_quantized_mlp: baseline test acc "
          f"{mlp['acc_test']:.4f}; "
          + ", ".join(f"l={k}: PTQ {v['ptq']:.4f} -> QAT {v['qat']:.4f}"
                      for k, v in mlp["by_values"].items())
          + f"; {mlp['s']:.1f} s")
    for k, v in mlp["by_values"].items():
        if not v["qat"] >= v["ptq"]:
            raise AssertionError(f"examples train_quantized_mlp: l={k} QAT "
                                 f"{v['qat']} below PTQ {v['ptq']}")
    phase(name, f"kernel-free examples {time.perf_counter() - t0:.1f} s "
          f"beside the build; 0 launches each")
    return dict(out, s=time.perf_counter() - t0)


def uniform_replay(seed: int) -> dict:
    """The fused-vs-gather replay of UNIFORM_ARGS (prompt seed ``seed``)
    on a uniform@16 pool, f32."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve

    args = serve.parse_args(UNIFORM_ARGS[:-1] + [str(seed)])
    cfg = get_reduced_config("qwen3_0_6b")
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    return fused_vs_gather(params, cfg, args, args.kv_quant)


def check_examples_served() -> dict:
    """Phase examples after the build: serve_quantized and trace_serving
    through their ``main()`` (kernel 1 launched; the trace reconciled),
    then the registered ``uniform`` method: the reduced qwen3 served with
    ``--kv-quant uniform@16`` on the fused engine (every freeze through
    ``uniform_pages``, kernel 1 on every step) and its fused-vs-gather
    replay within UNIFORM_REPLAY_REL_TOL."""
    name = "examples"
    t0 = time.perf_counter()
    out = {}
    for ex, argv in (("serve_quantized", ["--device", "cuda"]),
                     ("trace_serving", ["--device", "cuda", "--out",
                                        EXAMPLES_OUT])):
        t1 = time.perf_counter()
        r, launches = counting_launches(lambda: load_example(ex).main(argv))
        if r["device"] != "cuda" or r["attn_impl"] != "fused" \
                or launches["paged_decode_attention"] <= 0 \
                or launches["paged_decode_attention"] != r[
                    "paged_attention_launches"]:
            raise AssertionError(f"examples {ex}: device {r['device']}, "
                                 f"attn {r['attn_impl']}, launches "
                                 f"{launches}")
        out[ex] = dict(r, launches=launches, s=time.perf_counter() - t1)
    sq, tr = out["serve_quantized"], out["trace_serving"]
    # frozen migration: the pages are solved on the prefill worker and
    # land frozen in the decode worker's pool, which kernel 1 reads
    if not sq["migrated_pages"] or sq["host_page_solves"] \
            or not sq["migrate_bytes"] < sq["migrate_fp_equiv_bytes"]:
        raise AssertionError(f"examples serve_quantized: {sq}")
    phase(name, f"serve_quantized: {sq['ptq_tensors']} tensors PTQ'd, "
          f"{sq['compression']:.2f}x; decode agreement dense vs quantized "
          f"{sq['agreement']:.2%}; estimate on the H100's HBM dense "
          f"{sq['estimate']['t_dense_s'] * 1e6:.4f} us -> quantized "
          f"{sq['estimate']['t_quant_s'] * 1e6:.4f} us; disagg frozen "
          f"handoff {sq['migrate_bytes']:,} B against "
          f"{sq['migrate_fp_equiv_bytes']:,} B fp for "
          f"{sq['migrated_pages']} pages "
          f"({sq['migrate_fp_equiv_bytes'] / sq['migrate_bytes']:.2f}x), "
          f"{sq['launches']['paged_decode_attention']} kernel 1 launches; "
          f"{sq['s']:.1f} s")
    phase(name, f"trace_serving: {tr['events']} events, reconciled with "
          f"{tr['decode_steps']} decode steps, {tr['freeze_dispatches']} "
          f"freeze flushes, {tr['spec_steps']} verify slices; "
          f"{tr['launches']['paged_decode_attention']} kernel 1 launches; "
          f"{tr['s']:.1f} s")
    # a method registered at run time, served on the card
    t1 = time.perf_counter()
    register_uniform()
    UNIFORM_CALLS["n"] = 0
    s, params, cfg, args, launches = serve_once(UNIFORM_ARGS)
    calls = UNIFORM_CALLS["n"]
    line = check_launches(s, cfg, launches, quantized=False)
    if calls != s["freeze_dispatches"] or not s["freeze_installs"]:
        raise AssertionError(f"examples uniform: {calls} calls of the "
                             f"registered solver for "
                             f"{s['freeze_dispatches']} freeze dispatches, "
                             f"{s['freeze_installs']} installs")
    phase(name, f"uniform@16 (registered at run time) on the reduced "
          f"qwen3, fused: {calls} calls of its device solver = "
          f"{s['freeze_dispatches']} freeze dispatches -> "
          f"{s['freeze_installs']} installs; {line}")
    r = fused_vs_gather(params, cfg, args, args.kv_quant)
    ok = r["tokens_equal"] and r["rel"] <= UNIFORM_REPLAY_REL_TOL
    phase(name, f"uniform@16 fused vs gather replay (f32): greedy tokens "
          f"{r['agree']}/{r['total']} equal, max|dlogit| {r['dmax']:.4g} "
          f"rel {r['rel']:.4e} (tolerance {UNIFORM_REPLAY_REL_TOL:g}) -> "
          f"{'OK' if ok else 'EXCEEDED'}; {time.perf_counter() - t1:.1f} s")
    if not ok:
        raise AssertionError(f"examples uniform replay: {r}")
    phase(name, f"served examples {time.perf_counter() - t0:.1f} s on "
          f"{card_line()}")
    return dict(out, uniform=dict(launches=launches, calls=calls,
                                  summary=s, replay=r),
                s=time.perf_counter() - t0)


def examples_launches(free: dict, served: dict) -> dict:
    """Every kernel's launches over phase examples."""
    runs = [free[k]["launches"] for k in ("quickstart", "train_lm",
                                          "train_quantized_mlp")]
    runs += [served[k]["launches"] for k in ("serve_quantized",
                                             "trace_serving")]
    runs.append(served["uniform"]["launches"])
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def examples_main() -> int:
    """``--examples``: phase examples alone (the attention kernel built
    first)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("card", f"{card_line()} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    nv = in_thread(lambda: build.load_all(["paged_attention"]))
    free = check_examples_free()
    phase("build", f"paged_attention.cu {joined(nv):.1f} s")
    served = check_examples_served()
    print(json.dumps({"examples_launches": examples_launches(free, served),
                      "s": time.perf_counter() - t0}))
    return 0


def uniform_readings(seeds=(0, 1, 2)) -> int:
    """``--uniform-readings``: the uniform@16 fused-vs-gather replay's
    readings for prompt seeds 0-2, printed without a bound (run it from a
    copy with one line changed to read a planted fault)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    register_uniform()
    for seed in seeds:
        r = uniform_replay(seed)
        print(f"seed {seed} uniform@16 fused vs gather: tokens "
              f"{r['agree']}/{r['total']} equal, max|dlogit| {r['dmax']:.4g}"
              f" of range {r['scale']:.4g}, rel {r['rel']:.4e}", flush=True)
    return 0


def in_thread(fn) -> dict:
    """Start ``fn()`` in a thread (a build: its compilers run as
    processes); ``joined`` waits for it."""
    import threading

    out = {"t0": time.perf_counter()}

    def run():
        try:
            fn()
        except BaseException as e:        # raised by joined
            out["error"] = e
        out["s"] = time.perf_counter() - out["t0"]

    out["thread"] = threading.Thread(target=run, daemon=True)
    out["thread"].start()
    return out


def joined(h: dict) -> float:
    """Wait for an ``in_thread`` job; its seconds (its error raised)."""
    h["thread"].join()
    if "error" in h:
        raise h["error"]
    return h["s"]


def dist_main() -> int:
    """``--dist``: phase dist alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("card", f"{card_line()} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    print(json.dumps({"dist_launches": check_dist()["launches"]}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    phase("card", f"{card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one nvcc per source, all at once, beside the phases that launch no
    # kernel (train, static-ssm, static-families, dist), at a lower
    # priority than theirs (a thread's nice value is its own on Linux, and
    # the compilers it starts inherit it); the kernel phases wait for it
    sources = ("paged_attention", "quant_matmul", "fista_quant")

    def build_niced():
        os.nice(10)
        build.load_all(sources)

    nv = in_thread(build_niced)
    dr = start_dryrun()
    tr = check_train()
    trl = tr["launches"]
    ssm = check_static_ssm()["launches"]
    check_static_families()
    dsl = check_dist()["launches"]
    exf = check_examples_free()
    nv_s = joined(nv)
    dry = check_dryrun(dr, tr["a"]["median_s"])
    drl = dry["launches"]
    for name in sources:
        log = build.library_path(name).with_suffix(".log")
        ptxas = sorted({ln.strip() for ln in log.read_text().splitlines()
                        if "registers" in ln or "spill" in ln})
        phase("build", f"{name}.cu -> sm_90a ({len(sources)} sources in "
              f"parallel beside the kernel-free phases, {nv_s:.1f} s); "
              f"ptxas: {' | '.join(ptxas)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = check_kernel(gen)
    k.update(check_kernel_shapes(gen))
    q = check_qmm(gen)
    f = check_fista(gen)
    check_freeze(gen)
    from repro_torch.configs import get_config
    so = check_solvers(get_config("qwen3_0_6b"), gen)
    check_card_tests()
    check_serve_fp()
    sv = check_serve()
    tc = check_trace(sv["params"], sv["cfg"])
    st = check_stacked_path(sv["params"], sv["cfg"], gen)
    cfg = sv["cfg"]
    it = check_serve_iter_l1(sv["params"])
    dz = check_serve_disagg(sv["params"], sv)
    dzf = check_serve_disagg_frozen(sv["params"])
    ov = check_overload(sv["params"], cfg)
    check_transfer(gen)
    check_disagg_vs_colocated(sv["params"])
    check_static(sv["params"])
    sp = check_serve_spec(sv.pop("params"), sv)
    sp_launches = sp["launches"]
    pb = check_ptq_batched(cfg, gen)
    t0 = time.perf_counter()
    g4 = check_serve_glm4()
    phase("serve-glm4", f"{time.perf_counter() - t0:.1f} s")
    wide = {}
    for name, arch in (("serve-yi", "yi_34b"), ("serve-gemma2", "gemma2_27b")):
        t0 = time.perf_counter()
        wide[arch] = check_serve_wide(name, arch)
        phase(name, f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kh = check_kv_host()
    phase("kv-host", f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gr = check_serve_granite()
    phase("serve-granite", f"{time.perf_counter() - t0:.1f} s")
    exs = check_examples_served()
    exl = examples_launches(exf, exs)
    phase("examples", f"{exf['s'] + exs['s']:.1f} s ({exf['s']:.1f} s "
          f"beside the build, {exs['s']:.1f} s after it); launches {exl}")
    record = {"kernels": [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:242",
         "launches": sv["launches"]["paged_decode_attention"],
         "trace_launches": tc["launches"]["paged_decode_attention"],
         "serve_spec_launches": sp_launches["paged_decode_attention"],
         "serve_disagg_launches": dz["launches"]["paged_decode_attention"],
         "serve_disagg_frozen_launches": dzf["launches"][
             "paged_decode_attention"],
         "overload_launches": ov["launches"]["paged_decode_attention"],
         "serve_glm4_launches": g4["launches"]["paged_decode_attention"],
         "serve_yi_launches": wide["yi_34b"]["launches"][
             "paged_decode_attention"],
         "serve_gemma2_launches": wide["gemma2_27b"]["launches"][
             "paged_decode_attention"],
         "kv_host_launches": sum(r["paged_attention_launches"]
                                 for r in kh.values()),
         "serve_granite_launches": gr["launches"]["paged_decode_attention"],
         "serve_granite_kv_launches": gr["kv_launches"][
             "paged_decode_attention"],
         "static_ssm_launches": ssm["paged_decode_attention"],
         "train_launches": trl["paged_decode_attention"],
         "dist_launches": dsl["paged_decode_attention"],
         "dryrun_launches": drl["paged_decode_attention"],
         "examples_launches": exl["paged_decode_attention"],
         "examples_serve_quantized_launches": exs["serve_quantized"][
             "launches"]["paged_decode_attention"],
         "examples_trace_serving_launches": exs["trace_serving"][
             "launches"]["paged_decode_attention"],
         "examples_uniform_launches": exs["uniform"]["launches"][
             "paged_decode_attention"],
         **k},
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:50",
         "launches": sv["launches"]["quant_matmul"],
         "trace_launches": tc["launches"]["quant_matmul"],
         "serve_spec_launches": sp_launches["quant_matmul"],
         "serve_disagg_launches": dz["launches"]["quant_matmul"],
         "serve_disagg_frozen_launches": dzf["launches"]["quant_matmul"],
         "overload_launches": ov["launches"]["quant_matmul"],
         "serve_glm4_launches": g4["launches"]["quant_matmul"],
         "static_ssm_launches": ssm["quant_matmul"],
         "train_launches": trl["quant_matmul"],
         "dist_launches": dsl["quant_matmul"],
         "dryrun_launches": drl["quant_matmul"],
         "examples_launches": exl["quant_matmul"],
         "solvers_launches": so["quant_matmul"], **q},
        {"name": "quant_matmul_stacked", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:105",
         "static_ssm_launches": ssm["quant_matmul_stacked"],
         "train_launches": trl["quant_matmul_stacked"],
         "dist_launches": dsl["quant_matmul_stacked"],
         "dryrun_launches": drl["quant_matmul_stacked"],
         "examples_launches": exl["quant_matmul_stacked"], **st},
        {"name": "fista_quant", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fista_quant.cu",
         "replaces": "src/repro/kernels/fista_quant.py:79",
         "launches": pb.pop("ptq_launches"),
         "solvers_launches": so["fista_quant"],
         "static_ssm_launches": ssm["fista_quant"],
         "train_launches": trl["fista_quant"],
         "dist_launches": dsl["fista_quant"],
         "dryrun_launches": drl["fista_quant"],
         "examples_launches": exl["fista_quant"], **f["quant"], **pb},
        {"name": "fista_freeze", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fista_quant.cu",
         "replaces": "src/repro/kernels/fista_quant.py:79",
         "launches": it["launches"],
         "freeze_dispatches": it["freeze_dispatches"],
         "solvers_launches": so["fista_freeze"],
         "serve_disagg_frozen_launches": dzf["iter_launches"][
             "fista_freeze"],
         "serve_iter_l1_tpot_p50_ms": it["tpot_p50_ms"],
         "static_ssm_launches": ssm["fista_freeze"],
         "train_launches": trl["fista_freeze"],
         "dist_launches": dsl["fista_freeze"],
         "dryrun_launches": drl["fista_freeze"],
         "examples_launches": exl["fista_freeze"], **f["freeze"]},
    ]}
    phase("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--ssm-readings": ssm_readings,
              "--mlp-readings": mlp_readings,
              "--examples": examples_main,
              "--uniform-readings": uniform_readings,
              "--dist": dist_main,
              "--dryrun": dryrun_main}.get(
                  " ".join(sys.argv[1:]), main)())
