"""The trace phase of ``chip_smoke.py`` and its card test on one GPU,
without the other phases: builds the attention and dequant kernels,
serves the main path (PTQ'd qwen3-0.6B at full width and depth), runs
``chip_smoke.check_trace`` on its weights and ``pytest -m cuda -k
tracing`` in a child process, then prints the synchronizing-call warnings
(``torch.cuda.set_sync_debug_mode("warn")``) of three untraced runs of
the reduced engine with asynchronous page freezes and two with
synchronous ones: how many the end-of-run drain adds, one wait a solve
still in flight, depends on the card's timing. Needs one NVIDIA GPU.

    python3 tools/trace_probe.py
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402


def sync_warnings(params, cfg, prompts, freeze_async: bool) -> tuple:
    """(synchronizing-call warnings, freeze installs) of one untraced
    generate() of the reduced engine on the card."""
    from repro_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        params, cfg, device="cuda", max_slots=2, block_size=8,
        max_seq_len=64, kv_quant="kmeans_ls@16", attn_impl="fused",
        freeze_async=freeze_async, prefill_chunk=5)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.generate(prompts, max_new_tokens=12)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return (sum("synchroniz" in str(w.message) for w in caught),
            eng.counters["freeze_installs"])


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import build

    print(sys.version, torch.__version__, torch.version.cuda, cs.card_line())
    t0 = time.perf_counter()
    build.load_all(("paged_attention", "quant_matmul"))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    s, params, cfg, _, launches = cs.serve_once(cs.QUANT_ARGS)
    print(cs.check_launches(s, cfg, launches, quantized=True))
    print(f"main path {time.perf_counter() - t0:.1f} s", flush=True)
    print(cs.check_trace(params, cfg), flush=True)
    del params
    torch.cuda.empty_cache()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", "tests/test_torch_cuda.py", "-k", "tracing"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")),
        capture_output=True, text=True, timeout=600)
    print(res.stdout[-3000:], res.stderr[-2000:], flush=True)
    rcfg = get_reduced_config("qwen3_0_6b")
    rparams = models.init_params(
        rcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, rcfg.vocab, (n,), generator=rng).tolist()
               for n in (20, 16, 31)]
    for freeze_async in (True, True, True, False, False):
        n, installs = sync_warnings(rparams, rcfg, prompts, freeze_async)
        print(f"freeze_async {freeze_async}: {n} sync warnings, {installs} "
              f"freeze installs", flush=True)
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
