"""Serving subsystem (port of ``repro/serving``): continuous batching over
a paged KV pool whose full pages freeze to codebooks, read through the
fused paged-attention kernel, with speculative decoding and prefix
sharing, colocated or disaggregated (prefill workers handing fp pages, or
frozen ones as codes + codebooks, to decode workers), and overload
survival (``overload``: host offload of a victim's pages, preempt and
restore or recompute, SLO-aware admission)."""
from .engine import ContinuousBatchingEngine, DisaggEngine
from .kv_cache import (DEVICE_FREEZE_METHODS, BlockAllocator, DoubleFree,
                       PagedKVCache, PagedKVPool,
                       PoolExhausted, PrefixIndex, dispatch_freeze,
                       freeze_blocks, init_paged_cache, init_paged_layer,
                       install_freeze, page_bytes, paged_layer_from_reference,
                       quantize_page, resolve_kv_spec, thaw_blocks,
                       with_tables)
from .metrics import MetricsCollector, percentile
from .overload import (HostPageStore, OverloadManager, ResumeEntry,
                       SLOAdmission, choose_resume)
from .scheduler import (ContinuousBatchingScheduler, DisaggRouter, Request,
                        SeqState, make_requests, poisson_trace)
from .speculative import DraftWorker, derive_draft, window_step
from .transfer import (FinishedPrefill, PagePayload, extract_pages,
                       extract_resident_pages, splice_payload)
from .workers import DecodeWorker, PrefillWorker, sample_token

__all__ = [
    "ContinuousBatchingEngine", "DisaggEngine", "DisaggRouter",
    "PagePayload", "extract_pages", "extract_resident_pages",
    "splice_payload", "BlockAllocator", "DEVICE_FREEZE_METHODS",
    "DoubleFree",
    "PagedKVCache", "PagedKVPool", "PoolExhausted", "PrefixIndex",
    "dispatch_freeze", "freeze_blocks", "init_paged_cache", "init_paged_layer",
    "install_freeze", "page_bytes", "paged_layer_from_reference",
    "quantize_page", "resolve_kv_spec", "thaw_blocks", "with_tables",
    "MetricsCollector",
    "percentile", "ContinuousBatchingScheduler", "Request", "SeqState",
    "make_requests", "poisson_trace", "DecodeWorker", "FinishedPrefill",
    "PrefillWorker", "sample_token", "DraftWorker", "derive_draft",
    "window_step", "HostPageStore", "OverloadManager", "ResumeEntry",
    "SLOAdmission", "choose_resume",
]
