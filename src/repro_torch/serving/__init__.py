"""Serving subsystem (port of ``repro/serving``, slice 1): continuous
batching over a paged KV pool whose full pages freeze to kmeans_ls
codebooks, read through the fused paged-attention kernel."""
from .engine import ContinuousBatchingEngine
from .kv_cache import (BlockAllocator, DoubleFree, PagedKVCache, PagedKVPool,
                       PoolExhausted, dispatch_freeze, freeze_blocks,
                       init_paged_cache, init_paged_layer, install_freeze,
                       page_bytes, paged_layer_from_reference,
                       resolve_kv_spec, thaw_blocks, with_tables)
from .metrics import MetricsCollector, percentile
from .scheduler import (ContinuousBatchingScheduler, Request, SeqState,
                        make_requests, poisson_trace)
from .workers import DecodeWorker, FinishedPrefill, PrefillWorker, sample_token

__all__ = [
    "ContinuousBatchingEngine", "BlockAllocator", "DoubleFree",
    "PagedKVCache", "PagedKVPool", "PoolExhausted", "dispatch_freeze",
    "freeze_blocks", "init_paged_cache", "init_paged_layer",
    "install_freeze", "page_bytes", "paged_layer_from_reference",
    "resolve_kv_spec", "thaw_blocks", "with_tables", "MetricsCollector",
    "percentile", "ContinuousBatchingScheduler", "Request", "SeqState",
    "make_requests", "poisson_trace", "DecodeWorker", "FinishedPrefill",
    "PrefillWorker", "sample_token",
]
