"""KV-cache adapters: the one interface between attention and cache
storage (port of ``repro/models/cache.py``).

Attention calls

    new_cache, k_all, v_all, q_offset, kv_valid_len = adapter.update(k, v, idx)

and, when the adapter opts in, the fused extensions

    new_cache, out = adapter.fused_decode(q, k, v, softcap=...)
    new_cache, out = adapter.fused_prefill(q, k, v, softcap=...)

gated by ``supports_fused_decode`` / ``supports_fused_prefill`` exactly as
in the reference. The paged serving cache (``serving.kv_cache``) plugs in
through duck typing, so model code never imports serving code.
"""
from __future__ import annotations


def supports_fused_decode(adapter, seq_len: int, window) -> bool:
    """Full-context attention, the adapter opted in via
    ``use_fused_decode``, and a step no longer than its ``fused_window``."""
    if window is not None or not bool(getattr(adapter, "use_fused_decode",
                                              False)):
        return False
    return seq_len <= max(int(getattr(adapter, "fused_window", 1)), 1)


def supports_fused_prefill(adapter, seq_len: int, window) -> bool:
    """Full-context attention and the adapter opted in via
    ``use_fused_prefill`` (any chunk length qualifies)."""
    del seq_len
    return window is None and bool(getattr(adapter, "use_fused_prefill",
                                           False))


class DenseRingCache:
    """Contiguous (B, L, Hkv, Dh) buffers {"k", "v"} written at idx.

    Writes land in place (the reference returns fresh buffers): the dict
    passed in is updated and returned, which saves a copy of the cache
    per layer per step."""

    def __init__(self, cache: dict):
        self.cache = cache

    def update(self, k, v, cache_index: int):
        c = self.cache
        S = k.shape[1]
        c["k"][:, cache_index:cache_index + S] = k.to(c["k"].dtype)
        c["v"][:, cache_index:cache_index + S] = v.to(c["v"].dtype)
        return c, c["k"], c["v"], cache_index, cache_index + S


def as_adapter(cache):
    """Dispatch a cache to its adapter (objects with ``update`` pass
    through; dicts are dense ring buffers)."""
    if isinstance(cache, dict):
        return DenseRingCache(cache)
    if hasattr(cache, "update"):
        return cache
    raise TypeError(f"no KV-cache adapter for {type(cache)!r}")
