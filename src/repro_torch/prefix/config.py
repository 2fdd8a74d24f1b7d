"""`PrefixConfig`: the knobs of shared-prefix reuse and chunked prefill
(port of ``repro.prefix.config``).

``enabled`` turns on the content-addressed prefix index (block sharing
across requests); ``chunk_tokens`` > 0 turns on chunked prefill (prompts
processed ``chunk_tokens`` at a time, interleaved with decode ticks).
Chunking works on any backend; sharing also needs the paged backend.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PrefixConfig:
    """Prefix-cache and chunked-prefill configuration.

    enabled        — prompt-prefix blocks of earlier requests are shared
                     (refcounted) with later requests whose prompts start
                     with the same tokens.  Requires ``chunk_tokens > 0``
                     (the hash chain is cut at chunk boundaries) and the
                     paged cache backend.
    chunk_tokens   — split prompt prefill into chunks of this many tokens,
                     one chunk per scheduler tick; 0 = monolithic prefill.
    max_entries    — LRU capacity of the prefix index (unpinned entries are
                     evicted beyond it, and on demand when the pool is dry).
    """

    enabled: bool = False
    chunk_tokens: int = 0
    max_entries: int = 256

    def __post_init__(self):
        if self.chunk_tokens < 0:
            raise ValueError(
                f"chunk_tokens must be >= 0, got {self.chunk_tokens}")
        if self.enabled and self.chunk_tokens <= 0:
            raise ValueError(
                "prefix sharing requires chunked prefill: set chunk_tokens "
                "> 0 (the hash-chain is computed at chunk granularity)")
        if self.max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {self.max_entries}")
