"""Content-addressed index over prompt-prefix blocks (port of
``repro.prefix.index``).

Keys form a hash chain at chunk granularity,
``h_j = sha256(h_{j-1} || tokens[j·c:(j+1)·c])``, so the key of a boundary
commits to every token before it and two prompts share an entry only when
they are byte-identical up to that boundary.  The keys are byte-identical
to the reference's.

An entry is registered when a chunked prefill finishes (the donor's blocks
are final over the prefix by then) and holds one pool reference per block
of its own, so it stays valid after the donor retires.  A hit takes one
more reference per block for the matching request (the paged backend's
splice); copy-on-write in the backend (a block with refcount > 1 is never
written) keeps every holder's view bit-identical.

Eviction is LRU over unpinned entries, both to bound the index
(``max_entries``) and on demand when the pool runs dry.  An entry is
pinned while a chunked prefill reads from it.  The hit / miss / eviction
counters are what `stats` reports, and each also feeds the reference's
``prefix_{hits,misses,evictions}_total`` metric.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import NULL_OBS


@dataclass
class PrefixEntry:
    """Blocks and per-head retained lengths of one prompt-prefix boundary.

    ``table`` is (L, H, M) global block ids (0-padded) and ``lengths`` is
    (L, H) retained entries per kv head: indexed by head, not slot, because
    the slot that owns head ``h`` differs per row under replicated plans
    (the scheduler maps head to slot for the row at hand).  The entry owns
    one pool reference per nonzero id.
    """

    key: bytes
    tokens: int  # prefix length in tokens (a chunk multiple)
    table: np.ndarray  # (L, H, M) int32 block ids
    lengths: np.ndarray  # (L, H) int32 retained entries per head
    pins: int = 0

    def block_count(self) -> int:
        return int((self.table > 0).sum())


class PrefixIndex:
    """Hash-chained longest-prefix lookup with LRU eviction and pins.

    The index touches the pool only to incref at registration and decref
    at eviction; the references of *matching* requests are taken by the
    paged backend's splice (and dropped by its ``release_rows``).
    """

    def __init__(self, chunk_tokens: int, max_entries: int = 256, obs=None):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.chunk_tokens = int(chunk_tokens)
        self.max_entries = int(max_entries)
        self.obs = obs or NULL_OBS
        self.pool = None  # set by the owning scheduler (the backend's pool)
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ---- hashing -----------------------------------------------------------

    def chain_keys(self, prompt: Sequence[int]) -> List[Tuple[int, bytes]]:
        """[(t_j, key_j)] for every full chunk boundary of ``prompt``."""
        toks = np.asarray(prompt, np.int32)
        c = self.chunk_tokens
        out: List[Tuple[int, bytes]] = []
        h = hashlib.sha256(b"repro.prefix.v1")
        for j in range(len(toks) // c):
            h = h.copy()
            h.update(toks[j * c:(j + 1) * c].tobytes())
            out.append(((j + 1) * c, h.digest()))
        return out

    # ---- lookup / registration ---------------------------------------------

    def lookup(self, prompt: Sequence[int]) -> Optional[PrefixEntry]:
        """The longest indexed boundary strictly shorter than the prompt
        (so at least one chunk is recomputed: the request needs fresh
        logits for its first token).  Every boundary key is checked, since
        LRU eviction can drop a middle boundary while a longer one stays.
        A hit moves the entry to the most recently used end."""
        best: Optional[PrefixEntry] = None
        for t_j, key in self.chain_keys(prompt):
            if t_j >= len(prompt):
                break
            hit = self._entries.get(key)
            if hit is not None:
                best = hit
        if best is None:
            self.misses += 1
            self.obs.metrics.counter(
                "prefix_misses_total",
                help="prefix-index lookups with no usable boundary").inc()
            return None
        self._entries.move_to_end(best.key)
        self.hits += 1
        self.obs.metrics.counter(
            "prefix_hits_total",
            help="prefix-index lookups that matched a shared prefix").inc()
        return best

    def register(self, key: bytes, tokens: int, table: np.ndarray,
                 lengths: np.ndarray) -> bool:
        """Adopt one boundary's blocks into the index (increfs them).
        Returns False, and increfs nothing, when the key is already present
        (the entry is refreshed in LRU order instead)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        table = np.ascontiguousarray(table, np.int32)
        entry = PrefixEntry(key=key, tokens=int(tokens), table=table,
                            lengths=np.asarray(lengths, np.int32))
        for layer in range(table.shape[0]):
            ids = table[layer].reshape(-1)
            ids = ids[ids > 0]
            if ids.size:
                self.pool.incref(layer, ids.tolist())
        self._entries[key] = entry
        while len(self._entries) > self.max_entries:
            if not self.evict_lru():
                break  # everything pinned: oversize until something unpins
        return True

    # ---- pinning / eviction ------------------------------------------------

    def pin(self, entry: PrefixEntry) -> None:
        entry.pins += 1

    def unpin(self, entry: PrefixEntry) -> None:
        if entry.pins <= 0:
            raise ValueError(f"unpin of unpinned entry {entry.key.hex()[:12]}")
        entry.pins -= 1

    def evict_lru(self) -> bool:
        """Drop the least recently used unpinned entry; False if none."""
        victim = next((e for e in self._entries.values() if e.pins == 0), None)
        if victim is None:
            return False
        del self._entries[victim.key]
        for layer in range(victim.table.shape[0]):
            ids = victim.table[layer].reshape(-1)
            ids = ids[ids > 0]
            if ids.size:
                self.pool.decref(layer, ids.tolist())
        self.evictions += 1
        self.obs.metrics.counter(
            "prefix_evictions_total",
            help="prefix entries dropped by LRU / pool pressure").inc()
        return True

    def flush(self, decref: bool = True) -> None:
        """Drop every entry.  ``decref=False`` after an accepted migration:
        the backend rebuilt its pool from the live tables only, so the old
        references died with the old pool and must not be returned twice."""
        if decref:
            while self._entries:
                if not self.evict_lru():
                    raise RuntimeError(
                        "flush with pinned prefix entries still live")
        self._entries.clear()

    # ---- stats -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "pinned": sum(1 for e in self._entries.values() if e.pins > 0),
            "blocks_held": sum(e.block_count() for e in self._entries.values()),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
