"""Host-side block allocator for the paged KV backend (port of
``repro.paging.block_pool``).

The device holds a per-layer pool of fixed-size K/V blocks
(``paged_cache.PagedCache``); this module owns the topology: which blocks
of each layer's pool are free and how many references each allocated block
holds.  Allocation is host-side numpy and Python lists, the same split vLLM
uses between its block manager and its paged attention kernel.

Block 0 of every layer is the reserved **null block**: table entries that
point nowhere hold 0, and masked writes are redirected into it.  Its
contents are garbage by design; every read path masks by length first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np

from repro_torch.obs import NULL_OBS
from repro_torch.paging import kvquant


class PoolExhausted(RuntimeError):
    """An allocation could not be satisfied.  The scheduler treats it as a
    preemption signal: the pool never hands out a block it does not have,
    so exhaustion cannot corrupt live cache contents."""


@dataclass(frozen=True)
class PagingConfig:
    """Knobs for the paged cache backend.

    ``block_size``: tokens per K/V block (per slot-row, per layer).
    ``n_blocks``: per-layer pool size including the null block; 0 sizes the
    pool to the slot-cache worst case (every (slot, row) fully allocated),
    so nothing is ever preempted.  Undersize it to trade preemptions for
    memory.
    ``kv_dtype``: pool storage — "fp32" (the pools hold the engine dtype,
    bf16 on the card; no quantization), "int8" or "fp8" (int8 codes with
    per-block fp32 scales, dequantized inside the decode kernel).
    ``kv_dtype_overrides``: per-(layer, head) formats, ``{(layer, head):
    "int8" | "fp8"}`` or the equivalent triples; needs a quantized base.
    ``pool_hbm_bytes``: size the per-layer pool from a byte budget instead
    of a block count (exclusive with ``n_blocks``): at one budget an int8
    pool holds about twice the blocks of a bf16 pool, so block-count
    admission admits about twice the tokens.

    There is no ``decode_impl`` knob as in the reference: the device picks
    the implementation, as for every kernel of the port (the hand-written
    CUDA kernel for a CUDA tensor, the plain PyTorch version on the CPU).
    """

    block_size: int = 16
    n_blocks: int = 0
    kv_dtype: str = "fp32"
    kv_dtype_overrides: tuple = ()
    pool_hbm_bytes: int = 0

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.n_blocks < 0:
            raise ValueError(f"n_blocks must be >= 0, got {self.n_blocks}")
        if self.kv_dtype not in kvquant.KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r}; known: "
                f"{list(kvquant.KV_DTYPES)}")
        if self.kv_dtype == "fp8" and not kvquant.fp8_supported():
            raise ValueError(
                "kv_dtype='fp8' requires a torch with float8_e4m3fn")
        # canonical sorted hashable tuple (the dataclass is frozen)
        ov = self.kv_dtype_overrides
        if isinstance(ov, dict):
            ov = tuple((lh[0], lh[1], dt) for lh, dt in ov.items())
        ov = tuple(sorted((int(l), int(h), str(dt)) for l, h, dt in ov))
        object.__setattr__(self, "kv_dtype_overrides", ov)
        if ov and self.kv_dtype == "fp32":
            raise ValueError(
                "kv_dtype_overrides require a quantized base kv_dtype")
        for l, h, dt in ov:
            if dt not in kvquant.QUANT_DTYPES:
                raise ValueError(
                    f"kv_dtype override ({l}, {h}) -> {dt!r}: must be one "
                    f"of {list(kvquant.QUANT_DTYPES)}")
            if l < 0 or h < 0:
                raise ValueError(
                    f"kv_dtype override ({l}, {h}): indices must be >= 0")
        if self.pool_hbm_bytes < 0:
            raise ValueError(
                f"pool_hbm_bytes must be >= 0, got {self.pool_hbm_bytes}")
        if self.pool_hbm_bytes and self.n_blocks:
            raise ValueError(
                "pool_hbm_bytes and n_blocks are mutually exclusive pool "
                "sizing modes; set exactly one (or neither for worst-case)")


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """ceil(tokens / block_size): blocks needed to hold ``tokens`` entries."""
    return -(-int(tokens) // int(block_size))


class BlockPool:
    """Free lists and refcounts over each layer's block pool.

    Deterministic: each layer's free list is kept in descending order and
    ``alloc`` pops from its end, so blocks are handed out lowest id first
    and identical traces give identical tables.  An allocated block starts
    at refcount 1; prefix reuse shares it (`incref`: the prefix index and
    every row that maps it hold one reference each), and it returns to the
    free list when the last reference is dropped (`decref`).

    ``obs`` (the owning backend's handle) counts allocations, frees and
    refusals under the reference's ``pool_*`` names; `sample_gauges`
    records the pool-pressure gauges.  The port's pool is one partition.
    """

    def __init__(self, n_layers: int, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks per layer (1 null + 1 usable), got "
                f"{n_blocks}")
        self.n_layers = int(n_layers)
        self.n_blocks = int(n_blocks)
        self.refcount = np.zeros((n_layers, n_blocks), np.int32)
        self.refcount[:, 0] = 1  # the null block: pinned forever
        self._free: List[List[int]] = [list(range(n_blocks - 1, 0, -1))
                                       for _ in range(n_layers)]
        # most blocks one layer has held at once (the realized need)
        self.peak_in_use = 0
        self.obs = NULL_OBS

    # ---- introspection -----------------------------------------------------

    def free_blocks(self, layer: Optional[int] = None):
        """Free count of one layer, or the (L,) array of all layers."""
        if layer is not None:
            return len(self._free[layer])
        return np.asarray([len(f) for f in self._free], np.int64)

    @property
    def usable_blocks(self) -> int:
        """Allocatable blocks per layer (the null block never is)."""
        return self.n_blocks - 1

    def blocks_in_use(self) -> int:
        """Allocated blocks over all layers (null blocks excluded)."""
        return int(self.n_layers * self.usable_blocks
                   - int(self.free_blocks().sum()))

    def sample_gauges(self, metrics) -> None:
        """Record the pool-pressure gauges: free / in-use totals, free
        blocks per partition (one here), fragmentation (free blocks outside
        each layer's tightest partition: 0 with one partition) and the
        largest refcount (the sharing depth; 1 = none)."""
        free = self.free_blocks()[:, None]  # (L, P = 1)
        metrics.gauge(
            "pool_free_blocks",
            help="free KV blocks, summed over layers and partitions"
        ).set(int(free.sum()))
        metrics.gauge(
            "pool_blocks_in_use",
            help="allocated KV blocks across all layers (nulls excluded)"
        ).set(self.blocks_in_use())
        g = metrics.gauge(
            "pool_free_blocks_partition",
            help="free KV blocks per pool partition (one partition per "
                 "(model shard, data shard) pair), summed over layers")
        for p, v in enumerate(free.sum(axis=0)):
            g.set(int(v), partition=str(p))
        metrics.gauge(
            "pool_fragmentation_blocks",
            help="free blocks outside each layer's tightest partition — "
                 "free but unusable for the admission the tightest "
                 "partition is about to refuse"
        ).set(int((free - free.min(axis=1, keepdims=True)).sum()))
        metrics.gauge(
            "pool_max_refcount",
            help="max block refcount (copy-on-write sharing depth; 1 = "
                 "no sharing)"
        ).set(int(self.refcount.max()))

    # ---- alloc / free ------------------------------------------------------

    def alloc(self, layer: int, n: int) -> List[int]:
        """Allocate ``n`` blocks of ``layer`` (refcount 1 each).  Atomic:
        raises ``PoolExhausted`` without handing out anything when fewer
        than ``n`` are free."""
        free = self._free[layer]
        if n > len(free):
            self.obs.metrics.counter(
                "pool_exhausted_total",
                help="allocations refused by an empty free list (the "
                     "scheduler's preemption signal)").inc()
            raise PoolExhausted(
                f"layer {layer}: requested {n} blocks, {len(free)} free "
                f"(pool {self.usable_blocks}/layer)")
        ids = [free.pop() for _ in range(n)]
        self.refcount[layer, ids] = 1
        self.peak_in_use = max(self.peak_in_use, self.usable_blocks - len(free))
        self.obs.metrics.counter(
            "pool_alloc_blocks_total",
            help="KV blocks handed out by the pool").inc(n)
        return ids

    def incref(self, layer: int, ids: Iterable[int]) -> None:
        """Take one more reference per id (a shared prefix block); every
        id must be allocated."""
        for b in ids:
            if self.refcount[layer, b] < 1:
                raise ValueError(f"incref of unallocated block {b} in layer {layer}")
            self.refcount[layer, b] += 1

    def decref(self, layer: int, ids: Iterable[int]) -> None:
        """Drop one reference per id; blocks reaching 0 return to the free
        list.  Over-freeing raises."""
        freed: List[int] = []
        for b in ids:
            b = int(b)
            if b == 0:
                raise ValueError("null block 0 cannot be freed")
            rc = int(self.refcount[layer, b])
            if rc <= 0:
                raise ValueError(
                    f"double free: block {b} of layer {layer} has "
                    f"refcount {rc}")
            self.refcount[layer, b] = rc - 1
            if rc == 1:
                freed.append(b)
        if freed:
            self.obs.metrics.counter(
                "pool_freed_blocks_total",
                help="KV blocks returned to the pool "
                     "(refcount reached 0)").inc(len(freed))
            fl = self._free[layer]
            fl.extend(freed)
            fl.sort(reverse=True)  # lowest id first via pop()

    def free_table(self, table: np.ndarray) -> None:
        """Decref every nonzero entry of an (L, ...) id table."""
        for layer in range(self.n_layers):
            ids = np.asarray(table[layer]).reshape(-1)
            ids = ids[ids > 0]
            if ids.size:
                self.decref(layer, ids.tolist())

    def check_invariants(self) -> None:
        """Free lists and refcounts partition each layer's pool."""
        for layer in range(self.n_layers):
            fl = self._free[layer]
            free = set(fl)
            if 0 in free:
                raise AssertionError(f"layer {layer}: null block in the free list")
            if len(free) != len(fl):
                raise AssertionError(f"layer {layer}: duplicate free ids")
            for b in range(1, self.n_blocks):
                rc = int(self.refcount[layer, b])
                if rc < 0 or (b in free) != (rc == 0):
                    raise AssertionError(
                        f"layer {layer} block {b}: refcount {rc} but "
                        f"{'free' if b in free else 'allocated'}")
