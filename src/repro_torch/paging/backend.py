"""`PagedBackend`: the block-pool cache backend (port of
``repro.paging.backend``).

Bridges the host-side allocator (`BlockPool`) and the device tensors
(`PagedCache`) behind the `CacheBackend` interface.  A host numpy mirror
of the block table is the single source of truth for the topology (which
blocks belong to which (layer, slot, row)); after each topology change the
device table is rebuilt from it.  Contents (K/V, positions, scales,
lengths) change only through the in-place ops of ``paged_cache``.

Admission is a free-block budget: a request is admissible when every
layer's free list covers its projected prefill blocks plus one growth block
per head.  Later growth is not reserved: when the pool runs dry during
decode the scheduler preempts (this backend raises ``PoolExhausted``).  A
request whose worst case exceeds the whole pool fails at submit
(`never_fits`).

A speculative tick takes provisional blocks for its whole window
(`prepare_decode(n_tokens=...)`) and hands back what the verify pass
rejected (`trim_rows`).

Prefix reuse shares blocks between rows: `splice(shared_blocks=)` maps a
row onto blocks the prefix index already holds (refcounted, never written
through the row), and `prepare_decode` copies a shared block to a private
one before a row's next append would land in it (copy-on-write: only the
recency ring can wrap into a shared prefix).  Admission charges a request
only the blocks it does not share.

With an enabled ``obs`` handle each admission (`from_prefill`, `splice`)
records the codec's error on the admitted sub-cache (``kv_quant_rel_err``,
``kv_quant_tokens_total``; int8 / fp8 pools only), and `sample_metrics`
the pool gauges, ``cache_live_tokens`` and ``kv_bytes_per_token``: all on
the host between steps, outside every captured graph.

Pool partitions (the multi-GPU executor): with ``pool_partitions`` x
``row_partitions`` > 1 each layer's pool splits into one partition per
(model shard, data shard) pair with its own free list, and a (slot, row)
pair's blocks come from its shard's partition (`build_table`,
`prepare_decode`).  The host mirror keeps global ids and is identical on
every rank; on a mesh (``mesh``) a rank holds only its partition of the
pool and its (slots, rows) corner of the device table, writes through ids
made local to its partition, and reads lengths through `host_lengths`.
Admission is gated on the worst partition, so one full shard refuses a
request while the pool has room elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.registry import register_cache_backend
from repro_torch.cache.slot_cache import PlanArrays, take_rows
from repro_torch.compression.policies import layer_keep_bound
from repro_torch.paging import kvquant
from repro_torch.paging.block_pool import BlockPool
from repro_torch.paging.paged_cache import (
    PagedCache,
    block_hbm_bytes,
    build_table,
    init_paged_cache,
    max_blocks_per_row,
    paged_to_slot,
    paginate_rows,
    release_rows,
    reset_cache,
)
from repro_torch.serving import engine as _serve
from repro_torch.serving.cache_backend import CacheBackend, migrate_slots


def _owner_mask_np(pa: PlanArrays, rows: np.ndarray) -> np.ndarray:
    """(L, S, len(rows)) bool — the strided owner rule, on the host."""
    sh = pa.slot_head.cpu().numpy()
    rc = pa.replica_count.cpu().numpy()[:, :, None]
    ri = pa.replica_idx.cpu().numpy()[:, :, None]
    rows = np.asarray(rows, np.int64)[None, None, :]
    return (sh >= 0)[:, :, None] & ((rows % rc) == ri)


@register_cache_backend("paged")
class PagedBackend(CacheBackend):
    name = "paged"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.capacity = self.ccfg.static_capacity()
        self.block_size = self.paging.block_size
        self.max_blocks = max_blocks_per_row(self.capacity, self.block_size)
        self.pool: Optional[BlockPool] = None
        self.table: Optional[np.ndarray] = None  # host mirror (L, S, B, M)
        self.pa: Optional[PlanArrays] = None
        # int8/fp8 storage: the spec, the static (L, H) kind grid, and the
        # scale-reset backlog.  Growth blocks reuse pool blocks whose scale
        # entries are stale; the running-max scale of quantize-on-write
        # would inherit a large stale scale and flush small tokens to code
        # 0, so their scales are zeroed before the first append.
        self.kv_quant = kvquant.spec_from_paging(self.paging)
        self.kv_kinds = (kvquant.kind_grid(self.kv_quant, self.cfg.n_layers,
                                           self.cfg.n_kv_heads)
                         if self.kv_quant is not None else None)
        self.model_dtype: Optional[torch.dtype] = None
        self._pending_scale_reset: List[Tuple[int, List[int]]] = []
        # the mirror holds allocations the device table has not seen (an
        # allocation that raised PoolExhausted in a later layer)
        self._table_stale = False
        # copy-on-write backlog: (layer, old id, new id) content copies
        # queued by `prepare_decode` when a row's next append would land in
        # a shared block.  It survives a PoolExhausted mid-CoW, so the
        # retry loses nothing (the old block stays live: someone holds it)
        self._pending_cow: List[Tuple[int, int, int]] = []
        self.cow_copies = 0  # blocks privatized over the backend's life

    def _slot_kinds(self, pa) -> Optional[np.ndarray]:
        """(L, S) per-slot kinds under ``pa`` (None when unquantized)."""
        if self.kv_kinds is None:
            return None
        return kvquant.slot_kinds(self.kv_kinds, pa.slot_head.cpu().numpy())

    @property
    def partitions(self) -> Tuple[int, int]:
        """(slot parts, row parts) of the pool split."""
        return (self.pool_partitions, self.row_partitions)

    def _offset(self) -> int:
        """Global id of this process's partition's block 0."""
        return 0 if self.mesh is None else self.mesh.part * self.pool.part_size

    def _local_ids(self, table: np.ndarray) -> np.ndarray:
        """Global block ids → ids into the pool this process holds (0 stays
        the null block)."""
        off = self._offset()
        return table if off == 0 else np.where(table > 0, table - off, 0).astype(np.int32)

    def _mine(self) -> Tuple[slice, slice]:
        """(slots, rows) of the mirror whose device table this process holds."""
        return self._shard(self.table.shape[1], self.table.shape[2])

    def _sync_table(self, cache: PagedCache) -> None:
        """Rebuild the device table from the host mirror."""
        sl, rl = self._mine()
        cache.block_table.copy_(torch.from_numpy(np.ascontiguousarray(self.table[:, sl, rl])))

    def _paginate(self, cache: PagedCache, sub, rows, table: np.ndarray,
                  table_write: Optional[np.ndarray] = None) -> None:
        """Copy the sub-cache rows bound for ``rows`` (global ids) into
        their blocks through ``table`` (L, S, len(rows), M): on a mesh only
        this process's slots and rows, written through local ids while the
        stored table keeps the global ones.  ``table_write``: the write
        addressing when it differs (a shared-prefix splice)."""
        sel, loc = self._local_rows(rows)
        if sel.size == 0:
            return
        sl = self._mine()[0]
        if sel.size != len(rows):
            sub = take_rows(sub, sel)
        store = table[:, sl][:, :, sel]
        write = store if table_write is None else table_write[:, sl][:, :, sel]
        kinds = self._slot_kinds(self.pa)
        paginate_rows(cache, sub, loc, self._local_ids(write),
                      kinds=None if kinds is None else kinds[:, sl], table_store=store)

    # ---- state lifecycle ---------------------------------------------------

    def init_state(self, pa, batch, dtype):
        self.pa = pa
        self.n_rows = int(batch)
        self.model_dtype = dtype
        dev = pa.slot_head.device
        if self.cfg.attention_free:  # no cache, no pool
            return _serve.init_serve_state(self.cfg, pa, batch, self.ccfg,
                                           dtype=dtype, device=dev)
        S = int(pa.slot_head.shape[1])
        cache, self.pool = init_paged_cache(
            self.cfg.n_layers, S, batch, self.capacity, self.cfg.head_dim, self.paging,
            dtype=dtype, partitions=self.partitions, kv_quant=self.kv_quant, device=dev,
            shard=None if self.mesh is None else (self.mesh.model_idx, self.mesh.data_idx))
        self.pool.obs = self.obs  # alloc / free / exhaustion counters
        self.table = np.zeros((self.cfg.n_layers, S, batch, self.max_blocks), np.int32)
        self._pending_scale_reset.clear()
        self._pending_cow.clear()
        self._table_stale = False
        return _serve.init_serve_state(self.cfg, pa, batch, self.ccfg,
                                       dtype=dtype, device=dev, cache=cache)

    def from_prefill(self, state, pa):
        """One-shot adoption: re-house a full-batch slot prefill in blocks
        sized to its realized lengths (all rows live).  On a mesh the state
        holds this rank's slots and rows (`Executor.shard_state`)."""
        if state.cache is None:
            self.pa = pa
            self.n_rows = int(state.last_tokens.shape[0])
            return state
        slot = state.cache
        C = slot.k.shape[3]
        if C != self.capacity:
            raise ValueError(f"prefill capacity {C} != backend capacity "
                             f"{self.capacity}")
        B = int(state.last_tokens.shape[0])
        lengths = self.host_lengths(state)
        empty = self.init_state(pa, B, slot.k.dtype)  # fresh pool + mirror
        own = _owner_mask_np(pa, np.arange(B))
        self.table = build_table(lengths, self.pool, self.block_size, self.max_blocks,
                                 own=own, partitions=self.partitions, n_rows=B)
        rl = self._mine()[1]
        self._paginate(empty.cache, slot, np.arange(rl.start, rl.stop), self.table[:, :, rl])
        self._observe_quant_error(slot)
        state.cache = empty.cache
        return state

    def splice(self, state, sub, rows, shared_blocks=None):
        """Admit: allocate blocks for the sub-state's realized lengths and
        copy its contents in.  Atomic on ``PoolExhausted``.

        ``shared_blocks`` ((L, S, len(rows), M) int32) carries a prefix
        hit's blocks: each (layer, slot, row)'s shared full blocks,
        contiguous from column 0, already holding the matched prefix.
        Fresh blocks are allocated for the rest only (first, so a
        ``PoolExhausted`` changes nothing); the shared ids are incref'd and
        the stored table maps the row onto them, while their columns are
        written to the null block, so a hit costs ``need - shared`` new
        blocks and a shared block is never written.
        """
        if state.cache is None:
            return _serve.splice_state(state, sub, rows)
        rows_np = np.asarray(rows, np.int64)  # retired rows: no blocks held
        own = _owner_mask_np(self.pa, rows_np)
        lengths = self.host_lengths(sub, rows=False)  # the sub-state's rows are whole
        place = dict(partitions=self.partitions, rows=rows_np, n_rows=self.n_rows)
        if shared_blocks is None:
            table_sub = build_table(lengths, self.pool, self.block_size,
                                    self.max_blocks, own=own, **place)
            self.table[:, :, rows_np, :] = table_sub
            self._paginate(state.cache, sub.cache, rows_np, table_sub)
            self._observe_quant_error(sub.cache, rows=False)
            return _serve.set_row_state(state, rows_np, sub)
        shared = np.asarray(shared_blocks, np.int32)
        n_sh = (shared > 0).sum(axis=-1)  # (L, S, R) shared full blocks
        fresh = build_table(np.maximum(lengths - n_sh * self.block_size, 0),
                            self.pool, self.block_size, self.max_blocks, own=own, **place)
        L, S, R, M = fresh.shape
        for layer in range(L):
            ids = shared[layer][shared[layer] > 0]
            if ids.size:
                self.pool.incref(layer, ids.tolist())
        table_full = np.zeros_like(fresh)
        for layer, s, r in zip(*np.nonzero(own | (n_sh > 0))):
            f = int(n_sh[layer, s, r])
            fr = fresh[layer, s, r][fresh[layer, s, r] > 0]
            nf = min(fr.size, M - f)
            table_full[layer, s, r, :f] = shared[layer, s, r, :f]
            table_full[layer, s, r, f:f + nf] = fr[:nf]
            if fr.size > nf:  # a fully shared row at capacity: the growth
                self.pool.decref(layer, fr[nf:].tolist())  # block has no home
        self.table[:, :, rows_np, :] = table_full
        col = np.arange(M)[None, None, None, :]
        table_write = np.where(col < n_sh[..., None], 0, table_full)
        self._paginate(state.cache, sub.cache, rows_np, table_full, table_write=table_write)
        self._observe_quant_error(sub.cache, rows=False)
        return _serve.set_row_state(state, rows_np, sub)

    def _observe_quant_error(self, slot, rows: bool = True) -> None:
        """Quantization-error observation: roundtrip the admitted slot-layout
        sub-cache through the codec and record the relative error.  Only
        with obs on and int8 / fp8 pools (it costs a second encode pass and
        a sync); it reads the sub-cache and writes nothing.  On a mesh the
        sums are this rank's slots (and rows, when ``rows``) summed over
        the mesh, the same on every rank."""
        if self.kv_kinds is None or not self.obs.enabled:
            return
        sl = self._mine()[0]
        kinds = torch.as_tensor(self._slot_kinds(self.pa)[:, sl],
                                device=slot.k.device)[:, :, None, None]
        err_k, den_k = kvquant.roundtrip_error(slot.k, slot.pos, self.block_size, kinds)
        err_v, den_v = kvquant.roundtrip_error(slot.v, slot.pos, self.block_size, kinds)
        tokens = float(slot.lengths.sum())
        if self.mesh is not None:
            err_k, den_k, err_v, den_v, tokens = self.mesh.sum_over(
                [err_k, den_k, err_v, den_v, tokens], rows=rows)
        self.obs.metrics.counter(
            "kv_quant_tokens_total",
            help="KV tokens quantized into the paged pools").inc(int(tokens))
        self.obs.metrics.gauge(
            "kv_quant_rel_err",
            help="mean relative KV quantization error over the last "
                 "admitted sub-cache (Σ|deq(q(x))−x| / Σ|x|)"
        ).set(float((err_k + err_v) / max(den_k + den_v, 1e-9)))

    def release_rows(self, state, rows):
        if state.cache is None:
            return _serve.reset_state_rows(state, rows)
        rows_np = np.asarray(rows, np.int64)
        self.pool.free_table(
            self.table[:, :, rows_np, :].reshape(self.table.shape[0], -1))
        self.table[:, :, rows_np, :] = 0
        sel, loc = self._local_rows(rows_np)
        if sel.size:
            release_rows(state.cache, loc)
        return _serve.set_row_state(state, rows_np)

    def prepare_decode(self, state, active, n_tokens: int = 1):
        """Allocate the blocks backing each active row's next ``n_tokens``
        appends.

        The next write index is ``lengths`` while a row is below capacity
        (past that the recency ring revisits allocated blocks), so an owned
        (layer, slot, row) needs blocks through
        ``(min(len + n_tokens, capacity) - 1) // bs``.  With ``n_tokens >
        1`` (a speculative window) the extra blocks are provisional:
        `trim_rows` hands back those the verify pass did not keep.  Raises
        ``PoolExhausted`` when a layer's free list runs dry — the
        scheduler's preemption signal — leaving the mirror consistent.

        Copy-on-write: before growth is allocated, an owned next write that
        would land in a shared (refcount > 1) block gets a private block
        first (alloc, decref the shared id, queue a content copy of codes,
        positions and, on int8/fp8 pools, block scales).  Checking the
        first write block suffices for any ``n_tokens``: later writes of
        the window land in blocks this call allocates, and at-capacity rows
        (the only ring-wrap case) are clamped to one-token windows by the
        scheduler.  A shared write that survives this is a hard error.
        """
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        if state.cache is None:
            return state
        cache = state.cache
        B = self.table.shape[2]
        rows = np.arange(B) if active is None else np.asarray(list(active), np.int64)
        if rows.size:
            lens = self.host_lengths(state)[:, :, rows]  # (L, S, R)
            own = _owner_mask_np(self.pa, rows)
            blk = self._next_write_blocks(state, lens)  # (L, S, R)
            if int(self.pool.refcount.max()) > 1:
                self._cow_next_writes(rows, own, blk)
            have = (self.table[:, :, rows, :] > 0).sum(axis=-1)  # (L, S, R)
            growing = own & (lens < self.capacity)
            end = np.minimum(lens + n_tokens, self.capacity)  # exclusive
            need = np.where(growing, (end - 1) // self.block_size + 1, have)
            missing = np.maximum(need - have, 0)
            L, S = self.table.shape[:2]
            slot_parts, row_parts = self.partitions
            s_per, b_per = S // slot_parts, -(-B // row_parts)
            for layer in range(L):
                for sp in range(slot_parts):
                    for rp in range(row_parts):
                        cols = np.nonzero(rows // b_per == rp)[0]
                        miss = missing[layer, sp * s_per:(sp + 1) * s_per][:, cols]
                        n = int(miss.sum())
                        if n == 0:
                            continue
                        ids = self.pool.alloc(layer, n, partition=sp * row_parts + rp)
                        self._table_stale = True
                        if self.kv_kinds is not None:
                            self._pending_scale_reset.append((layer, list(ids)))
                        hv = have[layer, sp * s_per:(sp + 1) * s_per][:, cols]
                        at = 0
                        for s, c in zip(*np.nonzero(miss)):
                            m, h = int(miss[s, c]), int(hv[s, c])
                            self.table[layer, sp * s_per + s, rows[cols[c]],
                                       h:h + m] = ids[at:at + m]
                            at += m
            if int(self.pool.refcount.max()) > 1:
                # every owned next write must have been privatized above
                tbl = self.table[:, :, rows, :]
                bid = np.take_along_axis(tbl, blk[..., None], axis=-1)[..., 0]
                l_ix = np.arange(tbl.shape[0])[:, None, None]
                still = own & (bid > 0) & (self.pool.refcount[l_ix, bid] > 1)
                if still.any():
                    lyr, s, r = next(zip(*np.nonzero(still)))
                    raise RuntimeError(
                        f"next decode append for (layer {lyr}, slot {s}, row "
                        f"{rows[r]}) targets shared block {int(bid[lyr, s, r])} "
                        f"(refcount > 1); copy-on-write failed to privatize it")
        self._apply_pending(cache)
        if self._table_stale:
            self._sync_table(cache)
            self._table_stale = False
        return state

    def _next_write_blocks(self, state, lens: np.ndarray) -> np.ndarray:
        """(L, S, R) block index of each pair's next append: the host
        mirror of `ring_write_index` (``lens`` below capacity, the shared
        ring phase at capacity)."""
        cap = self.capacity
        ring = max(1, min(max(1, self.ccfg.decode_margin), cap))
        cyc = (cap - ring) + int(state.decode_steps) % ring
        return np.where(lens < cap, lens, cyc) // self.block_size

    def _cow_next_writes(self, rows, own, blk) -> None:
        """Privatize the shared blocks under the next write index: each
        gets a fresh block in the mirror and the pool, and a queued content
        copy.  A PoolExhausted mid-loop is safe to retry: the queue
        survives and the replacements made so far are consistent."""
        tbl = self.table[:, :, rows, :]  # (L, S, R, M)
        bid = np.take_along_axis(tbl, blk[..., None], axis=-1)[..., 0]
        l_ix = np.arange(tbl.shape[0])[:, None, None]
        hit = own & (bid > 0) & (self.pool.refcount[l_ix, bid] > 1)
        for layer, s, r in zip(*np.nonzero(hit)):
            old = int(bid[layer, s, r])
            new = int(self.pool.alloc(layer, 1, partition=self.pool.partition_of(old))[0])
            self.pool.decref(layer, [old])
            self.table[layer, s, rows[r], int(blk[layer, s, r])] = new
            self._table_stale = True
            self._pending_cow.append((int(layer), old, new))
            self.cow_copies += 1

    def _apply_pending(self, cache: PagedCache) -> None:
        """Flush the queued scale resets, then the queued CoW copies, into
        the device pools, in place.

        Resets first: an id queued for a reset, freed by a preemption and
        handed out again as a CoW destination must end with the donor's
        copied scale, not zero.  Copies run in queue order: a freed and
        reused id appears as a destination only after every entry that
        reads it as a source, so no copy reads clobbered content.  A
        privatized block copies its codes and scales verbatim (never a
        second quantization).  On a mesh each process applies the entries of
        its own partition, through local ids."""
        off = self._offset()
        mine = (lambda b: True) if self.mesh is None else (
            lambda b: self.pool.partition_of(b) == self.mesh.part)
        if self._pending_scale_reset:
            for layer, ids in self._pending_scale_reset:
                ids = [b - off for b in ids if mine(b)]
                if not ids:
                    continue
                idx = torch.as_tensor(ids, device=cache.k_scale.device)
                cache.k_scale[layer, idx] = 0.0
                cache.v_scale[layer, idx] = 0.0
            self._pending_scale_reset.clear()
        for layer, old, new in self._pending_cow:
            if not mine(new):
                continue
            old, new = old - off, new - off
            cache.k_pool[layer, new] = cache.k_pool[layer, old]
            cache.v_pool[layer, new] = cache.v_pool[layer, old]
            cache.pos_pool[layer, new] = cache.pos_pool[layer, old]
            if cache.k_scale is not None:
                cache.k_scale[layer, new] = cache.k_scale[layer, old]
                cache.v_scale[layer, new] = cache.v_scale[layer, old]
        self._pending_cow.clear()

    def trim_rows(self, state, rows):
        """Release provisional blocks no longer covered by ``lengths``.

        Speculative verify rolls rejected window entries back by lowering
        the device ``lengths``; the host mirror still maps the blocks that
        backed them.  For the given rows, every mapped block past
        ``ceil(len / bs)`` (taken by `prepare_decode(n_tokens=...)` for
        writes that were rejected or never made) goes back to the pool and
        its mirror entry is zeroed; then the device table is synced.  A
        recycled block's stale scale is reset when `prepare_decode` hands it
        out again.
        """
        rows_np = np.asarray(list(rows), np.int64)
        if rows_np.size == 0:
            return state
        cache = state.cache
        lens = self.host_lengths(state)[:, :, rows_np]  # (L, S, R)
        keep = -(-lens // self.block_size)  # ceil: blocks still covered
        tbl = self.table[:, :, rows_np, :]  # (L, S, R, M)
        past = np.arange(tbl.shape[-1])[None, None, None, :] >= keep[..., None]
        drop = np.where(past, tbl, 0)
        if drop.max(initial=0) == 0:
            return state
        self.pool.free_table(drop.reshape(self.table.shape[0], -1))
        self.table[:, :, rows_np, :] = np.where(past, 0, tbl)
        self._sync_table(cache)  # the mirror changed: the device table follows
        return state

    def rollback_rows(self, state, back):
        """Take the newest ``k`` entries of each row of ``back`` ({global
        row: k}) back out of the cache: the row's owned (layer, slot)
        lengths and its position drop by ``k``.  A replay cuts a committed
        speculative run so; `trim_rows` then frees the blocks past them."""
        rows = np.asarray([r for r, k in back.items() if k > 0], np.int64)
        sel, loc = self._local_rows(rows)
        if sel.size == 0:
            return state
        k = np.asarray([back[int(r)] for r in rows[sel]], np.int32)
        own = _owner_mask_np(self.pa, rows[sel])[:, self._mine()[0]]  # (L, S, R)
        cache = state.cache
        dev = cache.lengths.device
        idx = torch.as_tensor(loc, device=dev)
        cache.lengths[:, :, idx] -= torch.as_tensor((own * k).astype(np.int32), device=dev)
        cache.positions[idx] -= torch.as_tensor(k, device=dev)
        return state

    def migrate_cache(self, cache, old_pa, new_pa, active_rows=None):
        """Trial re-layout for a replan: materialize → migrate → allocate in
        a fresh trial allocator; the device re-pagination waits for
        ``commit`` (a rejected replan never pays it).  ``PoolExhausted``
        from the trial leaves the backend untouched."""
        # dequantized through the live scales, back in the model dtype, so
        # the re-pagination quantizes from full precision values; a mesh
        # rank reads its partition through local ids and its slots' kinds,
        # and the migration gathers the slot dim over the model group
        sl, rl = self._mine()
        old_kinds = self._slot_kinds(old_pa)
        view = cache if self.mesh is None else dataclasses.replace(
            cache, block_table=torch.from_numpy(
                self._local_ids(self.table[:, sl, rl])).to(cache.k_pool.device))
        slot = paged_to_slot(view, self.capacity,
                             kinds=None if old_kinds is None else old_kinds[:, sl],
                             out_dtype=self.model_dtype)
        slot2 = migrate_slots(slot, old_pa, new_pa, self.mesh)
        lengths = self._host(slot2.lengths)
        B = self.table.shape[2]
        rows = np.arange(B) if active_rows is None else np.asarray(
            list(active_rows), np.int64)
        own = np.zeros((self.table.shape[0], self.table.shape[1], B), bool)
        if rows.size:
            own[:, :, rows] = _owner_mask_np(new_pa, rows)
        trial = BlockPool(self.pool.n_layers, self.pool.n_blocks,
                          n_partitions=self.pool.n_partitions)
        trial.obs = self.obs  # trial allocations are real allocator work
        table = build_table(lengths, trial, self.block_size, self.max_blocks, own=own,
                            partitions=self.partitions, n_rows=B)

        def commit():
            # re-paginate into the live tensors, emptied as a fresh pool
            # would be: their addresses stay
            reset_cache(cache)
            trial.peak_in_use = max(trial.peak_in_use, self.pool.peak_in_use)
            self.pool, self.table, self.pa = trial, table, new_pa
            self._paginate(cache, slot2, np.arange(rl.start, rl.stop), table[:, :, rl])
            self._pending_scale_reset.clear()
            self._pending_cow.clear()
            self._table_stale = False
            return cache

        return torch.from_numpy(lengths), commit

    # ---- admission accounting ----------------------------------------------

    def _layer_blocks(self, prompt_len: int, max_new: int,
                      worst_case: bool) -> np.ndarray:
        """(L,) projected block need per layer: the prefill bound plus one
        growth block per head (admission), or the whole generation's bound
        (``worst_case``, the fail-fast check)."""
        H, L = self.cfg.n_kv_heads, self.cfg.n_layers
        bs = self.block_size
        out = np.zeros(L, np.int64)
        for layer in range(L):
            tokens = layer_keep_bound(self.ccfg.policy, self.ccfg, prompt_len,
                                      H, layer, L)
            if worst_case:
                tokens = min(tokens + H * max_new,
                             H * min(prompt_len + max_new, self.capacity))
                out[layer] = tokens // bs + H
            else:
                out[layer] = tokens // bs + 2 * H  # rounding + 1 growth block/head
        return out

    def _partition_need(self, prompt_len: int, max_new: int,
                        worst_case: bool) -> np.ndarray:
        """(L, slot parts) projected block need per (layer, model shard).

        The per-layer token bound splits over the shards in proportion to
        the plan's occupied slots there (replicas split rows, so a shard's
        expected share of a request's tokens follows its share of occupied
        slots); the per-slot growth and rounding slack is charged where the
        slots sit.  So admission is per model shard: one shard's full
        partition refuses a request while the pool has room elsewhere."""
        P = self.pool_partitions
        sh = self.pa.slot_head.cpu().numpy()  # (L, S)
        L, S = sh.shape
        occ = (sh >= 0).reshape(L, P, S // P).sum(axis=2)  # (L, P)
        frac = occ / np.maximum(occ.sum(axis=1, keepdims=True), 1)
        H, bs = self.cfg.n_kv_heads, self.block_size
        out = np.zeros((L, P), np.int64)
        for layer in range(L):
            tokens = layer_keep_bound(self.ccfg.policy, self.ccfg, prompt_len, H, layer, L)
            if worst_case:
                tokens = min(tokens + H * max_new,
                             H * min(prompt_len + max_new, self.capacity))
                slack = occ[layer]
            else:
                slack = 2 * occ[layer]  # rounding + 1 growth block per slot
            out[layer] = np.ceil(tokens * frac[layer] / bs).astype(np.int64) + slack
        return out

    def request_cost(self, req):
        if self.cfg.attention_free:
            return 0
        return int(self._layer_blocks(req.prompt_len, req.max_new_tokens,
                                      worst_case=True).sum())

    def admissible(self, state, req, pending=()):
        if self.pool is None:
            return True
        if self.pool.n_partitions > 1:
            need = self._partition_need(req.prompt_len, req.max_new_tokens, False)
            for p in pending:
                need = need + self._partition_need(p.prompt_len, p.max_new_tokens, False)
            free = self.pool.free_blocks_by_partition()  # (L, P)
            # the request lands in one row partition, unknown here: the
            # worst one must fit, so admission never over-commits a shard
            free = free.reshape(free.shape[0], self.pool_partitions,
                                self.row_partitions).min(axis=2)
            return bool((free >= need).all())
        need = np.zeros(self.cfg.n_layers, np.int64)
        for r in (req, *pending):
            need += self._discount_shared(
                self._layer_blocks(r.prompt_len, r.max_new_tokens, worst_case=False), r)
        return bool((self.pool.free_blocks() >= need).all())

    @staticmethod
    def _discount_shared(need: np.ndarray, req) -> np.ndarray:
        """Admission charges only unshared blocks: a prefix hit stamps
        ``req.prefix_shared_blocks`` ((L,) full blocks reused from the
        index), and those are already allocated."""
        sh = getattr(req, "prefix_shared_blocks", None)
        if sh is None:
            return need
        return np.maximum(need - np.asarray(sh, np.int64), 0)

    def never_fits(self, req):
        if self.cfg.attention_free:
            return None
        if self.pool is not None and self.pool.n_partitions > 1:
            need = self._partition_need(req.prompt_len, req.max_new_tokens, True)
            usable = self.pool.part_size - 1
            if int(need.max()) > usable:
                return (f"worst-case need of {int(need.max())} blocks in one (layer, "
                        f"model-shard) partition exceeds the partition ({usable} "
                        f"usable blocks)")
            return None
        need = self._layer_blocks(req.prompt_len, req.max_new_tokens,
                                  worst_case=True)
        usable = (self.pool.usable_blocks if self.pool is not None
                  else self.paging.n_blocks - 1 if self.paging.n_blocks
                  else None)
        if usable is not None and int(need.max()) > usable:
            return (f"worst-case need of {int(need.max())} blocks/layer "
                    f"exceeds the pool ({usable} usable blocks/layer)")
        return None

    # ---- telemetry ---------------------------------------------------------

    def sample_metrics(self, state) -> None:
        if self.pool is None:
            return
        self.pool.sample_gauges(self.obs.metrics)
        live = int(self.host_lengths(state).sum())
        self.obs.metrics.gauge(
            "cache_live_tokens",
            help="Σ retained KV tokens across the live cache").set(live)
        if isinstance(state.cache, PagedCache):
            per_block = block_hbm_bytes(self.block_size, self.cfg.head_dim,
                                        state.cache.k_pool.dtype,
                                        self.kv_kinds is not None)
            self.obs.metrics.gauge(
                "kv_bytes_per_token",
                help="HBM bytes pinned per live KV token (allocated "
                     "blocks x per-block footprint incl. scales / "
                     "live tokens) — the decode-bandwidth unit the "
                     "kv_dtype knob halves (DESIGN.md §15)"
            ).set(self.pool.blocks_in_use() * per_block / max(live, 1))

    def memory_stats(self, state) -> dict:
        c = state.cache
        if c is None:  # attention-free: no cache, no pool
            return {"backend": self.name, "block_size": self.block_size,
                    "blocks_in_use": 0, "blocks_total": 0, "cache_bytes": 0,
                    "pool_bytes": 0, "slot_equivalent_bytes": 0, "live_tokens": 0}
        lens = self.host_lengths(state)
        if not isinstance(c, PagedCache):
            # prefill leaves the cache in slot layout until generate adopts it
            (L, S, B), (C, Dh) = lens.shape, c.k.shape[3:]
            return {"backend": self.name, "layout": "slot (pre-adoption)",
                    "block_size": self.block_size,
                    "blocks_in_use": 0, "blocks_total": 0,
                    "peak_blocks_in_use_per_layer": 0,
                    "cache_bytes": int(2 * L * S * B * C * Dh * c.k.element_size()),
                    "pool_bytes": 0, "slot_equivalent_bytes": 0,
                    "live_tokens": int(lens.sum())}
        bs, Dh = c.k_pool.shape[2:]
        L, S, B = lens.shape
        # K + V payload (+ the two fp32 scales when quantized); the slot
        # baseline stays in the model dtype: it is the cache the pool replaces
        block_bytes = block_hbm_bytes(bs, Dh, c.k_pool.dtype, c.k_scale is not None)
        model_item = (self.model_dtype or c.k_pool.dtype).itemsize
        in_use = self.pool.blocks_in_use()
        usable = self.pool.usable_blocks
        return {
            "backend": self.name,
            "block_size": bs,
            "kv_dtype": self.paging.kv_dtype,
            "blocks_in_use": in_use,
            "blocks_total": L * usable,
            "peak_blocks_in_use_per_layer": self.pool.peak_in_use,
            "cache_bytes": in_use * block_bytes,
            "pool_bytes": L * usable * block_bytes,
            "slot_equivalent_bytes": int(2 * L * S * B * self.capacity * Dh * model_item),
            "live_tokens": int(lens.sum()),
        }
