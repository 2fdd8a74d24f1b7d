"""Paged slot-layout KV cache: block pools + block tables (port of
``repro.paging.paged_cache``).

The slot cache pads every (slot, row) to the static capacity ``C``; the
paged layout stores the same logical cache in fixed-size blocks allocated
in proportion to each (slot, row)'s realized retained length:

    k_pool, v_pool   : (L, N, bs, Dh)  N blocks of bs tokens per layer
    pos_pool         : (L, N, bs) int32  absolute entry positions
    block_table      : (L, S, B, M) int32  block ids per (slot, row); 0 = null
    lengths          : (L, S, B) int32  as in the slot cache
    positions        : (B,) int32  next absolute position per row
    k_scale, v_scale : (L, N) fp32  per-block scales, only for int8/fp8
                                    pools (None otherwise)

``M = ceil(C / bs)``.  Column ``c`` of a (slot, row) lives at offset
``c % bs`` of block ``table[c // bs]``, so gathering the blocks rebuilds the
slot cache's contiguous view and its masking, ring appends and ownership
rule carry over unchanged.  The topology (which table entries are nonzero)
belongs to the host-side ``BlockPool``; the functions here trust the table
they are given.  Unlike the reference, writes update the tensors in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.cache.slot_cache import (Rows, SlotCache, ring_write_index, row_index,
                                          rows_to_mask)
from repro_torch.paging import kvquant
from repro_torch.paging.block_pool import BlockPool, PagingConfig, blocks_for_tokens


@dataclass
class PagedCache:
    k_pool: torch.Tensor  # (L, N, bs, Dh)
    v_pool: torch.Tensor  # (L, N, bs, Dh)
    pos_pool: torch.Tensor  # (L, N, bs) int32
    block_table: torch.Tensor  # (L, S, B, M) int32; 0 = null block
    lengths: torch.Tensor  # (L, S, B) int32
    positions: torch.Tensor  # (B,) int32
    k_scale: Optional[torch.Tensor] = None  # (L, N) fp32 per-block scales
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[2]

    @property
    def n_blocks(self) -> int:
        return self.k_pool.shape[1]


def max_blocks_per_row(capacity: int, block_size: int) -> int:
    return blocks_for_tokens(capacity, block_size)


def block_hbm_bytes(block_size: int, head_dim: int, dtype: torch.dtype,
                    quantized: bool) -> int:
    """Device bytes one K+V block pins: the payload plus, when quantized,
    its two fp32 scale entries (the bytes-aware admission unit)."""
    return 2 * block_size * head_dim * dtype.itemsize + (8 if quantized else 0)


def init_paged_cache(
    n_layers: int, n_slots: int, batch: int, capacity: int, head_dim: int,
    paging: PagingConfig, dtype=torch.bfloat16,
    partitions: Tuple[int, int] = (1, 1),
    kv_quant: Optional[kvquant.KVQuantSpec] = None, device="cpu",
) -> Tuple[PagedCache, BlockPool]:
    """Empty paged cache + its allocator.

    ``paging.n_blocks == 0`` sizes each layer's pool to the slot-cache
    worst case (``S·B·M + 1``), which can never preempt;
    ``paging.pool_hbm_bytes`` sizes it from a byte budget at the storage
    dtype's block footprint.  ``kv_quant`` switches the pools to int8 codes
    with zeroed (L, N) scale pools; ``dtype`` is then only the model dtype.
    Pool partitions (one per mesh shard) belong to the multi-GPU executor
    and are not ported yet.
    """
    if tuple(partitions) != (1, 1):
        raise NotImplementedError(
            f"pool partitions {tuple(partitions)}: the partitioned pool of the "
            f"multi-GPU executor is not ported yet (ROADMAP Queue A.10)")
    bs = paging.block_size
    M = max_blocks_per_row(capacity, bs)
    pool_dtype = torch.int8 if kv_quant is not None else dtype
    if paging.n_blocks:
        n_blocks = paging.n_blocks
    elif paging.pool_hbm_bytes:
        per_block = block_hbm_bytes(bs, head_dim, pool_dtype, kv_quant is not None)
        n_blocks = max(2, paging.pool_hbm_bytes // (n_layers * per_block))
    else:
        n_blocks = n_slots * batch * M + 1
    scale = None
    if kv_quant is not None:
        scale = lambda: torch.zeros((n_layers, n_blocks), dtype=torch.float32,  # noqa: E731
                                    device=device)
    cache = PagedCache(
        k_pool=torch.zeros((n_layers, n_blocks, bs, head_dim), dtype=pool_dtype,
                           device=device),
        v_pool=torch.zeros((n_layers, n_blocks, bs, head_dim), dtype=pool_dtype,
                           device=device),
        pos_pool=torch.full((n_layers, n_blocks, bs), -1, dtype=torch.int32,
                            device=device),
        block_table=torch.zeros((n_layers, n_slots, batch, M), dtype=torch.int32,
                                device=device),
        lengths=torch.zeros((n_layers, n_slots, batch), dtype=torch.int32,
                            device=device),
        positions=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=scale() if scale else None, v_scale=scale() if scale else None,
    )
    return cache, BlockPool(n_layers, n_blocks)


def reset_cache(cache: PagedCache) -> PagedCache:
    """Empty a paged cache in place, to `init_paged_cache`'s contents."""
    for t in (cache.k_pool, cache.v_pool, cache.block_table, cache.lengths,
              cache.positions, cache.k_scale, cache.v_scale):
        if t is not None:
            t.zero_()
    cache.pos_pool.fill_(-1)
    return cache


def _kind_tensor(kinds, shape, device) -> torch.Tensor:
    """Per-slot kind codes as an int32 tensor (all int8 when omitted)."""
    if kinds is None:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return torch.as_tensor(kinds, device=device).to(torch.int32)


# ---------------------------------------------------------------------------
# Views
# ---------------------------------------------------------------------------


def paged_to_slot(cache: PagedCache, capacity: int, kinds=None,
                  out_dtype: Optional[torch.dtype] = None) -> SlotCache:
    """Full materialization into a new SlotCache (replan migration).

    Entries past each (slot, row)'s length are zeroed with position -1, so
    the result obeys the slot cache's masking contract and decodes to the
    paged path's output.  Quantized pools dequantize through the scale
    pools with the decode kernel's interpretation; ``kinds`` is the (L, S)
    per-slot grid (all int8 when omitted) and ``out_dtype`` the dtype of
    the dequantized values (fp32 when omitted).
    """
    L, N, bs, Dh = cache.k_pool.shape
    _, S, B, M = cache.block_table.shape
    dev = cache.k_pool.device
    gids = (torch.arange(L, device=dev)[:, None, None, None] * N
            + torch.clamp(cache.block_table, min=0).long())  # (L, S, B, M)
    k = cache.k_pool.reshape(L * N, bs, Dh)[gids]  # (L, S, B, M, bs, Dh)
    v = cache.v_pool.reshape(L * N, bs, Dh)[gids]
    if cache.k_scale is not None:
        kind = _kind_tensor(kinds, (L, S), dev)[:, :, None, None, None, None]
        k = kvquant.decode(k, cache.k_scale.reshape(-1)[gids][..., None, None], kind)
        v = kvquant.decode(v, cache.v_scale.reshape(-1)[gids][..., None, None], kind)
        if out_dtype is not None:
            k, v = k.to(out_dtype), v.to(out_dtype)
    k = k.reshape(L, S, B, M * bs, Dh)[..., :capacity, :]
    v = v.reshape(L, S, B, M * bs, Dh)[..., :capacity, :]
    pos = cache.pos_pool.reshape(L * N, bs)[gids].reshape(L, S, B, M * bs)
    pos = pos[..., :capacity]
    valid = (torch.arange(capacity, device=dev)[None, None, None, :]
             < cache.lengths[..., None])  # (L, S, B, C)
    return SlotCache(k=torch.where(valid[..., None], k, 0),
                     v=torch.where(valid[..., None], v, 0),
                     lengths=cache.lengths.clone(),
                     pos=torch.where(valid, pos, -1),
                     positions=cache.positions.clone())


# ---------------------------------------------------------------------------
# Writes
# ---------------------------------------------------------------------------


def paged_append_token(
    cache: PagedCache,
    layer: int,
    k_new: torch.Tensor,  # (S, B, Dh) post-RoPE
    v_new: torch.Tensor,  # (S, B, Dh)
    own: torch.Tensor,  # (S, B) bool
    decode_step: int,  # appends since prefill (the ring phase)
    capacity: int,
    ring: int = 128,
    kinds: Optional[torch.Tensor] = None,  # (S,) per-slot kind codes
    positions: Optional[torch.Tensor] = None,  # (B,) recorded positions
) -> None:
    """Append one token for the owned (slot, row) pairs of ``layer``, in
    place; the slot cache's `append_token`, addressed through the table.
    Each entry records its row's absolute position, ``positions`` when
    given (a speculative window writes several per row), else
    ``cache.positions``.

    The write index (recency ring included) is `ring_write_index`'s; the
    backend must have allocated the block that covers it
    (`PagedBackend.prepare_decode`).  Unowned pairs, and owned pairs whose
    block is missing, address the null block and write back the values they
    read there, so those duplicate writes all carry one value.

    Quantized pools quantize on write: the target block's scale grows as a
    running max (``max(old, amax|token| / qmax)``), the block is decoded at
    the old scale, the token inserted, and the block re-encoded at the new
    scale.  When the scale did not grow the re-encode is the identity on
    the other entries, so repeated appends never compound error.
    """
    bs = cache.block_size
    lengths = cache.lengths[layer]  # (S, B)
    idx = ring_write_index(lengths, decode_step, capacity, ring).long()
    blk, off = idx // bs, idx % bs
    bid = torch.gather(cache.block_table[layer], 2, blk[..., None])[..., 0].long()
    valid = own & (bid > 0)
    bid = torch.where(valid, bid, 0)
    kl, vl, pl = cache.k_pool[layer], cache.v_pool[layer], cache.pos_pool[layer]
    at = (bid, off)
    p_new = cache.positions if positions is None else positions
    p_new = p_new[None, :].expand(own.shape)
    pl.index_put_(at, torch.where(valid, p_new, pl[at]))
    if cache.k_scale is None:
        vd = valid[..., None]
        kl.index_put_(at, torch.where(vd, k_new.to(kl.dtype), kl[at]))
        vl.index_put_(at, torch.where(vd, v_new.to(vl.dtype), vl[at]))
    else:
        S = own.shape[0]
        kind = _kind_tensor(kinds, (S,), own.device)
        kind_sb = kind[:, None].expand(own.shape)[..., None, None]  # (S, B, 1, 1)
        qmax = kvquant.qmax_of(kind[:, None])  # (S, 1)
        ins = (valid[..., None] & (torch.arange(bs, device=own.device)
                                   == off[..., None]))[..., None]  # (S, B, bs, 1)
        for pool_l, scale_l, token in ((kl, cache.k_scale[layer], k_new),
                                       (vl, cache.v_scale[layer], v_new)):
            token = token.float()
            old_s = scale_l[bid]  # (S, B)
            new_s = torch.where(
                valid, torch.maximum(old_s, token.abs().amax(dim=-1) / qmax), old_s)
            codes_old = pool_l[bid]  # (S, B, bs, Dh)
            block = kvquant.decode(codes_old, old_s[..., None, None], kind_sb)
            block = torch.where(ins, token[:, :, None, :], block)
            codes = kvquant.encode(block, new_s[..., None, None], kind_sb)
            pool_l.index_put_((bid,), torch.where(valid[..., None, None], codes,
                                                  codes_old))
            scale_l.index_put_((bid,), new_s)
    lengths.copy_(torch.where(own, torch.clamp(lengths + 1, max=capacity), lengths))


def paginate_rows(cache: PagedCache, sub: SlotCache, rows: Rows,
                  table_sub: np.ndarray, kinds=None,
                  table_store: Optional[np.ndarray] = None) -> None:
    """Copy a prefilled slot sub-cache into freshly allocated blocks, in
    place.

    ``table_sub`` (L, S, B_sub, M) comes from `build_table`: entry
    ``[l, s, b, j]`` is the block for columns ``[j·bs, (j+1)·bs)``, 0 past
    the allocated count (those writes land in the null block).  The target
    rows' table, lengths and positions are replaced; they must have been
    released first.  Quantized pools block-quantize the sub-cache on the
    way in (`kvquant.quantize_blocks`), ``kinds`` being the (L, S)
    per-slot grid.

    ``table_store`` (optional) is the table the rows keep when it differs
    from the write addressing: a shared-prefix admission stores the shared
    blocks followed by its fresh ones, while its write table has zeros in
    the shared columns, so a block with refcount > 1 is never written (the
    null-redirect takes those writes).  Default: ``table_sub`` itself.
    """
    L, N, bs, Dh = cache.k_pool.shape
    _, S, B_sub, C, _ = sub.k.shape
    M = table_sub.shape[3]
    pad = M * bs - C
    if pad < 0:
        raise ValueError(f"sub capacity {C} exceeds table span {M * bs}")
    dev = cache.k_pool.device
    k_sub = F.pad(sub.k, (0, 0, 0, pad))
    v_sub = F.pad(sub.v, (0, 0, 0, pad))
    p_sub = F.pad(sub.pos, (0, pad), value=-1)
    if cache.k_scale is not None:
        kind = _kind_tensor(kinds, (L, S), dev)[:, :, None, None]
        k_sub, k_scales = kvquant.quantize_blocks(k_sub, p_sub, bs, kind)
        v_sub, v_scales = kvquant.quantize_blocks(v_sub, p_sub, bs, kind)
    tbl = np.asarray(table_sub, np.int64)
    gids = np.where(tbl > 0, np.arange(L, dtype=np.int64)[:, None, None, None] * N
                    + tbl, 0).reshape(-1)  # null redirect: block 0 of layer 0
    gids = torch.as_tensor(gids, device=dev)
    cache.k_pool.view(L * N, bs, Dh)[gids] = k_sub.reshape(-1, bs, Dh).to(cache.k_pool.dtype)
    cache.v_pool.view(L * N, bs, Dh)[gids] = v_sub.reshape(-1, bs, Dh).to(cache.v_pool.dtype)
    cache.pos_pool.view(L * N, bs)[gids] = p_sub.reshape(-1, bs)
    if cache.k_scale is not None:
        cache.k_scale.view(-1)[gids] = k_scales.reshape(-1)
        cache.v_scale.view(-1)[gids] = v_scales.reshape(-1)
    r = row_index(rows, dev)
    stored = table_sub if table_store is None else table_store
    cache.block_table[:, :, r] = torch.as_tensor(np.asarray(stored, np.int32),
                                                 device=dev)
    cache.lengths[:, :, r] = sub.lengths
    cache.positions[r] = sub.positions


def release_rows(cache: PagedCache, rows: Rows) -> None:
    """Device half of row retirement, in place: clear the rows' table,
    lengths and positions (``rows``: int ids or a (B,) bool mask).  Pool
    contents stay; the host allocator recycles the blocks
    (`BlockPool.decref`, driven by the backend)."""
    r = rows_to_mask(rows, cache.positions.shape[0], cache.k_pool.device)
    cache.block_table[:, :, r] = 0
    cache.lengths[:, :, r] = 0
    cache.positions[r] = 0


def build_table(lengths: np.ndarray, pool: BlockPool, block_size: int,
                max_blocks: int, own: Optional[np.ndarray] = None) -> np.ndarray:
    """Allocate blocks in proportion to realized lengths → (L, S, B, M)
    table (host numpy).

    Owned pairs get at least one block even at length 0, so the first
    decode append has a home.  Blocks fill each layer in row-major (slot,
    row, block) order.  Atomic: on ``PoolExhausted`` everything allocated
    so far is returned before the error propagates.
    """
    L, S, B = lengths.shape
    need = -(-np.asarray(lengths, np.int64) // block_size)  # ceil
    if own is not None:
        need = np.maximum(need, np.asarray(own, np.int64))
    if need.max(initial=0) > max_blocks:
        raise ValueError(
            f"row needs {need.max()} blocks > max_blocks {max_blocks}")
    table = np.zeros((L, S, B, max_blocks), np.int32)
    fill = np.arange(max_blocks)[None, None, None, :] < need[..., None]
    done = []  # (layer, ids) for rollback
    try:
        for layer in range(L):
            ids = pool.alloc(layer, int(need[layer].sum()))
            done.append((layer, ids))
            table[layer][fill[layer]] = ids
    except Exception:
        for layer, ids in done:
            if ids:
                pool.decref(layer, ids)
        raise
    return table
