"""Slot-layout budgeted KV cache (port of ``repro.cache.slot_cache``).

Layout: every model shard owns ``slots_per_shard`` *slots*; globally

    k, v     : (L, S, B, C, Dh)   S = total slots, C = static capacity
    lengths  : (L, S, B) int32     retained tokens per (slot, row); 0 for
                                   unowned rows and empty slots
    pos      : (L, S, B, C) int32  absolute position of each entry (-1 = none)
    positions: (B,) int32          next absolute position per row (for RoPE)

Replicas of one head split the batch by the strided rule
``owner(slot, b) = (b % replica_count) == replica_idx``; a slot only ever has
nonzero ``lengths`` on rows it owns, so the decode kernel's work is
proportional to Σ lengths and unowned pairs give exactly-zero output.

Unlike the reference (immutable arrays, a new cache per update), the port
updates the cache tensors in place: `fill_from_selection` overwrites one
layer's slice and `append_token` writes only the one column per (slot, row)
that receives the new token.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.placement import HeadPlacement


@dataclass
class PlanArrays:
    """Runtime form of a HeadPlacement, as tensors on the serving device.

    slot_head / replica_idx / replica_count: (L, S) int32.
    first_slot: (L, Hkv) int64 — the replica-0 slot of each head (prefill
    recovers original-layout weights from the slot layout through it, so no
    second weight copy is stored).
    """

    slot_head: torch.Tensor
    replica_idx: torch.Tensor
    replica_count: torch.Tensor
    first_slot: torch.Tensor

    @staticmethod
    def from_plan(plan: HeadPlacement, device="cpu") -> "PlanArrays":
        arrs = plan.as_arrays()
        sh = arrs["slot_head"]
        L, S = sh.shape
        first = np.zeros((L, plan.n_heads), dtype=np.int64)
        for l in range(L):
            for h in range(plan.n_heads):
                first[l, h] = int(np.nonzero(sh[l] == h)[0][0])

        def t(a):
            return torch.as_tensor(a, device=device)

        return PlanArrays(slot_head=t(arrs["slot_head"]),
                          replica_idx=t(arrs["replica_idx"]),
                          replica_count=t(arrs["replica_count"]),
                          first_slot=t(first))

    def owner_mask(self, layer: int, batch: int) -> torch.Tensor:
        """(S, B) bool — slot owns row."""
        rows = torch.arange(batch, dtype=torch.int32, device=self.slot_head.device)
        return self.owner_mask_rows(layer, rows)

    def owner_mask_rows(self, layer: int, rows: torch.Tensor) -> torch.Tensor:
        """(S, len(rows)) bool ownership for explicit *global* row ids (the
        strided owner rule keys on the global batch-row index)."""
        rows = rows.to(torch.int32)[None, :]
        rc = self.replica_count[layer][:, None]
        ri = self.replica_idx[layer][:, None]
        valid = (self.slot_head[layer] >= 0)[:, None]
        return valid & ((rows % rc) == ri)

    def owner_mask_all(self, batch: int) -> torch.Tensor:
        """(L, S, B) bool — `owner_mask` over every layer at once."""
        rows = torch.arange(batch, dtype=torch.int32,
                            device=self.slot_head.device)[None, None, :]
        rc = self.replica_count[:, :, None]
        ri = self.replica_idx[:, :, None]
        valid = (self.slot_head >= 0)[:, :, None]
        return valid & ((rows % rc) == ri)


@dataclass
class SlotCache:
    k: torch.Tensor  # (L, S, B, C, Dh)
    v: torch.Tensor  # (L, S, B, C, Dh)
    lengths: torch.Tensor  # (L, S, B) int32
    pos: torch.Tensor  # (L, S, B, C) int32
    positions: torch.Tensor  # (B,) int32


def init_cache(n_layers: int, n_slots: int, batch: int, capacity: int,
               head_dim: int, dtype=torch.bfloat16, device="cpu") -> SlotCache:
    shape = (n_layers, n_slots, batch, capacity)
    return SlotCache(
        k=torch.zeros(shape + (head_dim,), dtype=dtype, device=device),
        v=torch.zeros(shape + (head_dim,), dtype=dtype, device=device),
        lengths=torch.zeros(shape[:3], dtype=torch.int32, device=device),
        pos=torch.full(shape, -1, dtype=torch.int32, device=device),
        positions=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def ring_write_index(lengths: torch.Tensor, total_appended: int,
                     capacity: int, ring: int) -> torch.Tensor:
    """Write position for the next token.

    While a row is below capacity, append at ``lengths``.  Once full, cycle
    through the last ``ring`` positions (a recency window): overwritten
    entries are the oldest *dynamic* tokens; the compression-selected head
    of the buffer is preserved.  ``total_appended`` counts decode appends so
    far (the cycle phase, shared across rows).
    """
    ring = max(1, min(ring, capacity))
    cyc = capacity - ring + total_appended % ring
    return torch.where(lengths < capacity, lengths, cyc).to(torch.int32)


def append_token(
    cache: SlotCache,
    layer: int,
    k_new: torch.Tensor,  # (S, B, Dh) post-RoPE
    v_new: torch.Tensor,  # (S, B, Dh)
    own: torch.Tensor,  # (S, B) bool
    decode_step: int,  # appends since prefill
    ring: int = 128,
) -> None:
    """Append one token into layer ``layer`` for owned (slot, row) pairs,
    in place.

    One indexed write of one column per (slot, row): owned pairs get the
    new entry, unowned pairs get their current value back, so they stay
    bitwise untouched (``lengths == 0``, exactly-zero attention output).
    The reference's ``onehot`` mode rewrites the whole (S, B, C, Dh) layer
    slice per step to get the same values; its ``scatter`` mode is this
    write.  Both agree with this bitwise.
    """
    L, S, B, C, Dh = cache.k.shape
    lengths = cache.lengths[layer]  # (S, B)
    idx = ring_write_index(lengths, decode_step, C, ring).long()  # (S, B)
    dev = cache.k.device
    s_ix = torch.arange(S, device=dev)[:, None].expand(S, B)
    b_ix = torch.arange(B, device=dev)[None, :].expand(S, B)
    at = (s_ix, b_ix, idx)
    k_l, v_l, p_l = cache.k[layer], cache.v[layer], cache.pos[layer]
    own_d = own[..., None]
    k_l.index_put_(at, torch.where(own_d, k_new.to(k_l.dtype), k_l[at]))
    v_l.index_put_(at, torch.where(own_d, v_new.to(v_l.dtype), v_l[at]))
    p_new = cache.positions[None, :].expand(S, B)
    p_l.index_put_(at, torch.where(own, p_new, p_l[at]))
    lengths.copy_(torch.where(own, torch.clamp(lengths + 1, max=C), lengths))


def fill_from_selection(
    cache: SlotCache,
    layer: int,
    k_full: torch.Tensor,  # (B, T, Hkv, Dh) post-RoPE prefill keys
    v_full: torch.Tensor,  # (B, T, Hkv, Dh)
    sel_idx: torch.Tensor,  # (B, Hkv, Csel) selected positions into T
    sel_len: torch.Tensor,  # (B, Hkv) int32 retained counts (<= Csel)
    plan: PlanArrays,
    rows: Optional[torch.Tensor] = None,  # (B,) global row ids for ownership
) -> None:
    """Scatter the compression-selected prefill KV into slot layout, in
    place: layer ``layer``'s whole slice is overwritten.

    Slot s holds head ``slot_head[s]``'s selection on the rows it owns and
    zeros (length 0, positions -1) elsewhere.  ``rows`` are the global row
    ids the strided owner rule is evaluated at: a request prefilled alone
    for admission must be owned as the row it will occupy in the live
    cache, not as row 0.
    """
    L, S, B, C, Dh = cache.k.shape
    heads = torch.clamp(plan.slot_head[layer], min=0).long()  # (S,)
    own = (plan.owner_mask(layer, B) if rows is None
           else plan.owner_mask_rows(layer, rows))  # (S, B)
    Csel = sel_idx.shape[2]
    if Csel > C:
        raise ValueError(
            f"selection capacity {Csel} exceeds cache capacity {C}")
    idx = sel_idx[:, heads, :].permute(1, 0, 2).long()  # (S, B, Csel)
    b_ix = torch.arange(B, device=idx.device)[None, :, None]
    h_ix = heads[:, None, None]
    own4 = own[..., None, None]
    k_l, v_l, p_l = cache.k[layer], cache.v[layer], cache.pos[layer]
    k_l.zero_()
    v_l.zero_()
    k_l[:, :, :Csel] = torch.where(own4, k_full[b_ix, idx, h_ix].to(k_l.dtype), 0)
    v_l[:, :, :Csel] = torch.where(own4, v_full[b_ix, idx, h_ix].to(v_l.dtype), 0)
    # entry positions == selected indices (prefill positions are arange(T));
    # pad/unowned entries get -1 (outside any window, masked by length)
    p_l.fill_(-1)
    p_l[:, :, :Csel] = torch.where(own[..., None], idx.to(torch.int32), -1)
    lens = sel_len[:, heads].T  # (S, B)
    cache.lengths[layer] = torch.where(own, lens, 0).to(torch.int32)


def append_selection(
    cache: SlotCache,
    layer: int,
    k_full: torch.Tensor,  # (B, Ck, Hkv, Dh) post-RoPE chunk keys
    v_full: torch.Tensor,  # (B, Ck, Hkv, Dh)
    sel_idx: torch.Tensor,  # (B, Hkv, Csel) selected positions into Ck
    sel_len: torch.Tensor,  # (B, Hkv) int32 retained counts (<= Csel)
    plan: PlanArrays,
    rows: torch.Tensor,  # (B,) global row ids for ownership
    start: torch.Tensor,  # (B,) int32 absolute position of chunk token 0
) -> None:
    """Append a chunk's compression-selected KV after the existing entries,
    in place: the chunked-prefill counterpart of `fill_from_selection`.

    Owned (slot, row) pairs get their head's first ``sel_len`` selected
    entries at columns ``lengths .. lengths + sel_len`` with absolute
    positions ``start + sel_idx``, so each chunk's keep-set accumulates in
    the slot layout (keys are post-RoPE and positions explicit, so order
    does not matter to attention).  One indexed write of just those
    columns, as `append_token` does; the caller guarantees headroom, and
    columns past the capacity are dropped.

    The write has a fixed shape (no host sync, so a CUDA graph can hold
    it): lane ``j`` of a (slot, row) addresses column ``(lengths + j) % C``
    and writes what that column ends with, the entry of lane ``column -
    lengths`` when that lane is selected and fits, else the column's
    current value.  Lanes that meet at one column carry one value.
    """
    L, S, B, C, Dh = cache.k.shape
    heads = torch.clamp(plan.slot_head[layer], min=0).long()  # (S,)
    own = plan.owner_mask_rows(layer, rows)  # (S, B)
    idx = sel_idx[:, heads, :].permute(1, 0, 2).long()  # (S, B, Csel)
    Csel = idx.shape[2]
    lens_new = torch.where(own, sel_len[:, heads].T, 0)  # (S, B)
    cur = cache.lengths[layer]  # (S, B)
    dev = idx.device
    j = torch.arange(Csel, device=dev)
    col = (cur[:, :, None].long() + j) % C  # (S, B, Csel) the lane's column
    lane = col - cur[:, :, None].long()  # the lane whose entry belongs there
    put = (lane >= 0) & (lane < lens_new[:, :, None])
    src = torch.gather(idx, 2, torch.clamp(lane, 0, Csel - 1))  # chunk positions
    s_ix = torch.arange(S, device=dev)[:, None, None]
    b_ix = torch.arange(B, device=dev)[None, :, None]
    at = (s_ix.expand_as(col), b_ix.expand_as(col), col)
    h_ix = heads[:, None, None]
    for pool, full in ((cache.k[layer], k_full), (cache.v[layer], v_full)):
        pool.index_put_(at, torch.where(put[..., None], full[b_ix, src, h_ix].to(pool.dtype),
                                        pool[at]))
    p_l = cache.pos[layer]
    p_new = (start.to(torch.int64)[None, :, None] + src).to(torch.int32)
    p_l.index_put_(at, torch.where(put, p_new, p_l[at]))
    cur.copy_(torch.clamp(cur + lens_new, max=C).to(torch.int32))


# ---------------------------------------------------------------------------
# Row-level ops (continuous batching)
# ---------------------------------------------------------------------------

Rows = Union[Sequence[int], np.ndarray, torch.Tensor]


def rows_to_mask(rows: Rows, batch: int, device="cpu") -> torch.Tensor:
    """(B,) bool mask from int row indices (a bool mask passes through)."""
    rows = torch.as_tensor(rows, device=device)
    if rows.dtype == torch.bool:
        return rows
    m = torch.zeros((batch,), dtype=torch.bool, device=device)
    m[rows.long()] = True
    return m


def row_index(rows: Rows, device) -> torch.Tensor:
    """(R,) int64 row ids on ``device`` from ints, numpy or a tensor."""
    if torch.is_tensor(rows):
        return rows.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


def reset_rows(cache: SlotCache, rows: Rows) -> None:
    """Retire batch rows in place: zero K/V and ``lengths``, set ``pos`` to
    -1 and ``positions`` to 0 on every (layer, slot) of the rows (int ids
    or a (B,) bool mask).  A reset row's decode output is exactly zero
    (lengths 0), so retired rows ride along in the batched decode step
    until re-admission."""
    r = rows_to_mask(rows, cache.k.shape[2], cache.k.device)
    cache.k[:, :, r] = 0
    cache.v[:, :, r] = 0
    cache.lengths[:, :, r] = 0
    cache.pos[:, :, r] = -1
    cache.positions[r] = 0


def insert_rows(cache: SlotCache, sub: SlotCache, rows: Rows) -> None:
    """Splice a freshly prefilled sub-cache into ``rows`` of the live cache,
    in place.  ``sub`` (batch ``len(rows)``) must share (L, S, C, Dh) with
    ``cache`` and must have been filled with ownership at the target global
    rows (``prefill(..., rows=rows)``)."""
    L, S, B, C, Dh = cache.k.shape
    if (sub.k.shape[0] != L or sub.k.shape[1] != S
            or tuple(sub.k.shape[3:]) != (C, Dh)):
        raise ValueError(
            f"sub-cache layout {tuple(sub.k.shape)} incompatible with "
            f"{tuple(cache.k.shape)}")
    r = row_index(rows, cache.k.device)
    cache.k[:, :, r] = sub.k.to(cache.k.dtype)
    cache.v[:, :, r] = sub.v.to(cache.v.dtype)
    cache.lengths[:, :, r] = sub.lengths
    cache.pos[:, :, r] = sub.pos
    cache.positions[r] = sub.positions


def gather_head_layout(cache: SlotCache, plan: PlanArrays):
    """Slot layout → original head layout: ``(k, v, lengths, pos)`` shaped
    (L, H, B, C, Dh) / (L, H, B) / (L, H, B, C).

    Replicas of a head partition the rows, so every (head, row) has exactly
    one owning slot; its entries are gathered directly (the reference sums
    over slots under the owner mask, which gives the same values).
    """
    L, S, B, C, Dh = cache.k.shape
    H = int(plan.first_slot.shape[1])
    dev = cache.k.device
    own = plan.owner_mask_all(B)  # (L, S, B)
    hit = (plan.slot_head[:, :, None, None]
           == torch.arange(H, device=dev)[None, None, :, None]) & own[:, :, None, :]
    slot = hit.to(torch.int32).argmax(dim=1)  # (L, H, B) the owning slot
    l_ix = torch.arange(L, device=dev)[:, None, None]
    b_ix = torch.arange(B, device=dev)[None, None, :]
    at = (l_ix, slot, b_ix)
    return cache.k[at], cache.v[at], cache.lengths[at], cache.pos[at]


def copy_fields_(dst, src):
    """Copy every tensor field of dataclass ``src`` (a cache, slot or
    paged, or `PlanArrays`) into ``dst``'s tensors of the same shapes, in
    place; returns ``dst``.  A replan writes this way, so every address a
    captured step reads stays."""
    for f in dataclasses.fields(dst):
        t = getattr(dst, f.name)
        if t is not None:
            t.copy_(getattr(src, f.name))
    return dst


def migrate_cache(cache: SlotCache, old_plan: PlanArrays,
                  new_plan: PlanArrays) -> SlotCache:
    """Re-layout a live cache for a new placement (online replanning): back
    to head layout under ``old_plan``, then into the slots and owner split
    of ``new_plan``.  Returns a new cache (the layouts differ per row, so
    the move cannot run in place); the slot grid and capacity must match."""
    L, S, B, C, Dh = cache.k.shape
    if tuple(new_plan.slot_head.shape) != tuple(old_plan.slot_head.shape):
        raise ValueError(
            f"plan slot grids differ: {tuple(old_plan.slot_head.shape)} vs "
            f"{tuple(new_plan.slot_head.shape)}")
    k_h, v_h, len_h, pos_h = gather_head_layout(cache, old_plan)
    heads = torch.clamp(new_plan.slot_head, min=0).long()  # (L, S)
    own = new_plan.owner_mask_all(B)  # (L, S, B)
    l_ix = torch.arange(L, device=heads.device)[:, None]
    k_s, v_s = k_h[l_ix, heads], v_h[l_ix, heads]  # (L, S, B, C, Dh)
    return SlotCache(
        k=torch.where(own[..., None, None], k_s, 0),
        v=torch.where(own[..., None, None], v_s, 0),
        lengths=torch.where(own, len_h[l_ix, heads], 0).to(torch.int32),
        pos=torch.where(own[..., None], pos_h[l_ix, heads], -1),
        positions=cache.positions.clone(),
    )
