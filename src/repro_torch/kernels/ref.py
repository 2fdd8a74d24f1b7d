"""Plain PyTorch versions of the port's kernels (port of ``repro.kernels.ref``).

These define the semantics: the CUDA kernels must match them (fp32
accumulation) on the card, and the CPU path runs them.  Each follows the
reference oracle step for step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def dequant_block_codes(codes: torch.Tensor, scale: torch.Tensor,
                        kind) -> torch.Tensor:
    """int8 block codes → fp32 under per-block ``scale`` and ``kind``
    (0 = int8, 1 = fp8-e4m3 bit patterns).  fp8 NaN patterns (possible in
    never-written pool memory) flush to 0, so a masked entry cannot poison
    the probability-weighted sum through 0·NaN.  The oracle keeps its own
    copy of the codec's decode, apart from ``paging.kvquant``."""
    f = codes.float()
    f8 = codes.view(torch.float8_e4m3fn).float()
    f8 = torch.where(f8 == f8, f8, 0.0)
    f = torch.where(torch.as_tensor(kind, device=codes.device) == 1, f8, f)
    return f * scale


def fairkv_decode_ref(
    q: torch.Tensor,  # (B, S, G, Dh) — one new query per row per slot group
    k: torch.Tensor,  # (S, B, C, Dh) slot-layout cache keys (post-RoPE)
    v: torch.Tensor,  # (S, B, C, Dh)
    lengths: torch.Tensor,  # (S, B) int32 — retained tokens per (slot, row)
    attn_cap: float = 0.0,
    k_pos: Optional[torch.Tensor] = None,  # (S, B, C) absolute entry positions
    q_pos: Optional[torch.Tensor] = None,  # (B,) current positions
    window: int = 0,  # >0: sliding-window mask via k_pos/q_pos
) -> torch.Tensor:
    """Decode attention over the slot-layout cache.

    Rows a slot does not own have ``lengths == 0`` and yield exactly 0
    output, so the o-projection contraction over slots reassembles the
    batch.  Returns (B, S, G, Dh) in q's dtype.
    """
    B, S, G, Dh = q.shape
    C = k.shape[2]
    scores = torch.einsum("bsgd,sbcd->bsgc", q.float(), k.float()) / math.sqrt(Dh)
    if attn_cap > 0:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    valid = (torch.arange(C, device=q.device)[None, None, :]
             < lengths.T[..., None])  # (B, S, C)
    if window > 0:
        if k_pos is None or q_pos is None:
            raise ValueError("window > 0 needs k_pos and q_pos")
        valid &= k_pos.permute(1, 0, 2) > (q_pos[:, None, None] - window)
    scores = torch.where(valid[:, :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    nonempty = valid.any(dim=-1)[:, :, None, None]
    probs = torch.where(nonempty, probs, 0.0)
    out = torch.einsum("bsgc,sbcd->bsgd", probs, v.float())
    return out.to(q.dtype)


def fairkv_decode_partial_ref(
    q: torch.Tensor,  # (B, S, G, Dh)
    k: torch.Tensor,  # (S, B, C_loc, Dh): one shard of the cache's columns
    v: torch.Tensor,  # (S, B, C_loc, Dh)
    lengths: torch.Tensor,  # (S, B) int32: the shard's valid prefix
    attn_cap: float = 0.0,
    k_pos: Optional[torch.Tensor] = None,  # (S, B, C_loc)
    q_pos: Optional[torch.Tensor] = None,  # (B,)
    window: int = 0,
):
    """`fairkv_decode_ref` over one shard of the cache's columns (split-S
    decode), before the softmax's normalisation across shards: returns the
    shard's un-rounded fp32 output ``o`` (B, S, G, Dh), the softmax over
    the shard's valid entries applied to its values, and their log-sum-exp
    ``lse`` (B, S, G) fp32 of the (softcapped) scores.  A (slot, row) with
    no valid entry on the shard gives ``o = 0`` and ``lse = -inf``.
    `merge_partials` of every shard's pair, in shard order, is
    `fairkv_decode_ref` over the whole cache."""
    B, S, G, Dh = q.shape
    C = k.shape[2]
    scores = torch.einsum("bsgd,sbcd->bsgc", q.float(), k.float()) / math.sqrt(Dh)
    if attn_cap > 0:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    valid = (torch.arange(C, device=q.device)[None, None, :]
             < lengths.T[..., None])  # (B, S, C)
    if window > 0:
        if k_pos is None or q_pos is None:
            raise ValueError("window > 0 needs k_pos and q_pos")
        valid &= k_pos.permute(1, 0, 2) > (q_pos[:, None, None] - window)
    scores = torch.where(valid[:, :, None, :], scores, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)  # -inf where nothing is valid
    nonempty = valid.any(dim=-1)[:, :, None]  # (B, S, 1)
    probs = torch.exp(scores - torch.where(nonempty, lse, 0.0)[..., None])
    o = torch.einsum("bsgc,sbcd->bsgd", probs, v.float())
    return o, lse


def merge_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """The whole cache's decode output from its shards' `fairkv_decode_partial_ref`
    pairs ``parts`` = [(o_r, lse_r), ...] in shard order:
    ``Σ_r exp(lse_r - M) o_r / Σ_r exp(lse_r - M)`` with ``M = max_r
    lse_r``, cast once to ``dtype``.  Where every shard is empty (``M =
    -inf``) the output is exactly 0, as `fairkv_decode_ref`'s ``nonempty``
    rule gives, never a NaN."""
    lse = torch.stack([p[1] for p in parts])  # (n, B, S, G)
    m = lse.max(dim=0).values
    live = m > float("-inf")
    w = torch.exp(lse - torch.where(live, m, 0.0))  # an empty shard weighs 0
    num = sum(w[r][..., None] * parts[r][0] for r in range(len(parts)))
    den = w.sum(dim=0)
    out = torch.where(live[..., None], num / torch.where(live, den, 1.0)[..., None], 0.0)
    return out.to(dtype)


def fairkv_decode_mq_ref(
    q: torch.Tensor,  # (B, S, Q, G, Dh): Q query positions per row per slot
    k: torch.Tensor,  # (S, B, C, Dh) slot-layout cache keys (post-RoPE)
    v: torch.Tensor,  # (S, B, C, Dh)
    lengths: torch.Tensor,  # (S, B) int32: retained tokens AFTER the appends
    attn_cap: float = 0.0,
    k_pos: Optional[torch.Tensor] = None,  # (S, B, C) absolute entry positions
    q_pos: Optional[torch.Tensor] = None,  # (B,) position of query index 0
    q_lens: Optional[torch.Tensor] = None,  # (B,) valid queries per row (<= Q)
    window: int = 0,
) -> torch.Tensor:
    """Multi-query decode attention (speculative verify).

    Query ``i`` of row ``b`` sits at absolute position ``q_pos[b] + i``;
    with ``qn = q_lens[b]`` valid queries and ``lengths`` counting the
    cache after all ``qn`` appends, it sees the first
    ``min(lengths - (qn - 1 - i), lengths)`` entries (its own token
    included, later speculative tokens excluded).  Lanes ``i >= qn`` are
    garbage (the caller discards them) and clamp to the full length.  A
    (slot, row) query with no valid entry gives exact zeros.  With Q == 1
    and ``q_lens == 1`` this is `fairkv_decode_ref`.  Returns
    (B, S, Q, G, Dh) in q's dtype.
    """
    B, S, Q, G, Dh = q.shape
    C = k.shape[2]
    if q_lens is None:
        q_lens = torch.full((B,), Q, dtype=torch.int32, device=q.device)
    scores = torch.einsum("bsqgd,sbcd->bsqgc", q.float(), k.float()) / math.sqrt(Dh)
    if attn_cap > 0:
        scores = attn_cap * torch.tanh(scores / attn_cap)
    ln = lengths.T  # (B, S)
    qi = torch.arange(Q, device=q.device)[None, None, :]  # (1, 1, Q)
    limit = ln[:, :, None] - (q_lens[:, None, None] - 1 - qi)
    limit = torch.minimum(limit, ln[:, :, None])  # (B, S, Q)
    valid = (torch.arange(C, device=q.device)[None, None, None, :]
             < limit[..., None])  # (B, S, Q, C)
    if window > 0:
        if k_pos is None or q_pos is None:
            raise ValueError("window > 0 needs k_pos and q_pos")
        qp = q_pos[:, None, None] + qi  # (B, 1, Q)
        valid &= k_pos.permute(1, 0, 2)[:, :, None, :] > (qp[..., None] - window)
    scores = torch.where(valid[:, :, :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    nonempty = valid.any(dim=-1)[:, :, :, None, None]
    probs = torch.where(nonempty, probs, 0.0)
    out = torch.einsum("bsqgc,sbcd->bsqgd", probs, v.float())
    return out.to(q.dtype)


def paged_fairkv_decode_ref(
    q: torch.Tensor,  # (B, S, G, Dh), or (B, S, Q, G, Dh) multi-query
    k_pool: torch.Tensor,  # (N, bs, Dh) — one layer's pools
    v_pool: torch.Tensor,  # (N, bs, Dh)
    pos_pool: torch.Tensor,  # (N, bs) int32
    block_table: torch.Tensor,  # (S, B, M) int32; <= 0 = null block
    lengths: torch.Tensor,  # (S, B) int32
    capacity: int,
    attn_cap: float = 0.0,
    q_pos: Optional[torch.Tensor] = None,  # (B,) int32
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # (N,) fp32 per-block scales
    v_scale: Optional[torch.Tensor] = None,  # (N,)
    kinds: Optional[torch.Tensor] = None,  # (S,) int32 per-slot kind codes
    q_lens: Optional[torch.Tensor] = None,  # (B,) valid queries (5-D q only)
) -> torch.Tensor:
    """Paged decode attention, defined as slot decode over the gathered
    view: column ``c`` of a (slot, row) lives at offset ``c % bs`` of block
    ``table[c // bs]``; the blocks are gathered into the contiguous
    (S, B, C, Dh) view the slot cache would hold, then `fairkv_decode_ref`
    runs on it unchanged.  Quantized pools (``k_scale`` given) are
    dequantized after the gather (`dequant_block_codes`; all-int8 kinds
    when ``kinds`` is omitted).  A 5-D ``q`` selects the multi-query
    (speculative-verify) semantics of `fairkv_decode_mq_ref`.  Returns
    q's shape in q's dtype.
    """
    ids = torch.clamp(block_table, min=0).long()
    S, B, M = ids.shape
    bs, Dh = k_pool.shape[1], k_pool.shape[2]
    k = k_pool[ids]  # (S, B, M, bs, Dh)
    v = v_pool[ids]
    if k_scale is not None:
        kind = (torch.zeros((S,), dtype=torch.int32, device=q.device)
                if kinds is None else kinds.to(torch.int32))
        kind = kind[:, None, None, None, None]
        k = dequant_block_codes(k, k_scale[ids][..., None, None], kind)
        v = dequant_block_codes(v, v_scale[ids][..., None, None], kind)
    k = k.reshape(S, B, M * bs, Dh)[:, :, :capacity]
    v = v.reshape(S, B, M * bs, Dh)[:, :, :capacity]
    pos = pos_pool[ids].reshape(S, B, M * bs)[:, :, :capacity]
    if q.ndim == 5:
        return fairkv_decode_mq_ref(q, k, v, lengths, attn_cap, k_pos=pos,
                                    q_pos=q_pos, q_lens=q_lens, window=window)
    return fairkv_decode_ref(q, k, v, lengths, attn_cap, k_pos=pos,
                             q_pos=q_pos, window=window)


def snapkv_scores_ref(
    q_obs: torch.Tensor,  # (B, W, Hq, Dh) observation-window queries (RoPE'd)
    k: torch.Tensor,  # (B, T, Hkv, Dh)
    obs_positions: torch.Tensor,  # (B, W)
    k_positions: torch.Tensor,  # (B, T)
    attn_cap: float = 0.0,
) -> torch.Tensor:
    """Observation-window importance: Σ_{w,g} softmax_T(q_w · k) → (B, Hkv, T)
    fp32.  (Pooling is applied by the caller.)"""
    B, W, Hq, Dh = q_obs.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q_obs.reshape(B, W, Hkv, G, Dh).float()
    s = torch.einsum("bwhgd,bthd->bhgwt", qg, k.float()) / math.sqrt(Dh)
    if attn_cap > 0:
        s = attn_cap * torch.tanh(s / attn_cap)
    causal = k_positions[:, None, :] <= obs_positions[:, :, None]  # (B, W, T)
    s = torch.where(causal[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(causal[:, None, None], p, 0.0)
    return p.sum(dim=(2, 3))  # (B, Hkv, T)
