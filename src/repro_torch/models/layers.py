"""Shared model layers: norms, RoPE, attention (dense + chunked-flash), SwiGLU.

Plain PyTorch, step for step the reference's ``repro.models.layers``:
matmuls run in the param dtype (bf16 in production configs); norms, RoPE,
softmax and the attention contractions upcast to fp32 exactly where the
reference does.  Attention keeps its explicit masking and rounding steps
(no fused SDPA), so the port holds to the reference's numerics.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / theta ** (ar / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (prefill): dense and chunked-flash
# ---------------------------------------------------------------------------


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window: int = 0) -> torch.Tensor:
    """(..., Q, K) bool mask; window > 0 adds a sliding-window lower bound."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def dense_attention(
    q: torch.Tensor,  # (B, Q, Hq, Dh)
    k: torch.Tensor,  # (B, K, Hkv, Dh)
    v: torch.Tensor,  # (B, K, Hkv, Dh)
    q_pos: torch.Tensor,  # (B, Q)
    k_pos: torch.Tensor,  # (B, K)
    window: int = 0,
    attn_cap: float = 0.0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, K) bool, False = masked out
    causal: bool = True,
) -> torch.Tensor:
    """Reference GQA attention with full score materialization."""
    B, Q, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Q, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / math.sqrt(Dh)
    scores = softcap(scores, attn_cap)
    if causal:
        mask = _causal_mask(q_pos, k_pos, window)  # (B, Q, K)
    else:
        mask = torch.ones((B, Q, k.shape[1]), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        mask &= kv_mask[:, None, :]
    # in place on the (B, Hkv, G, Q, K) fp32 score buffer: at prefill size it
    # is the largest transient of the step, so no second copy is made
    scores.masked_fill_(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    # rows with no valid key (fully masked) produce uniform probs over
    # garbage; zero them explicitly
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    probs.masked_fill_(~any_valid, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Q, Hq, Dh).to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Q, Hq, Dh)
    k: torch.Tensor,  # (B, K, Hkv, Dh)
    v: torch.Tensor,  # (B, K, Hkv, Dh)
    q_pos: torch.Tensor,  # (B, Q)
    k_pos: torch.Tensor,  # (B, K)
    window: int = 0,
    attn_cap: float = 0.0,
    causal: bool = True,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks: O(Q·chunk) score memory.

    The forward of the reference's ``flash_attention_vjp`` (what
    ``attention`` runs past ``flash_threshold``): K is padded to a chunk
    multiple with positions at int32 max, which the causal mask excludes.
    """
    B, Q, Hq, Dh = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    chunk = min(chunk, K)
    if K % chunk != 0:
        pad = chunk - K % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=torch.iinfo(torch.int32).max)
    nc = k.shape[1] // chunk
    qg = q.reshape(B, Q, Hkv, G, Dh).float()
    acc = torch.zeros((B, Hkv, G, Q, Dh), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, Hkv, G, Q), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, Hkv, G, Q), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        k_i, v_i, pos_i = k[:, sl], v[:, sl], k_pos[:, sl]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i.float()) / math.sqrt(Dh)
        s = softcap(s, attn_cap)
        if causal:
            msk = _causal_mask(q_pos, pos_i, window)
        else:
            msk = torch.ones((B, Q, chunk), dtype=torch.bool, device=q.device)
        msk = msk[:, None, None]
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        # explicit mask: a fully-masked chunk keeps m_new at NEG_INF, where
        # exp(NEG_INF - NEG_INF) would be 1 — the mask zeroes it instead
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_i.float())
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    out = out.movedim(3, 1)  # (B, Q, Hkv, G, Dh)
    return out.reshape(B, Q, Hq, Dh).to(q.dtype)


def attention(q, k, v, q_pos, k_pos, *, window=0, attn_cap=0.0, kv_mask=None,
              causal=True, flash_threshold=2048, chunk=1024):
    """Dispatch dense vs chunked-flash on KV length (as the reference: the
    flash path takes no ``kv_mask``)."""
    if k.shape[1] <= flash_threshold:
        return dense_attention(q, k, v, q_pos, k_pos, window=window,
                               attn_cap=attn_cap, kv_mask=kv_mask, causal=causal)
    return flash_attention(q, k, v, q_pos, k_pos, window=window,
                           attn_cap=attn_cap, causal=causal, chunk=chunk)


# ---------------------------------------------------------------------------
# MLP, embedding
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor, cap: float = 0.0) -> torch.Tensor:
    logits = torch.einsum("bsd,vd->bsv", x, table).float()
    return softcap(logits, cap)
