"""Shared model layers: norms, RoPE, attention (dense + chunked-flash), SwiGLU.

Plain PyTorch, step for step the reference's ``repro.models.layers``:
matmuls run in the param dtype (bf16 in production configs); norms, RoPE,
softmax and the attention contractions upcast to fp32 exactly where the
reference does.  Attention keeps its explicit masking and rounding steps
(no fused SDPA), so the port holds to the reference's numerics.  Past
``flash_threshold`` keys, attention is `flash_attention_vjp`: the
chunked online-softmax forward and, for training, the reference's
recomputing backward (O(Q·chunk) memory, no stored score matrix).
Weights read by a product may be int8 `repro_torch.serving.quant.QTensor`
leaves, dequantized at the use.

`embed`, `unembed` and `swiglu` also run on one rank's shards of a serve
step under the rules (``shards``, a
`repro_torch.distributed.sharding.StepShards`; None, the default, is the
whole-weight function): the embedding over the rank's vocab rows (ids
outside them give zero rows, then one all-reduce over the vocab's group),
the unembedding into the rank's vocab columns, the SwiGLU over its ``ff``
columns of ``w1`` / ``w3`` and rows of ``w2`` (one all-reduce over the ff
group); under ``weights_2d`` each weight is gathered whole along d_model
just before its product.  On a train step's shards (a `TrainShards`) the
same functions read FSDP-gathered weights, and the embedding's rows and
the SwiGLU's partial output are reduce-scattered over ``model`` onto the
rank's sequence slice instead of all-reduced (`TrainShards.sum_vocab`,
`sum_ff`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.serving.quant import QTensor, operands

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
# Attention (prefill and training): dense and chunked-flash
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
    # in place on the (B, Hkv, G, Q, K) fp32 score buffer when no autograd
    # graph is built: at prefill size it is the largest transient of the
    # step, so no second copy is made.  Training's backward needs the
    # softcap output and the softmax output, so there the writes make copies
    grad = torch.is_grad_enabled() and scores.requires_grad
    scores = (scores.masked_fill(~mask[:, None, None], NEG_INF) if grad
              else scores.masked_fill_(~mask[:, None, None], NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    del scores
    # rows with no valid key (fully masked) produce uniform probs over
    # garbage; zero them explicitly
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    probs = probs.masked_fill(~any_valid, 0.0) if grad else probs.masked_fill_(~any_valid, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Q, Hq, Dh).to(q.dtype)


def _flash_fwd(q, k, v, q_pos, k_pos, window, attn_cap, causal, chunk):
    """The reference's ``_flash_fwd_padded``: K padded to a chunk multiple
    with positions at int32 max (which the causal mask excludes), then the
    online softmax over KV chunks.  Returns (out (B, Hkv, G, Q, Dh) fp32,
    m, l (B, Hkv, G, Q) fp32: the running max and normalizer)."""
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
        msk = _chunk_mask(q_pos, pos_i, window, causal, B, Q, chunk)
        # in place on the (B, Hkv, G, Q, chunk) fp32 score buffer when no
        # autograd graph is built (the values are the same): at a 32k
        # prefill it is 17 GB a layer for 64 query heads on two rows
        grad = torch.is_grad_enabled() and s.requires_grad
        s = torch.where(msk, s, NEG_INF) if grad else s.masked_fill_(~msk, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        # explicit mask: a fully-masked chunk keeps m_new at NEG_INF, where
        # exp(NEG_INF - NEG_INF) would be 1 — the mask zeroes it instead
        p = (torch.where(msk, torch.exp(s - m_new[..., None]), 0.0) if grad
             else s.sub_(m_new[..., None]).exp_().masked_fill_(~msk, 0.0))
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_i.float())
        m_run = m_new
    return acc / torch.clamp(l_run[..., None], min=1e-30), m_run, l_run


def _chunk_mask(q_pos, pos_i, window, causal, B, Q, chunk):
    """(B, 1, 1, Q, chunk) bool: which keys of a chunk each query sees."""
    if causal:
        return _causal_mask(q_pos, pos_i, window)[:, None, None]
    return torch.ones((B, 1, 1, Q, chunk), dtype=torch.bool, device=q_pos.device)


def _heads_last(out: torch.Tensor, dtype) -> torch.Tensor:
    """(B, Hkv, G, Q, Dh) → (B, Q, Hq, Dh) in ``dtype``."""
    B, Hkv, G, Q, Dh = out.shape
    return out.movedim(3, 1).reshape(B, Q, Hkv * G, Dh).to(dtype)


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
    The forward of `flash_attention_vjp`, without autograd."""
    out, _, _ = _flash_fwd(q, k, v, q_pos, k_pos, window, attn_cap, causal, chunk)
    return _heads_last(out, q.dtype)


class _FlashAttentionVJP(torch.autograd.Function):
    """The reference's ``flash_attention_vjp``: the forward saves (q, k, v,
    positions, out in the input dtype, m, l) and the backward recomputes
    each chunk's scores (the FlashAttention backward), so no (Q, K) matrix
    is stored between the passes."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, attn_cap, causal, chunk):
        out, m, l = _flash_fwd(q, k, v, q_pos, k_pos, window, attn_cap, causal, chunk)
        o = _heads_last(out, q.dtype)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, m, l)
        ctx.cfg = (window, attn_cap, causal, chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, o, m, l = ctx.saved_tensors
        window, attn_cap, causal, chunk = ctx.cfg
        dq, dk, dv = _flash_bwd(q, k, v, q_pos, k_pos, o, m, l, do,
                                window, attn_cap, causal, chunk)
        return dq, dk, dv, None, None, None, None, None, None


def _flash_bwd(q, k, v, q_pos, k_pos, o, m, l, do, window, attn_cap, causal, chunk):
    """The reference's ``_flash_vjp_bwd``: per KV chunk, the scores are
    recomputed from (q, k, m, l); dq accumulates over the chunks in order,
    dk / dv are written per chunk.  The softcap's chain rule multiplies
    dS by 1 - (s / cap)^2."""
    B, Q, Hq, Dh = q.shape
    K_orig, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    out = o.reshape(B, Q, Hkv, G, Dh).movedim(1, 3).float()  # (B, Hkv, G, Q, Dh)
    chunk = min(chunk, K_orig)
    Kp = -(-K_orig // chunk) * chunk
    if Kp != K_orig:
        pad = Kp - K_orig
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=torch.iinfo(torch.int32).max)
    qg = q.reshape(B, Q, Hkv, G, Dh).float()
    dog = do.reshape(B, Q, Hkv, G, Dh).float().movedim(1, 3)  # (B, Hkv, G, Q, Dh)
    lsafe = torch.clamp(l, min=1e-30)
    # D_i = Σ_d dout_i · out_i (out already normalized)
    dvec = (dog * out).sum(dim=-1)  # (B, Hkv, G, Q)
    scale = math.sqrt(Dh)
    dq = torch.zeros((B, Q, Hkv, G, Dh), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c in range(Kp // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        k_i, v_i, pos_i = k[:, sl].float(), v[:, sl].float(), k_pos[:, sl]
        s = softcap(torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i) / scale, attn_cap)
        msk = _chunk_mask(q_pos, pos_i, window, causal, B, Q, chunk)
        s_m = torch.where(msk, s, NEG_INF)
        p = torch.where(msk, torch.exp(s_m - m[..., None]), 0.0) / lsafe[..., None]
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, dog))
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dog, v_i)
        ds = p * (dp - dvec[..., None])
        if attn_cap > 0:  # softcap chain rule: d tanh
            ds = ds * (1.0 - (s / attn_cap) ** 2)
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, k_i) / scale
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) / scale)
    dk = torch.cat(dks, dim=1)[:, :K_orig]
    dv = torch.cat(dvs, dim=1)[:, :K_orig]
    return (dq.reshape(B, Q, Hq, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def flash_attention_vjp(q, k, v, q_pos, k_pos, window=0, attn_cap=0.0, causal=True,
                        chunk=1024) -> torch.Tensor:
    """Chunked flash attention whose backward recomputes the scores
    (``torch.autograd``-differentiable in q, k and v)."""
    return _FlashAttentionVJP.apply(q, k, v, q_pos, k_pos, window, attn_cap, causal, chunk)


def attention(q, k, v, q_pos, k_pos, *, window=0, attn_cap=0.0, kv_mask=None,
              causal=True, flash_threshold=2048, chunk=1024):
    """Dispatch dense vs chunked-flash on KV length (as the reference: the
    flash path takes no ``kv_mask``)."""
    if k.shape[1] <= flash_threshold:
        return dense_attention(q, k, v, q_pos, k_pos, window=window,
                               attn_cap=attn_cap, kv_mask=kv_mask, causal=causal)
    return flash_attention_vjp(q, k, v, q_pos, k_pos, window, attn_cap, causal, chunk)


# ---------------------------------------------------------------------------
# MLP, embedding
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w1, w3, w2, shards=None) -> torch.Tensor:
    if shards is not None:
        return _swiglu_shard(x, w1, w3, w2, shards)
    x1, w1 = operands(x, w1)
    x3, w3 = operands(x, w3)
    h = F.silu(x1 @ w1) * (x3 @ w3)
    h, w2 = operands(h, w2)
    return h @ w2


def _swiglu_shard(x, w1, w3, w2, shards) -> torch.Tensor:
    """`swiglu` over the rank's ``ff`` shard: its partial sum over the
    hidden dim, summed over the ff group (`StepShards.sum_ff` /
    `TrainShards.sum_ff`)."""
    x1, w = operands(x, shards.weight(w1, 0))
    a = x1 @ w
    x3, w = operands(x, shards.weight(w3, 0))
    h = F.silu(a) * (x3 @ w)
    h, w = operands(h, shards.weight(w2, 1))
    return shards.sum_ff(h @ w)


def embed(tokens: torch.Tensor, table, shards=None, prefix=None) -> torch.Tensor:
    """Rows of the table; an int8 table's rows times their per-row scale
    (the id clamped into the scale's rows), rounded to bf16.  On a rank's
    vocab shard (``shards``) an id outside its rows gives a zero row and
    the rows are summed over the vocab's group (``shards.sum_vocab``);
    ``prefix`` (B, I, D), the same on every rank, is put before the rows
    (the first vocab rank's, zeros elsewhere) ahead of that sum."""
    if shards is not None:
        table = shards.weight(table, 1)
        n, v = table.shape[0], shards.vocab
        local = tokens - v.offset(n)
        hit = (local >= 0) & (local < n)
        rows = torch.where(hit[..., None], embed(torch.where(hit, local, 0), table), 0)
        if prefix is not None:
            rows = torch.cat([prefix if v.index == 0 else torch.zeros_like(prefix), rows], 1)
        return shards.sum_vocab(rows)
    if isinstance(table, QTensor):
        rows = table.q[tokens].float()
        sc = table.scale
        if sc.shape[0] > 1:
            sc = sc[torch.clamp(tokens, max=sc.shape[0] - 1)]
        return (rows * sc).to(torch.bfloat16)
    return table[tokens]


def unembed(x: torch.Tensor, table, cap: float = 0.0, shards=None) -> torch.Tensor:
    """Logits (softcapped by ``cap``) of ``x`` against the table's rows: on
    a rank's vocab shard (``shards``) its columns of the logits."""
    if shards is not None:
        table = shards.weight(table, 1)
    x, table = operands(x, table)
    logits = torch.einsum("bsd,vd->bsv", x, table).float()
    return softcap(logits, cap)
