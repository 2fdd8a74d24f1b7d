"""Mamba-2 SSD (state-space duality) block: chunked scan + decode step.

The port of ``repro.models.ssm`` (arXiv:2405.21060 §6, the chunked SSD
algorithm), plain PyTorch as the reference is plain ``jnp``: within a
chunk the quadratic dual form, across chunks the (H, P, N) state carried
by a loop over chunks (the reference's ``lax.scan``; the terms that do not
read the state run batched over chunks, so the loop holds two ops a
chunk).  B / C are shared
across the heads of a group (n_groups = 1 in every config).  The state is
fp32 and the terms are summed in the reference's order: intra-chunk,
plus inter-chunk, plus D·x.

Shapes: x (B, T, H, P), dt (B, T, H), B / C (B, T, G, N), A_log (H,),
D (H,).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# chunks whose intra-chunk dual form runs as one batched pass: it does not
# read the carried state, so only the state's recurrence loops per chunk
# (a bound on the pass's (B, chunks, H, Q, Q) temporaries)
CHUNK_BATCH = 16


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` by doubling steps: elementwise
    adds, where ``torch.cumsum`` of floats on CUDA has no deterministic
    implementation (deterministic algorithms refuse it)."""
    n, step = x.shape[dim], 1
    while step < n:
        x = torch.cat([x.narrow(dim, 0, step),
                       x.narrow(dim, step, n - step) + x.narrow(dim, 0, n - step)], dim)
        step *= 2
    return x


def ssd_chunked(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H), post-softplus
    A_log: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, T, G, N)
    C_: torch.Tensor,  # (B, T, G, N)
    D_: torch.Tensor,  # (H,)
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, P) in x's dtype, final_state (B, H, P, N) fp32).
    A T off the chunk is padded with zeros (zero dt: no decay, no input).
    Up to `CHUNK_BATCH` chunks at a time: their intra-chunk terms and state
    contributions in one batched pass, then the state carried across them
    in order, then their inter-chunk terms."""
    Bsz, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    assert H % G == 0
    rep = H // G
    if T % chunk != 0:
        pad = chunk - T % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    Tp = x.shape[1]
    nc = Tp // chunk
    A = -torch.exp(A_log.float())  # (H,) negative decay rates

    xc = x.reshape(Bsz, nc, chunk, H, P).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bh = B_.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, dim=3)
    Ch = C_.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, dim=3)
    dA = dtc * A  # (B, nc, Q, H)
    cum = _prefix_sum(dA, 2)  # (B, nc, Q, H) inclusive log decay from the chunk's start
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    strict = torch.tril(mask, -1)  # j < i

    S = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c0 in range(0, nc, CHUNK_BATCH):
        cs = slice(c0, min(c0 + CHUNK_BATCH, nc))
        xq, dtq, bq, cq, cumq = xc[:, cs], dtc[:, cs], Bh[:, cs], Ch[:, cs], cum[:, cs]
        # the segment sums seg[i, j] = Σ_{j<k<=i} dA_k = cum_i - cum_j, summed
        # from their own terms: as a difference of two running sums near
        # -180 (a chunk of 256 at mamba2's decay) a short segment would carry
        # their rounding (1e-5 relative after the exp) where its weight is
        # largest
        seg = _prefix_sum(torch.where(strict, dA[:, cs].permute(0, 1, 3, 2)[..., None], 0.0), 3)
        # intra-chunk dual form: y[i] = Σ_{j<=i} (C_i·B_j) exp(seg[i, j]) dt_j x_j
        s = torch.einsum("bcihn,bcjhn->bchij", cq, bq)  # (B, c, H, Q, Q)
        # masked before the exp, so no masked entry reaches the gradient (as
        # cum_i - cum_j, seg above the diagonal overflowed exp at a chunk of
        # 256, and where(mask, exp(seg), 0)'s gradient there was 0 · inf)
        w = s * torch.exp(torch.where(mask, seg, float("-inf")))
        y_intra = torch.einsum("bchij,bcjhp->bcihp", w, dtq[..., None] * xq)
        # each chunk's own state contribution Σ_j B_j (dt_j x_j) exp(seg[Q-1, j])
        # and decay exp(Σ dA) (pairwise contractions: no operand product of
        # all the indices is ever formed, which at mamba2's width would be
        # gigabytes a chunk)
        total = torch.exp(cumq[:, :, -1, :])  # (B, c, H)
        wx = (dtq * torch.exp(seg[..., -1, :]).transpose(2, 3))[..., None] * xq  # (B, c, Q, H, P)
        contrib = torch.einsum("bcjhn,bcjhp->bchpn", bq, wx)
        prev = []  # S_{c-1} of every chunk: the state carried in order
        for c in range(cumq.shape[1]):
            prev.append(S)
            S = S * total[:, c, :, None, None] + contrib[:, c]
        # inter-chunk: y[i] = (C_i · S_{c-1}) exp(cum_i)
        y_inter = (torch.einsum("bcihn,bchpn->bcihp", cq, torch.stack(prev, dim=1))
                   * torch.exp(cumq)[..., None])
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1).reshape(Bsz, Tp, H, P)
    y = y + x.reshape(Bsz, Tp, H, P).float() * D_.float()[None, None, :, None]
    return y[:, :T].to(x.dtype), S


def ssd_decode_step(
    x: torch.Tensor,  # (B, H, P), one token
    dt: torch.Tensor,  # (B, H), post-softplus
    A_log: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, G, N)
    C_: torch.Tensor,  # (B, G, N)
    D_: torch.Tensor,  # (H,)
    state: torch.Tensor,  # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update, O(H·P·N) per row.  Returns (y (B, H,
    P) in x's dtype, new state (B, H, P, N) fp32)."""
    H = x.shape[1]
    rep = H // B_.shape[1]
    A = -torch.exp(A_log.float())
    dtf = dt.float()
    dA = torch.exp(dtf * A)  # (B, H)
    Bh = B_.repeat_interleave(rep, dim=1).float()  # (B, H, N)
    Ch = C_.repeat_interleave(rep, dim=1).float()
    xf = x.float()
    S_new = state * dA[..., None, None] + (dtf[..., None] * xf)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, S_new)
    y = y + xf * D_.float()[None, :, None]
    return y.to(x.dtype), S_new


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, T, C) with kernel (W, C).  Returns
    (y in x's dtype, new_state (B, W-1, C)): the last W-1 inputs."""
    W = w.shape[0]
    Bsz, T, Cd = x.shape
    if state is None:
        state = torch.zeros((Bsz, W - 1, Cd), dtype=x.dtype, device=x.device)
    xx = torch.cat([state.to(x.dtype), x], dim=1)  # (B, T + W - 1, C)
    windows = xx.unfold(1, W, 1)  # (B, T, C, W)
    y = torch.einsum("btcw,wc->btc", windows.float(), w.float())
    new_state = xx[:, T:] if W > 1 else xx[:, :0]
    return y.to(x.dtype), new_state
