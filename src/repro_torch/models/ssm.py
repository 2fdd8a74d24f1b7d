"""Mamba-2 SSD (state-space duality) block: chunked scan + decode step.

The port of ``repro.models.ssm`` (arXiv:2405.21060 §6, the chunked SSD
algorithm), plain PyTorch as the reference is plain ``jnp``: within a
chunk the quadratic dual form, across chunks the (H, P, N) state carried
by a loop over chunks (the reference's ``lax.scan``).  B / C are shared
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
    A T off the chunk is padded with zeros (zero dt: no decay, no input)."""
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
    cum = torch.cumsum(dtc * A, dim=2)  # (B, nc, Q, H) inclusive log decay
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))

    S = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq, cumq = xc[:, c], dtc[:, c], Bh[:, c], Ch[:, c], cum[:, c]
        # inter-chunk: y[i] = (C_i · S_{c-1}) exp(cum_i); then the state
        # S_c = S_{c-1} exp(Σ dA) + Σ_j B_j (dt_j x_j) exp(Σ - cum_j)
        # (the products are pairwise contractions, so no operand product of
        # all the indices is ever formed: at mamba2's width that would be
        # gigabytes per chunk)
        y_inter = torch.einsum("bihn,bhpn->bihp", cq, S) * torch.exp(cumq)[..., None]
        total = torch.exp(cumq[:, -1, :])  # (B, H)
        wx = (dtq * torch.exp(cumq[:, -1:, :] - cumq))[..., None] * xq  # (B, Q, H, P)
        contrib = torch.einsum("bjhn,bjhp->bhpn", bq, wx)
        S = S * total[:, :, None, None] + contrib
        # intra-chunk dual form: y[i] = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j
        s = torch.einsum("bihn,bjhn->bhij", cq, bq)  # (B, H, Q, Q)
        seg = (cumq[:, :, None, :] - cumq[:, None, :, :]).permute(0, 3, 1, 2)
        w = s * torch.where(mask, torch.exp(seg), 0.0)
        y_intra = torch.einsum("bhij,bjhp->bihp", w, dtq[..., None] * xq)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, Tp, H, P)
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
