"""Shared paged-layer fixture for the kernel checks (port of
``repro.paging.testing``).

One layer's (pools, table, lengths) built adversarially: block ids handed
out in shuffled order (nothing may rely on contiguity), every pool entry a
valid column does not overwrite left as garbage (a missing mask shows as a
mismatch, not as silent zeros), absolute positions written per column.
The draws from the numpy generator follow the reference fixture's order,
so one seed gives both packages the same layer.  Used by the CPU tests and
by ``chip_smoke.py``, as are `slot_layer_as_pool`, which lays a slot cache
out as pools so the slot and paged kernels can be held to each other, and
`relabel_pool_blocks` and `query_lengths`, which set up the paged
kernels' other bitwise contracts.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.paging import kvquant


def make_paged_layer(rng: np.random.Generator, S, B, C, bs, Dh, empty_frac=0.3,
                     dtype=torch.float32, lengths: Optional[np.ndarray] = None,
                     device="cpu"):
    """One layer's (k_pool, v_pool, pos_pool, block_table, lengths) as
    tensors on ``device``; ``lengths`` defaults to a ragged draw with
    ``empty_frac`` of the (slot, row) pairs empty (all-null table rows).
    The pools are drawn in fp32 and cast to ``dtype``."""
    M = -(-C // bs)
    if lengths is None:
        lengths = rng.integers(1, C + 1, size=(S, B)).astype(np.int32)
        lengths[rng.random((S, B)) < empty_frac] = 0
    else:
        lengths = np.asarray(lengths, np.int32)
    need = -(-lengths // bs)
    N = int(need.sum()) + 2
    ids = list(rng.permutation(np.arange(1, N)))
    table = np.zeros((S, B, M), np.int32)  # 0 = null block
    k_pool = rng.normal(size=(N, bs, Dh)).astype(np.float32)
    v_pool = rng.normal(size=(N, bs, Dh)).astype(np.float32)
    pos_pool = rng.integers(-1, 10**6, size=(N, bs)).astype(np.int32)
    for s in range(S):
        for b in range(B):
            n = int(need[s, b])
            blocks = [ids.pop() for _ in range(n)]
            table[s, b, :n] = blocks
            for c in range(int(lengths[s, b])):
                pos_pool[blocks[c // bs], c % bs] = c  # absolute positions

    def t(a, dt=None):
        out = torch.from_numpy(a).to(device)
        return out if dt is None else out.to(dt)

    return (t(k_pool, dtype), t(v_pool, dtype), t(pos_pool), t(table),
            t(lengths))


def quantize_paged_layer(k_pool, v_pool, block_table, kinds):
    """Quantize a `make_paged_layer` pool pair into int8 codes with (N,)
    fp32 per-block scales, each block at its owning slot's ``kinds`` entry
    (the null block and spare blocks as int8).  Whole blocks are encoded,
    garbage tail entries included: they have the magnitude of real data
    here, so they exercise the masking without distorting the scales.
    Returns (k_codes, v_codes, k_scale, v_scale) on the pools' device."""
    dev = k_pool.device
    N = k_pool.shape[0]
    tbl = block_table.cpu().numpy()
    kinds = np.broadcast_to(np.asarray(torch.as_tensor(kinds).cpu(), np.int32),
                            (tbl.shape[0],))
    block_kind = np.zeros((N,), np.int32)
    for s in range(tbl.shape[0]):
        owned = np.unique(tbl[s][tbl[s] > 0])
        block_kind[owned] = kinds[s]
    qmax = np.where(block_kind == kvquant.KIND_FP8, kvquant.FP8_QMAX,
                    kvquant.INT8_QMAX)
    k = k_pool.float().cpu().numpy()
    v = v_pool.float().cpu().numpy()
    k_scale = (np.abs(k).max(axis=(1, 2)) / qmax).astype(np.float32)
    v_scale = (np.abs(v).max(axis=(1, 2)) / qmax).astype(np.float32)
    kb = torch.from_numpy(block_kind)[:, None, None]
    k_codes = kvquant.encode(torch.from_numpy(k), torch.from_numpy(k_scale)[:, None, None], kb)
    v_codes = kvquant.encode(torch.from_numpy(v), torch.from_numpy(v_scale)[:, None, None], kb)
    return (k_codes.to(dev), v_codes.to(dev), torch.from_numpy(k_scale).to(dev),
            torch.from_numpy(v_scale).to(dev))


def slot_layer_as_pool(k: torch.Tensor, v: torch.Tensor, k_pos: torch.Tensor, bs: int):
    """One layer of a slot cache, k / v (S, B, C, Dh) and k_pos (S, B, C),
    as block pools with an identity block table: (k_pool, v_pool,
    pos_pool, block_table), C padded with zeros to a multiple of ``bs``,
    block 0 the null block, block 1 + (s*B + b)*M + m holding columns
    m*bs .. (m+1)*bs - 1 of (s, b)."""
    S, B, C = k_pos.shape
    M = -(-C // bs)
    n = S * B * M

    def blocks(x):  # (S, B, C, ...) -> (1 + n, bs, ...)
        pad = [0, 0] * (x.dim() - 3) + [0, M * bs - C]
        x = torch.nn.functional.pad(x, pad).reshape(n, bs, *x.shape[3:])
        return torch.cat([torch.zeros_like(x[:1]), x]).contiguous()

    table = 1 + torch.arange(n, dtype=torch.int32, device=k.device).reshape(S, B, M)
    return blocks(k), blocks(v), blocks(k_pos), table


def relabel_pool_blocks(k_pool, v_pool, pos_pool, block_table, scales=(), seed=0):
    """The same layer with pool blocks 1.. relabelled by a seeded
    permutation (block 0, the null block, stays) and the table remapped:
    a decode over it must give bitwise the original output.  ``scales``
    are (N,) per-block tensors relabelled with the blocks.  Returns
    (k_pool, v_pool, pos_pool, block_table, scales)."""
    N = k_pool.shape[0]
    g = torch.Generator().manual_seed(seed)
    perm = torch.cat([torch.zeros(1, dtype=torch.long),
                      1 + torch.randperm(N - 1, generator=g)]).to(k_pool.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(N, device=perm.device)  # new block of old block j: inv[j]
    table = torch.where(block_table > 0, inv[block_table.long().clamp(min=0)].to(torch.int32),
                        block_table).contiguous()
    return (k_pool[perm].contiguous(), v_pool[perm].contiguous(), pos_pool[perm].contiguous(),
            table, tuple(x[perm].contiguous() for x in scales))


def query_lengths(lengths: torch.Tensor, q_lens: torch.Tensor, i: int) -> torch.Tensor:
    """(S, B) int32 columns query ``i`` of a multi-query decode sees, the
    lengths the single-query decode is run at to reproduce it:
    min(len - (q_lens - 1 - i), len), clamped at 0."""
    lim = torch.clamp(lengths.long() - (q_lens.long()[None, :] - 1 - i), min=0)
    return torch.minimum(lim, lengths.long()).to(torch.int32).contiguous()
