"""Kernel entry points with device dispatch.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version in `kernels.ref`.  The
device of the inputs is the only switch: nothing sends a CUDA tensor to
the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref


def _plain_or_raise(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no implementation for device {t.device}")


def fairkv_decode(q, k, v, lengths, attn_cap: float = 0.0,
                  k_pos: Optional[torch.Tensor] = None,
                  q_pos: Optional[torch.Tensor] = None, window: int = 0):
    """Slot-layout decode attention (see ref.fairkv_decode_ref)."""
    if q.is_cuda:
        from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
        return fairkv_decode_cuda(q, k, v, lengths, attn_cap, k_pos=k_pos,
                                  q_pos=q_pos, window=window)
    _plain_or_raise(q, "fairkv_decode")
    return _ref.fairkv_decode_ref(q, k, v, lengths, attn_cap, k_pos=k_pos,
                                  q_pos=q_pos, window=window)


def snapkv_scores(q_obs, k, obs_positions, k_positions, attn_cap: float = 0.0):
    """Observation-window importance scores (see ref.snapkv_scores_ref)."""
    if q_obs.is_cuda:
        from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
        return snapkv_scores_cuda(q_obs, k, obs_positions, k_positions, attn_cap)
    _plain_or_raise(q_obs, "snapkv_scores")
    return _ref.snapkv_scores_ref(q_obs, k, obs_positions, k_positions, attn_cap)


def paged_fairkv_decode(q, k_pool, v_pool, pos_pool, block_table, lengths,
                        capacity: int, attn_cap: float = 0.0,
                        q_pos: Optional[torch.Tensor] = None, window: int = 0,
                        k_scale=None, v_scale=None, kinds=None,
                        q_lens: Optional[torch.Tensor] = None):
    """Paged decode attention over one layer's pools (see
    ref.paged_fairkv_decode_ref); int8/fp8 pools pass their per-block
    scales and per-slot kinds.  A 5-D ``q`` (B, S, Q, G, Dh) is the
    multi-query speculative-verify form, with ``q_lens`` (B,) valid queries
    per row."""
    if q.is_cuda:
        from repro_torch.kernels import paged_fairkv_decode as P
        if q.dim() == 5:
            return P.paged_fairkv_decode_mq_cuda(
                q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
                attn_cap, q_pos=q_pos, window=window, k_scale=k_scale,
                v_scale=v_scale, kinds=kinds, q_lens=q_lens)
        return P.paged_fairkv_decode_cuda(
            q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
            attn_cap, q_pos=q_pos, window=window, k_scale=k_scale,
            v_scale=v_scale, kinds=kinds)
    _plain_or_raise(q, "paged_fairkv_decode")
    return _ref.paged_fairkv_decode_ref(
        q, k_pool, v_pool, pos_pool, block_table, lengths, capacity, attn_cap,
        q_pos=q_pos, window=window, k_scale=k_scale, v_scale=v_scale,
        kinds=kinds, q_lens=q_lens)
