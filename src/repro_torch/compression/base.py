"""KV-cache compression policy interface (port of ``repro.compression.base``).

A policy looks at per-position importance scores gathered during prefill and
decides, per (batch row, kv head), *which* positions to retain and *how many*
(the per-head budget).  Balanced policies give every head the same budget;
imbalanced policies (Ada-SnapKV, HeadKV — the paper's targets) redistribute a
layer-wide pool across heads, which is what creates the unfair head load.

Scores come from the SnapKV observation-window statistic (the
``snapkv_scores`` kernel), then 1-D max-pooled (kernel ``pool``).

Selections are static-shape: top-``capacity`` per head plus a length mask
(``arange < keep``).  Retained index sets must equal the reference's, so
ties break the way ``jax.lax.top_k`` breaks them (lower index first).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class CompressionConfig:
    policy: str = "ada_snapkv"
    budget: int = 1024  # mean retained tokens per kv head
    capacity: int = 0  # static per-head cap; 0 -> alpha_max * budget
    alpha_max: float = 2.0  # capacity multiplier for imbalanced policies
    obs_window: int = 32
    pool: int = 7
    sink: int = 4  # always-keep prefix tokens (StreamingLLM sinks)
    decode_margin: int = 64  # extra capacity for decode appends
    # HeadKV: fraction of the pool pre-allocated uniformly ("base budget")
    headkv_base_ratio: float = 0.2
    # PyramidKV: budget decays linearly across layers by +/- this fraction
    pyramid_beta: float = 0.6

    def static_capacity(self) -> int:
        cap = self.capacity or int(round(self.alpha_max * self.budget))
        return cap + self.decode_margin


def pool_scores(scores: torch.Tensor, pool: int) -> torch.Tensor:
    """1-D max pool along the last axis (SnapKV's clustering trick)."""
    if pool <= 1:
        return scores
    pad = pool // 2
    padded = F.pad(scores, (pad, pad), value=float("-inf"))
    return padded.unfold(-1, pool, 1).amax(dim=-1)


def topk_select(
    scores: torch.Tensor,  # (B, Hkv, T)
    keep: torch.Tensor,  # (B, Hkv) int32, <= capacity
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static top-``capacity`` indices + per-head validity lengths.

    Pooled scores are full of exact ties (max-pooling copies a peak into its
    neighbours; guaranteed positions are all ``+inf``).  ``jax.lax.top_k``
    puts the lower index first among equals and ``torch.topk`` promises no
    order, so selection is a stable descending sort: equal scores keep
    their index order, and the first ``capacity`` indices are exactly the
    reference's.  Returned indices are sorted ascending.
    """
    T = scores.shape[-1]
    capacity = min(capacity, T)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[..., :capacity]
    keep = torch.clamp(keep, max=capacity).to(torch.int32)
    valid = torch.arange(capacity, device=scores.device)[None, None, :] < keep[..., None]
    idx = torch.where(valid, idx, T - 1)
    idx = torch.sort(idx, dim=-1).values
    return idx.to(torch.int32), keep
