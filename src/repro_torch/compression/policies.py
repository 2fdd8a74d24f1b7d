"""Compression policies (port of ``repro.compression.policies``).

Each policy maps pooled observation scores (B, Hkv, T) → (indices, lengths):
``indices`` (B, Hkv, C) positions retained per head, ``lengths`` (B, Hkv).

- ``snapkv``      balanced: per-head top-budget by pooled obs scores
- ``ada_snapkv``  imbalanced (the paper's target): a layer-wide pool of
                  Hkv·budget entries, allocated to heads by global score
                  ranking (Ada-KV's safeguarded variant: every head keeps at
                  least ``min(sink + obs_window, budget)``)

The other reference policies (streaming_llm, pyramidkv, h2o, headkv) are
not ported yet.  `layer_keep_bound` / `projected_request_tokens` are the
admission projections the continuous scheduler charges requests with.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.api.registry import POLICY_REGISTRY, register_policy
from repro_torch.compression.base import CompressionConfig, topk_select

Selection = Tuple[torch.Tensor, torch.Tensor]  # (idx (B,Hkv,C), lengths (B,Hkv))


def _boost_guaranteed(scores: torch.Tensor, t_len: int, cfg: CompressionConfig,
                      positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Force sinks + the observation window into every selection."""
    T = scores.shape[-1]
    pos = torch.arange(T, device=scores.device) if positions is None else positions
    guaranteed = (pos < cfg.sink) | (pos >= t_len - cfg.obs_window)
    return torch.where(guaranteed, float("inf"), scores)


def _uniform_budget(scores: torch.Tensor, budget: int, capacity: int) -> Selection:
    B, Hkv, T = scores.shape
    keep = torch.full((B, Hkv), min(budget, T, capacity), dtype=torch.int32,
                      device=scores.device)
    return topk_select(scores, keep, capacity)


@register_policy("snapkv")
def snapkv(scores: torch.Tensor, cfg: CompressionConfig,
           layer_idx: int, n_layers: int) -> Selection:
    scores = _boost_guaranteed(scores, scores.shape[-1], cfg)
    return _uniform_budget(scores, cfg.budget, cfg.static_capacity())


def _pooled_allocation(scores: torch.Tensor, pool_size: int,
                       floor: int, capacity: int) -> torch.Tensor:
    """Ada-KV allocation: per-row global threshold over (Hkv·T) scores.

    keep[b, h] = #scores of head h among the layer-wide top-``pool_size``,
    safeguarded to at least ``floor`` and clipped to ``capacity``.  Only
    the k-th largest *value* is used, so tie order does not matter here.
    """
    B, Hkv, T = scores.shape
    flat = scores.reshape(B, Hkv * T)
    k = min(int(pool_size), Hkv * T)
    thresh = torch.topk(flat, k, dim=-1).values[:, -1]  # (B,)
    keep = (scores >= thresh[:, None, None]).sum(dim=-1)  # (B, Hkv)
    return torch.clamp(keep, floor, capacity).to(torch.int32)


@register_policy("ada_snapkv")
def ada_snapkv(scores: torch.Tensor, cfg: CompressionConfig,
               layer_idx: int, n_layers: int) -> Selection:
    B, Hkv, T = scores.shape
    scores = _boost_guaranteed(scores, T, cfg)
    cap = cfg.static_capacity()
    floor = min(cfg.sink + cfg.obs_window, cfg.budget)
    keep = _pooled_allocation(scores, Hkv * cfg.budget, floor, min(cap, T))
    return topk_select(scores, keep, cap)


def layer_keep_bound(policy: str, cfg: CompressionConfig, T: int,
                     n_heads: int, layer_idx: int, n_layers: int) -> int:
    """Upper bound on Σ_h keep for one layer's prefill selection of a
    ``T``-token prompt, so admission never overcommits:

    - ``snapkv`` keeps ``min(budget, T, C)`` per head exactly;
    - ``ada_snapkv`` counts the layer-wide top-``H·budget`` scores, and the
      per-head floor ``min(sink + obs, budget)`` adds at most ``H·floor``
      more (when the guaranteed positions exceed the pool the count is
      ``H·(sink + obs)``): all within ``H·(budget + sink + obs_window)``;
    - ``none`` keeps every position, ``H·min(T, C)``.

    Any other (third-party) policy gets the conservative ``H·min(T, C)``.
    """
    H = int(n_heads)
    per_head_max = max(0, min(cfg.static_capacity(), T))
    if policy == "snapkv":
        return H * min(cfg.budget, per_head_max)
    if policy == "ada_snapkv":
        return H * min(cfg.budget + cfg.sink + cfg.obs_window, per_head_max)
    return H * per_head_max


def projected_request_tokens(policy: str, cfg: CompressionConfig,
                             prompt_len: int, max_new_tokens: int,
                             n_layers: int, n_heads: int) -> int:
    """Upper bound on Σ lengths a request can ever pin across the cache:
    per layer the prefill bound plus one append per head per generated
    token, each head clipped at the static capacity (the recency ring
    overwrites in place there)."""
    H, cap = int(n_heads), cfg.static_capacity()
    total = 0
    for layer in range(n_layers):
        prefill = layer_keep_bound(policy, cfg, prompt_len, H, layer, n_layers)
        total += min(prefill + H * max_new_tokens,
                     H * min(prompt_len + max_new_tokens, cap))
    return total


def select(policy: str, scores: torch.Tensor, cfg: CompressionConfig,
           layer_idx: int, n_layers: int) -> Selection:
    """Dispatch to a registered policy; ``"none"`` retains every position."""
    if policy == "none":
        B, Hkv, T = scores.shape
        idx = torch.arange(T, dtype=torch.int32, device=scores.device).expand(B, Hkv, T)
        return idx, torch.full((B, Hkv), T, dtype=torch.int32, device=scores.device)
    return POLICY_REGISTRY[policy](scores, cfg, layer_idx, n_layers)
