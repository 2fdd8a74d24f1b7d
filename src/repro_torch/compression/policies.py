"""The six compression policies (port of ``repro.compression.policies``).

Each policy maps pooled observation scores (B, Hkv, T) → (indices, lengths):
``indices`` (B, Hkv, C) positions retained per head, ``lengths`` (B, Hkv).

Balanced (fair) per-head:
- ``streaming_llm``  sinks + recent window (position-only, no scores)
- ``snapkv``         per-head top-budget by pooled obs scores
- ``pyramidkv``      snapkv with per-layer decaying budgets
- ``h2o``            accumulated-attention heavy hitters + recent window

Imbalanced (unfair) per-head — the paper's targets:
- ``ada_snapkv``     a layer-wide pool of Hkv·budget entries, allocated to
                     heads by global score ranking (Ada-KV's safeguarded
                     variant: every head keeps at least
                     ``min(sink + obs_window, budget)``)
- ``headkv``         static per-head importance splits the pool: uniform base
                     ratio + importance-proportional dynamic share

Every policy is a fixed sequence of tensor operations with no host sync, so
it runs inside a captured CUDA graph (the chunked-prefill step).
`layer_keep_bound` / `projected_request_tokens` are the admission
projections the continuous scheduler charges requests with.
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


@register_policy("streaming_llm")
def streaming_llm(scores: torch.Tensor, cfg: CompressionConfig,
                  layer_idx: int, n_layers: int) -> Selection:
    """Sinks + recent window; scores are ignored (balanced, position-only).
    The ``1e-6 · pos / T`` tie-break is computed in fp32 in the reference's
    order, so the ranking is the reference's bit for bit."""
    B, Hkv, T = scores.shape
    pos = torch.arange(T, dtype=torch.float32, device=scores.device)
    recent = cfg.budget - cfg.sink
    synthetic = (torch.where(pos < cfg.sink, 2.0, 0.0)
                 + torch.where(pos >= T - recent, 1.0, 0.0))
    synthetic = synthetic.expand(B, Hkv, T)
    cap = cfg.static_capacity()
    keep = torch.full((B, Hkv), min(cfg.budget, T, cap), dtype=torch.int32,
                      device=scores.device)
    return topk_select(synthetic + 1e-6 * pos / T, keep, cap)


@register_policy("snapkv")
def snapkv(scores: torch.Tensor, cfg: CompressionConfig,
           layer_idx: int, n_layers: int) -> Selection:
    scores = _boost_guaranteed(scores, scores.shape[-1], cfg)
    return _uniform_budget(scores, cfg.budget, cfg.static_capacity())


def _pyramid_budget(cfg: CompressionConfig, layer_idx: int, n_layers: int) -> int:
    """PyramidKV's per-layer budget: linear decay with depth, Python
    ``round`` as in the reference, floored at ``sink + obs_window``."""
    beta = cfg.pyramid_beta
    frac = 1.0 + beta - 2.0 * beta * (layer_idx / max(n_layers - 1, 1))
    return max(cfg.sink + cfg.obs_window, int(round(cfg.budget * frac)))


@register_policy("pyramidkv")
def pyramidkv(scores: torch.Tensor, cfg: CompressionConfig,
              layer_idx: int, n_layers: int) -> Selection:
    """Budget decays linearly with depth (early layers keep more)."""
    budget = _pyramid_budget(cfg, layer_idx, n_layers)
    scores = _boost_guaranteed(scores, scores.shape[-1], cfg)
    return _uniform_budget(scores, budget, cfg.static_capacity())


@register_policy("h2o")
def h2o(scores: torch.Tensor, cfg: CompressionConfig,
        layer_idx: int, n_layers: int) -> Selection:
    """Heavy hitters: half budget by accumulated score, half recent.

    NaN rule: where the recent window's ``+inf`` boost meets a ``-inf``
    score (the padding of a partial last chunk), the sum is NaN; the port
    ranks it as ``-inf``, below every number, with ties in index order.
    The reference's XLA top-k orders a negative NaN (what ``-inf + inf``
    gives on x86) below ``-inf``, and every such NaN lies past the last
    ``-inf`` pad, so both give the same order; a CUDA ``-inf + inf`` is a
    positive NaN, which a plain sort would rank first.
    """
    B, Hkv, T = scores.shape
    pos = torch.arange(T, device=scores.device)
    half = cfg.budget // 2
    scores = scores + torch.where(pos >= T - half, float("inf"), 0.0)
    scores = torch.where(torch.isnan(scores), float("-inf"), scores)
    scores = torch.where(pos < cfg.sink, float("inf"), scores)
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


@register_policy("headkv")
def headkv(scores: torch.Tensor, cfg: CompressionConfig,
           layer_idx: int, n_layers: int,
           head_importance: Optional[torch.Tensor] = None) -> Selection:
    """Static base budget + importance-proportional dynamic share.

    ``head_importance`` (Hkv,) — offline per-head weights (from a profile
    sample, e.g. `Engine.measure_profile`); defaults to the realized mean
    obs score per head.  The share is computed in fp32 and truncated to an
    integer after the clip, as in the reference.
    """
    B, Hkv, T = scores.shape
    pool = Hkv * cfg.budget
    base = int(round(cfg.headkv_base_ratio * cfg.budget))
    if head_importance is None:
        imp = scores.mean(dim=(0, 2))  # (Hkv,)
    else:
        imp = torch.as_tensor(head_importance, device=scores.device).to(torch.float32)
    imp = imp / torch.clamp(imp.sum(), min=1e-9)
    dynamic = (pool - Hkv * base) * imp  # (Hkv,)
    keep = (base + dynamic).expand(B, Hkv)
    cap = cfg.static_capacity()
    keep = torch.clamp(keep, min(cfg.sink + cfg.obs_window, cfg.budget),
                       min(cap, T)).to(torch.int32)
    scores = _boost_guaranteed(scores, T, cfg)
    return topk_select(scores, keep, cap)


def layer_keep_bound(policy: str, cfg: CompressionConfig, T: int,
                     n_heads: int, layer_idx: int, n_layers: int) -> int:
    """Upper bound on Σ_h keep for one layer's prefill selection of a
    ``T``-token prompt, so admission never overcommits:

    - balanced policies keep ``min(budget_l, T, C)`` per head exactly
      (``budget_l`` is PyramidKV's per-layer budget, else ``budget``);
    - ``ada_snapkv`` counts the layer-wide top-``H·budget`` scores, and the
      per-head floor ``min(sink + obs, budget)`` adds at most ``H·floor``
      more (when the guaranteed positions exceed the pool the count is
      ``H·(sink + obs)``): all within ``H·(budget + sink + obs_window)``;
    - ``headkv`` splits a pool of exactly ``H·budget`` (base + dynamic
      shares sum to it), with the same floor slack;
    - ``none`` keeps every position, ``H·min(T, C)``.

    Any other (third-party) policy gets the conservative ``H·min(T, C)``.
    """
    H = int(n_heads)
    per_head_max = max(0, min(cfg.static_capacity(), T))
    if policy == "none":
        return H * per_head_max
    if policy in ("snapkv", "streaming_llm", "h2o"):
        return H * min(cfg.budget, per_head_max)
    if policy == "pyramidkv":
        return H * min(_pyramid_budget(cfg, layer_idx, n_layers), per_head_max)
    if policy in ("ada_snapkv", "headkv"):
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


# live Mapping view over the registry: third-party ``@register_policy``
# providers appear here automatically
POLICIES = POLICY_REGISTRY

BALANCED = {"streaming_llm", "snapkv", "pyramidkv", "h2o"}
IMBALANCED = {"ada_snapkv", "headkv"}


def select(policy: str, scores: torch.Tensor, cfg: CompressionConfig,
           layer_idx: int, n_layers: int, **kw) -> Selection:
    """Dispatch to a registered policy; ``"none"`` retains every position.
    ``kw`` goes to the policy (``head_importance`` for ``headkv``)."""
    if policy == "none":
        B, Hkv, T = scores.shape
        idx = torch.arange(T, dtype=torch.int32, device=scores.device).expand(B, Hkv, T)
        return idx, torch.full((B, Hkv), T, dtype=torch.int32, device=scores.device)
    return POLICY_REGISTRY[policy](scores, cfg, layer_idx, n_layers, **kw)
