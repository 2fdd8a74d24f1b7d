"""Mixture-of-Experts FFN: top-k routing + sort-based grouped GEMM.

The port of ``repro.models.moe``, shape for shape.  Dispatch is the
capacity-bounded sorted-scatter pattern: sort token-replicas by expert id,
gather each expert's contiguous range into an (E, Ce, D) block, batched
products through the expert weights, weighted sum back to tokens.  Replicas
beyond an expert's capacity are dropped (Switch / GShard semantics).

Every shape depends on the call's shapes only, never on the data (no
``bincount``, boolean indexing, ``nonzero`` or ``.item()``), so the block
runs inside a captured CUDA graph.  Two places fix what the reference
leaves to its backend:

- **top-k ties.** ``jax.lax.top_k`` puts the lower expert id first on
  equal probabilities; ``torch.topk`` promises no order on CUDA.  The router
  runs in the weights' dtype, so bf16 logits tie often over 32 or 128
  experts.  A stable descending sort, then its first ``K``, is the
  reference's rule.
- **the combine.** ``jax.ops.segment_sum`` maps to ``index_add_``, which
  uses float atomics on CUDA: the sum order would change from run to run.
  Each kept replica's output is written to its own flat replica id (each id
  at most once), then the ``K`` replicas of a token are summed in a fixed
  order, so a graphed step equals an eager one bitwise.

The expert products are plain batched GEMMs outside any Pallas kernel in the
reference, so they go to ``torch.matmul`` here.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.quant import operands


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert slots ``Ce``: ``round(T·K/E·capacity_factor)`` with
    Python's (banker's) rounding, at least ``K`` and at most ``T·K``."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    ce = int(max(K, round(n_tokens * K / E * cfg.moe.capacity_factor)))
    return min(ce, n_tokens * K)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, D) tokens → (probs (T, E) fp32, gate (T, K) fp32, top_idx (T, K)).

    The router product runs in the weights' dtype, the softmax in fp32;
    ties in ``probs`` go to the lower expert id (a stable descending sort,
    as ``jax.lax.top_k``).  ``gate`` is renormalized over the K picks."""
    probs = torch.softmax(torch.matmul(*operands(x, router)).float(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, top_idx = srt.values[:, :top_k], srt.indices[:, :top_k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate, top_idx


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, minlength=n)`` with a fixed output size (no host
    sync, so it can be captured)."""
    return torch.zeros((n,), dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def dispatch(top_idx: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, K) expert picks → (src (E, Ce) flat replica ids ``t·K + k``,
    valid (E, Ce) bool).  Expert ``e``'s row lists its replicas in token
    order (a stable sort by expert id); the first ``Ce`` are kept, the rest
    dropped.  Invalid entries hold a clamped id that must be masked."""
    T, K = top_idx.shape
    E = cfg.moe.num_experts
    dev = top_idx.device
    flat_e = top_idx.reshape(-1)  # (T·K,)
    order = torch.sort(flat_e, stable=True).indices  # replicas grouped by expert
    counts = _count(flat_e, E)
    starts = torch.cumsum(counts, dim=0) - counts
    slot = torch.arange(expert_capacity(T, cfg), device=dev)
    valid = slot[None, :] < counts[:, None]  # (E, Ce)
    pos = torch.clamp(starts[:, None] + slot[None, :], 0, T * K - 1)
    return order[pos], valid


def moe_block(pl: dict, h: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) → (out (B, S, D), Switch load-balancing aux loss, fp32).

    ``T = B·S`` counts every row of the call, inactive and padded ones
    included: the reference routes them too, so they take capacity."""
    B, S, D = h.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    dev = h.device
    x = h.reshape(T, D)
    probs, gate, top_idx = route(x, pl["router"], K)

    src, valid = dispatch(top_idx, cfg)
    tok = src // K  # (E, Ce) token ids
    wgt = gate.reshape(-1)[src] * valid

    xg = x[tok]  # (E, Ce, D)
    h1 = (F.silu(torch.matmul(*operands(xg, pl["we1"])))
          * torch.matmul(*operands(xg, pl["we3"])))
    y = torch.matmul(*operands(h1, pl["we2"]))  # (E, Ce, D)
    y = y * wgt[..., None].to(y.dtype)

    # deterministic combine: each kept replica lands on its own flat id
    # (dropped ones on a dummy row), then a token's K replicas are summed
    dst = torch.where(valid, src, T * K).reshape(-1)
    buf = torch.zeros((T * K + 1, D), dtype=y.dtype, device=dev)
    buf[dst] = y.reshape(-1, D)
    out = buf[:T * K].reshape(T, K, D).sum(dim=1)

    # Switch load-balancing loss: E · Σ_e f_e · p̄_e
    f = _count(top_idx[:, 0], E).float() / T  # top-1 dispatch fraction
    aux = E * torch.sum(f * probs.mean(dim=0))
    return out.reshape(B, S, D).to(h.dtype), aux


def init_moe_params(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> dict:
    """Router and expert weights at the reference's shapes and scales
    (drawn from ``gen``, so not the reference's numbers)."""
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)

    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fe)
    return {
        "router": normal((D, E), s_in),
        "we1": normal((E, D, Fe), s_in),
        "we3": normal((E, D, Fe), s_in),
        "we2": normal((E, Fe, D), s_out),
    }
