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

On a rank's shards of a serve step (``shards``, a
`repro_torch.distributed.sharding.StepShards`: the reference's
``serve_rules``, experts over ``model``, tokens over ``data``) or of a
train step (a `TrainShards` under ``train_rules``: the same, the tokens
the rank's rows with their whole sequence) `moe_block` runs expert
parallel and keeps the reference's drops exactly: capacity ``Ce`` comes
from the global token count, and a replica's slot in its expert is its
place in the global token order (`_moe_block_shards`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import TrainShards
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


def moe_block(pl: dict, h: torch.Tensor, cfg: ModelConfig, shards=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) → (out (B, S, D), Switch load-balancing aux loss, fp32).

    ``T = B·S`` counts every row of the call, inactive and padded ones
    included: the reference routes them too, so they take capacity.
    ``shards``: on a rank's shards (`_moe_block_shards`); with neither the
    experts nor the tokens split it is this block, bitwise, and its output
    goes through the all-reduce over ``model`` (a group of one) that the
    step counts on every mesh."""
    if shards is not None:
        pl = {"router": pl["router"], "we1": shards.weight(pl["we1"], 1),
              "we3": shards.weight(pl["we3"], 1), "we2": shards.weight(pl["we2"], 2)}
        if shards.expert.size > 1 or shards.batch.size > 1:
            return _moe_block_shards(pl, h, cfg, shards)
        out, aux = moe_block(pl, h, cfg)
        if shards.expert.group is not None:
            out = comm.all_reduce_sum(out, shards.expert.group)
        return out, aux
    B, S, D = h.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    x = h.reshape(T, D)
    probs, gate, top_idx = route(x, pl["router"], K)

    src, valid = dispatch(top_idx, cfg)
    out = _experts(pl, x, gate, src, valid, K)

    # Switch load-balancing loss: E · Σ_e f_e · p̄_e
    f = _count(top_idx[:, 0], E).float() / T  # top-1 dispatch fraction
    aux = E * torch.sum(f * probs.mean(dim=0))
    return out.reshape(B, S, D).to(h.dtype), aux


def _experts(pl: dict, x: torch.Tensor, gate: torch.Tensor, src: torch.Tensor,
             valid: torch.Tensor, K: int) -> torch.Tensor:
    """The experts of ``pl`` (their (E', D, Fe) / (E', Fe, D) weights) on
    their kept replicas: ``src`` (E', Ce') flat replica ids ``t·K + k``
    into ``x`` (T, D), ``valid`` the kept ones, ``gate`` (T, K) their
    weights.  Returns (T, D): each token's gate-weighted sum of its kept
    replicas' outputs."""
    T, D = x.shape
    tok = src // K  # (E', Ce') token ids
    wgt = gate.reshape(-1)[src] * valid
    xg = x[tok]  # (E', Ce', D)
    h1 = (F.silu(torch.matmul(*operands(xg, pl["we1"])))
          * torch.matmul(*operands(xg, pl["we3"])))
    y = torch.matmul(*operands(h1, pl["we2"]))  # (E', Ce', D)
    y = y * wgt[..., None].to(y.dtype)
    # deterministic combine: each kept replica lands on its own flat id
    # (dropped ones on a dummy row), then a token's K replicas are summed
    dst = torch.where(valid, src, T * K).reshape(-1)
    buf = torch.zeros((T * K + 1, D), dtype=y.dtype, device=x.device)
    buf[dst] = y.reshape(-1, D)
    return buf[:T * K].reshape(T, K, D).sum(dim=1)


def _moe_block_shards(pl: dict, h: torch.Tensor, cfg: ModelConfig, shards
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_block` on one rank: its ``T_loc`` tokens (its batch rows, whole
    across ``model``), its ``E / |expert|`` experts' weights and its
    columns of the router.  Per call:

    - the router's weight (D, E / |model|) is all-gathered over ``model``
      (rather than the (T_loc, E / |model|) logits): it is D x E elements
      a layer whatever the batch, where the logits grow with the tokens
      (65,536 a rank at prefill_32k), and every rank then routes with the
      whole weight, the product the local block computes, so no near-tied
      pick depends on how the router was split;
    - each rank counts its replicas per expert and their top-1 picks and
      sums its probabilities; one all-gather over the batch group of those
      (3 x E float64, counts exact) gives the global token count ``T``
      (so the global ``Ce``, as the reference's), each expert's replicas
      on the ranks before this one, and the global aux loss;
    - replica (t, k) of expert e holds global slot ``prefix_e +`` its place
      among the rank's replicas of e in token order (a stable sort, as the
      reference's); it is kept iff that slot is below ``Ce``.  The batch
      group's ranks hold consecutive rows, so this is the reference's slot;
    - the rank runs its experts on its kept replicas (at most ``min(Ce,
      T_loc)`` a expert: a token picks an expert once), combines them
      without atomics as the local block does, and one all-reduce over
      ``model`` sums the experts' outputs (none when the experts do not
      split over ``model`` and every rank runs them all).

    In a train step (``shards`` a `TrainShards`) ``h`` is the rank's rows
    with their whole sequence (gathered over ``model``), the router's
    columns are gathered with autograd (their gradient reduce-scattered),
    the counts exchange as above without the probabilities, the aux loss's
    P̄ sums the probabilities of the rank's own sequence slice over every
    rank (`comm.all_reduce_diff`: the rank's aux back-propagates into its
    own positions only), and the experts' outputs are reduce-scattered onto
    the rank's slice (`TrainShards.sum_partial`).
    """
    B, S, D = h.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T_loc = B * S
    dev = h.device
    x = h.reshape(T_loc, D)
    ex, rows = shards.expert, shards.batch
    train = isinstance(shards, TrainShards)
    router = shards.gather(pl["router"], ex, 1) if ex.size > 1 else pl["router"]
    probs, gate, top_idx = route(x, router, K)
    flat_e = top_idx.reshape(-1)
    counts = _count(flat_e, E)
    stats = [counts.double(), _count(top_idx[:, 0], E).double()]
    if not train:
        stats.append(probs.sum(dim=0).double())
    stats = torch.cat(stats)  # (3E,), or (2E,) in a train step
    if rows.size > 1:
        every = comm.all_gather(stats[None], rows.group, dim=0)  # (n, 3E)
        prefix = every[:rows.index, :E].sum(dim=0).long()
        total = every.sum(dim=0)
    else:
        prefix = torch.zeros((E,), dtype=torch.int64, device=dev)
        total = stats
    T = T_loc * rows.size
    ce = expert_capacity(T, cfg)
    f = total[E:2 * E] / T
    if train:
        # P̄ from the probabilities of the rank's own positions, summed over
        # every rank: each rank's aux then gives the gradient of its
        # positions' probabilities only, once over the mesh
        pbar = shards.slice_seq(probs.reshape(B, S, E)).sum(dim=(0, 1))
        if shards.mesh.world > 1:
            pbar = comm.all_reduce_diff(pbar, shards.mesh.world_group)
        aux = E * torch.sum(f.float() * (pbar / T))
    else:
        aux = (E * torch.sum(f * (total[2 * E:] / T))).float()

    E_loc = E // ex.size
    mine = slice(ex.index * E_loc, (ex.index + 1) * E_loc)
    order = torch.sort(flat_e, stable=True).indices
    starts = torch.cumsum(counts, dim=0) - counts
    slot = torch.arange(min(ce, T_loc), device=dev)
    valid = ((slot[None, :] < counts[mine, None])
             & (prefix[mine, None] + slot[None, :] < ce))  # (E_loc, Ce_loc)
    pos = torch.clamp(starts[mine, None] + slot[None, :], 0, T_loc * K - 1)
    out = _experts(pl, x, gate, order[pos], valid, K)
    # experts whole on every rank (E % |model| != 0): no sum
    out = shards.sum_partial(out.reshape(B, S, D), ex)
    return out.to(h.dtype), aux


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
