"""FairExpert — the paper's §6 future work: FairKV-style balancing for MoE.

Expert load under top-k routing is skewed exactly like per-head KV budgets
(hot experts receive many times the mean token count).  The same machinery
applies verbatim with (expert ↔ head, token count ↔ retained length):

- *best-effort assignment*: place experts on shards against the measured
  routing distribution instead of round-robin;
- *fair-copying*: replicate hot experts; replicas split the token stream
  (capacity is per-replica, so a 2-replica expert serves 2× tokens without
  drops — this is the EPLB idea, derived here from the paper's Eq. 4).

``plan_experts`` returns a HeadPlacement over experts (slot = expert copy on
a shard); ``expert_dispatch_stats`` turns router probabilities into the
workload profile; ``simulate_expert_balance`` measures the max/mean token
load per shard for SHA vs FairExpert — the MoE analog of Table 2 / Fig. 4.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.placement import HeadPlacement
from repro_torch.core.planner import PlannerConfig, build_plan


def expert_dispatch_stats(router_probs: np.ndarray, top_k: int) -> np.ndarray:
    """(T, E) router probabilities → (E,) expected token load (top-k greedy)."""
    T, E = router_probs.shape
    idx = np.argsort(-router_probs, axis=1)[:, :top_k]
    counts = np.bincount(idx.reshape(-1), minlength=E)
    return counts.astype(np.float64)


def plan_experts(load: np.ndarray, n_shards: int, mode: str = "fairkv_dp",
                 extra_copies: int = 4,
                 slots_per_shard: Optional[int] = None) -> HeadPlacement:
    """Plan expert placement from a measured (E,) load profile."""
    E = load.shape[0]
    slots = slots_per_shard or max(1, -(-E // n_shards))
    return build_plan(load[None, :], n_shards, PlannerConfig(
        mode=mode, extra_copies=extra_copies, slots_per_shard=slots,
        fill_empty_slots=E < n_shards * slots))


def simulate_expert_balance(router_probs: np.ndarray, top_k: int,
                            n_shards: int, extra_copies: int = 4
                            ) -> Dict[str, float]:
    """Per-shard token-load balance E (Eq. 5) for SHA vs FairExpert plans."""
    load = expert_dispatch_stats(router_probs, top_k)
    out = {}
    for mode in ("sha", "fairkv_nodp", "fairkv_dp"):
        plan = plan_experts(load, n_shards, mode=mode,
                            extra_copies=extra_copies)
        out[mode] = plan.efficiency(load[None, :])
    return out
