"""System-efficiency metric (Eq. 5) and throughput simulation.

Given a plan, per-(layer, head, row) retained lengths, and a latency model,
simulate the per-shard decode time and derive:

- utilization  E = mean_j t_j / max_j t_j   (Eq. 5 — "GPU utilization" in the
  paper's Tables/Figures is exactly this quantity),
- throughput ∝ batch / max_j t_j,
- the per-shard load vector itself (for plots / debugging).

This is the measurement harness behind benchmarks/table2, fig3, fig4, fig5.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.latency import LinearLatencyModel
from repro_torch.core.placement import HeadPlacement


@dataclass(frozen=True)
class SimResult:
    per_shard_time: np.ndarray  # (n_shards,)
    utilization: float  # Eq. 5
    throughput: float  # rows per unit time
    makespan: float

    def gain_over(self, other: "SimResult") -> float:
        return self.throughput / other.throughput


def owned_mask(replica_idx: int, replica_count: int, batch: int) -> np.ndarray:
    """Strided batch ownership: replica i owns rows where b % r == i."""
    rows = np.arange(batch)
    return (rows % replica_count) == replica_idx


def simulate(
    plan: HeadPlacement,
    lengths: np.ndarray,
    model: LinearLatencyModel,
    uniform_overhead: float = 0.0,
) -> SimResult:
    """Simulate one decode step.

    ``lengths``: (L, H, B) retained KV length per layer/head/batch-row — the
    *actual* compression outcome (not just the profile means).
    ``uniform_overhead``: per-shard latency of the load-independent part
    (q/o projections, FFN, collectives) added to every shard.
    """
    L, H, B = lengths.shape
    assert L == plan.n_layers and H == plan.n_heads
    S = plan.slots_per_shard
    times = np.zeros(plan.n_shards)
    for j in range(plan.n_shards):
        total_len = 0.0
        n_rows = 0.0
        for li, lp in enumerate(plan.layers):
            for s in range(S):
                slot = j * S + s
                h = int(lp.slot_head[slot])
                if h < 0:
                    continue
                mask = owned_mask(int(lp.replica_idx[slot]),
                                  int(lp.replica_count[slot]), B)
                owned = lengths[li, h, mask]
                total_len += float(owned.sum())
                n_rows += float(mask.sum())
        # bilinear model over the shard's aggregate load
        times[j] = (model.a + model.b * (n_rows / max(L, 1))
                    + model.d * total_len) + uniform_overhead
    makespan = float(times.max())
    util = float(times.mean() / makespan) if makespan > 0 else 1.0
    return SimResult(per_shard_time=times, utilization=util,
                     throughput=B / makespan if makespan > 0 else np.inf,
                     makespan=makespan)


def utilization_from_loads(loads: np.ndarray) -> float:
    mx = loads.max()
    return float(loads.mean() / mx) if mx > 0 else 1.0
