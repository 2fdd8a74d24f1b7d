"""Head-placement plan: the artifact FairKV produces and the runtime consumes.

A *slot* is one (kv-head replica) position on one model shard.  Every model
shard owns exactly ``slots_per_shard`` slots so the SPMD program is uniform;
an empty slot has ``head == -1`` and carries zero retained length, i.e. ~zero
work inside the decode kernel.

Replicas of one head split the batch by a strided ownership rule
(``global_row % replica_count == replica_idx``) so the split stays balanced
within every data-axis shard (DESIGN.md §2).  For global_batch == 1
(long-context decode) replicas split the retained-KV range instead — the same
arrays describe both, the runtime chooses the split dimension.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class LayerPlacement:
    """Slot layout of one layer.  Arrays have shape (n_shards * slots_per_shard,)."""

    slot_head: np.ndarray  # int32, head id or -1
    replica_idx: np.ndarray  # int32, 0-based index among slots sharing the head
    replica_count: np.ndarray  # int32, total replicas of that head (1 for empty)

    @property
    def n_slots(self) -> int:
        return int(self.slot_head.shape[0])

    def shard_of_slot(self, slots_per_shard: int) -> np.ndarray:
        return np.arange(self.n_slots) // slots_per_shard

    def heads_on_shard(self, shard: int, slots_per_shard: int) -> List[int]:
        lo, hi = shard * slots_per_shard, (shard + 1) * slots_per_shard
        return [int(h) for h in self.slot_head[lo:hi] if h >= 0]

    def validate(self, n_heads: int, n_shards: int, slots_per_shard: int,
                 r_max: Optional[int] = None) -> None:
        sh = self.slot_head
        assert sh.shape == (n_shards * slots_per_shard,), sh.shape
        assert self.replica_idx.shape == sh.shape
        assert self.replica_count.shape == sh.shape
        seen: Dict[int, List[int]] = {}
        for j in range(self.n_slots):
            h = int(sh[j])
            if h < 0:
                assert int(self.replica_count[j]) == 1
                assert int(self.replica_idx[j]) == 0
                continue
            assert 0 <= h < n_heads, f"slot {j} head {h} out of range"
            seen.setdefault(h, []).append(j)
        # Eq. 2: every head assigned at least once
        missing = set(range(n_heads)) - set(seen)
        assert not missing, f"heads never placed: {sorted(missing)}"
        for h, slots in seen.items():
            r = len(slots)
            if r_max is not None:
                # Eq. 3: replication budget
                assert r <= r_max, f"head {h} has {r} replicas > R_max={r_max}"
            idxs = sorted(int(self.replica_idx[j]) for j in slots)
            assert idxs == list(range(r)), f"head {h} replica idxs {idxs}"
            for j in slots:
                assert int(self.replica_count[j]) == r
            # replicas must land on distinct shards (copying onto the same
            # shard is meaningless — paper §4.3.3)
            shards = [j // slots_per_shard for j in slots]
            assert len(set(shards)) == r, f"head {h} replicas share a shard"

    def per_shard_load(self, weights: np.ndarray, n_shards: int,
                       slots_per_shard: int) -> np.ndarray:
        """Eq. 4 inner sum: Σ_slots w_h / r_h per shard."""
        load = np.zeros(n_shards, dtype=np.float64)
        for j in range(self.n_slots):
            h = int(self.slot_head[j])
            if h >= 0:
                load[j // slots_per_shard] += float(weights[h]) / float(self.replica_count[j])
        return load


@dataclass(frozen=True)
class HeadPlacement:
    """Whole-model plan: one LayerPlacement per layer + mesh metadata."""

    layers: tuple  # Tuple[LayerPlacement, ...]
    n_heads: int
    n_shards: int
    slots_per_shard: int
    mode: str  # "sha" | "fairkv_nodp" | "fairkv_dp"
    r_max: int

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_slots(self) -> int:
        return self.n_shards * self.slots_per_shard

    def validate(self) -> None:
        for lp in self.layers:
            lp.validate(self.n_heads, self.n_shards, self.slots_per_shard, self.r_max)

    # ---- runtime arrays ----------------------------------------------------
    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Stacked (L, n_slots) int32 arrays for use inside jitted steps."""
        return {
            "slot_head": np.stack([lp.slot_head for lp in self.layers]).astype(np.int32),
            "replica_idx": np.stack([lp.replica_idx for lp in self.layers]).astype(np.int32),
            "replica_count": np.stack([lp.replica_count for lp in self.layers]).astype(np.int32),
        }

    # ---- metrics -----------------------------------------------------------
    def per_shard_load(self, weights: np.ndarray) -> np.ndarray:
        """Total load per shard across layers; weights (L, H)."""
        load = np.zeros(self.n_shards, dtype=np.float64)
        for li, lp in enumerate(self.layers):
            load += lp.per_shard_load(weights[li], self.n_shards, self.slots_per_shard)
        return load

    def makespan(self, weights: np.ndarray) -> float:
        return float(self.per_shard_load(weights).max())

    def efficiency(self, weights: np.ndarray) -> float:
        """Eq. 5: mean-shard-load / max-shard-load."""
        load = self.per_shard_load(weights)
        mx = load.max()
        return float(load.mean() / mx) if mx > 0 else 1.0

    def replication_overhead(self) -> float:
        """Fraction of extra head-copies materialized (weight-memory cost)."""
        total = sum(int((lp.slot_head >= 0).sum()) for lp in self.layers)
        base = self.n_layers * self.n_heads
        return total / base - 1.0

    # ---- serialization -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "n_heads": self.n_heads,
            "n_shards": self.n_shards,
            "slots_per_shard": self.slots_per_shard,
            "mode": self.mode,
            "r_max": self.r_max,
            "layers": [{
                "slot_head": lp.slot_head.tolist(),
                "replica_idx": lp.replica_idx.tolist(),
                "replica_count": lp.replica_count.tolist(),
            } for lp in self.layers],
        })

    @staticmethod
    def from_json(s: str) -> "HeadPlacement":
        d = json.loads(s)
        layers = tuple(
            LayerPlacement(
                slot_head=np.asarray(l["slot_head"], dtype=np.int32),
                replica_idx=np.asarray(l["replica_idx"], dtype=np.int32),
                replica_count=np.asarray(l["replica_count"], dtype=np.int32),
            )
            for l in d["layers"]
        )
        return HeadPlacement(layers=layers, n_heads=d["n_heads"],
                             n_shards=d["n_shards"],
                             slots_per_shard=d["slots_per_shard"],
                             mode=d["mode"], r_max=d["r_max"])


def layer_from_assignment(assignment: Sequence[Sequence[int]], n_shards: int,
                          slots_per_shard: int) -> LayerPlacement:
    """Build a LayerPlacement from a per-shard list of head ids.

    ``assignment[j]`` = heads (with multiplicity across shards = replication)
    placed on shard j; each inner list must fit in ``slots_per_shard``.
    """
    n_slots = n_shards * slots_per_shard
    slot_head = np.full(n_slots, -1, dtype=np.int32)
    replica_idx = np.zeros(n_slots, dtype=np.int32)
    replica_count = np.ones(n_slots, dtype=np.int32)
    counts: Dict[int, int] = {}
    positions: Dict[int, List[int]] = {}
    for shard, heads in enumerate(assignment):
        assert len(heads) <= slots_per_shard, (
            f"shard {shard} got {len(heads)} heads > {slots_per_shard} slots")
        for k, h in enumerate(heads):
            j = shard * slots_per_shard + k
            slot_head[j] = h
            replica_idx[j] = counts.get(h, 0)
            counts[h] = counts.get(h, 0) + 1
            positions.setdefault(h, []).append(j)
    for h, slots in positions.items():
        for j in slots:
            replica_count[j] = counts[h]
    return LayerPlacement(slot_head=slot_head, replica_idx=replica_idx,
                          replica_count=replica_count)
