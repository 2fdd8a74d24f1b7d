"""FairKV planner: profile → (best-effort assignment + fair-copying) → plan.

Modes (paper Fig. 2 / Fig. 4 ablation arms):

- ``sha``          Static Head Allocation — heads spread uniformly, replicas
                   (when shards > heads, the GQA base case) split the batch
                   uniformly.  The paper's baseline.
- ``fairkv_nodp``  Best-effort assignment only (Technique I): load-aware
                   placement, no replication beyond the forced base.
- ``fairkv_dp``    + Fair-copying (Technique II): up to ``extra_copies`` (the
                   paper's CH parameter) additional replicas of the heaviest
                   heads, each replica taking ``w/r`` load (Eq. 4), subject to
                   ``R_max`` (Eq. 3) and the slot capacity.

The planner works per layer (paper §4.3: heads are rearranged *across layers*
independently — each layer's head set is partitioned on the same shard grid).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.assignment import assign_items
from repro_torch.core.placement import HeadPlacement, LayerPlacement, layer_from_assignment


# planner modes (paper Fig. 2 arms) — the list EngineConfig validates against
PLANNER_MODES = ("sha", "fairkv_nodp", "fairkv_dp")


@dataclass(frozen=True)
class PlannerConfig:
    mode: str = "fairkv_dp"  # one of PLANNER_MODES
    extra_copies: int = 4  # CH, paper Fig. 5
    r_max: Optional[int] = None  # Eq. 3 cap; default = n_shards
    slots_per_shard: Optional[int] = None  # default: ceil-based minimum
    engine: str = "auto"  # assignment engine
    fill_empty_slots: bool = True  # use spare slots for free replicas
    # replicas split the batch, so r can never usefully exceed it (a replica
    # owning zero rows idles its slot); set to the serving batch size
    batch_cap: Optional[int] = None
    node_budget: int = 20_000  # branch-and-bound nodes per layer


def _min_slots(n_heads: int, n_shards: int) -> int:
    return max(1, math.ceil(n_heads / n_shards))


def _sha_layer(n_heads: int, n_shards: int, slots_per_shard: int,
               fill: bool = True, r_cap: Optional[int] = None) -> List[List[int]]:
    """Uniform static allocation.  With shards > heads each head gets
    floor/ceil(n_slots/H) replicas laid out contiguously — the standard GQA
    replication pattern (e.g. 8 kv heads on 16 shards -> every head on 2
    consecutive shards)."""
    n_slots = n_shards * slots_per_shard
    if n_heads > n_slots:
        raise ValueError("not enough slots for heads")
    # uniform base replication (the GQA fill); fill=False keeps one replica
    # per head (the paper's single-copy SHA baseline)
    reps = n_slots // n_heads if fill else 1
    if r_cap is not None:
        reps = min(reps, r_cap)
    if reps > n_shards:
        raise ValueError(
            f"uniform replication {reps} exceeds shard count {n_shards}")
    assign: List[List[int]] = [[] for _ in range(n_shards)]
    # replica k of the flattened list goes to shard k % n_shards, so replicas
    # of one head always land on distinct shards
    for k in range(n_heads * reps):
        assign[k % n_shards].append(k // reps)
    return assign


def plan_layer(
    weights: np.ndarray,
    n_shards: int,
    cfg: PlannerConfig,
    shard_speeds: Optional[Sequence[float]] = None,
    initial_load: Optional[np.ndarray] = None,
) -> LayerPlacement:
    """Plan one layer given the cumulative per-shard load of earlier layers.

    Eq. 4 minimizes the max of the *total* (summed over layers) shard load, so
    each layer is placed against the carry-in ``initial_load`` — the paper's
    "rearrange attention heads across layers".
    ``weights[h]`` = expected per-head workload.
    """
    n_heads = int(weights.shape[0])
    slots_per_shard = cfg.slots_per_shard or _min_slots(n_heads, n_shards)
    n_slots = n_shards * slots_per_shard
    r_max = cfg.r_max or n_shards

    r_hard = min(r_max, n_shards, cfg.batch_cap or n_shards)

    if cfg.mode == "sha":
        assign = _sha_layer(n_heads, n_shards, slots_per_shard,
                            fill=cfg.fill_empty_slots, r_cap=r_hard)
        return layer_from_assignment(assign, n_shards, slots_per_shard)

    if cfg.mode not in PLANNER_MODES:
        raise ValueError(
            f"unknown planner mode {cfg.mode!r}; known: {list(PLANNER_MODES)}")

    # ---- choose replica counts ----------------------------------------------
    # Base: uniform replication filling the slot grid (identical to SHA's
    # replica budget — when shards > heads this is the forced GQA fill; when
    # heads >= slots it is r == 1).  NoDP keeps the base; DP redistributes /
    # extends it with up to ``extra_copies`` (CH) load-aware copies.
    base = max(1, n_slots // n_heads) if cfg.fill_empty_slots else 1
    base = min(base, r_hard)
    reps = np.full(n_heads, base, dtype=int)
    r_cap = r_hard
    if cfg.mode == "fairkv_dp":
        reps = _water_fill_replicas(weights, reps, n_slots, r_cap,
                                    cfg.extra_copies)

    # ---- assign replicas as items -------------------------------------------
    items_head: List[int] = []
    for h in range(n_heads):
        items_head.extend([h] * int(reps[h]))
    item_w = [float(weights[h]) / int(reps[h]) for h in items_head]

    # replicas of a head must land on distinct shards (item_group constraint);
    # branch-and-bound only runs for the replica-free case.
    any_reps = any(r > 1 for r in reps)
    assign = assign_items(
        item_w, n_shards, slots_per_shard,
        engine=cfg.engine,
        shard_speeds=shard_speeds,
        item_group=items_head if any_reps else None,
        initial_load=initial_load,
        node_budget=cfg.node_budget,
    )
    head_assign = [[items_head[i] for i in shard] for shard in assign]
    return layer_from_assignment(head_assign, n_shards, slots_per_shard)


def _water_fill_replicas(weights: np.ndarray, base: np.ndarray, n_slots: int,
                         r_cap: int, ch: int) -> np.ndarray:
    """Fair-copying replica counts (Technique II).

    Minimize ``max_h w_h / r_h`` by (a) adding replicas of the heaviest heads
    into spare slots, then (b) moving replicas from the lightest to the
    heaviest heads — spending at most ``ch`` copy operations total (the
    paper's CH knob), keeping Σ r == n_slots capacity and r ≤ r_cap (Eq. 3).
    """
    w = np.asarray(weights, float)
    reps = base.copy()
    moves = 0

    def hottest():
        per = np.where(reps < r_cap, w / reps, -np.inf)
        h = int(per.argmax())
        return h if np.isfinite(per[h]) else -1

    # (a) pure additions into spare slots
    spare = n_slots - int(reps.sum())
    while spare > 0 and moves < ch:
        h = hottest()
        if h < 0:
            break
        reps[h] += 1
        spare -= 1
        moves += 1

    # (b) redistribution: take one replica from the coldest donor, give to the
    # hottest head, while it strictly reduces the max per-replica load
    while moves < ch:
        per = w / reps
        cur_max = float(per.max())
        rec = hottest()
        if rec < 0:
            break
        donors = [h for h in range(len(w)) if reps[h] > 1 and h != rec]
        if not donors:
            break
        donor = min(donors, key=lambda h: w[h] / (reps[h] - 1))
        new_donor = w[donor] / (reps[donor] - 1)
        new_rec = w[rec] / (reps[rec] + 1)
        others = np.delete(per, [donor, rec])
        new_max = max(new_donor, new_rec, float(others.max(initial=0.0)))
        if new_max >= cur_max - 1e-12:
            break
        reps[donor] -= 1
        reps[rec] += 1
        moves += 1
    return reps


def build_plan(
    profile: np.ndarray,
    n_shards: int,
    cfg: Optional[PlannerConfig] = None,
    shard_speeds: Optional[Sequence[float]] = None,
) -> HeadPlacement:
    """Plan all layers.  ``profile`` is (L, H) expected per-head workload."""
    cfg = cfg or PlannerConfig()
    profile = np.asarray(profile, dtype=np.float64)
    if profile.ndim != 2:
        raise ValueError("profile must be (n_layers, n_heads)")
    n_layers, n_heads = profile.shape
    slots_per_shard = cfg.slots_per_shard or _min_slots(n_heads, n_shards)
    cfg = PlannerConfig(**{**cfg.__dict__, "slots_per_shard": slots_per_shard})
    layers = []
    carry = np.zeros(n_shards, dtype=np.float64)
    for li in range(n_layers):
        lp = plan_layer(profile[li], n_shards, cfg, shard_speeds,
                        initial_load=None if cfg.mode == "sha" else carry)
        carry += lp.per_shard_load(profile[li], n_shards, slots_per_shard)
        layers.append(lp)
    plan = HeadPlacement(
        layers=tuple(layers), n_heads=n_heads, n_shards=n_shards,
        slots_per_shard=slots_per_shard, mode=cfg.mode,
        r_max=cfg.r_max or n_shards)
    plan.validate()
    return plan


def replan_for_stragglers(
    profile: np.ndarray,
    plan: HeadPlacement,
    shard_speeds: Sequence[float],
    cfg: Optional[PlannerConfig] = None,
) -> HeadPlacement:
    """Straggler mitigation: rebuild the plan with per-shard speed factors so a
    slow shard receives proportionally less KV load (DESIGN.md §6)."""
    cfg = cfg or PlannerConfig(mode=plan.mode,
                               slots_per_shard=plan.slots_per_shard,
                               r_max=plan.r_max)
    return build_plan(profile, plan.n_shards, cfg, shard_speeds)


def plan_kv_dtypes(
    profile: np.ndarray,
    base: str = "int8",
    low_dtype: str = "fp8",
    low_fraction: float = 0.5,
) -> tuple:
    """Per-head KV storage format as an allocatable budget axis.

    Quantized pools give every head the same bytes per token; what the
    planner can still allocate is *fidelity*.  Int8 codes spend their 8
    bits on one block-wide scale (fine uniform steps: lower error for the
    amplitude-stable distributions of heavily attended heads), while fp8
    (e4m3) spends bits on exponent (graceful under outliers, coarser
    steps).  This turns the (L, H) expected-workload profile the placement
    planner consumes into the `PagingConfig.kv_dtype_overrides` tuple: per
    layer, the coldest ``low_fraction`` of heads — whose retained KV
    carries the least attention mass — are stored as ``low_dtype`` while
    the hot heads keep ``base``.

    Returns the canonical sorted ``((layer, head, dtype), ...)`` tuple
    (empty when ``low_fraction`` rounds to zero heads or the two formats
    are equal), ready to pass to `PagingConfig`.
    """
    from repro_torch.paging.kvquant import QUANT_DTYPES

    for name, dt in (("base", base), ("low_dtype", low_dtype)):
        if dt not in QUANT_DTYPES:
            raise ValueError(
                f"{name} must be one of {list(QUANT_DTYPES)}, got {dt!r}")
    if not 0.0 <= low_fraction <= 1.0:
        raise ValueError(f"low_fraction must be in [0, 1], got {low_fraction}")
    profile = np.asarray(profile, dtype=np.float64)
    if profile.ndim != 2:
        raise ValueError("profile must be (n_layers, n_heads)")
    n_layers, n_heads = profile.shape
    n_low = int(low_fraction * n_heads)
    if base == low_dtype or n_low == 0:
        return ()
    overrides = []
    for layer in range(n_layers):
        # stable sort: ties resolve to lower head ids, deterministically
        cold = np.argsort(profile[layer], kind="stable")[:n_low]
        overrides.extend((layer, int(h), low_dtype) for h in cold)
    return tuple(sorted(overrides))


def draft_plan(plan, n_layers: int):
    """Head placement for the layer-truncated draft model (DESIGN.md §16).

    Self-speculative decoding's draft is the target's first ``n_layers``
    blocks, so its placement *rides* the target plan: the draft plan is
    literally the leading per-layer slice of the target's — same slot grid,
    same replica/owner rule, no separate planning pass — and every target
    replan re-plans the draft for free (the propose step re-slices whatever
    plan the executor holds).  Accepts the planning-time `HeadPlacement`
    or any runtime plan container whose fields are (L, ...)-leading stacked
    arrays (e.g. ``cache.slot_cache.PlanArrays``); returns the same type.
    """
    import dataclasses

    if isinstance(plan, HeadPlacement):
        if not 0 < n_layers <= plan.n_layers:
            raise ValueError(
                f"draft n_layers must be in [1, {plan.n_layers}], "
                f"got {n_layers}")
        return dataclasses.replace(plan, layers=plan.layers[:n_layers])
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name)[:n_layers]
        for f in dataclasses.fields(plan)})
