"""Best-effort assignment (paper Technique I).

The optimization target is Eq. 4: minimize the max per-shard load
``max_j Σ_i x_ij · w_i / r_i`` — weighted multiway number partitioning
(makespan scheduling), NP-hard.  Three primitives, composable:

- ``greedy_lpt``      — Longest-Processing-Time first; 4/3-approx, O(n log n).
- ``local_search``    — move/swap refinement of any assignment.
- ``backtracking``    — the paper's Algorithm 1 (recursive backtracking over
                        partitions), upgraded to branch-and-bound: LPT gives the
                        incumbent, partial-max + remaining-lower-bound prunes,
                        and a node budget keeps worst-case time bounded.

All primitives accept ``shard_speeds`` (relative speed per shard; default
1.0) — the straggler-mitigation extension: load_j is divided by speed_j so
slower shards receive proportionally less work (DESIGN.md §6).

**Engines** (the ``engine=`` strings of ``assign_items`` /
``PlannerConfig.engine``) are registered through
``repro.api.register_assignment_engine`` — the old string if/elif is gone,
so third-party solvers plug in without touching this file.  The engine
contract::

    @register_assignment_engine("my_solver")
    def my_solver(weights, n_shards, slots_per_shard, *, shard_speeds=None,
                  item_group=None, initial_load=None,
                  node_budget=200_000) -> List[List[int]]: ...

Built-ins: ``greedy`` (LPT + feasibility fallback + local search),
``backtracking`` (greedy incumbent + branch-and-bound; **rejects**
``item_group`` — the search does not implement replica distinct-shard
exclusion), ``auto`` (backtracking when replica-free, greedy otherwise).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.registry import (
    ASSIGNMENT_ENGINE_REGISTRY,
    register_assignment_engine,
)


def _loads_ok(items_per_shard: Sequence[int], cap: int) -> bool:
    return all(n <= cap for n in items_per_shard)


def greedy_lpt(
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    shard_speeds: Optional[Sequence[float]] = None,
    item_group: Optional[Sequence[int]] = None,
    initial_load: Optional[Sequence[float]] = None,
) -> List[List[int]]:
    """LPT with slot-capacity and distinct-shard-per-group constraints.

    ``weights[i]`` is the *effective* weight of item i (already divided by its
    replication factor).  ``item_group[i]`` (e.g. head id) — two items of the
    same group (replicas of one head) never share a shard.
    Returns per-shard item lists.
    """
    speeds = np.ones(n_shards) if shard_speeds is None else np.asarray(shard_speeds, float)
    order = np.argsort(-np.asarray(weights, float), kind="stable")
    assign: List[List[int]] = [[] for _ in range(n_shards)]
    groups: List[set] = [set() for _ in range(n_shards)]
    load = (np.zeros(n_shards) if initial_load is None
            else np.asarray(initial_load, float).copy())
    for i in order:
        i = int(i)
        g = item_group[i] if item_group is not None else None
        best_j, best_t = -1, np.inf
        for j in range(n_shards):
            if len(assign[j]) >= slots_per_shard:
                continue
            if g is not None and g in groups[j]:
                continue
            t = (load[j] + weights[i]) / speeds[j]
            if t < best_t:
                best_t, best_j = t, j
        if best_j < 0:
            raise ValueError(
                f"item {i} cannot be placed (capacity/group constraints exhausted)")
        assign[best_j].append(i)
        if g is not None:
            groups[best_j].add(g)
        load[best_j] += weights[i]
    return assign


def local_search(
    assign: List[List[int]],
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    shard_speeds: Optional[Sequence[float]] = None,
    item_group: Optional[Sequence[int]] = None,
    initial_load: Optional[Sequence[float]] = None,
    max_rounds: int = 64,
) -> List[List[int]]:
    """Move/swap refinement.  ``item_group[i]`` (e.g. head id) constrains moves
    so two items of the same group never share a shard."""
    speeds = np.ones(n_shards) if shard_speeds is None else np.asarray(shard_speeds, float)
    w = np.asarray(weights, float)
    base = (np.zeros(n_shards) if initial_load is None
            else np.asarray(initial_load, float))
    assign = [list(a) for a in assign]

    def shard_time(j):
        return (base[j] + sum(w[i] for i in assign[j])) / speeds[j]

    def group_conflict(i, j):
        if item_group is None:
            return False
        g = item_group[i]
        return any(item_group[k] == g for k in assign[j])

    for _ in range(max_rounds):
        times = np.array([shard_time(j) for j in range(n_shards)])
        src = int(times.argmax())
        improved = False
        # try moving an item off the bottleneck shard
        for i in sorted(assign[src], key=lambda i: -w[i]):
            for dst in np.argsort(times):
                dst = int(dst)
                if dst == src or len(assign[dst]) >= slots_per_shard:
                    continue
                if group_conflict(i, dst):
                    continue
                new_src = times[src] - w[i] / speeds[src]
                new_dst = times[dst] + w[i] / speeds[dst]
                if max(new_src, new_dst) < times[src] - 1e-12:
                    assign[src].remove(i)
                    assign[dst].append(i)
                    improved = True
                    break
            if improved:
                break
        if improved:
            continue
        # try swapping bottleneck item with a lighter one elsewhere
        swapped = False
        for i in sorted(assign[src], key=lambda i: -w[i]):
            for dst in np.argsort(times):
                dst = int(dst)
                if dst == src:
                    continue
                for k in assign[dst]:
                    if w[k] >= w[i]:
                        continue
                    if item_group is not None and (
                        any(item_group[x] == item_group[i] for x in assign[dst] if x != k)
                        or any(item_group[x] == item_group[k] for x in assign[src] if x != i)
                    ):
                        continue
                    new_src = times[src] + (w[k] - w[i]) / speeds[src]
                    new_dst = times[dst] + (w[i] - w[k]) / speeds[dst]
                    if max(new_src, new_dst) < times[src] - 1e-12:
                        assign[src].remove(i)
                        assign[dst].remove(k)
                        assign[src].append(k)
                        assign[dst].append(i)
                        swapped = True
                        break
                if swapped:
                    break
            if swapped:
                break
        if not swapped:
            break
    return assign


def backtracking(
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    shard_speeds: Optional[Sequence[float]] = None,
    incumbent: Optional[List[List[int]]] = None,
    initial_load: Optional[Sequence[float]] = None,
    node_budget: int = 200_000,
) -> Tuple[List[List[int]], float]:
    """Paper Algorithm 1 — recursive backtracking over head→shard partitions,
    as branch-and-bound.

    Items are placed in weight-descending order; a branch is cut when its
    partial makespan already meets the incumbent.  Shard-symmetry is broken by
    only allowing an item into at most one currently-empty shard.
    Returns (assignment, makespan).
    """
    w = np.asarray(weights, float)
    speeds = np.ones(n_shards) if shard_speeds is None else np.asarray(shard_speeds, float)
    order = np.argsort(-w, kind="stable")
    sorted_w = w[order]
    suffix_sum = np.concatenate([np.cumsum(sorted_w[::-1])[::-1], [0.0]])
    total_speed = speeds.sum()

    base = (np.zeros(n_shards) if initial_load is None
            else np.asarray(initial_load, float))
    if incumbent is None:
        incumbent = greedy_lpt(list(w), n_shards, slots_per_shard, shard_speeds,
                               initial_load=base)
    best_assign = [list(a) for a in incumbent]

    def makespan_of(a):
        return max(
            ((base[j] + sum(w[i] for i in a[j])) / speeds[j]) for j in range(n_shards))

    best = makespan_of(best_assign)
    load = base.copy()
    counts = np.zeros(n_shards, dtype=int)
    cur: List[List[int]] = [[] for _ in range(n_shards)]
    nodes = 0

    def rec(k: int) -> None:
        nonlocal best, best_assign, nodes
        nodes += 1
        if nodes > node_budget:
            return
        if k == len(order):
            ms = max(load[j] / speeds[j] for j in range(n_shards))
            if ms < best - 1e-12:
                best = ms
                best_assign = [list(a) for a in cur]
            return
        # lower bound: even a perfect spread of the remaining weight cannot
        # beat the incumbent
        lb = max(
            max(load[j] / speeds[j] for j in range(n_shards)),
            (load.sum() + suffix_sum[k]) / total_speed,
        )
        if lb >= best - 1e-12:
            return
        i = int(order[k])
        seen_empty_loads = set()
        cands = sorted(range(n_shards), key=lambda j: load[j] / speeds[j])
        for j in cands:
            if counts[j] >= slots_per_shard:
                continue
            if counts[j] == 0:
                key = round(float(load[j]), 9)
                if key in seen_empty_loads:
                    continue  # symmetry: empty shards with equal carry-in load
                seen_empty_loads.add(key)
            if (load[j] + w[i]) / speeds[j] >= best - 1e-12:
                continue
            load[j] += w[i]
            counts[j] += 1
            cur[j].append(i)
            rec(k + 1)
            cur[j].pop()
            counts[j] -= 1
            load[j] -= w[i]

    if len(order) * 1.0 <= n_shards * slots_per_shard:
        rec(0)
    return best_assign, best


def _greedy_refined(
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    shard_speeds: Optional[Sequence[float]] = None,
    item_group: Optional[Sequence[int]] = None,
    initial_load: Optional[Sequence[float]] = None,
) -> List[List[int]]:
    """LPT (with feasibility fallback for replica sets) + local search."""
    try:
        assign = greedy_lpt(weights, n_shards, slots_per_shard, shard_speeds,
                            item_group, initial_load)
    except ValueError:
        # weight-ordered LPT can strand a replica (its remaining shards are
        # full).  Feasibility-first: place heads with the most replicas
        # first (Hall's condition then guarantees a slot), refine after.
        assert item_group is not None
        from collections import Counter
        gcount = Counter(item_group)
        order = sorted(range(len(weights)),
                       key=lambda i: (-gcount[item_group[i]], -weights[i]))
        assign = [[] for _ in range(n_shards)]
        groups = [set() for _ in range(n_shards)]
        load = (np.zeros(n_shards) if initial_load is None
                else np.asarray(initial_load, float).copy())
        speeds = (np.ones(n_shards) if shard_speeds is None
                  else np.asarray(shard_speeds, float))
        for i in order:
            g = item_group[i]
            cands = [j for j in range(n_shards)
                     if len(assign[j]) < slots_per_shard and g not in groups[j]]
            if not cands:
                raise ValueError(
                    f"replica set infeasible: item {i} group {g}")
            j = min(cands, key=lambda j: (load[j] + weights[i]) / speeds[j])
            assign[j].append(i)
            groups[j].add(g)
            load[j] += weights[i]
    return local_search(assign, weights, n_shards, slots_per_shard,
                        shard_speeds, item_group, initial_load)


@register_assignment_engine("greedy")
def _engine_greedy(
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    *,
    shard_speeds: Optional[Sequence[float]] = None,
    item_group: Optional[Sequence[int]] = None,
    initial_load: Optional[Sequence[float]] = None,
    node_budget: int = 200_000,
) -> List[List[int]]:
    """LPT + local search; supports replica groups."""
    return _greedy_refined(weights, n_shards, slots_per_shard, shard_speeds,
                           item_group, initial_load)


@register_assignment_engine("backtracking")
def _engine_backtracking(
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    *,
    shard_speeds: Optional[Sequence[float]] = None,
    item_group: Optional[Sequence[int]] = None,
    initial_load: Optional[Sequence[float]] = None,
    node_budget: int = 200_000,
) -> List[List[int]]:
    """Branch-and-bound over a greedy incumbent; replica-free inputs only.

    ``item_group`` is rejected rather than silently downgraded to greedy
    (the historical behavior): the branch-and-bound search does not enforce
    the replicas-on-distinct-shards constraint, so honoring the request
    would return an invalid plan and ignoring it would lie about the engine
    that actually ran.
    """
    if item_group is not None:
        raise ValueError(
            "engine='backtracking' does not support replica groups "
            "(item_group): the branch-and-bound search cannot enforce the "
            "distinct-shard-per-head constraint.  Use engine='greedy', or "
            "engine='auto' to select the best supported engine "
            "automatically.")
    incumbent = _greedy_refined(weights, n_shards, slots_per_shard,
                                shard_speeds, None, initial_load)
    bt, _ = backtracking(weights, n_shards, slots_per_shard, shard_speeds,
                         incumbent=incumbent, initial_load=initial_load,
                         node_budget=node_budget)
    return bt


@register_assignment_engine("auto")
def _engine_auto(
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    *,
    shard_speeds: Optional[Sequence[float]] = None,
    item_group: Optional[Sequence[int]] = None,
    initial_load: Optional[Sequence[float]] = None,
    node_budget: int = 200_000,
) -> List[List[int]]:
    """Strongest supported engine: branch-and-bound when replica-free,
    greedy + local search otherwise."""
    if item_group is None:
        return _engine_backtracking(
            weights, n_shards, slots_per_shard, shard_speeds=shard_speeds,
            initial_load=initial_load, node_budget=node_budget)
    return _greedy_refined(weights, n_shards, slots_per_shard, shard_speeds,
                           item_group, initial_load)


def assign_items(
    weights: Sequence[float],
    n_shards: int,
    slots_per_shard: int,
    engine: str = "auto",
    shard_speeds: Optional[Sequence[float]] = None,
    item_group: Optional[Sequence[int]] = None,
    initial_load: Optional[Sequence[float]] = None,
    node_budget: int = 200_000,
) -> List[List[int]]:
    """Front door: dispatch to a registered assignment engine by name.

    Unknown names raise ``KeyError`` listing the registered engines (the
    same list ``repro_torch.api.list_engines`` feeds into config validation).
    """
    fn = ASSIGNMENT_ENGINE_REGISTRY[engine]
    return fn(weights, n_shards, slots_per_shard, shard_speeds=shard_speeds,
              item_group=item_group, initial_load=initial_load,
              node_budget=node_budget)
