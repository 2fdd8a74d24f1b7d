"""`EngineStats`: one typed snapshot of the engine's operational state
(port of ``repro.api.stats``; same sections and fields).

`Engine.stats()` gathers the loose accessors (`memory_stats`,
`prefix_stats`, `imbalance`, `replan_log`) and the replan outcome counters
into one nested frozen dataclass — ``scheduler`` / ``pool`` / ``prefix`` /
``plan`` / ``speculation`` — that is always constructible: a section with
no live source (no scheduler yet, obs off, slot backend) has ``None``
fields and an empty ``detail`` instead of raising.

Every section keeps the typed fields a dashboard or benchmark keys on, and
carries the full backing dict in ``detail``.  The old accessors remain as
thin delegates over `stats()`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class PoolStats:
    """Cache-memory footprint (the old ``memory_stats`` dict, typed)."""

    backend: Optional[str] = None  # "slot" | "paged" | plugin name
    blocks_total: Optional[int] = None  # paged only
    blocks_in_use: Optional[int] = None
    cache_bytes: Optional[int] = None
    slot_equivalent_bytes: Optional[int] = None
    detail: dict = field(default_factory=dict)  # full memory_stats payload


@dataclass(frozen=True)
class PrefixStats:
    """Shared-prefix cache census (the old ``prefix_stats`` dict, typed)."""

    enabled: bool = False
    entries: Optional[int] = None
    blocks_held: Optional[int] = None
    hits: Optional[int] = None
    misses: Optional[int] = None
    evictions: Optional[int] = None
    detail: dict = field(default_factory=dict)


@dataclass(frozen=True)
class SchedulerStats:
    """Continuous-batching lifecycle counters + the replan history."""

    mode: str = "idle"  # "idle" | "oneshot" | "continuous"
    steps: Optional[int] = None
    active_rows: Optional[int] = None
    queued: Optional[int] = None
    finished: Optional[int] = None
    replans: Optional[int] = None
    replans_accepted: Optional[int] = None  # accepted online replans
    replans_rejected: Optional[int] = None
    preemptions: Optional[int] = None
    cancellations: Optional[int] = None
    imbalance: Optional[float] = None  # realized max/mean per-shard load
    replan_log: List[dict] = field(default_factory=list)
    detail: dict = field(default_factory=dict)


@dataclass(frozen=True)
class PlanStats:
    """The live `HeadPlacement` summarized (replans update it in place)."""

    mode: Optional[str] = None  # planner mode the plan was built under
    n_shards: Optional[int] = None
    slots_per_shard: Optional[int] = None
    replicated_heads: Optional[int] = None  # heads with replica_count > 1
    max_replication: Optional[int] = None
    detail: dict = field(default_factory=dict)


@dataclass(frozen=True)
class SpeculationStats:
    """Speculative-decoding effectiveness."""

    enabled: bool = False
    max_k: Optional[int] = None
    draft_layers: Optional[int] = None
    proposed: Optional[int] = None  # lifetime draft tokens proposed
    accepted: Optional[int] = None  # lifetime draft tokens accepted
    acceptance: Optional[float] = None  # accepted / proposed
    detail: dict = field(default_factory=dict)


@dataclass(frozen=True)
class EngineStats:
    """The consolidated `Engine.stats()` snapshot."""

    scheduler: SchedulerStats = field(default_factory=SchedulerStats)
    pool: PoolStats = field(default_factory=PoolStats)
    prefix: PrefixStats = field(default_factory=PrefixStats)
    plan: PlanStats = field(default_factory=PlanStats)
    speculation: SpeculationStats = field(default_factory=SpeculationStats)

    def to_dict(self) -> dict:
        """Plain nested-dict form (JSON-serializable)."""
        return dataclasses.asdict(self)


def collect_stats(engine) -> EngineStats:
    """Build an `EngineStats` from a live `Engine` (the implementation
    behind `Engine.stats()`; lives here so the facade stays readable)."""
    sched = engine.scheduler

    # -- pool: whichever mode ran most recently has the live cache --------
    pool = PoolStats()
    mem = None
    if engine._mode == "continuous" and sched is not None:
        mem = sched.backend.memory_stats(sched.state)
    elif engine.state is not None:
        mem = engine.backend.memory_stats(engine.state)
    elif sched is not None:
        mem = sched.backend.memory_stats(sched.state)
    if mem is not None:
        pool = PoolStats(
            backend=mem.get("backend"),
            blocks_total=mem.get("blocks_total"),
            blocks_in_use=mem.get("blocks_in_use"),
            cache_bytes=mem.get("cache_bytes"),
            slot_equivalent_bytes=mem.get("slot_equivalent_bytes"),
            detail=dict(mem))

    # -- prefix -----------------------------------------------------------
    prefix = PrefixStats()
    if sched is not None:
        pst = sched.prefix_stats()
        if pst:
            prefix = PrefixStats(
                enabled=True, entries=pst.get("entries"),
                blocks_held=pst.get("blocks_held"), hits=pst.get("hits"),
                misses=pst.get("misses"), evictions=pst.get("evictions"),
                detail=dict(pst))

    # -- scheduler --------------------------------------------------------
    scheduler = SchedulerStats(mode=engine._mode or "idle")
    if sched is not None:
        acc = rej = None
        if sched.obs.enabled:
            acc = int(sched.obs.metrics.counter_value(
                "sched_replans_total", outcome="accepted"))
            rej = int(sched.obs.metrics.counter_value(
                "sched_replans_total", outcome="rejected"))
        scheduler = SchedulerStats(
            mode="continuous", steps=sched.step_idx,
            active_rows=len(sched.active), queued=len(sched.queue),
            finished=len(sched.finished), replans=sched.n_replans,
            replans_accepted=acc, replans_rejected=rej,
            preemptions=sched.n_preemptions,
            cancellations=sched.n_cancellations,
            imbalance=sched.imbalance(),
            replan_log=list(sched.replan_log))

    # -- plan -------------------------------------------------------------
    plan_obj = engine.plan
    plan = PlanStats()
    if plan_obj is not None:
        rc = np.concatenate([np.asarray(lp.replica_count).ravel()
                             for lp in plan_obj.layers])
        plan = PlanStats(
            mode=plan_obj.mode, n_shards=plan_obj.n_shards,
            slots_per_shard=plan_obj.slots_per_shard,
            replicated_heads=int((rc > 1).sum()),
            max_replication=int(rc.max()) if rc.size else None)

    # -- speculation ------------------------------------------------------
    scfg = engine.cfg.speculation
    speculation = SpeculationStats(enabled=scfg.enabled)
    if scfg.enabled:
        proposed = accepted = 0
        if sched is not None:
            reqs = list(sched.finished) + list(sched.active.values())
            proposed = sum(r.spec_proposed for r in reqs)
            accepted = sum(r.spec_accepted for r in reqs)
        speculation = SpeculationStats(
            enabled=True, max_k=scfg.max_k, draft_layers=scfg.draft_layers,
            proposed=proposed, accepted=accepted,
            acceptance=(accepted / proposed) if proposed else None,
            detail={"adaptive": scfg.adaptive, "min_k": scfg.min_k})

    return EngineStats(scheduler=scheduler, pool=pool, prefix=prefix,
                       plan=plan, speculation=speculation)
