"""`FrontendConfig`: the multi-tenant serving front end's knobs (port of
``repro.frontend.config``; the same names, defaults and checks).

Dataclasses only: `EngineConfig` composes a `FrontendConfig`, so this
module imports neither torch nor the asyncio / HTTP machinery.

Two layered policies are configured here:

- **fairness** between tenants: deficit round robin over per-tenant FIFO
  queues with a token-budget quota (``quantum_tokens`` refilled per pump
  tick, banked deficit capped at ``quota_cap_tokens``).  Costs are the
  backend's *projected* request cost, so fairness is cost-aware: a tenant
  sending long prompts under imbalanced per-head budgets drains its quota
  faster than one sending short ones (FairKV's premise that per-request
  cost is heterogeneous).
- **admission** within the engine: each request belongs to a
  `PriorityClass` carrying a TTFT SLO; the controller decides admit /
  queue / degrade / reject per pump tick (`repro_torch.frontend.admission`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class PriorityClass:
    """One latency class: SLO targets + the admission levers it may use.

    ``priority`` is the class index carried on `Request.priority` — lower
    is more urgent.  ``ttft_slo_steps`` is the time-to-first-token target
    in *scheduler steps* (deterministic across hardware; wall-clock SLOs
    are optional refinements used for attainment accounting only).

    Levers:
    - ``shed_after_steps``: REJECT a request still queued after this many
      steps (0 disables) — serving a request whose SLO is already blown
      wastes tokens that could be goodput for still-viable ones.
    - ``degrade_floor``: admission may shrink ``max_new_tokens`` down to
      this floor to fit the free budget (0 disables degradation).
    - ``preempt_below``: under pressure, queued requests of this class may
      evict an active lower-priority row via the scheduler's preemption
      path (the front end's enforcement lever).
    """

    name: str
    priority: int
    ttft_slo_steps: int = 32
    ttft_slo_s: Optional[float] = None  # optional wall-clock attainment SLO
    itl_slo_s: Optional[float] = None  # optional per-token cadence SLO
    shed_after_steps: int = 0
    degrade_floor: int = 0
    preempt_below: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("PriorityClass.name must be non-empty")
        if self.priority < 0:
            raise ValueError(
                f"priority must be >= 0, got {self.priority}")
        if self.ttft_slo_steps < 1:
            raise ValueError(
                f"ttft_slo_steps must be >= 1, got {self.ttft_slo_steps}")
        if self.shed_after_steps < 0:
            raise ValueError(
                f"shed_after_steps must be >= 0, got "
                f"{self.shed_after_steps}")
        if self.degrade_floor < 0:
            raise ValueError(
                f"degrade_floor must be >= 0, got {self.degrade_floor}")


# the default three-class ladder: interactive chat (tight TTFT, may preempt
# and shed), standard API traffic, and best-effort batch (degradable, never
# sheds — it would rather wait than waste its tokens)
DEFAULT_CLASSES: Tuple[PriorityClass, ...] = (
    PriorityClass(name="interactive", priority=0, ttft_slo_steps=8,
                  shed_after_steps=16, preempt_below=True),
    PriorityClass(name="standard", priority=1, ttft_slo_steps=24,
                  shed_after_steps=64),
    PriorityClass(name="batch", priority=2, ttft_slo_steps=200,
                  degrade_floor=4),
)


@dataclass(frozen=True)
class FrontendConfig:
    """Everything the serving front end needs, validated at construction.

    ``admission`` selects the controller: ``"slo"`` (the SLO decision
    table) or ``"fcfs"`` (admit-when-possible, never reject/degrade — the
    baseline the fig10 goodput bench compares against; it also bypasses
    tenant fairness, modelling a single global queue).
    """

    host: str = "127.0.0.1"
    port: int = 8000
    admission: str = "slo"  # "slo" | "fcfs"
    classes: Tuple[PriorityClass, ...] = DEFAULT_CLASSES
    # --- tenant fairness (deficit round robin) ------------------------------
    quantum_tokens: int = 512  # per-tenant token refill per pump tick
    quota_cap_tokens: int = 8192  # banked-deficit cap (>= largest request)
    max_queue_per_tenant: int = 256  # hard backlog bound -> reject
    # --- accounting ---------------------------------------------------------
    latency_window: int = 256  # rolling per-tenant percentile window
    # --- serving loop -------------------------------------------------------
    idle_sleep_s: float = 0.002  # engine-loop sleep when no work is live
    drain_timeout_s: float = 30.0  # graceful-shutdown decode budget
    max_prompt_tokens: int = 0  # per-request prompt bound (0 = engine's)
    max_new_tokens_cap: int = 0  # per-request generation bound (0 = none)

    def __post_init__(self):
        if self.admission not in ("slo", "fcfs"):
            raise ValueError(
                f"unknown admission mode {self.admission!r}; "
                f"known: ['slo', 'fcfs']")
        if not self.classes:
            raise ValueError("classes must be non-empty")
        prios = [c.priority for c in self.classes]
        if len(set(prios)) != len(prios):
            raise ValueError(
                f"duplicate PriorityClass.priority values: {sorted(prios)}")
        if self.quantum_tokens < 1:
            raise ValueError(
                f"quantum_tokens must be >= 1, got {self.quantum_tokens}")
        if self.quota_cap_tokens < self.quantum_tokens:
            raise ValueError(
                f"quota_cap_tokens ({self.quota_cap_tokens}) must be >= "
                f"quantum_tokens ({self.quantum_tokens}) or the deficit "
                f"can never bank a full refill")
        if self.max_queue_per_tenant < 1:
            raise ValueError(
                f"max_queue_per_tenant must be >= 1, got "
                f"{self.max_queue_per_tenant}")
        if self.latency_window < 2:
            raise ValueError(
                f"latency_window must be >= 2, got {self.latency_window}")
        if self.idle_sleep_s < 0 or self.drain_timeout_s < 0:
            raise ValueError("idle_sleep_s / drain_timeout_s must be >= 0")
        if not 0 <= self.port <= 65535:
            raise ValueError(f"port must be in [0, 65535], got {self.port}")

    def class_for(self, priority: int) -> PriorityClass:
        """The class whose index matches, else the *least* urgent class at
        or above the requested index (unknown priorities degrade to the
        closest configured class instead of crashing the ingress)."""
        best = None
        for c in sorted(self.classes, key=lambda c: c.priority):
            if c.priority == priority:
                return c
            if c.priority < priority:
                best = c
        return best if best is not None else min(
            self.classes, key=lambda c: c.priority)
