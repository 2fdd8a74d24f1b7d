"""Frontend core: fair queuing + admission + accounting around one
`Scheduler` (port of ``repro.frontend.core``; tick for tick the same
decisions on the same trace).

`FrontendScheduler` is the synchronous heart of the serving front end — the
HTTP layer (`repro_torch.frontend.http`) and the engine loop thread
(`repro_torch.frontend.bridge`) are adapters over it, and the fig10 goodput
bench drives it directly with a synthetic trace (`run_frontend_trace`).

Per `pump()` tick, in order:

1. **fair queuing** — one DRR round over the per-tenant queues; every
   request the round surfaces is *offered* to the admission controller;
2. **admission** — the controller's verdict maps onto the queue protocol:
   admit/degrade → `Scheduler.submit` (charging the tenant's deficit),
   reject → terminal CANCELLED without ever touching the engine,
   queue → stays queued (optionally arming one lower-priority preemption);
3. **engine tick** — `Scheduler.step()` (prefill-admit, decode, retire);
4. **accounting** — newly retired requests are judged for SLO attainment
   and goodput, per-tenant queue-depth/deficit gauges are refreshed.

The frontend only hands the engine what it has row capacity for *now*
(``free rows − engine-owned requeues``), so the engine's own FCFS queue
stays empty except for preemption victims — all waiting happens in the
tenant-fair queues where priority and quota policy apply.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.frontend import admission as adm
from repro_torch.frontend import queues as q
from repro_torch.frontend.accounting import TenantAccounting
from repro_torch.frontend.config import FrontendConfig
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import Scheduler


class FrontendScheduler:
    """Multi-tenant ingress for one engine `Scheduler` (single-threaded:
    the caller's loop owns every method here)."""

    def __init__(self, sched: Scheduler, cfg: Optional[FrontendConfig] = None):
        self.sched = sched
        self.cfg = cfg if cfg is not None else FrontendConfig()
        self.obs = sched.obs
        self.controller = adm.make_admission(self.cfg)
        prios = [c.priority for c in self.cfg.classes]
        self._prio_lo, self._prio_hi = min(prios), max(prios)
        if self.cfg.admission == "slo":
            # FrontendConfig's quota knobs are denominated in *request*
            # tokens (prompt + generation), but the DRR charges the
            # backend's request_cost — L·H-scaled projected tokens (slot)
            # or blocks (paged).  Calibrate the quantum/cap into backend
            # units so a "512-token" quantum means 512 request tokens on
            # any model geometry; without this, every request on a
            # many-layer model outprices the cap and could never be
            # admitted (the DRR's saturation path still guarantees
            # liveness, but fairness would degenerate).
            unit = self._cost_unit()
            self.queue = q.DeficitRoundRobin(
                max(1, round(self.cfg.quantum_tokens * unit)),
                max(1, round(self.cfg.quota_cap_tokens * unit)),
                self.cfg.max_queue_per_tenant)
        else:  # fcfs baseline: one global queue, tenant- and quota-blind
            self.queue = q.SingleQueue()
        self.accounting = TenantAccounting(self.cfg, self.obs.metrics)
        self.draining = False
        # terminal requests the engine never saw (rejected / shed at the
        # frontend) plus engine-finished ones, in completion order
        self.finished: List[Request] = []
        self.reject_reasons: Dict[int, str] = {}
        self._engine_seen = 0  # high-water mark into sched.finished
        self._seen_tenants: set = set()
        # optional terminal-event callback (the async bridge wires this to
        # wake waiting HTTP handlers); called with each newly terminal req
        self.on_terminal: Optional[Callable[[Request], None]] = None

    def _cost_unit(self) -> float:
        """Backend cost units per request token, measured with a canonical
        64-token probe against the live backend's projection machinery
        (host arithmetic in both backends: no device read, no allocation)."""
        probe = Request(req_id=-1, prompt=np.zeros(32, np.int32),
                        max_new_tokens=32)
        return max(1.0, float(self.sched.backend.request_cost(probe))) / 64.0

    # ---- ingress -----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue into the tenant's fair queue.  False = refused outright
        (draining, or the tenant's backlog bound is hit) — the request is
        terminal immediately with a recorded reason."""
        if req.arrival_time is None:
            req.arrival_time = time.time()
        req.arrival_step = self.sched.step_idx
        # clamp client-supplied priority to the configured ladder: an
        # out-of-range value (e.g. a negative one) would otherwise outrank
        # every configured class in the scheduler's queue pick and arm
        # preemption against all of them
        req.priority = max(self._prio_lo, min(self._prio_hi, req.priority))
        self._seen_tenants.add(req.tenant)
        if self.draining:
            self._reject(req, "draining")
            return False
        if not self.queue.push(req.tenant, req):
            self.accounting.on_decision(req.tenant, "reject")
            self._reject(req, "tenant_backlog_full")
            return False
        return True

    def cancel(self, req_id: int) -> bool:
        """Cancel wherever the request lives: still tenant-queued (remove,
        terminal here) or already inside the engine (row/blocks released
        by `Scheduler.cancel`)."""
        for tenant in list(self._seen_tenants):
            for req in self.queue.items(tenant):
                if req.req_id == req_id:
                    self.queue.remove(tenant, req)
                    self._reject(req, "cancelled")
                    return True
        if self.sched.cancel(req_id):
            self._collect_engine_finished()
            return True
        return False

    def drain(self) -> None:
        """Graceful shutdown: refuse new ingress, shed every queued (not
        yet admitted) request, let the engine decode its live rows out.
        `pump()` keeps working until `idle`.  Preemption victims waiting in
        the engine's own queue are shed too: a draining scheduler admits
        nothing, so they would hold the drain open for good (ROADMAP C.8)."""
        self.draining = True
        for tenant in list(self._seen_tenants):
            for req in self.queue.items(tenant):
                self.queue.remove(tenant, req)
                self._reject(req, "draining")
        for req in list(self.sched.queue):
            self.reject_reasons[req.req_id] = "draining"
            self.obs.metrics.counter(
                "frontend_rejections_total",
                help="requests refused or shed by the frontend, by reason"
            ).inc(tenant=req.tenant, reason="draining")
            self.sched.cancel(req.req_id)
        self._collect_engine_finished()
        self.sched.drain()

    @property
    def idle(self) -> bool:
        """Nothing queued, live or mid chunked prefill (a chunk job holds a
        row outside ``sched.active`` until its last chunk; ROADMAP C.8)."""
        return (len(self.queue) == 0 and not self.sched.active
                and not self.sched.queue and not self.sched.prefilling)

    # ---- terminal bookkeeping ----------------------------------------------

    def _reject(self, req: Request, reason: str) -> None:
        req.state = RequestState.CANCELLED
        req.finish_step = self.sched.step_idx
        req.finish_time = time.time()
        self.reject_reasons[req.req_id] = reason
        self.finished.append(req)
        self.accounting.on_finished(req)
        self.obs.metrics.counter(
            "frontend_rejections_total",
            help="requests refused or shed by the frontend, by reason"
        ).inc(tenant=req.tenant, reason=reason)
        if self.on_terminal is not None:
            self.on_terminal(req)

    def _collect_engine_finished(self) -> None:
        new = self.sched.finished[self._engine_seen:]
        self._engine_seen = len(self.sched.finished)
        for req in new:
            self.finished.append(req)
            self.accounting.on_finished(req)
            if self.on_terminal is not None:
                self.on_terminal(req)

    # ---- the pump tick -----------------------------------------------------

    def pump(self) -> dict:
        """One frontend tick (see module docstring).  Returns the engine
        step events extended with the frontend's admission activity."""
        # requests handed to the engine THIS tick: they are in sched.queue
        # but not yet spliced, so the backend's admissible() cannot see
        # their charge — the controller gets them as ``pending`` so later
        # admissions this tick are checked against the joint budget, not
        # each against the same un-spliced state
        pending: List[Request] = []
        preempted_this_tick = False
        # rows the engine can fill this tick: free rows minus the requeues
        # it already owned at tick start (preemption victims re-admit
        # first).  Snapshot the backlog NOW — our own in-tick submissions
        # land in ``sched.queue`` too and are counted via ``pending``,
        # and a mid-tick preemption that frees a row must enlarge the room
        # for the urgent request that armed it, not for its victim.
        engine_backlog = len(self.sched.queue)

        def room() -> int:
            return len(self.sched.freelist) - engine_backlog - len(pending)

        def cost(req: Request) -> float:
            return float(self.sched.backend.request_cost(req))

        def offer(tenant: str, req: Request) -> str:
            nonlocal preempted_this_tick
            d = self.controller.decide(self.sched, req, pending)
            if (d.action == adm.QUEUE and d.preempt
                    and not preempted_this_tick
                    and self.sched.preempt_lower_priority(req.priority)):
                # the eviction freed a row for THIS request — re-decide so
                # it can take the opening this very tick (the engine's
                # priority-aware queue pick would otherwise hand the row
                # straight back to the victim at step()).  At most one
                # eviction per tick: one opening is one row; more is thrash.
                preempted_this_tick = True
                d = self.controller.decide(self.sched, req, pending)
            if (d.action in (adm.ADMIT, adm.DEGRADE) and room() <= 0):
                # controller sized against the backend, but every free row
                # is already spoken for this tick — wait, engine-full
                d = adm.Decision(adm.QUEUE, reason="engine_full",
                                 global_block=True)
            self.accounting.on_decision(tenant, d.action)
            if d.action == adm.REJECT:
                self._reject(req, d.reason)
                return q.REJECTED
            if d.action in (adm.ADMIT, adm.DEGRADE):
                if d.action == adm.DEGRADE:
                    if req.degraded_from is None:
                        req.degraded_from = req.max_new_tokens
                    req.max_new_tokens = int(d.degrade_to)
                self.sched.submit(req)
                pending.append(req)
                return q.ADMITTED
            return q.STALL if d.global_block else q.BLOCKED

        admitted = self.queue.tick(cost, offer)
        ev = self.sched.step()
        self._collect_engine_finished()
        for tenant in sorted(self._seen_tenants):
            self.accounting.on_queue_sample(
                tenant, self.queue.backlog(tenant),
                self.queue.deficit(tenant))
        ev["frontend_admitted"] = [(t, r.req_id) for t, r in admitted]
        ev["frontend_queued"] = len(self.queue)
        return ev

    # ---- programmatic summary ----------------------------------------------

    def summary(self) -> dict:
        att = self.accounting.attained.total()
        mis = self.accounting.missed.total()
        steps = max(1, self.sched.step_idx)
        goodput = self.accounting.goodput_tokens.total()
        return {
            "admission": self.controller.name,
            "steps": self.sched.step_idx,
            "finished": len(self.finished),
            "rejected": len(self.reject_reasons),
            "generated_tokens": self.accounting.tokens.total(),
            "goodput_tokens": goodput,
            "goodput_tokens_per_step": goodput / steps,
            "slo_attained": att,
            "slo_missed": mis,
            "slo_attainment": att / (att + mis) if att + mis else None,
            "preemptions": self.sched.n_preemptions,
            "tenants": self.accounting.summary(),
        }


def run_frontend_trace(fe: FrontendScheduler, requests: List[Request],
                       max_steps: int = 10_000) -> dict:
    """Drive a synthetic trace through the frontend synchronously (the
    fig10 harness and tests): submit by ``arrival_step``, pump until every
    request is terminal (engine-finished or frontend-rejected)."""
    pending = sorted(requests, key=lambda r: (r.arrival_step, r.req_id))
    n_total = len(pending)
    i = 0
    t0 = time.time()
    while len(fe.finished) < n_total and fe.sched.step_idx < max_steps:
        while (i < len(pending)
               and pending[i].arrival_step <= fe.sched.step_idx):
            fe.submit(pending[i])
            i += 1
        fe.pump()
    out = fe.summary()
    out["total"] = n_total
    out["wall_s"] = time.time() - t0
    out["converged"] = len(fe.finished) >= n_total
    return out
