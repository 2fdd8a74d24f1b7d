"""SLO-aware admission control (port of ``repro.frontend.admission``: the
same decision table, reasons and probes).

The controller prices a queued request with the cache backend's *projected*
cost machinery (`CacheBackend.request_cost` / `admissible` /
`never_fits` — the same projections scheduler admission enforces) and
decides one of four actions per pump tick:

====================  =====================================================
action                when
====================  =====================================================
``admit``             a free row exists and the backend's projected-cost
                      check passes at the full ask
``degrade``           the full ask does not fit but a shrunken
                      ``max_new_tokens`` (>= the class's ``degrade_floor``)
                      does — trade generation length for latency
``queue``             no capacity now, but the request's TTFT SLO is still
                      attainable; optionally evict a lower-priority active
                      row (``preempt_below``) to make room next tick
``reject``            the request can never fit (`never_fits`), its
                      deadline elapsed, or it queued past the class's
                      ``shed_after_steps`` — its SLO is already blown, so
                      decoding it would burn tokens that can still be
                      goodput for viable requests
====================  =====================================================

The ``"fcfs"`` controller is the deliberately naive baseline: admit when
possible, otherwise wait — no shedding, no degradation, no priorities.
The fig10 goodput bench measures exactly the gap between the two.

The degrade search probes ``dataclasses.replace(req, max_new_tokens=m)``:
`Request` holds host values only, so a probe copies no device tensor, and
both backends' ``admissible`` / ``never_fits`` / ``request_cost`` read the
state without changing it (the paged ones are pure host arithmetic).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.frontend.config import FrontendConfig, PriorityClass
from repro_torch.serving.request import Request

ADMIT = "admit"
QUEUE = "queue"
DEGRADE = "degrade"
REJECT = "reject"


@dataclass(frozen=True)
class Decision:
    """One admission verdict.

    ``degrade_to`` is the shrunken ``max_new_tokens`` when action is
    ``degrade``; ``preempt`` asks the pump to evict one lower-priority
    active row via `Scheduler.preempt_lower_priority`; ``global_block``
    marks a queue verdict whose cause (no free batch row) blocks every
    tenant equally — the DRR tick stalls instead of probing other tenants.
    """

    action: str
    reason: str = ""
    degrade_to: Optional[int] = None
    preempt: bool = False
    global_block: bool = False


class AdmissionController:
    """The ``"slo"`` decision table above, stateless per decision."""

    name = "slo"

    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg

    # ---- helpers -----------------------------------------------------------

    def _fits_now(self, sched, req: Request,
                  pending: Sequence[Request]) -> bool:
        """Free row + backend projected-cost admission at the current ask,
        charged jointly with the ``pending`` requests already admitted this
        tick (submitted but not yet spliced, so invisible to ``state``)."""
        return (len(sched.freelist) > 0
                and sched.backend.admissible(sched.state, req,
                                             pending=pending))

    def _degrade_ask(self, sched, req: Request, cls: PriorityClass,
                     pending: Sequence[Request]) -> Optional[int]:
        """Largest ``max_new_tokens`` in [floor, current) whose projected
        cost fits right now (admissibility is monotone in the ask, so
        binary search); None when even the floor does not fit."""
        if not cls.degrade_floor or req.max_new_tokens <= cls.degrade_floor:
            return None
        if len(sched.freelist) == 0:
            return None

        def fits(m: int) -> bool:
            probe = dataclasses.replace(req, max_new_tokens=m)
            return sched.backend.admissible(sched.state, probe,
                                            pending=pending)

        lo, hi = cls.degrade_floor, req.max_new_tokens - 1
        if not fits(lo):
            return None
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fits(mid):
                lo = mid
            else:
                hi = mid - 1
        return lo

    # ---- the decision table ------------------------------------------------

    def decide(self, sched, req: Request,
               pending: Sequence[Request] = ()) -> Decision:
        """One verdict for ``req``.  ``pending`` are requests already
        admitted this pump tick (in the engine's queue, not yet spliced):
        capacity checks charge them too, so a burst admitted in one tick
        cannot jointly overshoot the backend budget."""
        cls = self.cfg.class_for(req.priority)
        waited = sched.step_idx - req.arrival_step
        # 1. dead on arrival or already past its latency budget: shed
        if req.deadline_exceeded():
            return Decision(REJECT, reason="deadline_exceeded")
        if cls.shed_after_steps and waited > cls.shed_after_steps:
            return Decision(REJECT, reason="slo_blown")
        # 2. structurally impossible at the current ask
        never = sched.backend.never_fits(req)
        if never is not None:
            floor = cls.degrade_floor
            if floor and req.max_new_tokens > floor:
                probe = dataclasses.replace(req, max_new_tokens=floor)
                if sched.backend.never_fits(probe) is None:
                    return Decision(DEGRADE, reason="never_fits_full_ask",
                                    degrade_to=floor)
            return Decision(REJECT, reason=f"never_fits: {never}")
        # 3. capacity now?
        if self._fits_now(sched, req, pending):
            return Decision(ADMIT, reason="fits")
        degrade_to = self._degrade_ask(sched, req, cls, pending)
        if degrade_to is not None and waited >= cls.ttft_slo_steps // 2:
            # only trade length for latency once the SLO is actually at
            # risk — a young request would rather wait for the full ask
            return Decision(DEGRADE, reason="pressure", degrade_to=degrade_to)
        # 4. wait — with the preemption lever armed for urgent classes
        # whose SLO clock is running out
        preempt = (cls.preempt_below
                   and waited >= max(1, cls.ttft_slo_steps // 2))
        return Decision(QUEUE, reason="no_capacity", preempt=preempt,
                        global_block=len(sched.freelist) == 0)


class FCFSController:
    """Baseline: admit-when-possible, never shed/degrade/preempt.  Still
    rejects structural `never_fits` requests — the scheduler itself
    fail-fasts those at submit, so queueing them would just crash later."""

    name = "fcfs"

    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg

    def decide(self, sched, req: Request,
               pending: Sequence[Request] = ()) -> Decision:
        never = sched.backend.never_fits(req)
        if never is not None:
            return Decision(REJECT, reason=f"never_fits: {never}")
        if (len(sched.freelist) > 0
                and sched.backend.admissible(sched.state, req,
                                             pending=pending)):
            return Decision(ADMIT, reason="fits")
        return Decision(QUEUE, reason="no_capacity",
                        global_block=True)  # strict FCFS: head blocks all


def make_admission(cfg: FrontendConfig):
    return (AdmissionController(cfg) if cfg.admission == "slo"
            else FCFSController(cfg))
