"""Per-tenant fair queuing: deficit round robin over token-budget quotas
(port of ``repro.frontend.queues``: the same verdicts, order and counters).

Classic DRR (Shreedhar & Varghese) with the packet length replaced by the
cache backend's *projected request cost* in tokens — admission fairness is
therefore cost-aware: a tenant whose requests pin more projected KV (long
prompts, imbalanced per-head budgets) drains its quota proportionally
faster than one sending cheap requests, even at equal request counts.

Mechanics per `tick`:

- every backlogged tenant banks ``quantum`` tokens of deficit (clamped to
  ``cap`` — an idle-then-bursting tenant cannot hoard unbounded credit);
- tenants are visited in round-robin order starting after the last tenant
  served first in the previous tick (no positional bias);
- a tenant admits requests from its FIFO head while its deficit covers the
  head's cost (clamped to ``cap`` — see oversized items below); each
  admission charges the deficit by the cost, clamped to the banked amount;
- a tenant whose queue empties forfeits its remaining deficit (classic DRR
  — credit only banks while backlogged).

Starvation-freedom (property-tested): while a tenant stays backlogged its
deficit grows by ``quantum`` per tick and is never charged except by its
own admissions, so any head request with cost ≤ ``cap`` becomes admissible
within ``ceil(cost / quantum)`` ticks; the visit order guarantees the
tenant is offered the admission attempt each tick.  An *oversized* head
request (cost > ``cap``) can never be covered by banked deficit, so the
quota gate saturates instead of starving: once the tenant's deficit
reaches ``cap`` — the maximum wait any request can be charged,
``ceil(cap / quantum)`` ticks — the item is offered anyway and, if
admitted, charged the entire banked deficit.  Every queued item therefore
reaches the admission controller (which may admit, reject, or shed it) in
bounded ticks; nothing is silently head-of-line blocked forever.  Token
conservation (also property-tested): for every tenant,
``deficit == refilled - charged - forfeited`` exactly, and the deficit is
always within ``[0, cap]``.

The structure is engine-agnostic and synchronous — the decision of *what
happens* to an offered request (admit / reject / leave queued / stop the
tick) is delegated to a callback, so the same queue drives the admission
controller, the property tests, and the goodput bench.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# callback verdicts for one offered head request
ADMITTED = "admitted"  # dequeue + charge the tenant's deficit
REJECTED = "rejected"  # dequeue without charging (no capacity consumed)
BLOCKED = "blocked"  # leave queued, move on to the next tenant
STALL = "stall"  # leave queued, stop the whole tick (engine full)


@dataclass
class _Tenant:
    queue: deque = field(default_factory=deque)
    deficit: float = 0.0
    refilled: float = 0.0  # Σ quantum actually banked (post-clamp)
    charged: float = 0.0  # Σ admitted costs
    forfeited: float = 0.0  # Σ deficit dropped on queue-empty


class DeficitRoundRobin:
    """Cost-aware fair queue over per-tenant FIFOs; see module docstring."""

    def __init__(self, quantum: int, cap: int,
                 max_queue_per_tenant: int = 0):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if cap < quantum:
            raise ValueError(f"cap ({cap}) must be >= quantum ({quantum})")
        self.quantum = float(quantum)
        self.cap = float(cap)
        self.max_queue_per_tenant = int(max_queue_per_tenant)
        self._tenants: Dict[str, _Tenant] = {}
        self._order: List[str] = []  # visit order (insertion, rotated)

    # ---- enqueue -----------------------------------------------------------

    def push(self, tenant: str, item) -> bool:
        """FIFO-append ``item`` to ``tenant``'s queue.  Returns False (and
        drops the item) when the tenant's backlog bound is hit — the
        caller's overload rejection, not a silent tail drop."""
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _Tenant()
            self._order.append(tenant)
        if (self.max_queue_per_tenant
                and len(t.queue) >= self.max_queue_per_tenant):
            return False
        t.queue.append(item)
        return True

    def remove(self, tenant: str, item) -> bool:
        """Withdraw a queued item (cancellation before admission)."""
        t = self._tenants.get(tenant)
        if t is None or item not in t.queue:
            return False
        t.queue.remove(item)
        self._settle(t)
        return True

    # ---- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return sum(len(t.queue) for t in self._tenants.values())

    def backlog(self, tenant: str) -> int:
        t = self._tenants.get(tenant)
        return 0 if t is None else len(t.queue)

    def backlogged(self) -> List[str]:
        return [n for n in self._order if self._tenants[n].queue]

    def deficit(self, tenant: str) -> float:
        t = self._tenants.get(tenant)
        return 0.0 if t is None else t.deficit

    def counters(self, tenant: str) -> Tuple[float, float, float]:
        """(refilled, charged, forfeited) — the conservation observables."""
        t = self._tenants.get(tenant)
        return ((0.0, 0.0, 0.0) if t is None
                else (t.refilled, t.charged, t.forfeited))

    def items(self, tenant: str) -> List:
        t = self._tenants.get(tenant)
        return [] if t is None else list(t.queue)

    # ---- the DRR tick ------------------------------------------------------

    def _settle(self, t: _Tenant) -> None:
        """Queue drained: forfeit banked deficit (classic DRR)."""
        if not t.queue and t.deficit:
            t.forfeited += t.deficit
            t.deficit = 0.0

    def tick(self, cost: Callable[[object], float],
             offer: Callable[[str, object], str],
             refill: bool = True) -> List[Tuple[str, object]]:
        """One DRR round.  ``cost(item)`` prices an item in tokens;
        ``offer(tenant, item)`` decides its fate (ADMITTED / REJECTED /
        BLOCKED / STALL).  Returns the ``(tenant, item)`` pairs admitted
        this round, in admission order."""
        admitted: List[Tuple[str, object]] = []
        names = self.backlogged()
        if not names:
            return admitted
        if refill:
            for name in names:
                t = self._tenants[name]
                add = min(self.quantum, self.cap - t.deficit)
                t.deficit += add
                t.refilled += add
        stalled = False
        for name in names:
            t = self._tenants[name]
            while t.queue:
                item = t.queue[0]
                c = float(cost(item))
                # an oversized item (c > cap) can never be covered by
                # banked deficit — gate it on quota *saturation* instead,
                # so it still reaches the controller (admit/reject there)
                # rather than head-of-line blocking its tenant forever
                if min(c, self.cap) > t.deficit:
                    break  # quota exhausted: bank and wait for refills
                verdict = offer(name, item)
                if verdict == ADMITTED:
                    t.queue.popleft()
                    charge = min(c, t.deficit)  # oversized: drain the bank
                    t.deficit -= charge
                    t.charged += charge
                    admitted.append((name, item))
                elif verdict == REJECTED:
                    t.queue.popleft()
                elif verdict == BLOCKED:
                    break
                elif verdict == STALL:
                    stalled = True
                    break
                else:
                    raise ValueError(f"unknown offer verdict {verdict!r}")
            self._settle(t)
            if stalled:
                break
        # rotate: next tick starts the visit after this tick's first tenant
        if names:
            first = names[0]
            idx = self._order.index(first)
            self._order = self._order[idx + 1:] + self._order[:idx + 1]
        return admitted


class SingleQueue:
    """Degenerate fair queue for ``admission="fcfs"``: one global FIFO,
    tenant-blind, quota-free — the baseline the goodput bench compares
    DRR+SLO admission against.  Implements the `DeficitRoundRobin` surface
    the frontend core uses."""

    def __init__(self, max_queue: int = 0):
        self.max_queue = int(max_queue)
        self._queue: deque = deque()

    def push(self, tenant: str, item) -> bool:
        if self.max_queue and len(self._queue) >= self.max_queue:
            return False
        self._queue.append((tenant, item))
        return True

    def remove(self, tenant: str, item) -> bool:
        if (tenant, item) in self._queue:
            self._queue.remove((tenant, item))
            return True
        return False

    def __len__(self) -> int:
        return len(self._queue)

    def backlog(self, tenant: str) -> int:
        return sum(1 for t, _ in self._queue if t == tenant)

    def backlogged(self) -> List[str]:
        seen, out = set(), []
        for t, _ in self._queue:
            if t not in seen:
                seen.add(t)
                out.append(t)
        return out

    def deficit(self, tenant: str) -> float:
        return 0.0

    def counters(self, tenant: str) -> Tuple[float, float, float]:
        return (0.0, 0.0, 0.0)

    def items(self, tenant: Optional[str] = None) -> List:
        return [i for t, i in self._queue if tenant is None or t == tenant]

    def tick(self, cost, offer, refill: bool = True):
        admitted = []
        while self._queue:
            tenant, item = self._queue[0]
            verdict = offer(tenant, item)
            if verdict == ADMITTED:
                self._queue.popleft()
                admitted.append((tenant, item))
            elif verdict == REJECTED:
                self._queue.popleft()
            else:  # BLOCKED / STALL: strict FCFS head-of-line blocks
                break
        return admitted
