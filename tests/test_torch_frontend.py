"""The port's multi-tenant front end (`repro_torch.frontend`) against the JAX
package's, on the CPU.

minitron-8b smoke in fp32, the reference's weights carried across with
`repro_torch.interop`.  Covered here:

- the reference's own cases (`tests/test_frontend.py`), run on the port:
  DRR starvation-freedom and token conservation, the oversized-item path,
  the backlog bound, the FCFS queue, the SLO decision table on stub
  schedulers, cancellation conserving the paged pool, and the synchronous
  pump end to end (drain, backlog bound, cancel, quota calibration,
  priority clamping, the ``pending`` charge);
- DRR and `SingleQueue` parity: the same push / remove / tick sequences
  give the same admitted order, deficits and counters in both packages;
- `AdmissionController` / `FCFSController` parity on stub scheduler states;
- `run_frontend_trace` under ``"slo"`` and ``"fcfs"`` on the slot backend
  (an admission token budget, so requests degrade) and the paged backend
  (a pool too small for some full asks), a fig10-shaped bursty
  three-tenant trace, tick by tick next to the JAX engine: every
  admission decision, the admitted ``(tenant, req_id)``, reject reasons,
  degradations, preemptions, finished order, tokens, the per-tenant
  counters and the step-based fields of ``summary()``;
- `synthesize_requests` with a tenant mix, with and without templates,
  bitwise; `Scheduler.preempt_lower_priority` choosing the reference's
  victim; `Request.deadline_exceeded` at injected times.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import Engine as JEngine
from repro.api import EngineConfig as JEngineConfig
from repro.api import PagingConfig as JPaging
from repro.api import PlannerConfig as JPlanner
from repro.api import SchedulerConfig as JScheduler
from repro.api import synthesize_requests as jsynth
from repro.frontend import AdmissionController as JAdmission
from repro.frontend import DeficitRoundRobin as JDRR
from repro.frontend import FCFSController as JFCFS
from repro.frontend import FrontendConfig as JFrontendConfig
from repro.frontend import FrontendScheduler as JFrontendScheduler
from repro.frontend import PriorityClass as JClass
from repro.frontend import SingleQueue as JSingleQueue
from repro.frontend import run_frontend_trace as jrun_trace
from repro.serving.request import Request as JRequest
from repro_torch import interop
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, SchedulerConfig, synthesize_requests)
from repro_torch.frontend import (AdmissionController, DeficitRoundRobin, FCFSController,
                                  FrontendConfig, FrontendScheduler, PriorityClass,
                                  SingleQueue, run_frontend_trace)
from repro_torch.frontend import queues as q
from repro_torch.frontend.admission import ADMIT, DEGRADE, QUEUE, REJECT
from repro_torch.serving.request import Request, RequestState
from tests._hypothesis_compat import given, settings, st

torch.set_num_threads(2)

ARCH = "minitron-8b"
TENANT_MIX = {"interactive": 1.0, "standard": 1.0, "batch": 3.0}
TENANT_PRIO = {"interactive": 0, "standard": 1, "batch": 2}
# fig10's classes (benchmarks/fig10_goodput.py), as dicts for both packages
FIG10_CLASSES = (
    dict(name="interactive", priority=0, ttft_slo_steps=24, shed_after_steps=28,
         preempt_below=True),
    dict(name="standard", priority=1, ttft_slo_steps=48, shed_after_steps=52),
    dict(name="batch", priority=2, ttft_slo_steps=110, degrade_floor=4),
)


def configs(backend="slot", rows=2, n_blocks=0, block_size=8, **sched_kw):
    """(JAX config, port config): the reference's `tests/test_frontend.py`
    `_cfg`, the same in both packages."""
    scfg = dict(max_rows=rows, enable_replan=False)
    scfg.update(sched_kw)
    comp = dict(policy="ada_snapkv", budget=12, alpha_max=2.0, obs_window=8, sink=2,
                decode_margin=8)
    common = dict(n_shards=4, max_seq_len=64, cache_backend=backend)
    j = JEngineConfig.smoke(
        ARCH, compression=JCompression(**comp),
        planner=JPlanner(mode="fairkv_dp", extra_copies=4, batch_cap=rows),
        scheduler=JScheduler(**scfg), paging=JPaging(block_size=block_size, n_blocks=n_blocks),
        **common)
    t = EngineConfig.smoke(
        ARCH, device="cpu", compression=CompressionConfig(**comp),
        planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=rows),
        scheduler=SchedulerConfig(**scfg),
        paging=PagingConfig(block_size=block_size, n_blocks=n_blocks), **common)
    return j, t


_PARAMS: dict = {}


def shared_params():
    """One weight set for every engine of the module: the reference's
    params and their torch copy."""
    if not _PARAMS:
        jparams = JEngine.build(configs()[0]).params
        _PARAMS["p"] = (jparams, interop.to_torch(jax.tree.map(np.asarray, jparams)))
    return _PARAMS["p"]


def port_engine(backend="slot", **kw):
    return Engine.build(configs(backend, **kw)[1], params=shared_params()[1])


# ---------------------------------------------------------------------------
# the reference's DRR and FCFS-queue cases, on the port (no engine)
# ---------------------------------------------------------------------------


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 32), st.integers(1, 4),
       st.lists(st.integers(1, 50), min_size=1, max_size=6),
       st.integers(2, 30))
def test_drr_never_starves_backlogged_tenant(quantum, cap_mult, victim_costs, n_aggressor):
    cap = quantum * cap_mult
    drr = DeficitRoundRobin(quantum, cap)
    victim_costs = [min(c, cap) for c in victim_costs]
    for i, c in enumerate(victim_costs):
        drr.push("victim", ("v", i, c))
    for i in range(n_aggressor):
        drr.push("aggressor", ("a", i, 1))
    ticks_waited = 0
    while drr.backlog("victim"):
        head = drr.items("victim")[0]
        admitted = drr.tick(lambda item: item[2], lambda t, item: q.ADMITTED)
        ticks_waited += 1
        if any(i == head for _, i in admitted):
            assert ticks_waited <= math.ceil(head[2] / quantum)
            ticks_waited = 0
        drr.push("aggressor", ("a", 10_000 + ticks_waited, 1))
        assert ticks_waited <= math.ceil(cap / quantum) + 1, "starved"


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 24), st.integers(1, 4),
       st.lists(st.integers(1, 60), min_size=1, max_size=10),
       st.integers(0, 2**31 - 1))
def test_drr_token_conservation(quantum, cap_mult, costs, seed):
    cap = quantum * cap_mult
    drr = DeficitRoundRobin(quantum, cap)
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c"]
    for i, c in enumerate(costs):
        drr.push(tenants[i % len(tenants)], (i, c))
    verdicts = (q.ADMITTED, q.REJECTED, q.BLOCKED, q.STALL)
    for tick in range(12):
        drr.tick(lambda item: item[1],
                 lambda tenant, item: verdicts[int(rng.integers(len(verdicts)))])
        if tick == 4:
            drr.push(tenants[tick % len(tenants)], (1000 + tick, quantum))
        for t in tenants:
            refilled, charged, forfeited = drr.counters(t)
            assert drr.deficit(t) == pytest.approx(refilled - charged - forfeited)
            assert 0.0 <= drr.deficit(t) <= cap + 1e-9


def test_drr_oversized_item_reaches_controller():
    drr = DeficitRoundRobin(4, 8)
    drr.push("t", ("big", 100))
    drr.push("t", ("small", 2))
    offered, admitted = [], []
    for _ in range(math.ceil(8 / 4) + 1):
        admitted += drr.tick(lambda item: item[1],
                             lambda t, item: (offered.append(item), q.ADMITTED)[1])
    assert ("big", 100) in offered
    assert [i for _, i in admitted] == [("big", 100), ("small", 2)]
    refilled, charged, forfeited = drr.counters("t")
    assert drr.deficit("t") == pytest.approx(refilled - charged - forfeited)
    assert 0.0 <= drr.deficit("t") <= 8.0


def test_drr_validates_config():
    with pytest.raises(ValueError, match="quantum"):
        DeficitRoundRobin(0, 10)
    with pytest.raises(ValueError, match="cap"):
        DeficitRoundRobin(16, 8)


def test_drr_backlog_bound_and_remove():
    drr = DeficitRoundRobin(4, 8, max_queue_per_tenant=2)
    assert drr.push("t", "x") and drr.push("t", "y")
    assert not drr.push("t", "z")
    assert drr.remove("t", "x")
    assert not drr.remove("t", "x")
    assert drr.items("t") == ["y"]


def test_single_queue_is_strict_fcfs():
    sq = SingleQueue()
    for i, tenant in enumerate(["a", "b", "a", "c"]):
        sq.push(tenant, i)
    admitted = sq.tick(lambda i: 1.0, lambda t, i: q.ADMITTED if i < 2 else q.BLOCKED)
    assert [i for _, i in admitted] == [0, 1]
    assert sq.items() == [2, 3]
    assert sq.deficit("a") == 0.0


# ---------------------------------------------------------------------------
# queue parity: the same operation sequence through both packages
# ---------------------------------------------------------------------------


def _queue_ops(rng, n_ops=40):
    """A seeded sequence of push / remove / tick operations over three
    tenants; a tick carries the verdicts its offers get, in order."""
    verdicts = (q.ADMITTED, q.REJECTED, q.BLOCKED, q.STALL)
    ops, n_items = [], 0
    for _ in range(n_ops):
        kind = rng.choice(["push", "push", "remove", "tick"])
        tenant = "abc"[int(rng.integers(3))]
        if kind == "push":
            ops.append(("push", tenant, (n_items, int(rng.integers(1, 80)))))
            n_items += 1
        elif kind == "remove":
            ops.append(("remove", tenant, int(rng.integers(max(1, n_items)))))
        else:
            ops.append(("tick", [verdicts[int(v)] for v in rng.integers(0, 4, size=64)],
                        bool(rng.integers(4))))
    return ops


def _observe(qu):
    return {t: (qu.backlog(t), qu.deficit(t), qu.counters(t), qu.items(t))
            for t in "abc"} | {"len": len(qu), "backlogged": qu.backlogged()}


def _apply(qu, op):
    if op[0] == "push":
        return qu.push(op[1], op[2])
    if op[0] == "remove":
        item = next((i for i in qu.items(op[1]) if i[0] == op[2]), None)
        return qu.remove(op[1], item) if item is not None else None
    verdicts = iter(op[1])
    return qu.tick(lambda item: item[1], lambda tenant, item: next(verdicts), refill=op[2])


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 24), st.integers(1, 4), st.integers(0, 6),
       st.integers(0, 2**31 - 1))
def test_queues_match_reference(quantum, cap_mult, backlog, seed):
    """DRR (and the FCFS `SingleQueue`) through the same push / remove /
    tick sequence in both packages: equal return values (the admitted
    order), backlogs, deficits, counters and visit order after every op."""
    cap = quantum * cap_mult
    ops = _queue_ops(np.random.default_rng(seed))
    pairs = ((JDRR(quantum, cap, backlog), DeficitRoundRobin(quantum, cap, backlog)),
             (JSingleQueue(backlog), SingleQueue(backlog)))
    for jq, tq in pairs:
        for op in ops:
            assert _apply(tq, op) == _apply(jq, op), op
            assert _observe(tq) == _observe(jq), op


# ---------------------------------------------------------------------------
# the reference's admission cases (stub scheduler), on the port
# ---------------------------------------------------------------------------


class _StubBackend:
    def __init__(self, never=None, fits_upto=10_000):
        self.never = never
        self.fits_upto = fits_upto

    def never_fits(self, req):
        return self.never

    def admissible(self, state, req, pending=()):
        return req.max_new_tokens <= self.fits_upto

    def request_cost(self, req):
        return req.prompt_len + req.max_new_tokens


class _StubSched:
    def __init__(self, free=1, step_idx=0, backend=None):
        self.freelist = list(range(free))
        self.step_idx = step_idx
        self.backend = backend if backend is not None else _StubBackend()
        self.state = None


def _req(priority=1, arrival=0, gen=16, deadline_s=None, arrival_time=None, cls=Request):
    return cls(req_id=0, prompt=np.zeros(4, np.int32), arrival_step=arrival,
               max_new_tokens=gen, priority=priority, deadline_s=deadline_s,
               arrival_time=arrival_time)


def test_admission_admit_when_fits():
    assert AdmissionController(FrontendConfig()).decide(_StubSched(), _req()).action == ADMIT


def test_admission_queue_blocks_globally_when_no_row():
    d = AdmissionController(FrontendConfig()).decide(_StubSched(free=0), _req())
    assert d.action == QUEUE and d.global_block and not d.preempt


def test_admission_preempt_arms_for_urgent_class():
    cfg = FrontendConfig()
    cls = cfg.class_for(0)
    assert cls.preempt_below
    d = AdmissionController(cfg).decide(
        _StubSched(free=0, step_idx=cls.ttft_slo_steps // 2), _req(priority=0))
    assert d.action == QUEUE and d.preempt
    young = AdmissionController(cfg).decide(_StubSched(free=0), _req(priority=0))
    assert not young.preempt


def test_admission_sheds_blown_slo():
    cfg = FrontendConfig()
    waited = cfg.class_for(0).shed_after_steps + 1
    d = AdmissionController(cfg).decide(_StubSched(step_idx=waited), _req(priority=0))
    assert d.action == REJECT and d.reason == "slo_blown"


def test_admission_rejects_exceeded_deadline():
    d = AdmissionController(FrontendConfig()).decide(
        _StubSched(), _req(deadline_s=0.0, arrival_time=0.0))
    assert d.action == REJECT and d.reason == "deadline_exceeded"


def test_admission_degrades_under_pressure_to_largest_fit():
    cfg = FrontendConfig()
    cls = cfg.class_for(2)
    assert cls.degrade_floor == 4
    sched = _StubSched(backend=_StubBackend(fits_upto=6), step_idx=cls.ttft_slo_steps // 2)
    d = AdmissionController(cfg).decide(sched, _req(priority=2, gen=16))
    assert d.action == DEGRADE and d.degrade_to == 6
    young = AdmissionController(cfg).decide(
        _StubSched(backend=_StubBackend(fits_upto=6)), _req(priority=2))
    assert young.action == QUEUE


def test_admission_never_fits_degrades_or_rejects():
    cfg = FrontendConfig()
    sched = _StubSched(backend=_StubBackend(never="too long"))
    d = AdmissionController(cfg).decide(sched, _req(priority=1))
    assert d.action == REJECT and "never_fits" in d.reason
    assert AdmissionController(cfg).decide(sched, _req(priority=2)).action == REJECT


def test_fcfs_controller_is_naive():
    c = FCFSController(FrontendConfig(admission="fcfs"))
    assert c.decide(_StubSched(), _req()).action == ADMIT
    d = c.decide(_StubSched(free=0), _req())
    assert d.action == QUEUE and d.global_block
    assert c.decide(_StubSched(backend=_StubBackend(never="x")), _req()).action == REJECT


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2), st.integers(0, 120), st.integers(0, 40), st.booleans(),
       st.integers(0, 2), st.integers(1, 40), st.integers(0, 60), st.booleans(),
       st.sampled_from(["slo", "fcfs"]))
def test_admission_decisions_match_reference(free, step_idx, fits_upto, never, priority,
                                             gen, arrival, late, admission):
    """Both packages' controllers give the same `Decision` (action, reason,
    degrade_to, preempt, global_block) on the same stub scheduler state."""
    sched = _StubSched(free=free, step_idx=step_idx,
                       backend=_StubBackend(never="too long" if never else None,
                                            fits_upto=fits_upto))
    deadline = dict(deadline_s=1.0, arrival_time=0.0) if late else {}
    t_ctl = (AdmissionController if admission == "slo" else FCFSController)(
        FrontendConfig(admission=admission))
    j_ctl = (JAdmission if admission == "slo" else JFCFS)(JFrontendConfig(admission=admission))
    td = t_ctl.decide(sched, _req(priority, arrival, gen, cls=Request, **deadline))
    jd = j_ctl.decide(sched, _req(priority, arrival, gen, cls=JRequest, **deadline))
    assert (td.action, td.reason, td.degrade_to, td.preempt, td.global_block) == (
        jd.action, jd.reason, jd.degrade_to, jd.preempt, jd.global_block)


# ---------------------------------------------------------------------------
# the reference's engine-level cases, on the port
# ---------------------------------------------------------------------------


def test_cancel_returns_blocks_to_pool():
    eng = port_engine("paged", rows=2)
    vocab = eng.cfg.model.vocab_size
    reqs = synthesize_requests(3, 5.0, vocab, min_prompt=12, max_prompt=20,
                               max_new_tokens=6, seed=3)
    for r in reqs:
        eng.submit(r)
    sched = eng.scheduler
    while not sched.active:
        eng.step()
    victim_id = next(iter(sched.active.values())).req_id
    pool = sched.backend.pool
    in_use_before = pool.blocks_in_use()
    assert in_use_before > 0
    assert eng.cancel(victim_id)
    assert pool.blocks_in_use() < in_use_before
    pool.check_invariants()
    victim = next(r for r in sched.finished if r.req_id == victim_id)
    assert victim.state is RequestState.CANCELLED
    assert not eng.cancel(victim_id)
    assert not eng.cancel(10_000)
    extra = synthesize_requests(1, 5.0, vocab, min_prompt=12, max_prompt=20,
                                max_new_tokens=6, seed=9)[0]
    extra.req_id = 50
    eng.submit(extra)
    for _ in range(200):
        if len(sched.finished) == 4:
            break
        eng.step()
    assert len(sched.finished) == 4
    assert all(r.is_finished for r in sched.finished)
    assert pool.blocks_in_use() == 0
    pool.check_invariants()
    assert sched.n_cancellations == 1


def _frontend(eng, **fe_kw):
    fe_kw.setdefault("quantum_tokens", 64)
    fe_kw.setdefault("quota_cap_tokens", 512)
    return FrontendScheduler(eng._ensure_scheduler(), FrontendConfig(**fe_kw))


def _tenant_trace(vocab, n=8, gen=4, seed=11, synth=synthesize_requests):
    return synth(n, 2.0, vocab, min_prompt=8, max_prompt=16, max_new_tokens=gen, seed=seed,
                 tenant_mix={"fast": 1.0, "slow": 1.0},
                 tenant_priorities={"fast": 0, "slow": 2})


def test_frontend_trace_slo_mode():
    eng = port_engine()
    fe = _frontend(eng)
    out = run_frontend_trace(fe, _tenant_trace(eng.cfg.model.vocab_size), max_steps=400)
    assert out["converged"] and out["finished"] == out["total"]
    assert out["admission"] == "slo"
    assert out["generated_tokens"] >= out["goodput_tokens"] > 0
    assert set(out["tenants"]) == {"fast", "slow"}
    assert out["slo_attained"] + out["slo_missed"] == out["total"]
    prom = eng.metrics_prometheus()
    for family in ("slo_attained_total", "slo_missed_total", "goodput_tokens_total",
                   "frontend_admission_total"):
        assert f"{family}{{" in prom, family
    assert 'tenant="fast"' in prom


def test_frontend_drain_sheds_queued_finishes_live():
    eng = port_engine()
    fe = _frontend(eng)
    vocab = eng.cfg.model.vocab_size
    reqs = _tenant_trace(vocab, n=6, seed=13)
    for r in reqs:
        r.arrival_step = 0
        fe.submit(r)
    fe.pump()
    live = len(fe.sched.active)
    assert live > 0 and len(fe.queue) > 0
    fe.drain()
    assert len(fe.queue) == 0
    for _ in range(200):
        if fe.idle:
            break
        fe.pump()
    assert fe.idle
    assert len(fe.finished) == len(reqs)
    shed = [r for r in fe.finished if fe.reject_reasons.get(r.req_id)]
    assert all(fe.reject_reasons[r.req_id] == "draining" for r in shed)
    done = [r for r in fe.finished if r.state is RequestState.FINISHED]
    assert len(done) == live
    late = _tenant_trace(vocab, n=1, seed=17)[0]
    late.req_id = 99
    assert not fe.submit(late)
    assert fe.reject_reasons[99] == "draining"


def test_frontend_backlog_bound_and_cancel():
    eng = port_engine()
    fe = _frontend(eng, max_queue_per_tenant=1, quantum_tokens=128)
    reqs = _tenant_trace(eng.cfg.model.vocab_size, n=4, seed=19)
    for i, r in enumerate(reqs):
        r.req_id = i
        r.tenant, r.priority = "fast", 0
    fe.submit(reqs[0])
    fe.pump()
    fe.submit(reqs[1])
    fe.pump()
    assert len(fe.sched.active) == 2
    assert fe.submit(reqs[2])
    assert not fe.submit(reqs[3])
    assert fe.reject_reasons[3] == "tenant_backlog_full"
    assert fe.cancel(2)
    assert fe.reject_reasons[2] == "cancelled"
    assert len(fe.queue) == 0
    assert fe.cancel(2) is False


def test_frontend_serves_requests_costing_more_than_quota_cap():
    eng = port_engine()
    fe = _frontend(eng, quantum_tokens=1, quota_cap_tokens=1)
    vocab = eng.cfg.model.vocab_size
    assert all(fe.sched.backend.request_cost(r) > fe.queue.cap
               for r in _tenant_trace(vocab, n=4, seed=23))
    out = run_frontend_trace(fe, _tenant_trace(vocab, n=4, seed=23), max_steps=400)
    assert out["converged"] and out["finished"] == out["total"]


def test_frontend_quota_calibrated_to_backend_units():
    eng = port_engine()
    fe = _frontend(eng)
    req = _tenant_trace(eng.cfg.model.vocab_size, n=1)[0]
    assert fe.sched.backend.request_cost(req) <= fe.queue.cap


def test_frontend_submit_clamps_priority_to_configured_classes():
    eng = port_engine()
    fe = _frontend(eng)
    lo = _tenant_trace(eng.cfg.model.vocab_size, n=2, seed=29)
    lo[0].priority, lo[1].priority = -5, 99
    for r in lo:
        fe.submit(r)
    assert lo[0].priority == 0
    assert lo[1].priority == 2


def test_backend_admissible_charges_pending():
    eng = port_engine()
    sched = eng._ensure_scheduler()
    b = sched.backend
    req = Request(req_id=0, prompt=np.zeros(16, np.int32), max_new_tokens=4)
    old = b.max_live_tokens
    try:
        b.max_live_tokens = int(b.request_cost(req) * 1.5)
        assert b.admissible(sched.state, req)
        assert not b.admissible(sched.state, req, pending=[req])
    finally:
        b.max_live_tokens = old


# ---------------------------------------------------------------------------
# run_frontend_trace tick by tick next to the reference
# ---------------------------------------------------------------------------

# (backend, engine knobs): the slot backend under an admission token budget
# (the full ask of a second request does not fit, a shorter one may:
# degradation under pressure), and paged pools one block short of some
# requests' worst case (never_fits at the full ask: degradation to the
# floor, or rejection)
TRACE_CASES = {"slot": dict(max_live_tokens=150), "paged": dict(n_blocks=9)}
N_TRACE, BURST, GAP, GEN = 24, 12, 10, 12


def _bursty(synth, vocab):
    """fig10's trace shape at smoke size: three tenants, batch 3x the
    others, bursts of 12 (6x the rows) every 10 steps."""
    reqs = synth(N_TRACE, 1.0, vocab, min_prompt=8, max_prompt=16, max_new_tokens=GEN,
                 seed=7, tenant_mix=TENANT_MIX, tenant_priorities=TENANT_PRIO)
    for i, r in enumerate(reqs):
        r.arrival_step = (i // BURST) * GAP
    return reqs


def _record(fe, reqs):
    """Wrap ``fe.pump`` and ``fe.controller.decide`` to log, per tick, what
    must match the reference."""
    ticks, decisions = [], []
    pump, decide = fe.pump, fe.controller.decide

    def logged_decide(sched, req, pending=()):
        d = decide(sched, req, pending)
        decisions.append((sched.step_idx, req.req_id, d.action, d.reason, d.degrade_to,
                          d.preempt, d.global_block))
        return d

    def logged_pump():
        n_fin = len(fe.finished)
        ev = pump()
        ticks.append(dict(
            step=ev["step"], admitted=ev["frontend_admitted"], queued=ev["frontend_queued"],
            engine_admitted=ev["admitted"], finished=ev["finished"],
            preempted=ev["preempted"],
            terminal=[(r.req_id, r.state.value, fe.reject_reasons.get(r.req_id))
                      for r in fe.finished[n_fin:]],
            degraded=[(r.req_id, r.degraded_from, r.max_new_tokens) for r in reqs
                      if r.degraded_from is not None],
            active=sorted(fe.sched.active),
            deficits={t: fe.queue.deficit(t) for t in TENANT_MIX}))
        return ev

    fe.pump = logged_pump
    fe.controller.decide = logged_decide
    return ticks, decisions


_STEP_FIELDS = ("admission", "steps", "finished", "rejected", "generated_tokens",
                "goodput_tokens", "goodput_tokens_per_step", "slo_attained", "slo_missed",
                "slo_attainment", "preemptions", "total", "converged")
_TENANT_FIELDS = ("attained", "missed", "attainment", "goodput_tokens", "tokens",
                  "p50_ttft_steps", "p99_ttft_steps")
_FAMILIES = ("frontend_admission_total", "frontend_rejections_total", "slo_attained_total",
             "slo_missed_total", "goodput_tokens_total", "tokens_total",
             "frontend_ttft_steps", "frontend_queue_depth", "frontend_quota_deficit_tokens")


@pytest.mark.parametrize("admission", ["slo", "fcfs"])
@pytest.mark.parametrize("backend", sorted(TRACE_CASES))
def test_frontend_trace_matches_reference(backend, admission):
    jparams, tparams = shared_params()
    jcfg, tcfg = configs(backend, **TRACE_CASES[backend])
    je, te = JEngine.build(jcfg, params=jparams), Engine.build(tcfg, params=tparams)
    jfe = JFrontendScheduler(je._ensure_scheduler(), JFrontendConfig(
        admission=admission, classes=tuple(JClass(**c) for c in FIG10_CLASSES),
        quantum_tokens=64, quota_cap_tokens=512))
    tfe = FrontendScheduler(te._ensure_scheduler(), FrontendConfig(
        admission=admission, classes=tuple(PriorityClass(**c) for c in FIG10_CLASSES),
        quantum_tokens=64, quota_cap_tokens=512))
    assert type(tfe.queue).__name__ == type(jfe.queue).__name__
    assert vars(tfe.queue).get("quantum") == vars(jfe.queue).get("quantum")
    assert vars(tfe.queue).get("cap") == vars(jfe.queue).get("cap")
    vocab = tcfg.model.vocab_size
    jreqs, treqs = _bursty(jsynth, vocab), _bursty(synthesize_requests, vocab)
    jlog, tlog = _record(jfe, jreqs), _record(tfe, treqs)
    jout = jrun_trace(jfe, jreqs, max_steps=600)
    tout = run_frontend_trace(tfe, treqs, max_steps=600)
    jticks, jdec = jlog
    tticks, tdec = tlog
    assert len(tticks) == len(jticks)
    for a, b in zip(tticks, jticks):
        assert a == b, (a, b)
    assert tdec == jdec
    assert [r.req_id for r in tfe.finished] == [r.req_id for r in jfe.finished]
    assert tfe.reject_reasons == jfe.reject_reasons
    assert [list(r.generated) for r in treqs] == [list(r.generated) for r in jreqs]
    assert [r.ttft_steps() for r in treqs] == [r.ttft_steps() for r in jreqs]
    assert {k: tout[k] for k in _STEP_FIELDS} == {k: jout[k] for k in _STEP_FIELDS}
    assert set(tout["tenants"]) == set(jout["tenants"])
    for tenant in jout["tenants"]:
        assert ({k: tout["tenants"][tenant][k] for k in _TENANT_FIELDS}
                == {k: jout["tenants"][tenant][k] for k in _TENANT_FIELDS}), tenant
    tm, jm = te.metrics(), je.metrics()
    for fam in _FAMILIES:
        assert tm.get(fam) == jm.get(fam), fam
    assert tout["converged"]
    # the trace exercises the levers it is here for
    if admission == "slo":
        assert tout["rejected"] > 0 and tout["preemptions"] > 0
        assert any(r.degraded_from is not None for r in treqs)
    if backend == "paged":
        pool = te.scheduler.backend.pool
        pool.check_invariants()
        assert pool.blocks_in_use() == 0


# ---------------------------------------------------------------------------
# requests and the scheduler's priority lever
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(tenant_mix=TENANT_MIX, tenant_priorities=TENANT_PRIO),
    dict(tenant_mix={"a": 2.0, "b": 0.5, "c": 1.0}, tenant_priorities={"b": 0}),
    dict(tenant_mix=TENANT_MIX, tenant_priorities=TENANT_PRIO, prefix_templates=2,
         prefix_len=6, shared_fraction=0.6),
    dict(tenant_mix={"x": 1.0}, prefix_templates=3, prefix_len=4, shared_fraction=1.0),
], ids=["mix", "partial-priorities", "mix-templates", "one-tenant-templates"])
def test_synthesize_requests_tenant_mix_bitwise(kw):
    """Arrivals, prompts (bytes), tenants, priorities equal the reference's."""
    jr = jsynth(40, 0.7, 500, min_prompt=8, max_prompt=20, max_new_tokens=5, seed=5, **kw)
    tr = synthesize_requests(40, 0.7, 500, min_prompt=8, max_prompt=20, max_new_tokens=5,
                             seed=5, **kw)
    assert [(r.arrival_step, r.tenant, r.priority, r.max_new_tokens, r.deadline_s)
            for r in tr] == [(r.arrival_step, r.tenant, r.priority, r.max_new_tokens,
                              r.deadline_s) for r in jr]
    for a, b in zip(tr, jr):
        assert a.prompt.dtype == b.prompt.dtype and a.prompt.tobytes() == b.prompt.tobytes()
    # without a mix the trace is the one the seed always gave
    plain = synthesize_requests(40, 0.7, 500, min_prompt=8, max_prompt=20, seed=5)
    assert all(r.tenant == "default" and r.priority == 1 for r in plain)
    with pytest.raises(ValueError, match="tenant_mix"):
        synthesize_requests(3, 1.0, 50, tenant_mix={"a": -1.0})


def test_preempt_lower_priority_matches_reference():
    """Three live rows of classes 2 / 1 / 2: `preempt_lower_priority(0)`
    evicts the least urgent, youngest one in both packages (same victim,
    queue and rows); nothing is less urgent than class 2; the rest of the
    run gives the same tokens."""
    jparams, tparams = shared_params()
    jcfg, tcfg = configs("paged", rows=3)
    je, te = JEngine.build(jcfg, params=jparams), Engine.build(tcfg, params=tparams)
    vocab = tcfg.model.vocab_size

    def reqs(cls):
        rng = np.random.default_rng(31)
        return [cls(req_id=i, prompt=rng.integers(0, vocab, size=10 + i).astype(np.int32),
                    max_new_tokens=8, priority=p, tenant=f"t{p}")
                for i, p in enumerate((2, 1, 2))]

    out = {}
    for name, eng, cls in (("jax", je, JRequest), ("torch", te, Request)):
        rs = reqs(cls)
        for r in rs:
            eng.submit(r)
        sched = eng._ensure_scheduler()
        while len(sched.active) < 3:
            eng.step()
        eng.step()
        hit = sched.preempt_lower_priority(0)
        victim = [r.req_id for r in rs if r.n_preemptions]
        queue = [r.req_id for r in sched.queue]
        none_left = sched.preempt_lower_priority(2)
        while len(sched.finished) < 3:
            eng.step()
        out[name] = (hit, victim, queue, none_left, sched.n_preemptions,
                     [list(r.generated) for r in rs], sched.freelist.in_use)
    assert out["torch"] == out["jax"]
    assert out["torch"][:4] == (True, [2], [2], False)


def test_scheduler_live_tokens_and_cost():
    """`Scheduler.live_tokens` and `_estimated_cost` equal the reference's
    mid-trace."""
    jparams, tparams = shared_params()
    jcfg, tcfg = configs("slot", rows=2)
    je, te = JEngine.build(jcfg, params=jparams), Engine.build(tcfg, params=tparams)
    vocab = tcfg.model.vocab_size
    seen = []
    for eng, synth in ((je, jsynth), (te, synthesize_requests)):
        rs = synth(3, 2.0, vocab, min_prompt=8, max_prompt=16, max_new_tokens=4, seed=3)
        for r in rs:
            eng.submit(r)
        sched = eng._ensure_scheduler()
        costs = [sched._estimated_cost(r) for r in rs]
        eng.step()
        eng.step()
        seen.append((sched.live_tokens(), costs, sched.freelist.in_use))
    assert seen[1] == seen[0]
    assert seen[1][0] > 0


def test_deadline_exceeded_at_injected_times():
    for dl, arrival, now in ((None, 0.0, 1e9), (1.0, None, 5.0), (1.0, 10.0, 10.5),
                             (1.0, 10.0, 11.0), (1.0, 10.0, 11.0001), (0.0, 3.0, 3.0),
                             (0.0, 3.0, 3.25)):
        t = Request(req_id=0, prompt=np.zeros(2, np.int32), deadline_s=dl, arrival_time=arrival)
        j = JRequest(req_id=0, prompt=np.zeros(2, np.int32), deadline_s=dl,
                     arrival_time=arrival)
        assert t.deadline_exceeded(now=now) == j.deadline_exceeded(now=now), (dl, arrival, now)
    r = Request(req_id=0, prompt=np.zeros(2, np.int32), deadline_s=2.0, arrival_time=100.0)
    assert not r.deadline_exceeded(now=101.0) and r.deadline_exceeded(now=102.5)
    assert r.deadline_exceeded()  # the clock is far past 102


# ---------------------------------------------------------------------------
# ROADMAP C.8: faults of the reference's front end the port repairs
# ---------------------------------------------------------------------------


def _package(package, jcfg, tcfg):
    """(engine, FrontendScheduler, FrontendConfig, Request) of one package."""
    jparams, tparams = shared_params()
    if package == "port":
        return (Engine.build(tcfg, params=tparams), FrontendScheduler, FrontendConfig,
                Request)
    return JEngine.build(jcfg, params=jparams), JFrontendScheduler, JFrontendConfig, JRequest


@pytest.mark.parametrize("package", ["port", "reference"])
def test_drain_with_a_preemption_victim_queued(package):
    """Two batch rows live, an interactive request preempts one: the victim
    waits in the engine's own queue.  A drain then never ends in the
    reference (a draining scheduler admits nothing, and `drain` sheds only
    the tenant queues); the port sheds the victim too (``draining``) and
    the live rows decode to the end."""
    eng, FS, FC, R = _package(package, *configs("slot", rows=2))
    fe = FS(eng._ensure_scheduler(), FC(quantum_tokens=64, quota_cap_tokens=512))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 250, size=10 + i).astype(np.int32) for i in range(3)]
    for i in range(2):
        fe.submit(R(req_id=i, prompt=prompts[i], max_new_tokens=30, tenant="bulk", priority=2))
    fe.pump()
    fe.submit(R(req_id=2, prompt=prompts[2], max_new_tokens=4, tenant="chat", priority=0))
    for _ in range(20):
        fe.pump()
        if fe.sched.n_preemptions:
            break
    assert fe.sched.n_preemptions == 1 and [r.req_id for r in fe.sched.queue] == [1]
    fe.drain()
    for _ in range(100):
        if fe.idle:
            break
        fe.pump()
    victim = fe.sched.queue[0] if fe.sched.queue else next(
        r for r in fe.finished if r.req_id == 1)
    if package == "port":
        assert fe.idle and fe.reject_reasons == {1: "draining"}
        assert victim.cancelled
        assert sorted(r.req_id for r in fe.finished
                      if r.state is RequestState.FINISHED) == [0, 2]
    else:
        assert not fe.idle and victim.state.value == "queued"


@pytest.mark.parametrize("package", ["port", "reference"])
def test_idle_counts_a_chunked_prefill(package):
    """Chunked prefill (16-token chunks): after one pump a lone request is
    mid-prefill, in ``sched.prefilling`` and not in ``sched.active``.  The
    reference's ``idle`` is then True, so its engine loop sleeps and the
    request never finishes; the port counts the chunk job."""
    import dataclasses
    from repro.api import PrefixConfig as JPrefix
    from repro_torch.api import PrefixConfig
    jcfg, tcfg = configs("slot", rows=2)
    jcfg = dataclasses.replace(jcfg, prefix=JPrefix(chunk_tokens=16))
    tcfg = tcfg.replace(prefix=PrefixConfig(chunk_tokens=16))
    eng, FS, FC, R = _package(package, jcfg, tcfg)
    fe = FS(eng._ensure_scheduler(), FC())
    prompt = np.random.default_rng(8).integers(1, 250, size=40).astype(np.int32)
    fe.submit(R(req_id=0, prompt=prompt, max_new_tokens=3))
    fe.pump()
    assert fe.sched.prefilling and not fe.sched.active
    assert fe.idle is (package == "reference")
    if package == "port":
        while not fe.idle:
            fe.pump()
        assert fe.finished[0].n_generated == 3


@pytest.mark.parametrize("package", ["port", "reference"])
def test_preempted_replay_keeps_its_tokens(package):
    """A batch request is preempted after four tokens, and then the model
    changes (the final norm's sign flips, and with it every logit), so its
    replay computes other tokens, as a replay in another row or batch can
    by rounding on the card.  The reference commits them: the four tokens
    a client was already sent are replaced.  The port commits the four
    again and feeds them back; only the tokens after them are new."""
    eng, _, _, R = _package(package, *configs("slot", rows=2))
    sched = eng._ensure_scheduler()
    rng = np.random.default_rng(5)
    reqs = [R(req_id=i, prompt=rng.integers(1, 250, size=10 + i).astype(np.int32),
              max_new_tokens=8, priority=2) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    while min(r.n_generated for r in reqs) < 4:
        eng.step()
    before = {r.req_id: list(r.generated) for r in reqs}
    assert sched.preempt_lower_priority(0)
    victim = next(r for r in reqs if r.n_preemptions)
    sent = before[victim.req_id]
    sched.sp["final_norm"] = -2.0 - sched.sp["final_norm"]  # (1 + w) -> -(1 + w)
    while len(sched.finished) < 2:
        eng.step()
    assert victim.n_generated == 8 and len(sent) >= 4
    if package == "port":
        assert victim.generated[:len(sent)] == sent and victim.replay == sent
    else:
        assert victim.generated[:len(sent)] != sent


def _replay_engine(mode):
    """One-row port engine: the slot backend, chunked prefill (16-token
    chunks) on it, or paged pools with a full-depth draft."""
    from repro_torch.api import PrefixConfig, SpeculationConfig
    _, tcfg = configs("paged" if mode == "speculative" else "slot", rows=1)
    if mode == "chunked":
        tcfg = tcfg.replace(prefix=PrefixConfig(chunk_tokens=16))
    if mode == "speculative":
        tcfg = tcfg.replace(speculation=SpeculationConfig(enabled=True, max_k=3,
                                                          draft_layers=0))
    return Engine.build(tcfg, params=shared_params()[1])


def _run_alone(eng, prompt, gen, replay=(), feed=()):
    """One request alone in ``eng``'s scheduler, with ``replay`` as a
    preemption leaves it; after every tick the row's next input is its last
    committed token.  ``feed`` is the oracle: tokens written by hand into
    the row's input before each decode step (teacher forcing), of which
    the run's own tokens replace those at the same index."""
    sched = eng._ensure_scheduler()
    req = Request(req_id=0, prompt=prompt, max_new_tokens=gen, replay=list(replay))
    if feed:
        decode = sched.executor.decode

        def fed(sp, state, pa, tokens, **kw):
            k = req.n_generated - 1  # the index of the token this step reads
            if k < len(feed):
                tokens[req.row] = feed[k]
            return decode(sp, state, pa, tokens, **kw)
        sched.executor.decode = fed
    eng.submit(req)
    while req.state is not RequestState.FINISHED:
        eng.step()
        if not feed and req.state is RequestState.DECODING:
            assert int(sched.state.last_tokens[req.row]) == req.generated[-1]
    if feed:
        return list(feed) + req.generated[len(feed):]
    return list(req.generated)


@pytest.mark.parametrize("mode", ["slot", "chunked", "speculative"])
def test_replay_is_teacher_forced(mode):
    """A replay whose tokens 0 and 2 are not what the model computes (the
    first after prefill, the chunked one's after its last chunk): the run
    commits the four replayed tokens, then continues exactly as teacher
    forcing by hand does (plain decode on the same backend).  The
    speculative run cuts its committed windows at a replayed token and
    takes the rest back out of the cache; the pool ends empty."""
    vocab = configs()[1].model.vocab_size
    prompt = np.random.default_rng(13).integers(1, vocab, size=40).astype(np.int32)
    gen = 10
    free = _run_alone(_replay_engine(mode), prompt, gen)
    replay = free[:4]
    replay[0], replay[2] = (replay[0] + 1) % vocab, (replay[2] + 1) % vocab
    eng = _replay_engine(mode)
    backend = eng._ensure_scheduler().backend
    cuts = []
    if mode == "speculative":
        rollback = backend.rollback_rows
        backend.rollback_rows = lambda st, back: (cuts.append(dict(back)),
                                                  rollback(st, back))[1]
    got = _run_alone(eng, prompt, gen, replay=replay)
    oracle = _replay_engine("slot" if mode == "slot" else mode)
    if mode == "speculative":
        oracle = Engine.build(oracle.cfg.replace(speculation=dataclasses.replace(
            oracle.cfg.speculation, enabled=False)), params=shared_params()[1])
    want = _run_alone(oracle, prompt, gen, feed=replay)
    assert got[:4] == replay and got != free
    assert got == want
    if mode == "speculative":
        assert any(k > 0 for c in cuts for k in c.values()), cuts
        assert backend.pool.blocks_in_use() == 0
        backend.pool.check_invariants()
